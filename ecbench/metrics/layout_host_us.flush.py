"""Host microseconds a fused flush step spends enqueuing its layout work:
spans ``ec.segments`` and ``ec.crc_combine`` together."""

from ecbench import program_trace


def read(view):
    return program_trace.per_step(
        view, {program_trace.SEGMENTS, program_trace.COMBINE}, "host_us")
