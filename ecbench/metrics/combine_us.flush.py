"""Device microseconds a fused flush step in the crc's stage-2 combine,
span ``ec.crc_combine`` (``ops/crc32c_torch.combine_rows``), from the
span's CUDA events."""

from ecbench import program_trace


def read(view):
    return program_trace.per_step(view, {program_trace.COMBINE},
                                  "device_us")
