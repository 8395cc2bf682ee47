"""Device microseconds a fused flush step in its segment layout, span
``ec.segments`` (``osd/ec_util._segments``' copies), from the span's CUDA
events."""

from ecbench import program_trace


def read(view):
    return program_trace.per_step(view, {program_trace.SEGMENTS},
                                  "device_us")
