"""Seconds the port spent in its own set-up phases in this run: kernel
library loads (with any build), Clay's repair calibrations and encode
tables, from the device telemetry's set-up table."""

from ecbench import program_trace


def read(view):
    return program_trace.setup_s()
