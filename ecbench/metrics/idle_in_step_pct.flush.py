"""The share of the traced window in which no operation ran on the card
while the host was inside a fused flush step (span ``ec.fused_step``)."""

from ecbench import program_trace


def read(view):
    return program_trace.idle_in_steps_pct(view)
