"""The share of the traced window in which no kernel, copy or memset ran
on the card."""

from ecbench.metrics_common import idle_pct


def read(view):
    return idle_pct(view)
