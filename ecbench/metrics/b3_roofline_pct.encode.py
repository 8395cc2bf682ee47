"""Kernel B3 (``ops/clay_cuda.py``, ``csrc/clay_encode.cu``) against its
bytes bound: k data chunks in, m parity chunks out."""

from ecbench.metrics_common import B3


def read(view):
    return view.roofline_pct("b3", B3)
