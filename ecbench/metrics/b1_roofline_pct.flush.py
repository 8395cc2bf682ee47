"""Kernel B1 (``ops/gf_cuda.py``, ``csrc/gf_matvec.cu``) against its
bytes bound: [k, N] data in, [m, N] parity out."""

from ecbench.metrics_common import B1


def read(view):
    return view.roofline_pct("b1", B1)
