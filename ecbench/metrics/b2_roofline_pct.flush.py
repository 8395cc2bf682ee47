"""Kernel B2 (``ops/crc32c_cuda.py``, ``csrc/crc32c_rows.cu``) against its
bytes bound: the padded segments in, an int64 a 512-byte row out."""

from ecbench.metrics_common import B2


def read(view):
    return view.roofline_pct("b2", B2)
