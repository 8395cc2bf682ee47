"""The repair product, whichever route the calibration took (kernel B5,
``ops/gf_block_sparse_cuda.py``, or the dense product), against its bytes
bound: the helpers' sub-chunks in, one chunk out. Every device operation
of the traced calls counts."""


def read(view):
    return view.roofline_pct("repair")
