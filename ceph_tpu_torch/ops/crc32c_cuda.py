"""Kernel B2 on Hopper: per-row crc32c linear part (csrc/crc32c_rows.cu).

Replaces ``ceph_tpu/ops/crc32c_device.py::_pallas_rows_fn``. L is linear
in a row's 4096 bits, so the kernel reads a row with one warp (16 bytes a
lane), XORs one shared-memory table word per 6-bit field and reduces the
lane parts of :data:`ROWS` rows together; each block builds its tables
from :func:`basis_words`, uploaded once per device (see the source).

The wrapper's contract is the plain version's (``crc32c_torch.crc_rows``):
[rows, 512] uint8 -> [rows] int64 in [0, 2^32), written by the kernel.
For a CUDA tensor it launches the kernel or raises; for a CPU tensor it
runs the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ceph_tpu_torch.ops import crc32c_torch, cuda_build

#: launches of the CUDA kernel since the last reset (plain runs not counted)
launches = 0

#: the kernel's defaults (``B2_ROWS``, ``B2_THREADS`` in the source): rows
#: a warp reduces together, threads a block (one block an SM)
ROWS = 8
THREADS = 512

_NAME = "crc32c_rows"
_launcher = None


def reset_launches() -> None:
    global launches
    launches = 0


@functools.lru_cache(maxsize=1)
def basis_words() -> np.ndarray:
    """[4096] uint32: word i = L(bit i of a 512-byte row alone), bit
    8c + b being bit b of byte c: ``_B_matrix(512)``'s row i packed, bit j
    = column j."""
    bits = crc32c_torch._B_matrix(crc32c_torch.ROW_BYTES).astype(np.uint32)
    return np.bitwise_or.reduce(bits << np.arange(32, dtype=np.uint32),
                                axis=1).astype(np.uint32)


@functools.lru_cache(maxsize=1)
def _basis() -> cuda_build.DeviceArrays:
    return cuda_build.DeviceArrays({"basis": basis_words()})


def _lib() -> tuple[ctypes.CDLL, object]:
    """(library, launcher), the launcher's ctypes signature set once when
    the library loads."""
    global _launcher
    if _launcher is None:
        lib = cuda_build.load(_NAME)
        fn = lib.crc32c_rows_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = lib, fn
    return _launcher


def crc_rows(x: torch.Tensor) -> torch.Tensor:
    """[rows, 512] uint8 -> [rows] int64 linear crc of each row."""
    if not x.is_cuda:
        return crc32c_torch.crc_rows(x)
    rb = crc32c_torch.ROW_BYTES
    if x.dtype != torch.uint8 or x.dim() != 2 or x.shape[1] != rb:
        raise ValueError(f"x must be [rows, {rb}] uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    rows = x.shape[0]
    dev = x.device
    out = torch.empty(rows, dtype=torch.int64, device=dev)
    if rows:
        lib, fn = _lib()
        args = (x.data_ptr(), _basis().on(dev)["basis"].data_ptr(),
                out.data_ptr(), rows,
                torch.cuda.current_stream(dev).cuda_stream)
        if dev.index == torch.cuda.current_device():
            err = fn(*args)
        else:
            with torch.cuda.device(dev):
                err = fn(*args)
        cuda_build.check(lib, err, "crc32c_rows launch")
        global launches
        launches += 1
    return out
