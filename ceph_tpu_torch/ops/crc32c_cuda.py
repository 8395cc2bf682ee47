"""Kernel B2 on Hopper: per-row crc32c linear part (csrc/crc32c_rows.cu).

Replaces ``ceph_tpu/ops/crc32c_device.py::_pallas_rows_fn``. One thread per
512-byte row runs the Castagnoli table recurrence from state 0. The
wrapper's contract is the plain version's (``crc32c_torch.crc_rows``):
[rows, 512] uint8 -> [rows] int64 in [0, 2^32). For a CUDA tensor it
launches the kernel or raises; for a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ceph_tpu_torch.ops import crc32c_torch, cuda_build

#: launches of the CUDA kernel since the last reset (plain runs not counted)
launches = 0

_NAME = "crc32c_rows"


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_NAME)
    fn = lib.crc32c_rows_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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
    out = torch.empty(rows, dtype=torch.int32, device=x.device)
    if rows:
        lib = _lib()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        with torch.cuda.device(x.device):
            err = lib.crc32c_rows_launch(x.data_ptr(), out.data_ptr(),
                                         rows, stream)
        cuda_build.check(lib, err, "crc32c_rows launch")
        global launches
        launches += 1
    # the kernel writes uint32 bits; widen to the int64 contract
    return out.to(torch.int64) & 0xFFFFFFFF
