"""Kernel B1 on Hopper: the GF(2^8) matrix-stripe product (csrc/gf_matvec.cu).

Replaces ``ceph_tpu/ops/gf_pallas.py::_gf_matvec_kernel`` (entry
``matvec_device``). The host builds ISA-L-style split-nibble tables, 32
bytes per coefficient; the kernel stages them in shared memory and each
thread XORs table lookups for 16 lanes into up to four output rows per
pass. See the source for the design and its bound.

:func:`matvec_device` is device-in/device-out and byte-identical to
``gf256.gf_matvec_chunks``. For a CUDA tensor it launches the kernel or
raises; for a CPU tensor it runs the plain version (ops/gf_torch.py).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ceph_tpu_torch.ops import cuda_build, gf256, gf_torch

#: largest matrix the kernel takes: 32 x 128 coefficients are 128 KiB of
#: tables in shared memory (the TPU wrapper's limit, gf_pallas.py:234)
MAX_M, MAX_K = 32, 128

#: launches of the CUDA kernel since the last reset (plain runs not counted)
launches = 0

_NAME = "gf_matvec"
_tables_lock = threading.Lock()
_tables: dict[tuple, torch.Tensor] = {}


def reset_launches() -> None:
    global launches
    launches = 0


def nibble_tables(mat: np.ndarray) -> np.ndarray:
    """[m, k, 32] uint8: entry (i, j) holds mat[i,j]*x for x = 0..15
    (low nibble) then mat[i,j]*(x << 4) (high nibble)."""
    mat = np.asarray(mat, dtype=np.uint8)
    nib = np.arange(16, dtype=np.uint8)
    lo = gf256.MUL_TABLE[mat[:, :, None], nib[None, None, :]]
    hi = gf256.MUL_TABLE[mat[:, :, None], (nib << 4)[None, None, :]]
    return np.ascontiguousarray(np.concatenate([lo, hi], axis=2))


def _device_tables(mat: np.ndarray, device: torch.device) -> torch.Tensor:
    key = (mat.shape, mat.tobytes(), str(device))
    with _tables_lock:
        dev = _tables.get(key)
        if dev is None:
            if len(_tables) > 256:
                _tables.clear()
            dev = _tables[key] = torch.from_numpy(
                nibble_tables(mat)).to(device)
    return dev


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_NAME)
    fn = lib.gf_matvec_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def matvec_device(mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """parity[m, N] = mat[m, k] (x) data[k, N] over GF(2^8).

    ``data`` is a [k, N] uint8 tensor; the result lies on its device.
    On CUDA the kernel runs on the current stream (no synchronisation).
    """
    if not data.is_cuda:
        return gf_torch.matvec(mat, data)
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    m, k = mat.shape
    if m > MAX_M or k > MAX_K:
        raise ValueError(f"matrix {m}x{k} exceeds the kernel's "
                         f"{MAX_M}x{MAX_K} limit")
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[0] != k:
        raise ValueError(f"data must be [{k}, N] uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    n = data.shape[1]
    out = torch.empty((m, n), dtype=torch.uint8, device=data.device)
    if n == 0:
        return out
    tables = _device_tables(mat, data.device)
    vec = int(n % 16 == 0 and data.data_ptr() % 16 == 0)
    lib = _lib()
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        err = lib.gf_matvec_launch(tables.data_ptr(), data.data_ptr(),
                                   out.data_ptr(), m, k, n, vec, stream)
    cuda_build.check(lib, err, "gf_matvec launch")
    global launches
    launches += 1
    return out
