"""Kernel B1 on Hopper: the GF(2^8) matrix-stripe product (csrc/gf_matvec.cu).

Replaces ``ceph_tpu/ops/gf_pallas.py::_gf_matvec_kernel`` (entry
``matvec_device``). A thread holds 32 lanes of a data row as 8 bit-plane
words and multiplies along the multiply-by-x chain; the host turns the
matrix into a parameter block (:func:`coef_block`: per input column and
chain step, the mask of output rows whose coefficient has that bit set)
that the kernel takes in its launch parameters. See the source for the
design and its bound.

:func:`matvec_device` is device-in/device-out and byte-identical to
``gf256.gf_matvec_chunks``. For a CUDA tensor it launches the kernel or
raises; for a CPU tensor it runs the plain version (ops/gf_torch.py).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from ceph_tpu_torch.ops import cuda_build, gf_torch

#: largest matrix the kernel takes: 32 output rows fit one 32-bit row
#: mask, and 128 columns of masks (4 KiB) the kernel's parameters (the
#: TPU wrapper's limit, gf_pallas.py:234)
MAX_M, MAX_K = 32, 128

#: launches of the CUDA kernel since the last reset (plain runs not counted)
launches = 0

#: the kernel's block size, the lanes of one block (256 threads x 32
#: lanes) and its row-block templates: output rows accumulated in
#: registers per pass over the data (the smallest that holds m, passes of
#: 16 past 16)
THREADS = 256
TILE_LANES = THREADS * 32
ROW_BLOCKS = (2, 4, 16)

_NAME = "gf_matvec"
_coef_lock = threading.Lock()
_coef: dict[tuple, tuple[np.ndarray, int]] = {}
_launcher = None


def reset_launches() -> None:
    global launches
    launches = 0


def coef_block(mat: np.ndarray) -> np.ndarray:
    """The kernel's parameter block for ``mat`` [m, k], as uint8: mask
    [k, 8] uint32 little-endian, bit i of mask[j, s] = bit s of
    mat[i, j] (= B[8i+s, 8j] of ``bitmatrix.expand_bitmatrix``), then
    steps [k] uint8, the chain length of column j (its top set bit + 1,
    0 for a zero column)."""
    mat = np.asarray(mat, dtype=np.uint8)
    m, k = mat.shape
    bits = (mat[:, :, None] >> np.arange(8, dtype=np.uint8)) & 1
    mask = (bits.astype(np.uint32) <<
            np.arange(m, dtype=np.uint32)[:, None, None]).sum(
                axis=0, dtype=np.uint32)
    top = np.bitwise_or.reduce(mat, axis=0)
    steps = np.array([int(v).bit_length() for v in top], dtype=np.uint8)
    return np.concatenate([mask.astype("<u4").view(np.uint8).reshape(-1),
                           steps])


class LaunchPlan(NamedTuple):
    """One B1 launch: row-block template, passes over the data, blocks."""
    rows: int
    passes: int
    blocks: int


def launch_plan(n: int, m: int) -> LaunchPlan:
    """B1's launch for N lanes and m output rows: rows 2 for m <= 2, 4 for
    m <= 4, else 16; one block of 256 threads per tile of TILE_LANES
    lanes and pass. The C launcher takes this plan as it is and only
    refuses one that does not cover m rows and N lanes."""
    rows = next((r for r in ROW_BLOCKS if m <= r), ROW_BLOCKS[-1])
    passes = -(-m // rows)
    return LaunchPlan(rows, passes, -(-n // TILE_LANES) * passes)


def _coef_ptr(mat: np.ndarray) -> tuple[np.ndarray, int]:
    """(parameter block, its address), built once per matrix."""
    key = (mat.shape, mat.tobytes())
    hit = _coef.get(key)
    if hit is None:
        blk = coef_block(mat)
        hit = blk, blk.ctypes.data
        with _coef_lock:
            if len(_coef) > 256:
                _coef.clear()
            _coef[key] = hit
    return hit


def _lib() -> tuple[ctypes.CDLL, object]:
    """(library, launcher), the launcher's ctypes signature set once when
    the library loads."""
    global _launcher
    if _launcher is None:
        lib = cuda_build.load(_NAME)
        fn = lib.gf_matvec_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = lib, fn
    return _launcher


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
    dev = data.device
    out = torch.empty((m, n), dtype=torch.uint8, device=dev)
    if n == 0 or m == 0:
        return out
    coef = _coef_ptr(mat)        # held until the launch has copied it
    plan = launch_plan(n, m)
    src, dst = data.data_ptr(), out.data_ptr()
    vec = int(n % 16 == 0 and src % 16 == 0 and dst % 16 == 0)
    lib, fn = _lib()
    args = (src, dst, n, m, k, coef[1], *plan, vec,
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    cuda_build.check(lib, err, "gf_matvec launch")
    global launches
    launches += 1
    return out


def matvec_tiled(mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """[w, p] (x) [p, N] -> [w, N] for a matrix of any size: one
    :func:`matvec_device` per block of at most ``MAX_M`` rows and
    ``MAX_K`` columns, the column blocks' partial products XORed together
    (a [64, 176] matrix is 2 x 2 launches)."""
    w, p = mat.shape
    rows = []
    for r0 in range(0, w, MAX_M):
        acc = None
        for c0 in range(0, p, MAX_K):
            part = matvec_device(
                np.ascontiguousarray(mat[r0:r0 + MAX_M, c0:c0 + MAX_K]),
                data[c0:c0 + MAX_K])
            acc = part if acc is None else acc.bitwise_xor_(part)
        rows.append(acc)
    return rows[0] if len(rows) == 1 else torch.cat(rows)
