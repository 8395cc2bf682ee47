"""Kernel B5 on Hopper: the block-sparse GF(2^8) matvec
(csrc/gf_block_sparse.cu).

Replaces ``ceph_tpu/ops/gf_block_sparse.py::_sparse_kernel`` (launched by
``_build_runner``). One CUDA block per (row group, 4096-lane tile): it
streams the group's occupied column blocks through shared memory as
split-nibble tables (4 KiB per [16, 8] block, so any group fits: the
whole group's tables of up to 320 KiB never have to) and writes each
output row straight to its un-permuted position. See the source for the
design and its bound.

:func:`matvec` takes a plan (ops/gf_block_sparse.py) and a CUDA tensor
and launches the kernel or raises; for a CPU tensor it runs the plain
version (ops/gf_block_sparse_torch.py).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ceph_tpu_torch.ops import cuda_build, gf_block_sparse_torch, gf_cuda
from ceph_tpu_torch.ops.gf_block_sparse import BlockPlan

#: largest row group the kernel's register accumulators take
MAX_TILE_M = 16

#: launches of the CUDA kernel since the last reset (plain runs not counted)
launches = 0

_NAME = "gf_block_sparse"
_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    launches = 0


def plan_arrays(plan: BlockPlan) -> dict[str, np.ndarray]:
    """The plan as the flat arrays the kernel reads:

    - ``grp_off`` [groups + 1] int32: group g owns blocks
      grp_off[g] .. grp_off[g+1]-1;
    - ``blk_col`` [blocks] int32: the column-block id of each block;
    - ``coefs`` [blocks, tile_m, tile_k] uint8: its GF coefficients;
    - ``tabs`` [blocks, tile_m, tile_k, 32] uint8: their nibble tables;
    - ``out_row`` [groups * tile_m] int32: output row of each group slot
      (-1 for the padding rows of the last group).
    """
    tm, tk = plan.tile_m, plan.tile_k
    off, cols, coefs = [0], [], []
    for occ, coef in plan.groups:
        for bi, b in enumerate(occ):
            cols.append(int(b))
            coefs.append(coef[:, bi * tk:(bi + 1) * tk])
        off.append(len(cols))
    coefs = np.stack(coefs) if coefs else np.zeros((0, tm, tk), np.uint8)
    tabs = gf_cuda.nibble_tables(coefs.reshape(-1, tk)).reshape(
        len(cols), tm, tk, 32) if len(cols) else \
        np.zeros((0, tm, tk, 32), np.uint8)
    rows = plan.row_order.astype(np.int32)
    return {
        "grp_off": np.asarray(off, dtype=np.int32),
        "blk_col": np.asarray(cols, dtype=np.int32),
        "coefs": np.ascontiguousarray(coefs, dtype=np.uint8),
        "tabs": np.ascontiguousarray(tabs, dtype=np.uint8),
        "out_row": np.where(rows < plan.m, rows, -1).astype(np.int32),
    }


def _device_arrays(plan: BlockPlan, device: torch.device) -> dict:
    with _lock:
        arrays = plan.__dict__.get("_device_arrays")
        if arrays is None:
            arrays = plan.__dict__["_device_arrays"] = \
                cuda_build.DeviceArrays(plan_arrays(plan))
    return arrays.on(device)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(_NAME)
    fn = lib.gf_block_sparse_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def matvec(plan: BlockPlan, data: torch.Tensor) -> torch.Tensor:
    """out[m, N] = mat (x) data[k, N] over GF(2^8) along ``plan``, on
    data's device. On CUDA the kernel runs on the current stream (no
    synchronisation)."""
    if not data.is_cuda:
        return gf_block_sparse_torch.matvec(plan, data)
    if data.dtype != torch.uint8 or data.dim() != 2 or \
            data.shape[0] != plan.k:
        raise ValueError(f"data must be [{plan.k}, N] uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if plan.tile_m > MAX_TILE_M:
        raise ValueError(f"tile_m={plan.tile_m} exceeds the kernel's "
                         f"{MAX_TILE_M}")
    n = data.shape[1]
    out = torch.empty((plan.m, n), dtype=torch.uint8, device=data.device)
    if n == 0:
        return out
    arr = _device_arrays(plan, data.device)
    vec = int(n % 16 == 0 and data.data_ptr() % 16 == 0)
    lib = _lib()
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        err = lib.gf_block_sparse_launch(
            arr["grp_off"].data_ptr(), arr["blk_col"].data_ptr(),
            arr["tabs"].data_ptr(), arr["coefs"].data_ptr(),
            arr["out_row"].data_ptr(), data.data_ptr(), out.data_ptr(),
            len(plan.groups), plan.tile_m, plan.tile_k, plan.k, n, vec,
            stream)
    cuda_build.check(lib, err, "gf_block_sparse launch")
    global launches
    launches += 1
    return out
