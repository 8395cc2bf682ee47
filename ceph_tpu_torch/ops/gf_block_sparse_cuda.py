"""Kernel B5 on Hopper: the block-sparse GF(2^8) matvec, bit-sliced
(csrc/gf_block_sparse.cu).

Replaces ``ceph_tpu/ops/gf_block_sparse.py::_sparse_kernel`` (launched by
``_build_runner``). No tables: a thread holds 32 lanes as 8 bit planes.
Per live column of its row group it transposes 32 data bytes into planes,
forms the multiples x^b * data and XORs each into the rows whose
coefficient has bit b set; each accumulator row is transposed back and
written straight to its un-permuted position. One CUDA block per (row
group, lane tile), the group fastest-varying so a tile's groups share its
data rows in L2; for short N the block's warps split the columns instead.
The kernel reads only each live column's data row and 16 coefficient
bytes (:func:`plan_arrays`). See the source for the design and its bound.

:func:`matvec` takes a plan (ops/gf_block_sparse.py) and a CUDA tensor
and launches the kernel or raises; for a CPU tensor it runs the plain
version (ops/gf_block_sparse_torch.py).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ceph_tpu_torch.ops import cuda_build, gf_block_sparse_torch
from ceph_tpu_torch.ops.gf_block_sparse import BlockPlan

#: rows of a group in the kernel's register accumulators (the largest
#: tile_m it takes)
MAX_TILE_M = 16

#: launches of the CUDA kernel since the last reset (plain runs not counted)
launches = 0

_NAME = "gf_block_sparse"
_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    launches = 0


def plan_arrays(plan: BlockPlan) -> dict[str, np.ndarray]:
    """The plan as the flat arrays the kernel reads. A live column of a
    group is a data row with at least one nonzero coefficient in the
    group's rows (columns of an occupied block that are zero throughout
    the group are dropped). Groups are laid out at 16 rows whatever the
    plan's ``tile_m``; rows past it are padding.

    - ``grp_off`` [groups + 1] int32: group g owns live columns
      grp_off[g] .. grp_off[g+1]-1, in ascending data-row order;
    - ``col_row`` [cols] int32: the data row of each live column;
    - ``col_coef`` [cols, 16] uint8: the coefficients of the group's 16
      rows in that column (one 16-byte load);
    - ``out_row`` [groups * 16] int32: output row of each group slot (-1
      for padding rows).
    """
    tm, tk = plan.tile_m, plan.tile_k
    off, rows, coefs = [0], [], []
    for occ, coef in plan.groups:
        if coef is not None:
            live = np.nonzero(coef.any(axis=0))[0]
            cols = (np.asarray(occ, np.int64)[:, None] * tk +
                    np.arange(tk)).reshape(-1)[live]
            rows.extend(cols.tolist())
            padded = np.zeros((len(live), MAX_TILE_M), np.uint8)
            padded[:, :tm] = coef[:, live].T
            coefs.append(padded)
        off.append(len(rows))
    order = np.full((len(plan.groups), MAX_TILE_M), plan.m, np.int64)
    order[:, :tm] = np.asarray(plan.row_order).reshape(-1, tm)
    return {
        "grp_off": np.asarray(off, dtype=np.int32),
        "col_row": np.asarray(rows, dtype=np.int32),
        "col_coef": np.concatenate(coefs) if coefs else
        np.zeros((0, MAX_TILE_M), np.uint8),
        "out_row": np.where(order < plan.m, order, -1).astype(np.int32)
        .reshape(-1),
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
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
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
            arr["grp_off"].data_ptr(), arr["col_row"].data_ptr(),
            arr["col_coef"].data_ptr(), arr["out_row"].data_ptr(),
            data.data_ptr(), out.data_ptr(), len(plan.groups), n, vec,
            stream)
    cuda_build.check(lib, err, "gf_block_sparse launch")
    global launches
    launches += 1
    return out
