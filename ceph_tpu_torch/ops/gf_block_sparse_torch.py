"""Plain torch version of kernel B5 — the block-sparse GF(2^8) matvec.

Follows the plan of ops/gf_block_sparse.py step by step: per row group,
gather the data rows of its occupied column blocks, multiply them by the
group's compact [tile_m, G] coefficients with the plain bit-sliced
product (ops/gf_torch.py), stack the groups' rows group-major, and
un-permute with ``inv_order``. This is what the CUDA kernel
(ops/gf_block_sparse_cuda.py) is held to, and what B5's wrapper runs for
a tensor on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ops import gf_torch
from ceph_tpu_torch.ops.gf_block_sparse import BlockPlan


def matvec(plan: BlockPlan, data: torch.Tensor) -> torch.Tensor:
    """out[m, N] = mat (x) data[k, N] over GF(2^8) along ``plan``."""
    if data.dtype != torch.uint8 or data.dim() != 2 or \
            data.shape[0] != plan.k:
        raise ValueError(f"data must be [{plan.k}, N] uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    n = data.shape[1]
    tm, tk = plan.tile_m, plan.tile_k
    if plan.kp != plan.k:
        pad = torch.zeros((plan.kp - plan.k, n), dtype=torch.uint8,
                          device=data.device)
        data = torch.cat([data, pad])
    parts = []
    for occ, coef in plan.groups:
        if coef is None:
            parts.append(torch.zeros((tm, n), dtype=torch.uint8,
                                     device=data.device))
            continue
        idx = np.concatenate([np.arange(b * tk, (b + 1) * tk) for b in occ])
        gathered = data[torch.from_numpy(idx).to(data.device)]
        parts.append(gf_torch.matvec(coef, gathered))
    grouped = torch.cat(parts)                      # group-major rows
    inv = torch.from_numpy(plan.inv_order).to(data.device)
    return grouped[inv]
