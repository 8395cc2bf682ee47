"""Block-sparse GF(2^8) matrix-stripe product — host planner and dispatch.

Port of ``ceph_tpu/ops/gf_block_sparse.py`` (the host side of kernel B5).
The Clay linearized signature matrices (models/clay.py) are big and
sparse: the k=8,m=4,d=11 decode-2 matrix is [128, 640] GF entries at ~8%
byte density. A dense product touches every entry; this one skips the
zero blocks:

- :func:`plan_blocks` partitions the matrix into [tile_m, tile_k] GF
  blocks and keeps only the occupied ones. Row groups are formed by
  greedy support clustering (rows sharing column support land in the same
  group), so a group's occupied column blocks are few. The plan's
  ``row_order``, ``inv_order`` and per-group block ids are the
  reference's exactly.
- each group carries its COMPACT GF coefficients [tile_m, G] (G = 8 x
  occupied blocks). The reference carries the bit-matrix expansion of the
  same coefficients (``_permute_bitmatrix``), an artefact of the TPU's
  matrix unit; both kernels compute the same product.

The product itself: kernel B5 (ops/gf_block_sparse_cuda.py,
csrc/gf_block_sparse.cu) for a CUDA tensor, its plain version
(ops/gf_block_sparse_torch.py) for a tensor on the CPU. The reference's
lane-tile argument and pow2 padding are TPU artefacts and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ceph_tpu_torch.utils import tracepoints
from ceph_tpu_torch.utils.lru import BoundedLRU

_SPAN_PLAN = tracepoints.provider("bsparse").span("plan_lookup")

#: GF rows per row group (the reference's 8*16 = 128 bit rows)
TILE_M = 16

#: GF columns per column block
TILE_K = 8

#: plan cache bound (decode signatures are C(k+m, <=m) per codec; the
#: same sizing argument as the ISA decode-table LRU)
_PLAN_CACHE_SIZE = 64


@dataclass
class BlockPlan:
    """Host-side gather-of-blocks schedule for one GF matrix."""

    m: int                       # GF output rows (unpadded)
    k: int                       # GF input rows (unpadded)
    kp: int                      # input rows padded to tile_k
    tile_m: int
    tile_k: int
    row_order: np.ndarray        # [mp] group-major original-row ids
    inv_order: np.ndarray        # [m] output row -> group-major slot
    groups: list                 # [(block_col_ids, coef [tile_m, G] or None)]
    occupancy: float             # occupied / total blocks
    mac_frac: float              # sparse bit-MACs / dense bit-MACs
    cost_frac: float             # matrix-unit cost (row-pass * depth) ratio

    @property
    def worthwhile(self) -> bool:
        """Whether the schedule saves real work: a nearly-dense matrix
        gains nothing and pays the gather overhead."""
        return self.cost_frac <= 0.7


def _support(mat: np.ndarray, tile_k: int) -> list:
    """Per-row frozenset of occupied column-block ids."""
    m, kp = mat.shape
    nb = kp // tile_k
    blocked = mat.reshape(m, nb, tile_k).any(axis=2)
    return [frozenset(np.nonzero(blocked[r])[0].tolist())
            for r in range(m)]


def _cluster_rows(sup: list, tile_m: int) -> list:
    """Greedy support clustering: groups of tile_m rows minimizing
    each group's union of occupied column blocks."""
    remaining = set(range(len(sup)))
    groups = []
    while remaining:
        seed = max(remaining, key=lambda r: (len(sup[r]), -r))
        grp = [seed]
        remaining.discard(seed)
        union = set(sup[seed])
        while len(grp) < tile_m and remaining:
            best = min(remaining,
                       key=lambda r: (len(sup[r] - union),
                                      -len(sup[r] & union), r))
            grp.append(best)
            remaining.discard(best)
            union |= sup[best]
        groups.append(sorted(grp))
    return groups


def plan_blocks(mat: np.ndarray, tile_m: int = TILE_M,
                tile_k: int = TILE_K) -> BlockPlan:
    """Build the gather-of-blocks schedule for ``mat`` [m, k] uint8."""
    mat = np.asarray(mat, dtype=np.uint8)
    m, k = mat.shape
    kp = -(-k // tile_k) * tile_k
    mp = -(-m // tile_m) * tile_m
    padded = np.zeros((mp, kp), dtype=np.uint8)
    padded[:m, :k] = mat
    sup = _support(padded, tile_k)
    clusters = _cluster_rows(sup[:m], tile_m)
    # pad the last group with virtual zero rows
    flat: list[int] = []
    for grp in clusters:
        flat.extend(grp)
    while len(flat) < mp:
        flat.append(len(flat))          # virtual padding row ids
    row_order = np.asarray(flat, dtype=np.int64)
    inv_order = np.empty(m, dtype=np.int64)
    for slot, r in enumerate(flat):
        if r < m:
            inv_order[r] = slot

    groups = []
    occupied = 0
    cost = 0
    nb = kp // tile_k
    for gi in range(mp // tile_m):
        rows = row_order[gi * tile_m:(gi + 1) * tile_m]
        sub = padded[rows]               # [tile_m, kp]
        occ = np.nonzero(
            sub.reshape(tile_m, nb, tile_k).any(axis=(0, 2)))[0]
        occupied += len(occ)
        cost += len(occ) * 8 * tile_k    # one row pass per group
        compact = np.ascontiguousarray(np.concatenate(
            [sub[:, b * tile_k:(b + 1) * tile_k] for b in occ],
            axis=1)) if len(occ) else None
        groups.append((occ.astype(np.int64), compact))
    total_blocks = (mp // tile_m) * nb
    dense_cost = (mp // tile_m) * -(-8 * tile_m // 128) * 8 * kp
    return BlockPlan(
        m=m, k=k, kp=kp, tile_m=tile_m, tile_k=tile_k,
        row_order=row_order, inv_order=inv_order, groups=groups,
        occupancy=occupied / max(total_blocks, 1),
        mac_frac=(occupied * 8 * tile_m * 8 * tile_k)
        / max(8 * mp * 8 * kp, 1),
        cost_frac=cost * -(-8 * tile_m // 128) / max(dense_cost, 1))


def occupancy_stats(mat: np.ndarray, tile_m: int = TILE_M,
                    tile_k: int = TILE_K) -> dict:
    """Density numbers for bench reporting."""
    plan = plan_blocks(mat, tile_m, tile_k)
    mat = np.asarray(mat, dtype=np.uint8)
    return {
        "shape": list(mat.shape),
        "byte_density": round(float((mat != 0).mean()), 4),
        "block_occupancy": round(plan.occupancy, 4),
        "mac_frac": round(plan.mac_frac, 4),
        "cost_frac": round(plan.cost_frac, 4),
        "mac_cut": round(1.0 / max(plan.cost_frac, 1e-9), 2),
    }


def _runner(plan: BlockPlan):
    def runner(data: torch.Tensor) -> torch.Tensor:
        # imported here: both modules import this one for BlockPlan
        from ceph_tpu_torch.ops import (gf_block_sparse_cuda,
                                        gf_block_sparse_torch)
        if data.is_cuda:
            return gf_block_sparse_cuda.matvec(plan, data)
        return gf_block_sparse_torch.matvec(plan, data)
    return runner


class _RunnerCache:
    """(matrix bytes, tiles) -> (plan, runner), LRU-bounded like the
    linearized-transform cache it sits next to in models/clay.py."""

    def __init__(self) -> None:
        self._lru = BoundedLRU(_PLAN_CACHE_SIZE, "bsparse.plans")

    def get(self, mat: np.ndarray, tile_m: int, tile_k: int):
        mat = np.asarray(mat, dtype=np.uint8)
        key = (mat.shape, tile_m, tile_k, mat.tobytes())

        def build():
            plan = plan_blocks(mat, tile_m, tile_k)
            return plan, _runner(plan)

        return self._lru.get_or_build(key, build)


_runner_cache = _RunnerCache()


def matvec_device(mat: np.ndarray, data: torch.Tensor,
                  tile_m: int = TILE_M, tile_k: int = TILE_K
                  ) -> torch.Tensor:
    """Device-in/device-out block-sparse GF matvec.

    mat: [m, k] uint8 (host). data: [k, N] uint8 tensor. Returns [m, N]
    uint8 on data's device, byte-identical to the dense product (zero
    blocks contribute nothing over GF). On CUDA this launches kernel B5
    or raises. The plan's lookup (which hashes the matrix) is span
    ``bsparse.plan_lookup``."""
    with _SPAN_PLAN():
        _plan, runner = _runner_cache.get(mat, tile_m, tile_k)
    return runner(data)


def matvec(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Host-in/host-out wrapper (ops.backend matvec contract); runs the
    plain version on the CPU."""
    dev = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8))
    return matvec_device(mat, dev).numpy()


def plan_for(mat: np.ndarray, tile_m: int = TILE_M,
             tile_k: int = TILE_K) -> BlockPlan:
    """The cached plan for ``mat`` (stats live on it)."""
    plan, _runner_fn = _runner_cache.get(mat, tile_m, tile_k)
    return plan
