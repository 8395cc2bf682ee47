"""Plain Reed-Solomon encode with ISA-L's ``reed_sol_van`` matrix, and the
per-shard crcs of a fused flush, for the benchmark's reference.

ISA-L's ``gf_gen_rs_matrix`` (what Ceph's isa plugin builds for
``technique=reed_sol_van``) makes coding row r of the m x k matrix the
powers of 2^r: row 0 all ones, row 1 1, 2, 4, ..., row 2 1, 4, 16, ....
"""

from __future__ import annotations

import numpy as np
import torch

from ecbench.reference import crc32c, gf256


def isa_rs_matrix(k: int, m: int) -> np.ndarray:
    mat = np.zeros((m, k), dtype=np.uint8)
    for r in range(m):
        gen = gf256.power(2, r)
        for j in range(k):
            mat[r, j] = gf256.power(gen, j)
    return mat


def parity(field: gf256.Field, k: int, m: int,
           data: torch.Tensor) -> torch.Tensor:
    """[k, N] data shards -> [m, N] parity shards."""
    return field.matvec(isa_rs_matrix(k, m), data)


def segment_crcs(data: torch.Tensor, par: torch.Tensor,
                 op_bytes: int) -> torch.Tensor:
    """[nops, k + m] int64: the crc register (linear part) of every op's
    segment of every shard, shard-major data [k, N] and parity [m, N] cut
    into ops of ``op_bytes`` consecutive bytes a shard."""
    shards = torch.cat([data, par])
    n_shards, total = shards.shape
    nops = total // op_bytes
    segs = shards.reshape(n_shards, nops, op_bytes).transpose(0, 1)
    return crc32c.register(segs.reshape(nops * n_shards, op_bytes)) \
        .reshape(nops, n_shards)
