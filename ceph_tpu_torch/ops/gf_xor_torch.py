"""Plain torch version of kernel B6 (the XOR-strip transform).

Each output strip r is the XOR of the input strips that ``schedule[r]``
lists, over the strip layout ``[8k, B, 128]`` int32 (ops/gf_xor.py). The
CPU path and the tests use it; ``chip_smoke.py`` holds the CUDA kernel
(ops/gf_xor_cuda.py) against it on the card.
"""

from __future__ import annotations

import torch


def xor_strips(schedule, strips: torch.Tensor) -> torch.Tensor:
    """strips [8k, B, 128] int32 -> [len(schedule), B, 128] int32 on the
    same device. Each row gathers its terms, then halves them with
    in-place XORs (log2 of the term count steps)."""
    flat = [j for terms in schedule for j in terms]
    idx = torch.tensor(flat, dtype=torch.long, device=strips.device)
    out = strips.new_empty((len(schedule),) + tuple(strips.shape[1:]))
    pos = 0
    for r, terms in enumerate(schedule):
        acc = strips.index_select(0, idx[pos:pos + len(terms)])
        pos += len(terms)
        n = acc.shape[0]
        while n > 1:
            h = n // 2
            acc[:h] ^= acc[n - h:n]
            n -= h
        out[r] = acc[0]
    return out
