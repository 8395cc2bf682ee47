"""Plain GF(2^8) arithmetic for the benchmark's reference.

The field is GF(2)[x] / (x^8 + x^4 + x^3 + x^2 + 1) (0x11D), the field of
ISA-L and of jerasure at w=8. Products are worked out here by carry-less
shift-and-add, a formulation of its own, and held in one 256 x 256 table;
the device side applies it by table lookup, one coefficient at a time.
Nothing here comes from the program under test.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

POLY = 0x11D


def mul(a: int, b: int) -> int:
    """a * b in GF(2^8), by shift-and-add with reduction by POLY."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= POLY
    return out


@functools.lru_cache(maxsize=None)
def mul_table() -> np.ndarray:
    """[256, 256] uint8: row a, column b holds a * b."""
    tbl = np.zeros((256, 256), dtype=np.uint8)
    for a in range(256):
        for b in range(256):
            tbl[a, b] = mul(a, b)
    return tbl


@functools.lru_cache(maxsize=None)
def power(a: int, n: int) -> int:
    out = 1
    for _ in range(n):
        out = mul(out, a)
    return out


@functools.lru_cache(maxsize=None)
def inverse(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return next(b for b in range(1, 256) if mul(a, b) == 1)


def mat_inverse(mat: np.ndarray) -> np.ndarray:
    """Inverse of a square matrix over GF(2^8) by Gauss-Jordan."""
    n = mat.shape[0]
    a = [[int(v) for v in row] + [int(i == j) for j in range(n)]
         for i, row in enumerate(mat)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col])
        a[col], a[piv] = a[piv], a[col]
        s = inverse(a[col][col])
        a[col] = [mul(s, v) for v in a[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [v ^ mul(f, w) for v, w in zip(a[r], a[col])]
    return np.array([row[n:] for row in a], dtype=np.uint8)


class Field:
    """The multiplication table on one device, with the vector forms the
    reference needs."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.table = torch.from_numpy(mul_table()).to(self.device)

    def scale(self, c: int, v: torch.Tensor) -> torch.Tensor:
        """c * v, element-wise, for a uint8 tensor v."""
        if c == 0:
            return torch.zeros_like(v)
        if c == 1:
            return v.clone()
        return self.table[c][v.long()]

    def matvec(self, mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
        """out[r] = XOR over c of mat[r, c] * data[c]; data [cols, ...]."""
        rows, cols = mat.shape
        if data.shape[0] != cols:
            raise ValueError(f"matrix has {cols} columns, data "
                             f"{data.shape[0]} rows")
        out = torch.zeros((rows,) + tuple(data.shape[1:]),
                          dtype=torch.uint8, device=data.device)
        for c in range(cols):
            idx = data[c].long()
            for r in range(rows):
                coef = int(mat[r, c])
                if coef:
                    out[r] ^= self.table[coef][idx]
        return out
