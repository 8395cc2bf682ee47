"""GF(2^8) -> GF(2) bit-matrix expansion (port of ``ceph_tpu/ops/bitmatrix.py``).

Multiplication by a fixed GF(2^8) element ``a`` is linear over GF(2): writing
a byte as bits x = sum_c x_c 2^c, the product y = a*x has
bit_r(y) = XOR_c x_c * bit_r(a * 2^c). So an m×k GF(2^8) coding matrix
expands to an (8m)×(8k) binary matrix B with 8×8 blocks
B[8i+r, 8j+c] = bit_r(A[i,j] * 2^c), and position-wise chunk encoding
becomes a binary matmul over per-byte bit planes:

    P_bits[8m, N] = B[8m, 8k] @ D_bits[8k, N]  (mod 2)

where D_bits[8j+c, x] = bit c of data chunk j, byte x. The plain torch
matvec (ops/gf_torch.py) is this product.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ops import gf256


def expand_bitmatrix(mat: np.ndarray) -> np.ndarray:
    """Expand an [M,K] GF(2^8) matrix to the [8M,8K] binary matrix (uint8 0/1).

    B[8i+r, 8j+c] = bit r of (mat[i,j] * 2^c).
    """
    mat = np.asarray(mat, dtype=np.uint8)
    m, k = mat.shape
    powers = np.uint8([1 << c for c in range(8)])          # 2^c as field elems
    prods = gf256.MUL_TABLE[mat[:, :, None], powers[None, None, :]]  # [M,K,8]
    bits = (prods[:, :, None, :] >> np.arange(8)[None, None, :, None]) & 1
    # bits[i, j, r, c] = bit r of mat[i,j]*2^c  ->  B[8i+r, 8j+c]
    return bits.transpose(0, 2, 1, 3).reshape(8 * m, 8 * k).astype(np.uint8)


def unpack_bits(data: np.ndarray) -> np.ndarray:
    """[K, N] uint8 chunks -> [8K, N] bit planes, plane 8j+c = bit c of chunk j."""
    data = np.asarray(data, dtype=np.uint8)
    k, n = data.shape
    bits = (data[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1
    return bits.reshape(8 * k, n)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """[8M, N] bit planes -> [M, N] uint8 chunks (inverse of unpack_bits)."""
    m8, n = bits.shape
    if m8 % 8:
        raise ValueError(f"pack_bits: {m8} planes is not a multiple of 8")
    planes = bits.reshape(m8 // 8, 8, n).astype(np.uint16)
    weights = (np.uint16(1) << np.arange(8, dtype=np.uint16))[None, :, None]
    return (planes * weights).sum(axis=1).astype(np.uint8)
