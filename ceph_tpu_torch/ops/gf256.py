"""GF(2^8) arithmetic core — the numpy reference implementation.

This replaces the reference's vendored gf-complete / jerasure / ISA-L math
(all empty submodules in the snapshot; the reference C++ only orchestrates —
see src/erasure-code/jerasure/ErasureCodeJerasure.cc and
src/erasure-code/isa/ErasureCodeIsa.cc for the call sites this feeds).

Field: GF(2^8) with the primitive polynomial x^8 + x^4 + x^3 + x^2 + 1
(0x11d), the polynomial used by both gf-complete (w=8 default) and ISA-L, so
Reed-Solomon coefficients here match the reference plugins' field semantics.

Everything is vectorized numpy over uint8 arrays. This module is the port's
own copy of ``ceph_tpu/ops/gf256.py`` (the port imports nothing of
``ceph_tpu``) and the bit-exactness oracle for its device path
(ops/gf_torch.py, ops/gf_cuda.py): the corpus gate
(reference: src/test/erasure-code/ceph_erasure_code_non_regression.cc:39-57)
requires encode output to be byte-identical across backends.
"""

from __future__ import annotations

import numpy as np

# Primitive polynomial for GF(2^8): x^8+x^4+x^3+x^2+1 (0x11d) with generator 2.
POLY = 0x11D
FIELD = 256


def _build_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Build exp/log tables, the full 256x256 multiplication table and inverses."""
    gf_exp = np.zeros(512, dtype=np.uint8)
    gf_log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        gf_exp[i] = x
        gf_log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    # replicate so exp[log a + log b] never needs a mod
    gf_exp[255:510] = gf_exp[0:255]

    # Full multiplication table: MUL[a, b] = a * b in GF(2^8).
    la = gf_log[:, None]  # [256,1]
    lb = gf_log[None, :]  # [1,256]
    mul = gf_exp[(la + lb) % 255].astype(np.uint8)
    mul[0, :] = 0
    mul[:, 0] = 0

    inv = np.zeros(256, dtype=np.uint8)
    inv[1:] = gf_exp[(255 - gf_log[1:]) % 255]
    return gf_exp, gf_log, mul, inv


GF_EXP, GF_LOG, MUL_TABLE, INV_TABLE = _build_tables()


def gf_mul(a, b):
    """Element-wise GF(2^8) multiply of arrays/scalars (uint8)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    return MUL_TABLE[a, b]


def gf_inv(a):
    """Element-wise multiplicative inverse. inv(0) = 0 by convention."""
    return INV_TABLE[np.asarray(a, dtype=np.uint8)]


def gf_div(a, b):
    return gf_mul(a, gf_inv(b))


def gf_pow(a: int, n: int) -> int:
    """a**n in GF(2^8) (scalar)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % 255])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8): C[i,j] = XOR_k a[i,k] * b[k,j].

    Works for any a:[M,K], b:[K,N] uint8. For the codec hot path with large N
    (chunk bytes) use :func:`gf_matvec_chunks` which loops over K to bound
    temporary memory.
    """
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    prod = MUL_TABLE[a[:, :, None], b[None, :, :]]  # [M,K,N]
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_matvec_chunks(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Apply an [M,K] GF matrix to K data chunks of N bytes each -> [M,N].

    This is the reference hot kernel: ``ec_encode_data`` in ISA-L /
    ``jerasure_matrix_encode`` (called from
    src/erasure-code/isa/ErasureCodeIsa.cc:118-130 and
    src/erasure-code/jerasure/ErasureCodeJerasure.cc), done position-wise:
    out[i][x] = XOR_k mat[i,k] * data[k][x].
    """
    mat = np.asarray(mat, dtype=np.uint8)
    data = np.asarray(data, dtype=np.uint8)
    m, k = mat.shape
    assert data.shape[0] == k, (mat.shape, data.shape)
    out = np.zeros((m, data.shape[1]), dtype=np.uint8)
    for j in range(k):
        out ^= MUL_TABLE[mat[:, j][:, None], data[j][None, :]]
    return out


def invert_matrix(mat: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix via Gauss-Jordan elimination.

    The decode path builds a k×k submatrix of surviving rows and inverts it
    (reference: src/erasure-code/isa/ErasureCodeIsa.cc:274
    ``gf_invert_matrix``; jerasure ``jerasure_invert_matrix``).
    Raises ValueError if singular.
    """
    mat = np.array(mat, dtype=np.uint8)
    n = mat.shape[0]
    assert mat.shape == (n, n)
    aug = np.concatenate([mat, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if aug[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise ValueError("matrix is singular over GF(2^8)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv_p = INV_TABLE[aug[col, col]]
        aug[col] = MUL_TABLE[inv_p, aug[col]]
        for row in range(n):
            if row != col and aug[row, col] != 0:
                aug[row] ^= MUL_TABLE[aug[row, col], aug[col]]
    return aug[:, n:].copy()


# ---------------------------------------------------------------------------
# Generator-matrix constructions
# ---------------------------------------------------------------------------

def rs_vandermonde_matrix(k: int, m: int) -> np.ndarray:
    """Systematic Reed-Solomon coding matrix, jerasure ``reed_sol_van`` style.

    Semantics of jerasure's ``reed_sol_vandermonde_coding_matrix`` (reference
    call site: src/erasure-code/jerasure/ErasureCodeJerasure.h:82-120,
    technique ``reed_sol_van``): build the (k+m)×k Vandermonde matrix
    V[i,j] = i^j over GF(2^8), then apply elementary *column* operations to
    turn the top k×k block into the identity; the bottom m rows are the
    coding matrix. Any k rows of the result are invertible (each k×k
    submatrix of a Vandermonde on distinct points is nonsingular, and column
    ops preserve that), so this is MDS for k+m <= 256.

    Returns the m×k coding matrix (the systematic identity is implicit).
    """
    n = k + m
    if n > FIELD:
        raise ValueError(f"k+m={n} exceeds field size {FIELD}")
    vdm = np.zeros((n, k), dtype=np.uint8)
    for i in range(n):
        for j in range(k):
            vdm[i, j] = gf_pow(i, j)  # 0^0 == 1
    # Column-eliminate the top square block to identity.
    for i in range(k):
        if vdm[i, i] == 0:
            swap = next(j for j in range(i + 1, k) if vdm[i, j] != 0)
            vdm[:, [i, swap]] = vdm[:, [swap, i]]
        if vdm[i, i] != 1:
            vdm[:, i] = MUL_TABLE[INV_TABLE[vdm[i, i]], vdm[:, i]]
        for j in range(k):
            if j != i and vdm[i, j] != 0:
                vdm[:, j] ^= MUL_TABLE[vdm[i, j], vdm[:, i]]
    assert np.array_equal(vdm[:k], np.eye(k, dtype=np.uint8))
    return vdm[k:].copy()


def rs_matrix_isa(k: int, m: int) -> np.ndarray:
    """ISA-L ``gf_gen_rs_matrix`` coding rows (non-systematized Vandermonde).

    Coding row r has entries (2^r)^j for j in 0..k-1 — i.e. row 0 is all
    ones, row 1 is 1,2,4,8,..., row 2 is 1,4,16,... This is only guaranteed
    MDS inside the envelope k<=32, m<=4 (m==4 => k<=21), which the reference
    clamps at src/erasure-code/isa/ErasureCodeIsa.cc:330-360; callers must
    enforce the same envelope.
    """
    mat = np.zeros((m, k), dtype=np.uint8)
    gen = 1
    for i in range(m):
        p = 1
        for j in range(k):
            mat[i, j] = p
            p = int(MUL_TABLE[p, gen])
        gen = int(MUL_TABLE[gen, 2])
    return mat


def cauchy_matrix_isa(k: int, m: int) -> np.ndarray:
    """ISA-L ``gf_gen_cauchy1_matrix``: coding row i, col j = inv((i+k) ^ j).

    Cauchy matrices are MDS for any k+m <= 256 (used by the reference when
    the Vandermonde envelope is exceeded, ErasureCodeIsa.cc:344-358).
    """
    if k + m > FIELD:
        raise ValueError(f"k+m={k + m} exceeds field size {FIELD}")
    rows = np.arange(k, k + m, dtype=np.int32)[:, None]
    cols = np.arange(k, dtype=np.int32)[None, :]
    return INV_TABLE[(rows ^ cols).astype(np.uint8)]


def cauchy_original_matrix(k: int, m: int) -> np.ndarray:
    """jerasure ``cauchy_original_coding_matrix``: row i, col j = 1/(i ^ (m+j)).

    Technique ``cauchy_orig`` (reference:
    src/erasure-code/jerasure/ErasureCodeJerasure.h:135-155). Points i in
    0..m-1 and m+j in m..m+k-1 are disjoint, so all entries are defined.
    """
    if k + m > FIELD:
        raise ValueError(f"k+m={k + m} exceeds field size {FIELD}")
    rows = np.arange(m, dtype=np.int32)[:, None]
    cols = np.arange(m, m + k, dtype=np.int32)[None, :]
    return INV_TABLE[(rows ^ cols).astype(np.uint8)]


def systematic_generator(coding: np.ndarray) -> np.ndarray:
    """Stack identity over the m×k coding matrix -> full (k+m)×k generator."""
    m, k = coding.shape
    return np.concatenate([np.eye(k, dtype=np.uint8), coding], axis=0)


def decode_matrix(generator: np.ndarray, present_rows: list[int],
                  want_rows: list[int]) -> np.ndarray:
    """Build the decode matrix mapping k surviving chunks -> wanted chunks.

    ``generator`` is the full (k+m)×k systematic generator. ``present_rows``
    lists k surviving chunk indices (sorted); ``want_rows`` the chunk indices
    to reconstruct. Mirrors the reference decode: select the k surviving
    generator rows, invert, then re-multiply by the wanted rows
    (src/erasure-code/isa/ErasureCodeIsa.cc:150-310).
    """
    k = generator.shape[1]
    assert len(present_rows) == k, (present_rows, k)
    sub = generator[np.asarray(present_rows, dtype=np.int64)]
    inv = invert_matrix(sub)  # maps surviving chunks -> data chunks
    out_rows = []
    for r in want_rows:
        if r < k:
            out_rows.append(inv[r])
        else:
            # parity chunk: generator row r applied to recovered data
            out_rows.append(gf_matmul(generator[r][None, :], inv)[0])
    return np.stack(out_rows).astype(np.uint8)
