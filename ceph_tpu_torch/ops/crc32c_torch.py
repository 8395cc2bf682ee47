"""crc32c on the device as linear algebra over GF(2) — the torch side of B2.

Port of ``ceph_tpu/ops/crc32c_device.py``. The crc32c state update is
affine over GF(2) in (state, data), so with

    L(M) := crc32c(M, 0) XOR crc32c(0^len, 0)        (the linear part)

we have for any seed s:  crc32c(M, s) = L(M) XOR crc32c(0^len, s), and L is
linear in the bits of M and invariant under FRONT zero-padding. A batch of
crcs then becomes:

  1. stage 1 (kernel B2): each 512-byte row's L-contribution;
  2. stage 2 (here, torch): rows combine through per-row byte-shift
     matrices, ``rowbits[R*32] @ P[R*32, 32] mod 2``;
  3. the seed correction crc32c(0^len, s) on the host (:func:`zeros_crc`).

This module holds the host affine machinery (copied from
crc32c_device.py:48-130), the PLAIN version of stage 1
(:func:`crc_rows`: ``bits[rows, 4096] @ B[4096, 32] mod 2``, the TPU
kernel's own formulation), the stage-2 combine, and
:func:`crc_linear_device`, which sends stage 1 through the B2 wrapper
(ops/crc32c_cuda.py): the CUDA kernel for a CUDA tensor, this plain
version for a CPU tensor.

Row crcs are held as int64 in [0, 2^32): torch has almost no uint32 ops.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ceph_tpu_torch.utils import checksum

#: bytes per stage-1 row
ROW_BYTES = 512

#: rows per plain stage-1 matmul: bounds the 32x float32 bit expansion
_PLAIN_ROWS = 1 << 14


# -- host-side GF(2)/affine machinery ---------------------------------

def _one_zero_affine() -> tuple[np.ndarray, int]:
    """The affine map of processing ONE zero byte: s -> A·s ^ c."""
    c0 = checksum.crc32c(b"\x00", 0)
    cols = np.zeros(32, dtype=np.uint64)
    for i in range(32):
        cols[i] = checksum.crc32c(b"\x00", 1 << i) ^ c0
    return cols, c0


def _apply(cols: np.ndarray, s: int) -> int:
    out = 0
    v = s
    i = 0
    while v:
        if v & 1:
            out ^= int(cols[i])
        v >>= 1
        i += 1
    return out


def _compose(a2: np.ndarray, c2: int, a1: np.ndarray, c1: int):
    """(A2,c2) after (A1,c1): s -> A2(A1 s ^ c1) ^ c2."""
    cols = np.array([_apply(a2, int(x)) for x in a1], dtype=np.uint64)
    return cols, _apply(a2, c1) ^ c2


@functools.lru_cache(maxsize=64)
def _zero_affine_pow(n: int) -> tuple[tuple, int]:
    """Affine map of n zero bytes, by repeated squaring."""
    a, c = _one_zero_affine()
    ra = np.array([1 << i for i in range(32)], dtype=np.uint64)
    rc = 0
    while n:
        if n & 1:
            ra, rc = _compose(a, c, ra, rc)
        a, c = _compose(a, c, a, c)
        n >>= 1
    return tuple(int(x) for x in ra), rc


def zeros_crc(n: int, seed: int) -> int:
    """crc32c(b"\\x00"*n, seed) in O(32^2 log n) — the seed-correction
    term of the affine identity (and the crc32_combine shift)."""
    ra, rc = _zero_affine_pow(n)
    return _apply(np.array(ra, dtype=np.uint64), seed) ^ rc


@functools.lru_cache(maxsize=8)
def _B_matrix(c_bytes: int) -> np.ndarray:
    """[C*8, 32] int8: row (c*8 + b) = bits of L(byte(1<<b) at column
    c of a C-byte row) — i.e. shifted by (C-1-c) bytes."""
    a, _c0 = _one_zero_affine()
    out = np.zeros((c_bytes * 8, 32), dtype=np.int8)
    for bit in range(8):
        v = checksum.crc32c(bytes([1 << bit]), 0) ^ \
            checksum.crc32c(b"\x00", 0)          # L of the single byte
        for dist in range(c_bytes):
            col = c_bytes - 1 - dist
            out[col * 8 + bit] = [(v >> j) & 1 for j in range(32)]
            v = _apply(a, v)                      # one more zero byte
    return out


@functools.lru_cache(maxsize=32)
def _P_matrix(r_rows: int, c_bytes: int) -> np.ndarray:
    """[R*32, 32] int8: row (r*32 + i) = bits of (basis-bit i of row
    r's crc) shifted by (R-1-r)*C bytes."""
    ra, _rc = _zero_affine_pow(c_bytes)
    s_cols = np.array(ra, dtype=np.uint64)        # linear shift-by-C
    out = np.zeros((r_rows * 32, 32), dtype=np.int8)
    cur = np.array([1 << i for i in range(32)], dtype=np.uint64)  # I
    for r in range(r_rows - 1, -1, -1):
        for i in range(32):
            v = int(cur[i])
            out[r * 32 + i] = [(v >> j) & 1 for j in range(32)]
        if r:
            cur = np.array([_apply(s_cols, int(x)) for x in cur],
                           dtype=np.uint64)
    return out


# -- device-side: float32 0/1 matrices, cached per device -------------

_dev_lock = threading.Lock()
_dev_mats: dict[tuple, torch.Tensor] = {}


def _device_matrix(kind: str, r_rows: int, device) -> torch.Tensor:
    key = (kind, r_rows, str(device))
    with _dev_lock:
        t = _dev_mats.get(key)
        if t is None:
            if len(_dev_mats) > 64:
                _dev_mats.clear()
            host = _B_matrix(ROW_BYTES) if kind == "B" \
                else _P_matrix(r_rows, ROW_BYTES)
            t = _dev_mats[key] = torch.from_numpy(
                host.astype(np.float32)).to(device)
    return t


def _pack32(bits: torch.Tensor) -> torch.Tensor:
    """[..., 32] float 0/1 -> [...] int64 word, bit j = entry j."""
    w = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, device=bits.device)
    return (bits.to(torch.int64) * w).sum(dim=-1)


def crc_rows(x: torch.Tensor) -> torch.Tensor:
    """PLAIN stage 1: [rows, 512] uint8 -> [rows] int64 linear crc of each
    row, as ``bits[rows, 4096] @ B[4096, 32] mod 2`` in float32 (exact:
    0/1 entries, sums <= 4096 < 2^24)."""
    if x.dtype != torch.uint8 or x.dim() != 2 or x.shape[1] != ROW_BYTES:
        raise ValueError(f"x must be [rows, {ROW_BYTES}] uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b_mat = _device_matrix("B", 0, x.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for r0 in range(0, x.shape[0], _PLAIN_ROWS):
        blk = x[r0:r0 + _PLAIN_ROWS]
        # column (c*8 + b) = bit b of byte c, matching _B_matrix rows
        bits = ((blk[:, :, None] >> shifts) & 1).reshape(blk.shape[0], -1)
        acc = bits.to(torch.float32) @ b_mat
        out[r0:r0 + _PLAIN_ROWS] = _pack32(torch.remainder(acc, 2))
    return out


def combine_rows(rowc: torch.Tensor) -> torch.Tensor:
    """Stage 2: [n, r] int64 row crcs -> [n] int64 linear crc of each
    buffer, ``rowbits[n, r*32] @ P[r*32, 32] mod 2`` in float32 (exact
    while r*32 < 2^24)."""
    n, r = rowc.shape
    if r * 32 >= 1 << 24:
        raise ValueError(f"{r} rows per buffer exceed the exact float32 "
                         "stage-2 combine")
    p_mat = _device_matrix("P", r, rowc.device)
    shifts = torch.arange(32, device=rowc.device)
    rowbits = ((rowc[:, :, None] >> shifts) & 1).reshape(n, r * 32)
    acc = rowbits.to(torch.float32) @ p_mat
    return _pack32(torch.remainder(acc, 2))


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def crc_linear_device(x: torch.Tensor) -> torch.Tensor:
    """Linear crc parts of a [n, L] uint8 batch -> [n] int64 on x's device.

    Combine with ``zeros_crc(L, seed)`` (or :func:`crc32c_from_linear`)
    for a full crc32c. Front-pads to a multiple of ROW_BYTES — free, by
    linearity. Stage 1 goes through kernel B2 for a CUDA tensor.
    """
    from ceph_tpu_torch.ops import crc32c_cuda
    rowc = crc32c_cuda.crc_rows(row_view(x))
    r = _round_up(max(x.shape[1], 1), ROW_BYTES) // ROW_BYTES
    return combine_rows(rowc.reshape(x.shape[0], r))


def row_view(x: torch.Tensor) -> torch.Tensor:
    """[n, L] uint8 -> [n * r, ROW_BYTES]: each buffer front-padded to r
    whole rows (free, by linearity), the rows of one buffer adjacent."""
    if x.dtype != torch.uint8 or x.dim() != 2:
        raise ValueError(f"x must be [n, L] uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, ln = x.shape
    padded = _round_up(max(ln, 1), ROW_BYTES)
    if padded != ln:
        x = F.pad(x, (padded - ln, 0))
    return x.contiguous().reshape(n * (padded // ROW_BYTES), ROW_BYTES)


def crc32c_from_linear(lin: int, length: int, seed: int = 0) -> int:
    """Recover a full crc32c from a device-computed LINEAR part (the
    affine identity): ``crc32c(M, seed) = L(M) ^ crc32c(0^len, seed)``.
    ``length`` is the TRUE buffer length — front zero-padding applied on
    device does not change L."""
    return (int(lin) & 0xFFFFFFFF) ^ zeros_crc(length, seed)
