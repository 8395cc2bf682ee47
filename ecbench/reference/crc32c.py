"""Plain crc32c (Castagnoli, reflected polynomial 0x82F63B78) for the
benchmark's reference.

``register(rows)`` gives, for every row of a uint8 tensor, the crc
register reached from a zero register with no final inversion: the linear
part of crc32c, ``crc32c(M) ^ crc32c(zeros of len(M))`` in the usual
form, which is what an OSD's per-shard hash is combined from. It is the
byte-at-a-time table recurrence, unrolled by linearity:

1. each 512-byte block's register is the XOR of one table entry per byte
   position (``T_p[b]``: byte b at position p followed by zeros);
2. blocks are joined pairwise, the left one moved across the right one's
   length of zero bytes by a 4 x 256 table of that shift, until one
   register is left per row.

Rows are front-padded with zeros to a power of two of blocks, which
leaves the register unchanged. ``crc32c(data)`` is the standard checksum
(check value 0xE3069283 for b"123456789").
"""

from __future__ import annotations

import functools

import numpy as np
import torch

POLY_REFLECTED = 0x82F63B78
BLOCK = 512


@functools.lru_cache(maxsize=None)
def byte_table() -> np.ndarray:
    """[256] uint64: the register after one byte b fed to a zero register."""
    out = np.zeros(256, dtype=np.uint64)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ POLY_REFLECTED if c & 1 else c >> 1
        out[b] = c
    return out


def _zero_byte(c: np.ndarray) -> np.ndarray:
    """Registers c moved across one zero byte."""
    return byte_table()[(c & np.uint64(0xFF)).astype(np.int64)] ^ (c >> np.uint64(8))


@functools.lru_cache(maxsize=None)
def position_tables() -> np.ndarray:
    """[BLOCK, 256] int64: T[p, b] is the register of a block holding b at
    position p and zeros elsewhere."""
    tbl = np.zeros((BLOCK, 256), dtype=np.uint64)
    tbl[BLOCK - 1] = byte_table()
    for p in range(BLOCK - 2, -1, -1):
        tbl[p] = _zero_byte(tbl[p + 1])
    return tbl.astype(np.int64)


@functools.lru_cache(maxsize=None)
def shift_tables(nbytes: int) -> np.ndarray:
    """[4, 256] int64: row i, column b is the register (b << 8i) moved
    across ``nbytes`` zero bytes; a register's shift is the XOR of its
    four bytes' entries. Built by doubling from 512 bytes."""
    if nbytes == BLOCK:
        regs = (np.arange(256, dtype=np.uint64)[None, :]
                << (np.uint64(8) * np.arange(4, dtype=np.uint64)[:, None]))
        for _ in range(BLOCK):
            regs = _zero_byte(regs)
        return regs.astype(np.int64)
    if nbytes % 2 or nbytes < BLOCK:
        raise ValueError(f"shift of {nbytes} bytes is not built by doubling")
    half = shift_tables(nbytes // 2)
    base = (np.arange(256, dtype=np.int64)[None, :]
            << (8 * np.arange(4, dtype=np.int64)[:, None]))
    return _apply_np(half, _apply_np(half, base))


def _apply_np(tbl: np.ndarray, regs: np.ndarray) -> np.ndarray:
    out = np.zeros_like(regs)
    for i in range(4):
        out ^= tbl[i][(regs >> (8 * i)) & 0xFF]
    return out


def _apply(tbl: torch.Tensor, regs: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(regs)
    for i in range(4):
        out ^= tbl[i][(regs >> (8 * i)) & 0xFF]
    return out


def register(rows: torch.Tensor, block_rows: int = 1 << 14) -> torch.Tensor:
    """[n, L] uint8 -> [n] int64: each row's crc32c register from zero,
    without the final inversion (the crc's linear part)."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"rows must be [n, L] uint8, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    n, length = rows.shape
    dev = rows.device
    nblocks = 1
    while nblocks * BLOCK < length:
        nblocks *= 2
    pad = nblocks * BLOCK - length
    if pad:
        rows = torch.nn.functional.pad(rows, (pad, 0))
    tpos = torch.from_numpy(position_tables()).to(dev)
    col = torch.arange(BLOCK, device=dev) * 256
    flat_t = tpos.reshape(-1)
    blocks = rows.reshape(n * nblocks, BLOCK)
    regs = torch.empty(n * nblocks, dtype=torch.int64, device=dev)
    for r0 in range(0, n * nblocks, block_rows):
        part = flat_t[blocks[r0:r0 + block_rows].long() + col]
        width = BLOCK
        while width > 1:
            width //= 2
            part = part[:, :width] ^ part[:, width:2 * width]
        regs[r0:r0 + block_rows] = part[:, 0]
    regs = regs.reshape(n, nblocks)
    span = BLOCK
    while regs.shape[1] > 1:
        tbl = torch.from_numpy(shift_tables(span)).to(dev)
        regs = _apply(tbl, regs[:, 0::2]) ^ regs[:, 1::2]
        span *= 2
    return regs[:, 0]


def crc32c(data: bytes) -> int:
    """The standard crc32c of ``data`` (initial register and final XOR
    0xFFFFFFFF)."""
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8) \
        if data else torch.zeros(0, dtype=torch.uint8)
    lin = int(register(buf.reshape(1, -1))[0]) if data else 0
    init = np.array([0xFFFFFFFF], dtype=np.uint64)
    for _ in range(len(data)):
        init = _zero_byte(init)
    return (lin ^ int(init[0])) ^ 0xFFFFFFFF
