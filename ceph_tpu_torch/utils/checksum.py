"""Host crc32c — the port's oracle for the device crc path.

Port of ``crc32c_sw`` and ``crc32c`` from ``ceph_tpu/utils/checksum.py``
(the sctp_crc32 baseline role of the reference's src/common/crc32c*.cc).
The reference's ``crc32c`` takes its native library when built; the
port's runs row-parallel in numpy from 4 KiB (the OSD chain verifies
every shard it serves with it). Plus a numpy version vectorised ACROSS
buffers (:func:`crc32c_rows`): one numpy step per byte position for a
whole batch of equal-length buffers, which checks every segment of a
full-size flush in seconds where the per-byte Python loop would take
minutes.

Convention: standard CRC-32C — crc32c(b"123456789") == 0xE3069283. A
running crc continues by passing the previous value.
"""

from __future__ import annotations

import functools

import numpy as np

#: Castagnoli polynomial, reflected
POLY = 0x82F63B78


@functools.lru_cache(maxsize=1)
def table() -> np.ndarray:
    """The 256-entry byte-at-a-time crc32c table (uint32)."""
    tbl = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        tbl[i] = c
    return tbl


def _as_bytes(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8).ravel()
    return np.frombuffer(memoryview(data), dtype=np.uint8)


def _sw_register(buf: bytes, c: int) -> int:
    """The crc register after feeding ``buf`` from register ``c``."""
    tbl = _table_list()
    for b in buf:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c


@functools.lru_cache(maxsize=1)
def _table_list() -> list[int]:
    return [int(x) for x in table()]


def crc32c_sw(data, crc: int = 0) -> int:
    """Pure-python table crc32c of one buffer (one Python step per byte:
    keep buffers to a few KiB)."""
    return ~_sw_register(_as_bytes(data).tobytes(), ~crc & 0xFFFFFFFF) \
        & 0xFFFFFFFF


#: row length of the row-parallel path of :func:`crc32c`
_ROW_BYTES = 1024
#: buffers from this size take the row-parallel path
_ROWS_MIN_BYTES = 4096


@functools.lru_cache(maxsize=1)
def _position_tables() -> np.ndarray:
    """[_ROW_BYTES * 256] uint32: entry ``i * 256 + b`` is the register,
    from zero, after byte ``b`` at position ``i`` of a row and the row's
    remaining zero bytes — a row's linear part is the XOR of one entry
    a byte."""
    tbl = table()
    out = np.empty((_ROW_BYTES, 256), dtype=np.uint32)
    c = tbl.copy()                       # the row's last byte
    for i in range(_ROW_BYTES - 1, -1, -1):
        out[i] = c
        c = tbl[c & 0xFF] ^ (c >> 8)     # one more zero byte after it
    return out.ravel()


@functools.lru_cache(maxsize=1)
def _shift_tables() -> list[list[int]]:
    """Four 256-entry tables of the linear map "feed a row of zero
    bytes" on the 32-bit register, one for each register byte."""
    tbl = table()
    c = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for _ in range(_ROW_BYTES):
        c = tbl[c & 0xFF] ^ (c >> 8)
    out = []
    for k in range(4):
        t = np.zeros(256, dtype=np.uint32)
        for bit in range(8):
            t[np.arange(256) >> bit & 1 == 1] ^= c[8 * k + bit]
        out.append([int(x) for x in t])
    return out


def crc32c(data, crc: int = 0) -> int:
    """crc32c of one buffer (the reference's ``crc32c``, whose fast
    path is its native library). From 4 KiB the buffer is cut into
    1 KiB rows after its leading partial row, and the crc's linearity
    does the rest: each row's register from zero is the XOR of one
    position-table entry a byte (one gather and one reduction for all
    rows), and the running register moves across each row by table
    lookups (the zero-fed shift of the one before it, XOR the row's
    own). A handful of numpy calls a buffer, so a thread gives up the
    GIL a handful of times a buffer, not once a byte position."""
    buf = _as_bytes(data)
    n = len(buf)
    if n < _ROWS_MIN_BYTES:
        return crc32c_sw(buf, crc)
    head = n % _ROW_BYTES
    c = _sw_register(buf[:head].tobytes(), ~crc & 0xFFFFFFFF)
    rows = buf[head:].reshape(-1, _ROW_BYTES)
    idx = rows + np.arange(0, _ROW_BYTES * 256, 256, dtype=np.int32)
    lin = np.bitwise_xor.reduce(_position_tables()[idx], axis=1)
    t0, t1, t2, t3 = _shift_tables()
    for v in lin.tolist():
        c = t0[c & 0xFF] ^ t1[(c >> 8) & 0xFF] ^ t2[(c >> 16) & 0xFF] \
            ^ t3[c >> 24] ^ v
    return ~c & 0xFFFFFFFF


def crc32c_rows(rows: np.ndarray, crc: int = 0) -> np.ndarray:
    """crc32c of every row of ``rows`` [n, L] uint8 with seed ``crc``,
    as [n] uint32 — the same table recurrence as :func:`crc32c_sw`, run
    for all n rows at once."""
    rows = np.asarray(rows, dtype=np.uint8)
    n, ln = rows.shape
    tbl = table()
    cols = np.ascontiguousarray(rows.T)        # byte position major
    c = np.full(n, ~crc & 0xFFFFFFFF, dtype=np.uint32)
    for j in range(ln):
        c = tbl[(c ^ cols[j]) & 0xFF] ^ (c >> 8)
    return ~c
