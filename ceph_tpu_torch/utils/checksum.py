"""Host crc32c — the port's oracle for the device crc path.

Port of ``crc32c_sw`` from ``ceph_tpu/utils/checksum.py`` (the
sctp_crc32 baseline role of the reference's src/common/crc32c*.cc), plus a
numpy version vectorised ACROSS buffers: one numpy step per byte position
for a whole batch of equal-length buffers, which checks every segment of a
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


def crc32c(data, crc: int = 0) -> int:
    """Pure-python table crc32c of one buffer (one Python step per byte:
    keep buffers to a few KiB)."""
    tbl = [int(x) for x in table()]
    c = ~crc & 0xFFFFFFFF
    for b in _as_bytes(data).tobytes():
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return ~c & 0xFFFFFFFF


def crc32c_rows(rows: np.ndarray, crc: int = 0) -> np.ndarray:
    """crc32c of every row of ``rows`` [n, L] uint8 with seed ``crc``,
    as [n] uint32 — the same table recurrence as :func:`crc32c`, run for
    all n rows at once."""
    rows = np.asarray(rows, dtype=np.uint8)
    n, ln = rows.shape
    tbl = table()
    cols = np.ascontiguousarray(rows.T)        # byte position major
    c = np.full(n, ~crc & 0xFFFFFFFF, dtype=np.uint32)
    for j in range(ln):
        c = tbl[(c ^ cols[j]) & 0xFF] ^ (c >> 8)
    return ~c
