"""The benchmark's frozen yardstick: the bytes each device program must
move, counted from its shapes, and the card's published memory rate.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again. The counts follow the shapes the port's
cost model states for B1, B2 and the fused flush; they are frozen here so
that no change to the program can move them. The peak is NVIDIA's
published HBM3 rate of one H100 SXM, with no override.
"""

from __future__ import annotations

#: bytes/s of device memory on one H100 SXM (NVIDIA data sheet, 700 W)
PEAK_HBM_BYTES_PER_S = 3.35e12

#: bytes of a crc32c stage-1 row (kernel B2 reads rows, writes an int64)
CRC_ROW_BYTES = 512


def gf_matvec(k: int, m: int, n: int) -> int:
    """Kernel B1: parity[m, n] = mat[m, k] (x) data[k, n]."""
    return (k + m) * n


def crc_rows(nbytes: int) -> int:
    """Kernel B2: an int64 linear crc of each 512-byte row of ``nbytes``."""
    return nbytes + nbytes // CRC_ROW_BYTES * 8


def fused_step(k: int, m: int, n: int, nops: int) -> int:
    """The fused flush's device step: the data in, the parity and an
    int64 crc of every op's k + m segments out."""
    return k * n + m * n + nops * (k + m) * 8


def clay_encode(k: int, m: int, ssc: int, lanes: int) -> int:
    """Kernel B3: [k, ssc, L] data chunks in, [m, ssc, L] parity out."""
    return (k + m) * ssc * lanes


def clay_repair(d: int, repair_subchunks: int, ssc: int, lanes: int) -> int:
    """The repair product: d helpers' sub-chunks in, one chunk out."""
    return (d * repair_subchunks + ssc) * lanes


def bound_s(nbytes: int) -> float:
    """The least time the card can take to move ``nbytes``."""
    return nbytes / PEAK_HBM_BYTES_PER_S
