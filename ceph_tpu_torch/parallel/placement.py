"""PG placement hashing — the host part of ``ceph_tpu/parallel/placement.py``.

The reference maps a pgid to the stripe row of a device mesh that owns
its device work, with a CRUSH-stable hash of the pgid. The port has no
mesh yet (ROADMAP A.5), so only the hash is here: the EC backend and the
Objecter key their read-set and replica choices by it.
"""

from __future__ import annotations

import zlib


def stable_hash(key) -> int:
    """CRUSH-stable 32-bit hash of ``str(key)``: a pure function,
    identical across processes, restarts, and python hash seeds (the
    rjenkins role — crc32 here; the point is stability, not
    avalanche quality)."""
    return zlib.crc32(str(key).encode("utf-8")) & 0xFFFFFFFF
