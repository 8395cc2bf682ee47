"""ExtentCache — pin in-flight write content for overlapping RMW.

Role of src/osd/ExtentCache.h:37-45: the reference pins the extents an
in-flight EC overwrite touches so that a later overlapping
partial-stripe RMW can read them from memory instead of from shards
that may not have committed the earlier write yet.

Why this is correctness, not just pipelining, here: the primary fans a
write out asynchronously; until the first shard commits it, EVERY
shard still agrees on the previous version, so a subsequent RMW's
version-agreement check happily accepts the stale-but-consistent read.
Re-encoding the touched stripe window from that stale state would then
write pre-A bytes back over A's in-flight data (a lost update). The
cache overlays every in-flight entry newer than the version the shard
read agreed on, in version order, before the window is spliced and
re-encoded.

Entries are pinned before fan-out (under pg.lock, so version order is
submission order) and unpinned from the all-commit callback. A write
that loses shards still reaches all-commit on the survivors
(drop_down_shards); a write abandoned by the expiry sweep unpins via
InflightWrite.on_expire — so entries cannot leak (a leaked full/remove
entry would make covers() feed stale content to every later RMW).
"""

from __future__ import annotations

import threading

from ceph_tpu_torch.analysis.lock_witness import make_lock
from dataclasses import dataclass


@dataclass
class _Entry:
    version: int
    offset: int           # logical byte offset (0 for full/remove)
    data: bytes           # payload ("" for remove)
    new_size: int         # logical object size after this write
    full: bool            # write_full: replaces the whole object
    remove: bool = False


class ExtentSnapshot:
    """Immutable view of one object's in-flight entries. An RMW must
    take ONE snapshot and drive covers()/versions()/overlay() from it:
    querying the live cache at each step races the unpin that runs on
    the store-commit thread (an entry present for covers() but gone by
    overlay() would silently drop its bytes from the window)."""

    def __init__(self, entries: list[_Entry]) -> None:
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def versions(self) -> frozenset[int]:
        return frozenset(e.version for e in self._entries)

    def effective_size(self, base_size: int, base_version: int) -> int:
        size = base_size
        for e in self._entries:
            if e.version <= base_version:
                continue
            size = 0 if e.remove else (
                e.new_size if e.full else max(size, e.new_size))
        return size

    def covers(self, lo: int, hi: int) -> bool:
        ivals = []
        for e in self._entries:
            if e.remove or e.full:
                return True
            ivals.append((e.offset, e.offset + len(e.data)))
        ivals.sort()
        at = lo
        for s, t in ivals:
            if s > at:
                return False
            at = max(at, t)
            if at >= hi:
                return True
        return at >= hi

    def overlay(self, window: bytearray, win_off: int,
                base_version: int) -> int:
        applied = 0
        for e in self._entries:
            if e.version <= base_version:
                continue
            applied += 1
            if e.remove or e.full:
                window[:] = bytes(len(window))
            off, data = (0, e.data) if (e.full or e.remove) \
                else (e.offset, e.data)
            lo = max(off, win_off)
            hi = min(off + len(data), win_off + len(window))
            if lo < hi:
                window[lo - win_off:hi - win_off] = \
                    data[lo - off:hi - off]
        return applied


class ExtentCache:
    def __init__(self) -> None:
        self._lock = make_lock("extent_cache.state")
        self._by_oid: dict[str, list[_Entry]] = {}

    def snapshot(self, oid: str) -> ExtentSnapshot:
        with self._lock:
            return ExtentSnapshot(list(self._by_oid.get(oid, ())))

    def pin(self, oid: str, version: int, offset: int, data: bytes,
            new_size: int, full: bool, remove: bool = False) -> None:
        e = _Entry(version, offset, bytes(data), new_size, full, remove)
        with self._lock:
            entries = self._by_oid.setdefault(oid, [])
            entries.append(e)
            entries.sort(key=lambda x: x.version)

    def unpin(self, oid: str, version: int) -> None:
        with self._lock:
            entries = self._by_oid.get(oid)
            if not entries:
                return
            self._by_oid[oid] = [e for e in entries
                                 if e.version != version]
            if not self._by_oid[oid]:
                del self._by_oid[oid]

    def effective_size(self, oid: str, base_size: int,
                       base_version: int) -> int:
        """Object size after applying in-flight writes newer than
        ``base_version`` to a committed size of ``base_size``."""
        return self.snapshot(oid).effective_size(base_size,
                                                 base_version)

    def overlay(self, oid: str, window: bytearray, win_off: int,
                base_version: int) -> int:
        """Splice in-flight content newer than ``base_version`` into
        ``window`` (logical bytes [win_off, win_off+len)). Returns how
        many entries applied (for counters/tests). Racy callers must
        use snapshot() instead (see ExtentSnapshot)."""
        return self.snapshot(oid).overlay(window, win_off,
                                          base_version)

    def pinned(self, oid: str) -> int:
        with self._lock:
            return len(self._by_oid.get(oid, ()))

    def versions(self, oid: str) -> frozenset[int]:
        return self.snapshot(oid).versions()

    def covers(self, oid: str, lo: int, hi: int) -> bool:
        return self.snapshot(oid).covers(lo, hi)
