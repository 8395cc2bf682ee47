"""ObjectCacher — client-side object/extent cache (src/osdc/
ObjectCacher.h role).

The reference's ObjectCacher sits under librbd/cephfs and keeps
recently-read object extents so repeated I/O does not hit the
cluster. This keeps the READ cache with write-through invalidation;
the coherence story is the caller's, exactly as in the reference:

- librbd enables the cache only while it owns the image (our rbd
  Image attaches one per open handle and drops everything on a
  header watch/notify);
- cephfs caches under its capability leases (services/cephfs.py)
  and does not use this layer;
- the librados cache tier (``client_cache``) keeps one per
  RadosClient coherent through per-object inval watches: the OSD
  holds a mutating op's reply until every cached copy acknowledged
  its invalidation (client/rados.py).

Storage is a per-object EXTENT MAP, not an exact-request map: a put
that overlaps an older cached extent TRIMS the stale overlap away
(the old exact-key cache left the older entry's bytes stale and
double-counted the overlap against ``max_bytes``). ``stats()`` byte
accounting is exact: the sum of live extent lengths, every put and
eviction included. Whole objects are LRU-evicted until the bound
holds.

Fill/invalidate fencing: callers snapshot ``generation()`` before
fetching and pass it to ``put`` — a fill that STARTED before an
invalidation of that object must not land after it. The fence is
per-object (an invalidation of a different object does not drop the
fill), with a global floor for ``invalidate_all``.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict

#: live cachers, for process-wide hit-rate sensing (mgr/tuner.py
#: samples this the way it samples the dataplane registries)
_ALL_CACHERS: "weakref.WeakSet[ObjectCacher]" = weakref.WeakSet()

#: per-object invalidation-generation entries kept before the oldest
#: are folded into the global floor (bounded memory; folding is
#: conservative — it can only drop MORE in-flight fills, never fewer)
_GEN_CAP = 4096


class ObjectCacher:
    def __init__(self, max_bytes: int = 32 << 20) -> None:
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        #: oid -> sorted non-overlapping [(start, bytes), ...]; LRU
        #: order is the dict order (whole-object eviction granularity)
        self._objects: OrderedDict[str, list] = OrderedDict()
        #: oid -> full object size, known only after a whole-object
        #: read filled [0, size) — lets length=0 reads hit
        self._sizes: dict[str, int] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        #: global invalidation counter (generation() snapshots it)
        self._gen = 0
        #: _gen at the last invalidate_all: fills older than this are
        #: dropped regardless of object
        self._all_floor = 0
        #: oid -> _gen at that object's last invalidation
        self._oid_gens: dict[str, int] = {}
        _ALL_CACHERS.add(self)

    # -- generations ---------------------------------------------------
    def generation(self) -> int:
        with self._lock:
            return self._gen

    def _fill_fenced_locked(self, oid: str, gen) -> bool:
        if gen is None:
            return False
        return gen < self._all_floor or gen < self._oid_gens.get(oid, 0)

    def _bump_gen_locked(self, oid: str) -> None:
        self._gen += 1
        self._oid_gens[oid] = self._gen
        if len(self._oid_gens) > _GEN_CAP:
            cut = sorted(self._oid_gens.values())[_GEN_CAP // 2]
            self._oid_gens = {o: g for o, g in self._oid_gens.items()
                              if g > cut}
            self._all_floor = max(self._all_floor, cut)

    # -- read side -----------------------------------------------------
    def get(self, oid: str, off: int, length: int) -> bytes | None:
        """Bytes for [off, off+length) iff fully covered by cached
        extents; ``length == 0`` means the whole object (hit only if
        a whole-object read established its size). The hit path is a
        dict probe + extent walk — no wire, no syscalls."""
        with self._lock:
            exts = self._objects.get(oid)
            if exts is None:
                self.misses += 1
                return None
            if length == 0:
                size = self._sizes.get(oid)
                if size is None:
                    self.misses += 1
                    return None
                if size == 0:
                    self._objects.move_to_end(oid)
                    self.hits += 1
                    return b""
                off, length = 0, size
            data = self._slice(exts, off, length)
            if data is None:
                self.misses += 1
                return None
            self._objects.move_to_end(oid)
            self.hits += 1
            return data

    @staticmethod
    def _slice(exts: list, off: int, length: int) -> bytes | None:
        end = off + length
        out = bytearray()
        pos = off
        for s, buf in exts:
            e = s + len(buf)
            if e <= pos:
                continue
            if s > pos:
                return None          # coverage gap
            out += buf[pos - s:min(e, end) - s]
            pos = min(e, end)
            if pos >= end:
                return bytes(out)
        return None

    # -- fill side -----------------------------------------------------
    def put(self, oid: str, off: int, length: int, data: bytes,
            gen: int | None = None, whole: bool = False) -> None:
        """Cache ``data`` at [off, off+len(data)). ``length`` is the
        requested length (kept for the historical signature; a short
        read stores only what arrived). ``whole`` marks a full-object
        read: records the size so length=0 gets can hit. ``gen``
        fences the fill/invalidate race (see module docstring)."""
        with self._lock:
            if self._fill_fenced_locked(oid, gen):
                return               # invalidated while fetching
            exts = self._objects.pop(oid, None) or []
            old_bytes = sum(len(buf) for _, buf in exts)
            exts, new_bytes = self._splice(exts, off, bytes(data))
            self._objects[oid] = exts
            self._bytes += new_bytes - old_bytes
            if whole:
                self._sizes[oid] = len(data)
            self._evict_locked()

    @staticmethod
    def _splice(exts: list, a: int, data: bytes):
        """Overlay [a, a+len(data)) onto the extent list: stale
        overlap is TRIMMED (never left beside the new bytes), adjacent
        runs merge. Returns (new extents, their total bytes)."""
        b = a + len(data)
        out = []
        for s, buf in exts:
            e = s + len(buf)
            if e <= a or s >= b:
                out.append((s, buf))
                continue
            if s < a:
                out.append((s, buf[:a - s]))
            if e > b:
                out.append((b, buf[b - s:]))
        out.append((a, data))
        out.sort(key=lambda t: t[0])
        merged = [out[0]]
        for s, buf in out[1:]:
            ps, pbuf = merged[-1]
            if ps + len(pbuf) == s:
                merged[-1] = (ps, pbuf + buf)
            else:
                merged.append((s, buf))
        return merged, sum(len(buf) for _, buf in merged)

    def _evict_locked(self) -> None:
        while self._bytes > self.max_bytes and self._objects:
            oid, exts = self._objects.popitem(last=False)
            self._bytes -= sum(len(buf) for _, buf in exts)
            self._sizes.pop(oid, None)

    # -- invalidation --------------------------------------------------
    def invalidate_object(self, oid: str) -> None:
        """Drop every cached extent of one object (write-through)."""
        with self._lock:
            self._bump_gen_locked(oid)
            exts = self._objects.pop(oid, None)
            if exts is not None:
                self._bytes -= sum(len(buf) for _, buf in exts)
            self._sizes.pop(oid, None)

    def invalidate_all(self) -> None:
        with self._lock:
            self._gen += 1
            self._all_floor = self._gen
            self._oid_gens.clear()
            self._objects.clear()
            self._sizes.clear()
            self._bytes = 0

    # -- sizing / stats ------------------------------------------------
    def resize(self, max_bytes: int) -> None:
        """Live capacity change (the tuner steps client_cache_bytes
        through a config observer that lands here)."""
        with self._lock:
            self.max_bytes = int(max_bytes)
            self._evict_locked()

    def stats(self) -> dict:
        with self._lock:
            return {"bytes": self._bytes,
                    "entries": sum(len(e) for e in
                                   self._objects.values()),
                    "objects": len(self._objects),
                    "hits": self.hits, "misses": self.misses,
                    "max_bytes": self.max_bytes}


def aggregate_stats() -> dict:
    """Process-wide cache picture across every live cacher — the
    tuner's cache_hit_rate sensor (mgr/tuner.py LiveSensors)."""
    hits = misses = nbytes = cap = 0
    for cacher in list(_ALL_CACHERS):
        s = cacher.stats()
        hits += s["hits"]
        misses += s["misses"]
        nbytes += s["bytes"]
        cap += s["max_bytes"]
    lookups = hits + misses
    return {"hits": hits, "misses": misses, "bytes": nbytes,
            "max_bytes": cap,
            "hit_rate": (hits / lookups) if lookups else None}
