"""Tiny bounded LRU for codec table/plan caches.

The reference caches ISA decode tables per erasure signature in exactly
this shape (ErasureCodeIsaTableCache, src/erasure-code/isa/
ErasureCodeIsa.cc:226-303, LRU sizing notes isa/README:57-62); the matrix
codecs, SHEC plan search, and the Clay linearized transforms all share it
here instead of each hand-rolling the pattern.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, TypeVar

V = TypeVar("V")

#: id -> weak reference of every live cache, for :func:`cache_stats`
#: (a dict is unhashable, so no WeakSet)
_caches: dict[int, weakref.ref] = {}


class BoundedLRU(OrderedDict):
    """OrderedDict with a size bound and a get-or-build accessor.

    ``maxsize`` is a plain attribute so callers (and tests) can retune
    the bound after construction.

    Thread-safe for the put/get_or_build accessors: the decode-table
    caches are shared across the OSD's op-shard and reader threads
    (the reference locks its table cache the same way —
    ErasureCodeIsaTableCache, and tests the class of bug with
    TestErasureCodeShec_thread.cc). Without the lock, a get's
    move_to_end can race another thread's eviction of the same key
    into a KeyError, and two concurrent builds can double-evict.
    Plain dict operations remain unlocked — callers using them (the
    mon's dedup) hold their own locks.

    ``get_or_build`` counts ``hits`` and ``misses``, and both bounded
    inserts count ``evictions``; :func:`cache_stats` sums them by the
    cache's ``name`` over every live cache.
    """

    def __init__(self, maxsize: int, name: str = "unnamed") -> None:
        super().__init__()
        self.maxsize = maxsize
        self.name = name
        self.hits = self.misses = self.evictions = 0
        self._lock = threading.RLock()
        key = id(self)
        _caches[key] = weakref.ref(self, lambda _r: _caches.pop(key, None))

    def _evict_locked(self) -> None:
        if len(self) > self.maxsize:
            self.popitem(last=False)
            self.evictions += 1

    def put(self, key, value) -> None:
        """Bounded insert (plain ``self[key] =`` does NOT evict)."""
        with self._lock:
            self[key] = value
            self.move_to_end(key)
            self._evict_locked()

    def get_or_build(self, key, build: Callable[[], V]) -> V:
        with self._lock:
            hit = self.get(key)
            if hit is None:
                # build under the lock: deterministic table builds are
                # cheap, and racing builds would double-insert/evict
                self.misses += 1
                hit = self[key] = build()
                self._evict_locked()
            else:
                self.hits += 1
                self.move_to_end(key)
            return hit


def cache_stats() -> dict[str, dict]:
    """{cache name: {caches, size, hits, misses, evictions}} summed over
    the live caches of each name (the ``device perf dump`` table)."""
    out: dict[str, dict] = {}
    for ref in list(_caches.values()):
        cache = ref()
        if cache is None:
            continue
        with cache._lock:
            row = out.setdefault(cache.name, {
                "caches": 0, "size": 0, "hits": 0, "misses": 0,
                "evictions": 0})
            row["caches"] += 1
            row["size"] += len(cache)
            row["hits"] += cache.hits
            row["misses"] += cache.misses
            row["evictions"] += cache.evictions
    return dict(sorted(out.items()))
