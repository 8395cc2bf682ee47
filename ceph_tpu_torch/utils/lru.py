"""Tiny bounded LRU for codec table/plan caches.

The reference caches ISA decode tables per erasure signature in exactly
this shape (ErasureCodeIsaTableCache, src/erasure-code/isa/
ErasureCodeIsa.cc:226-303, LRU sizing notes isa/README:57-62); the matrix
codecs, SHEC plan search, and the Clay linearized transforms all share it
here instead of each hand-rolling the pattern.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, TypeVar

V = TypeVar("V")


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
    """

    def __init__(self, maxsize: int) -> None:
        super().__init__()
        self.maxsize = maxsize
        self._lock = threading.RLock()

    def put(self, key, value) -> None:
        """Bounded insert (plain ``self[key] =`` does NOT evict)."""
        with self._lock:
            self[key] = value
            self.move_to_end(key)
            if len(self) > self.maxsize:
                self.popitem(last=False)

    def get_or_build(self, key, build: Callable[[], V]) -> V:
        with self._lock:
            hit = self.get(key)
            if hit is None:
                # build under the lock: deterministic table builds are
                # cheap, and racing builds would double-insert/evict
                hit = self[key] = build()
                if len(self) > self.maxsize:
                    self.popitem(last=False)
            else:
                self.move_to_end(key)
            return hit
