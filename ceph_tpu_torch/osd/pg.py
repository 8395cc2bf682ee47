"""PG — placement-group state, log, and peering-lite.

Reference: src/osd/PG.{h,cc} + PrimaryLogPG. The reference's PG is a
log-based replication machine with a boost::statechart peering engine
(PG.h:1831+). Here a PG holds:

  - identity ``(pool, ps)`` and the acting set at the current epoch;
  - a bounded, persisted op log (PGLog role): every write/remove is a
    numbered entry, stored in the pgmeta object's omap atomically with
    the data mutation, so any shard can report "how far it got"
    (``last_version``) and the primary can replay just the missed tail
    (log-based catch-up) or fall back to a full listing diff (backfill)
    when the divergence exceeds the log (the reference's
    log-vs-backfill split, doc/dev/osd_internals/pg.rst);
  - a small activation state machine: CREATED -> PEERING -> ACTIVE
    (degraded recovery runs behind ACTIVE, as async recovery does in
    the reference).

Collections: an EC PG stores shard s in collection ``pg_{pool}.{ps}s{s}``
(one per acting-set position, like the reference's ghobject shard_id);
a replicated PG uses ``pg_{pool}.{ps}`` on every replica.
"""

from __future__ import annotations

import threading

from ceph_tpu_torch.utils.noop_hooks import make_rlock
from dataclasses import dataclass

from ceph_tpu_torch.store.object_store import (
    NoSuchCollection,
    NoSuchObject,
    ObjectStore,
    StoreError,
    Transaction,
)
from ceph_tpu_torch.utils.encoding import Decoder, Encoder

#: sentinel shard id for replicated PGs (shard_id_t::NO_SHARD role)
NO_SHARD = 255

#: pgmeta pseudo-object holding the log + info omap (the reference's
#: pgmeta ghobject)
PGMETA = "_pgmeta"

LOG_WRITE = 1
LOG_REMOVE = 2

#: bounded log length (osd_min_pg_log_entries/osd_max_pg_log_entries role)
LOG_MAX = 1000


def pg_cid(pool: int, ps: int, shard: int) -> str:
    """Collection id for one PG shard (ghobject shard naming)."""
    if shard == NO_SHARD:
        return f"pg_{pool}.{ps}"
    return f"pg_{pool}.{ps}s{shard}"


@dataclass
class LogEntry:
    version: int
    op: int                   # LOG_WRITE | LOG_REMOVE
    oid: str

    def encode(self, e: Encoder) -> None:
        e.u64(self.version); e.u8(self.op); e.str(self.oid)

    @classmethod
    def decode(cls, d: Decoder) -> "LogEntry":
        return cls(d.u64(), d.u8(), d.str())


class PGLog:
    """Bounded persisted op log + last_version, kept in pgmeta omap.

    ``txn_append`` stages the log entry into the SAME transaction as the
    data mutation, so log and data commit atomically (the reference
    writes log entries and data in one ObjectStore transaction).
    """

    def __init__(self) -> None:
        self.entries: dict[int, LogEntry] = {}
        self.last_version = 0
        self.tail = 0             # lowest version still in the log

    # -- persistence ---------------------------------------------------
    @staticmethod
    def _info_bytes(last_version: int, tail: int) -> bytes:
        e = Encoder(); e.u64(last_version); e.u64(tail)
        return e.getvalue()

    def stage(self, entry: LogEntry) -> tuple[dict[str, bytes], list[str]]:
        """Record an entry in memory; return (omap kv, omap keys to drop)
        to be applied to EVERY shard's pgmeta in that shard's txn (an EC
        PG keeps one pgmeta per shard collection, all with the same log)."""
        self.entries[entry.version] = entry
        self.last_version = max(self.last_version, entry.version)
        kv = {}
        ee = Encoder(); entry.encode(ee)
        kv[f"log/{entry.version:016d}"] = ee.getvalue()
        drop = []
        while len(self.entries) > LOG_MAX:
            v = min(self.entries)
            del self.entries[v]
            drop.append(f"log/{v:016d}")
        self.tail = min(self.entries) if self.entries else entry.version
        kv["info"] = self._info_bytes(self.last_version, self.tail)
        return kv, drop

    @staticmethod
    def apply_to_txn(txn: Transaction, cid: str, kv: dict[str, bytes],
                     drop: list[str]) -> None:
        txn.touch(cid, PGMETA)
        txn.omap_set(cid, PGMETA, kv)
        if drop:
            txn.omap_rm(cid, PGMETA, drop)

    def txn_append(self, txn: Transaction, cid: str,
                   entry: LogEntry) -> None:
        kv, drop = self.stage(entry)
        self.apply_to_txn(txn, cid, kv, drop)

    @classmethod
    def load(cls, store: ObjectStore, cid: str) -> "PGLog":
        log = cls()
        try:
            omap = store.omap_get(cid, PGMETA)
        except StoreError:
            return log
        info = omap.get("info")
        if info:
            d = Decoder(info)
            log.last_version = d.u64()
            log.tail = d.u64()
        for key, raw in omap.items():
            if key.startswith("log/"):
                ent = LogEntry.decode(Decoder(raw))
                log.entries[ent.version] = ent
        return log

    def covers(self, from_version: int) -> bool:
        """Can we replay (from_version, last_version] from the log?"""
        if from_version >= self.last_version:
            return True
        return not self.entries or self.tail <= from_version + 1

    def entries_after(self, from_version: int) -> list[LogEntry]:
        return [self.entries[v] for v in sorted(self.entries)
                if v > from_version]


class PG:
    """Primary-side PG instance (PrimaryLogPG role). Replica-side state
    is just collections + pgmeta; replicas don't instantiate PG."""

    CREATED = "created"
    PEERING = "peering"
    ACTIVE = "active"

    def __init__(self, pool: int, ps: int) -> None:
        self.pool = pool
        self.ps = ps
        self.lock = make_rlock("pg.lock")
        self.state = self.CREATED
        self.acting: list[int] = []
        self.epoch = 0
        self.log = PGLog()
        # ops parked until ACTIVE (waiting_for_active role)
        self.waiting_for_active: list = []
        # shards known to be missing objects (peer_missing role):
        # position -> {oid: version_needed}
        self.peer_missing: dict[int, dict[str, int]] = {}
        self.recovery_in_flight = False
        # oid -> consecutive recovery rounds it was unreconstructible
        # (rollback hysteresis: one failed round may just be a write
        # mid-commit; two means the write is dead)
        self.rollback_pending: dict[str, int] = {}
        # in-flight write content for overlapping RMW (ExtentCache role)
        from ceph_tpu_torch.osd.extent_cache import ExtentCache
        self.extent_cache = ExtentCache()
        # cache-tier state (osd/tiering.py): ops parked behind a
        # promote, and recent promote outcomes (suppress re-promote)
        self.tier_parked: dict[str, list] = {}
        self.tier_recent: dict[str, float] = {}
        # hit-set windows (src/osd/HitSet.h:33 role, in-memory
        # reduction): the CURRENT window's touched oids, its start
        # stamp, and up to pool.hit_set_count archived windows —
        # promotion recency is judged against these
        self.hit_set_live: set[str] = set()
        self.hit_set_start: float = 0.0
        self.hit_set_archive: list[set[str]] = []
        self.backend = None       # set by the OSD when instantiated
        # version allocation cursor: versions are handed out when an op
        # is ACCEPTED (under pg.lock), not when its log entry stages.
        # On the device path staging is deferred to the engine
        # continuation, so ``log.last_version + 1`` at op time would
        # hand the SAME version to concurrent ops (and to the snap-COW
        # clone + snapset + client-op triple) — colliding PGLog omap
        # keys silently overwrite each other and replica replay loses
        # ops. The cursor never runs behind last_version (peering may
        # raise last_version past it).
        self._ver_cursor = 0

    def alloc_version(self) -> int:
        """Next unique object/log version (caller holds pg.lock)."""
        self._ver_cursor = max(self._ver_cursor,
                               self.log.last_version) + 1
        return self._ver_cursor

    def missing_dirty(self) -> bool:
        """Any shard still missing objects? Safe to call WITHOUT the pg
        lock (heartbeat/harness peek): a concurrent mutation mid-scan
        just means the answer is already stale — report dirty and let
        the locked consumer re-check."""
        try:
            return any(m for m in self.peer_missing.values())
        except RuntimeError:      # dict changed size during iteration
            return True

    @property
    def pgid(self) -> tuple[int, int]:
        return (self.pool, self.ps)

    def __repr__(self) -> str:
        return (f"PG({self.pool}.{self.ps} {self.state} "
                f"acting={self.acting} v={self.log.last_version})")


def read_shard_info(store: ObjectStore, cid: str,
                    log: "PGLog | None" = None
                    ) -> tuple[int, dict[str, int]]:
    """Replica-side answer to MPGQuery: (last_version, {oid: version}).

    Version of each object rides its "v" attr (written in the same txn
    as the data, so it is never stale). Pass an already-loaded ``log``
    to reuse its last_version instead of re-reading the pgmeta omap.
    """
    if log is not None:
        last_version = log.last_version
    else:
        try:
            omap = store.omap_get(cid, PGMETA)
        except StoreError:
            return 0, {}
        last_version = 0
        info = omap.get("info")
        if info:
            last_version = Decoder(info).u64()
    objects: dict[str, int] = {}
    try:
        for oid in store.list_objects(cid):
            if oid == PGMETA:
                continue
            try:
                v = int.from_bytes(store.getattr(cid, oid, "v"), "little")
            except StoreError:
                v = 0
            objects[oid] = v
    except NoSuchCollection:
        pass
    return last_version, objects
