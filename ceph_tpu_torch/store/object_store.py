"""ObjectStore interface + Transaction — the src/os/ObjectStore.h role.

A ``Transaction`` is an ordered batch of mutations that the store
applies atomically and durably; ``queue_transaction`` completes the
commit callback only once the batch is recoverable (the reference's
``queue_transactions`` + on_commit contexts, ObjectStore.h). Ops are
enumerated and wire-encodable (our Encoder) because EC sub-writes ship
whole shard transactions to peer OSDs (ECSubWrite carries a
Transaction, src/osd/ECMsgTypes.h:23-89).

Naming: ``cid`` is a collection (one per PG shard, e.g. "pg_1.2s0"),
``oid`` an object within it.
"""

from __future__ import annotations

from typing import Callable, Iterator

from ceph_tpu_torch.analysis.lock_witness import make_condition, make_lock
from ceph_tpu_torch.utils.encoding import Decoder, Encoder


def group_commit_enabled() -> bool:
    """The ROADMAP-1a store batching switch (shared with the OSD's
    ``CEPH_TPU_GROUP_COMMIT`` A/B convention): when off, every txn
    pays its own inline barrier set exactly like the pre-15 stores."""
    import os
    return os.environ.get("CEPH_TPU_GROUP_COMMIT", "1") != "0"


class StoreError(Exception):
    pass


class _SharedBarrier:
    """Leader-follower barrier coalescing — THE group-commit
    mechanism the adjacency-window ledger priced (the classic WAL
    group commit): a caller whose appends need durability either
    leads a barrier round immediately (idle path: zero added
    latency) or, when a round is already in flight, waits and shares
    a later round with every other caller that arrived meanwhile.
    One fsync set then covers them all — under load the barrier rate
    converges on 1/fsync-duration instead of 1/txn.

    Rounds have two phases. While a round is COLLECTING, new callers
    join it (their appends precede the fsync, which has not started);
    once it is SYNCING, arrivals wait for the next round. A hot
    leader — one whose previous round was shared — DWELLS for the
    adjacency window before syncing, sweeping in the near-adjacent
    commits the what-if ledger measured; a cold (idle-stream) leader
    syncs immediately, so light traffic never pays the window.

    The leader runs ``do_sync`` with no locks held (waiters park on
    this barrier's own condition, never on a store or PG lock)."""

    __slots__ = ("_cond", "_gen", "_phase", "_members",
                 "_last_shared", "_last_end")

    _IDLE, _COLLECTING, _SYNCING = 0, 1, 2

    #: hotness horizon: a leader dwells when the previous round ended
    #: within this many windows ago (the stream is adjacent even if
    #: commits never overlap — the exact population the what-if
    #: ledger's window replay grouped)
    _HOT_WINDOWS = 5.0

    def __init__(self, name: str) -> None:
        self._cond = make_condition(name)
        self._gen = 0
        self._phase = self._IDLE
        self._members = 0
        self._last_shared = False
        self._last_end = -1e18

    def sync(self, do_sync: Callable[[], None],
             window_s: float = 0.0) -> None:
        import time as _time
        with self._cond:
            while True:
                if self._phase == self._IDLE:
                    self._phase = self._COLLECTING   # lead new round
                    break
                # either way we are concurrent demand: the NEXT
                # leader's dwell decision keys on having had waiters
                self._members += 1
                if self._phase == self._COLLECTING:
                    # join the open round (its fsync has not started,
                    # so it covers our appends) and wait it out
                    my_round = self._gen + 1
                    while self._gen < my_round:
                        self._cond.wait()
                    return
                # SYNCING: that fsync may predate our appends — wait
                # for the round to finish, then join/lead the next
                cur = self._gen
                while self._gen == cur and \
                        self._phase == self._SYNCING:
                    self._cond.wait()
            hot = self._last_shared or (
                _time.monotonic() - self._last_end
                < self._HOT_WINDOWS * window_s)
            dwell = window_s if hot else 0.0
        if dwell > 0:
            _time.sleep(dwell)  # collect the adjacency window
        with self._cond:
            self._phase = self._SYNCING
        try:
            do_sync()
        finally:
            with self._cond:
                self._gen += 1
                self._phase = self._IDLE
                self._last_shared = self._members > 0
                self._members = 0
                self._last_end = _time.monotonic()
                self._cond.notify_all()


class _ParkedCompletions:
    """Thread-safe holder for the deferred leg of group commit: the
    completion callbacks (and, for stores with a separate data file,
    the needs-a-data-barrier flag) parked between a ``defer=True``
    :meth:`ObjectStore.queue_transaction_group` and the shared
    :meth:`ObjectStore.barrier`. Only list/flag handoff happens under
    its lock — the barrier's fsyncs and the completion sweep run
    outside it."""

    __slots__ = ("_lock", "_cbs", "_dirty")

    def __init__(self, name: str) -> None:
        self._lock = make_lock(name)
        self._cbs: list = []
        self._dirty = False

    def park(self, cbs, dirty: bool = False) -> None:
        with self._lock:
            self._cbs.extend(cbs)
            self._dirty = self._dirty or dirty

    def take(self) -> tuple[list, bool]:
        with self._lock:
            cbs, self._cbs = self._cbs, []
            dirty, self._dirty = self._dirty, False
        return cbs, dirty

    def __bool__(self) -> bool:
        with self._lock:
            return bool(self._cbs) or self._dirty


class EIOError(StoreError):
    """Data-level read failure (bad checksum or injected EIO) — the
    reference surfaces these as -EIO to trigger repair
    (bluestore_debug_inject_read_err, OSD.cc:5261-5264)."""


class NoSuchObject(StoreError):
    pass


class NoSuchCollection(StoreError):
    pass


# transaction op codes (the OP_* enum of ObjectStore::Transaction)
OP_TOUCH = 1
OP_WRITE = 2
OP_ZERO = 3
OP_TRUNCATE = 4
OP_REMOVE = 5
OP_SETATTR = 6
OP_RMATTR = 7
OP_OMAP_SET = 8
OP_OMAP_RM = 9
OP_MKCOLL = 10
OP_RMCOLL = 11
OP_OMAP_RMRANGE = 12


class Transaction:
    """Ordered mutation batch; append-style builder like the reference's
    ``t.write(...); t.setattr(...)`` call chains."""

    def __init__(self) -> None:
        self.ops: list[tuple] = []

    # -- builders -----------------------------------------------------
    def touch(self, cid: str, oid: str) -> "Transaction":
        self.ops.append((OP_TOUCH, cid, oid)); return self

    def write(self, cid: str, oid: str, off: int, data: bytes) -> "Transaction":
        self.ops.append((OP_WRITE, cid, oid, off, bytes(data))); return self

    def zero(self, cid: str, oid: str, off: int, length: int) -> "Transaction":
        self.ops.append((OP_ZERO, cid, oid, off, length)); return self

    def truncate(self, cid: str, oid: str, size: int) -> "Transaction":
        self.ops.append((OP_TRUNCATE, cid, oid, size)); return self

    def remove(self, cid: str, oid: str) -> "Transaction":
        self.ops.append((OP_REMOVE, cid, oid)); return self

    def setattr(self, cid: str, oid: str, name: str, value: bytes) -> "Transaction":
        self.ops.append((OP_SETATTR, cid, oid, name, bytes(value))); return self

    def rmattr(self, cid: str, oid: str, name: str) -> "Transaction":
        self.ops.append((OP_RMATTR, cid, oid, name)); return self

    def omap_set(self, cid: str, oid: str, kv: dict[str, bytes]) -> "Transaction":
        self.ops.append((OP_OMAP_SET, cid, oid,
                         {k: bytes(v) for k, v in kv.items()})); return self

    def omap_rm(self, cid: str, oid: str, keys: list[str]) -> "Transaction":
        self.ops.append((OP_OMAP_RM, cid, oid, list(keys))); return self

    def omap_rmrange(self, cid: str, oid: str, prefix: str) -> "Transaction":
        """Remove every omap key starting with ``prefix`` (the
        reference's omap_rmkeyrange; lets a log-sync atomically REPLACE
        a shard's log namespace instead of merging into stale keys)."""
        self.ops.append((OP_OMAP_RMRANGE, cid, oid, prefix)); return self

    def create_collection(self, cid: str) -> "Transaction":
        self.ops.append((OP_MKCOLL, cid)); return self

    def remove_collection(self, cid: str) -> "Transaction":
        self.ops.append((OP_RMCOLL, cid)); return self

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops); return self

    def __len__(self) -> int:
        return len(self.ops)

    # -- wire ---------------------------------------------------------
    def encode(self) -> bytes:
        body = Encoder()

        def enc_op(e: Encoder, op: tuple) -> None:
            code = op[0]
            e.u8(code)
            if code in (OP_MKCOLL, OP_RMCOLL):
                e.str(op[1])
                return
            e.str(op[1]); e.str(op[2])
            if code == OP_WRITE:
                e.u64(op[3]); e.bytes(op[4])
            elif code == OP_ZERO:
                e.u64(op[3]); e.u64(op[4])
            elif code == OP_TRUNCATE:
                e.u64(op[3])
            elif code == OP_SETATTR:
                e.str(op[3]); e.bytes(op[4])
            elif code == OP_RMATTR:
                e.str(op[3])
            elif code == OP_OMAP_SET:
                e.map(op[3], Encoder.str, Encoder.bytes)
            elif code == OP_OMAP_RM:
                e.list(op[3], Encoder.str)
            elif code == OP_OMAP_RMRANGE:
                e.str(op[3])

        body.list(self.ops, enc_op)
        e = Encoder()
        e.section(1, body)
        return e.getvalue()

    @classmethod
    def decode(cls, buf: bytes) -> "Transaction":
        _, d = Decoder(buf).section(1)

        def dec_op(dd: Decoder) -> tuple:
            code = dd.u8()
            if code in (OP_MKCOLL, OP_RMCOLL):
                return (code, dd.str())
            cid, oid = dd.str(), dd.str()
            if code == OP_WRITE:
                return (code, cid, oid, dd.u64(), dd.bytes())
            if code == OP_ZERO:
                return (code, cid, oid, dd.u64(), dd.u64())
            if code == OP_TRUNCATE:
                return (code, cid, oid, dd.u64())
            if code == OP_SETATTR:
                return (code, cid, oid, dd.str(), dd.bytes())
            if code == OP_RMATTR:
                return (code, cid, oid, dd.str())
            if code == OP_OMAP_SET:
                return (code, cid, oid, dd.map(Decoder.str, Decoder.bytes))
            if code == OP_OMAP_RM:
                return (code, cid, oid, dd.list(Decoder.str))
            if code == OP_OMAP_RMRANGE:
                return (code, cid, oid, dd.str())
            return (code, cid, oid)

        t = cls()
        t.ops = d.list(dec_op)
        return t


class ObjectStore:
    """Abstract store. Implementations must make a queued transaction's
    effects atomic (all-or-nothing on crash) and fire ``on_commit`` only
    at durability."""

    def mount(self) -> None: ...
    def umount(self) -> None: ...

    def queue_transaction(self, txn: Transaction,
                          on_commit: Callable[[], None] | None = None) -> None:
        raise NotImplementedError

    # -- group commit (ROADMAP item 1a) -------------------------------
    def queue_transaction_group(self, pairs: list,
                                defer: bool = False) -> None:
        """Commit many ``(txn, on_commit)`` pairs as ONE store commit:
        one apply pass, one metadata batch, one WAL append, one
        durability-barrier set — instead of per-txn completion
        machinery — with the completions delivered as one batched
        sweep in submission order (the group-commit path the
        adjacency-window ledger in utils/store_telemetry projected).
        The group is atomic as a whole (it is a flush group: the same
        all-or-nothing envelope the merged-transaction path had).

        ``defer=True`` additionally parks the barrier AND the
        completion sweep until :meth:`barrier` — the cross-thread leg:
        several groups queued from different op-shard threads (one
        per PG of a batched sub-write frame) share ONE barrier issued
        by whoever calls :meth:`barrier` last. Callers own liveness:
        every ``defer=True`` queue MUST be followed by a
        :meth:`barrier` on some thread, or the acks never fire.
        """
        for txn, cb in pairs:
            self.queue_transaction(txn, cb)
        if defer:
            # base fallback committed synchronously: nothing parked
            return

    def barrier(self) -> None:
        """Flush every deferred durability barrier and sweep the
        parked completions in submission order. Must never be called
        (and is never needed) under a per-PG or store lock the op
        path also takes — the fsync runs lock-free."""

    def barrier_pending(self) -> bool:
        """True when deferred completions are parked (tick backstop
        hook: a stranded ``defer=True`` group must not strand its
        acks forever)."""
        return False

    # -- reads (never require a transaction) --------------------------
    def read(self, cid: str, oid: str, off: int = 0,
             length: int | None = None) -> bytes:
        raise NotImplementedError

    def stat(self, cid: str, oid: str) -> int:
        """Object size in bytes; raises NoSuchObject."""
        raise NotImplementedError

    def getattr(self, cid: str, oid: str, name: str) -> bytes:
        raise NotImplementedError

    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]:
        raise NotImplementedError

    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        raise NotImplementedError

    def list_collections(self) -> list[str]:
        raise NotImplementedError

    def list_objects(self, cid: str) -> list[str]:
        raise NotImplementedError

    def exists(self, cid: str, oid: str) -> bool:
        try:
            self.stat(cid, oid)
            return True
        except StoreError:
            return False

    # -- fault injection (store->inject_data_error role) --------------
    def inject_data_error(self, cid: str, oid: str) -> None:
        raise NotImplementedError

    def clear_data_error(self, cid: str, oid: str) -> None:
        raise NotImplementedError

    def inject_bit_flip(self, cid: str, oid: str, offset: int = 0,
                        length: int = 4) -> None:
        """SILENT corruption injection (the bitrot the deep-scrub
        parity/crc pass exists to catch): XOR-flip ``length`` stored
        bytes at ``offset`` such that a subsequent read returns the
        flipped bytes WITHOUT an EIO — i.e. below-the-checksum rot, or
        rot the store's csum collides with. A rewrite of the object
        replaces the flipped bytes like any other data."""
        raise NotImplementedError


def create_store(kind: str, path: str | None = None) -> ObjectStore:
    """Factory (ObjectStore::create role, src/os/ObjectStore.cc:62-95)."""
    from ceph_tpu_torch.store.blockstore import BlockStore
    from ceph_tpu_torch.store.kstore import KStore
    from ceph_tpu_torch.store.memstore import MemStore
    if kind == "memstore":
        return MemStore()
    if kind == "blockstore":
        if path is None:
            raise ValueError("blockstore requires a path")
        return BlockStore(path)
    if kind == "kstore":
        return KStore(path)          # kv-only; path optional (MemDB)
    raise ValueError(f"unknown store kind {kind!r}")
