"""PGBackend — the replication-strategy seam + the replicated twin.

Reference: src/osd/PGBackend.{h,cc}; ``build_pg_backend``
(PGBackend.cc:532-569) picks ReplicatedBackend or ECBackend from the
pool type. The backend owns HOW object data moves between acting-set
members; the PG above it owns versions, the log, and peering; the OSD
below it owns messengers and the store.

``Listener`` is the service interface the OSD hands to backends (the
reference's PGBackend::Listener), so backends stay testable without a
full daemon.

Sub-op plumbing: every fan-out gets a tid. Write fan-outs register an
:class:`InflightWrite` (pending position set + completion callback —
the pending_commit tracking of ECBackend.cc:1090); read fan-outs
register a blocking :class:`SubOpWait`. The OSD routes
MECSubWriteReply/MECSubReadReply by tid, and on every map epoch drops
pending positions whose OSD died (the write then completes on the
surviving shards and the dead shard is recorded missing, to be fixed
by recovery — the reference's on-peering-change accounting).
"""

from __future__ import annotations

import threading

from ceph_tpu_torch.utils.noop_hooks import make_condition, make_lock
import time
from typing import Callable, Protocol

from ceph_tpu_torch.osd.pg import (
    LOG_REMOVE,
    LOG_WRITE,
    NO_SHARD,
    PG,
    LogEntry,
    pg_cid,
)
from ceph_tpu_torch.parallel import messages as M
from ceph_tpu_torch.parallel.osdmap import OSDMap
from ceph_tpu_torch.store.object_store import (
    ObjectStore,
    StoreError,
    Transaction,
)
from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.utils import flow_telemetry as _flows

log = Dout("osd")

#: how long a primary waits for one sub-op round trip before treating
#: the shard as unavailable (messenger is lossy; peers may be dead)
SUBOP_TIMEOUT = 5.0

#: store-attr namespace for CLIENT xattrs (the reference separates
#: user xattrs with a "_" prefix from internal "_ceph." attrs —
#: src/osd/PrimaryLogPG.cc getxattr/setxattr; ours are "u/<name>"
#: beside the internal "v"/"sz"/"hinfo"/"crc" attrs)
USER_XATTR = "u/"


def user_xattrs(attrs: dict[str, bytes]) -> dict[str, bytes]:
    """Strip the store-attr namespace down to the client's view."""
    return {n[len(USER_XATTR):]: v for n, v in attrs.items()
            if n.startswith(USER_XATTR)}


class SubOpWait:
    """Blocking rendezvous for a read fan-out."""

    def __init__(self, expected: set[int]) -> None:
        self.lock = make_lock("pg_backend.subop_wait")
        self.cond = make_condition("pg_backend.subop_wait", self.lock)
        self.pending: set[int] = set(expected)
        self.results: dict[int, object] = {}

    def complete(self, shard: int, result: object) -> None:
        with self.lock:
            self.results[shard] = result
            self.pending.discard(shard)
            self.cond.notify_all()

    def drop(self, shard: int) -> None:
        with self.lock:
            self.pending.discard(shard)
            self.cond.notify_all()

    def wait(self, timeout: float = SUBOP_TIMEOUT) -> dict[int, object]:
        with self.lock:
            self.cond.wait_for(lambda: not self.pending, timeout)
            return dict(self.results)


class InflightWrite:
    """One write fan-out awaiting shard commits."""

    def __init__(self, tid: int, pg: PG, oid: str, version: int,
                 pending: set[int], on_all_commit: Callable[[], None]
                 ) -> None:
        self.tid = tid
        self.pg = pg
        self.oid = oid
        self.version = version
        self.acting = list(pg.acting)     # snapshot at submit time
        self.pending = set(pending)
        self.on_all_commit = on_all_commit
        #: fired (once) when the write is abandoned by the expiry
        #: sweep instead of completing — cleanup that must not wait
        #: for a commit that will never be confirmed (e.g. extent-
        #: cache unpin; a leaked pin would poison later RMWs forever)
        self.on_expire: Callable[[], None] | None = None
        #: the client op's StageClock (utils/stage_clock), set by the
        #: EC fan-out so shard sub-op timelines arriving in
        #: MECSubWriteReply merge under the op (None = untimed)
        self.clock = None
        self.created_at = time.monotonic()
        self._lock = make_lock("pg_backend.inflight_write")
        self._done = False

    def complete(self, pos: int) -> bool:
        """Mark one position committed; returns True when this call
        finished the write (caller then fires on_all_commit)."""
        with self._lock:
            self.pending.discard(pos)
            if self.pending or self._done:
                return False
            self._done = True
            return True

    def drop_down_shards(self, osdmap: OSDMap) -> tuple[bool, list[int]]:
        """Map-change hook: stop waiting for dead shards; the write
        completes on survivors. Returns (finished, dropped_positions);
        the CALLER records the dropped shards missing under pg.lock
        (never taken here: lock order is pg.lock -> iw._lock, because
        complete() runs inside store-commit callbacks under pg.lock)."""
        finished = False
        dropped: list[int] = []
        with self._lock:
            for pos in list(self.pending):
                osd = self.acting[pos] if pos < len(self.acting) else -1
                info = osdmap.osds.get(osd)
                if info is None or not info.up:
                    self.pending.discard(pos)
                    dropped.append(pos)
            if not self.pending and not self._done:
                self._done = True
                finished = True
        return finished, dropped

    def expire(self) -> "tuple[list[int], Callable[[], None] | None]":
        """Timeout sweep: abandon the write, returning (positions never
        heard from, deferred on_expire-or-None). The client owns
        end-to-end completion: it times out and resends, and the dup-op
        cache makes the resend safe.

        on_expire is NOT fired here: the caller must record the dropped
        positions in pg.peer_missing FIRST, then invoke it — firing the
        extent-cache unpin before the missing bookkeeping would let an
        RMW racing in that window snapshot a cache lacking the expired
        version and read the stale shard (not yet avoided) as its
        floor: a lost update."""
        with self._lock:
            already = self._done
            self._done = True
            dropped = sorted(self.pending)
            self.pending.clear()
        fire = None if already else self.on_expire
        return dropped, fire


class Listener(Protocol):
    """What a backend needs from its hosting OSD."""

    whoami: int
    store: ObjectStore

    def get_osdmap(self) -> OSDMap: ...
    def send_osd(self, osd: int, msg: M.Message) -> None: ...
    def new_tid(self) -> int: ...
    def register_write(self, iw: InflightWrite) -> None: ...
    def register_wait(self, tid: int, wait: SubOpWait) -> None: ...
    def unregister_wait(self, tid: int) -> None: ...
    def queue_local_txn(self, txn: Transaction,
                        on_commit: Callable[[], None]) -> None: ...
    def device_engine(self): ...   # lazy per-OSD DeviceEncodeEngine


class PGBackend:
    """Abstract backend (PGBackend.h role)."""

    def __init__(self, parent: Listener, pool_info) -> None:
        self.parent = parent
        self.pool = pool_info

    # -- client-facing entry points (primary side) --------------------
    def submit_write(self, pg: PG, oid: str, data: bytes, version: int,
                     on_commit: Callable[[int], None]) -> None:
        """Apply a full-object write at ``version`` across the acting
        set; ``on_commit(code)`` once every up shard has committed."""
        raise NotImplementedError

    def submit_remove(self, pg: PG, oid: str, version: int,
                      on_commit: Callable[[int], None]) -> None:
        raise NotImplementedError

    def read_object(self, pg: PG, oid: str) -> bytes:
        """Full-object read, reconstructing if degraded. Raises
        StoreError/NoSuchObject on failure."""
        raise NotImplementedError

    def read_object_async(self, pg: PG, oid: str,
                          cont: Callable[[bytes | None,
                                          Exception | None],
                                         None]) -> None:
        """Async-capable full-object read: ``cont(data, err)`` fires
        exactly once — inline here (no batched decode route for this
        backend); ECBackend overrides it so a degraded read stages a
        signature-batched engine decode and frees the op worker.
        Failures route to ``cont``, never raise to the caller."""
        try:
            data = self.read_object(pg, oid)
        except Exception as exc:
            cont(None, exc)
            return
        cont(data, None)

    def stat_object(self, pg: PG, oid: str) -> int:
        raise NotImplementedError

    def build_push(self, pg: PG, oid: str, shard: int, version: int,
                   tid: int) -> "M.MPGPush | None":
        """Rebuild one shard's copy of ``oid`` as a push message
        (recover_object / continue_recovery_op role); None when the
        object cannot be reconstructed right now. The OSD delivers it
        and waits for the ack before log-syncing the shard."""
        raise NotImplementedError

    def recover_rollback(self, pg: PG, oid: str, wanted: int
                         ) -> "dict[int, M.MPGPush] | None":
        """Last-resort recovery when ``oid`` at ``wanted`` cannot be
        rebuilt at all: roll the object back cluster-wide to the newest
        state enough shards still agree on (the EC log-rollback role,
        ecbackend.rst:9-26). Returns {position: push} or None when
        rollback does not apply / state is unknown."""
        return None

    def submit_truncate(self, pg: PG, oid: str, new_size: int,
                        version: int,
                        on_commit: Callable[[int], None]) -> None:
        """Shrink/zero-extend to ``new_size`` (CEPH_OSD_OP_TRUNCATE;
        absent objects are created zero-filled, write-op semantics).
        Default: synchronous read + full rewrite."""
        from ceph_tpu_torch.store.object_store import (
            NoSuchCollection,
            NoSuchObject,
        )
        try:
            cur = self.read_object(pg, oid)
        except (NoSuchObject, NoSuchCollection):
            cur = b""                  # create zero-filled
        except StoreError:
            on_commit(-5)              # transient read failure: fail,
            return                     # never silently zero the object
        if new_size <= len(cur):
            data = bytes(cur[:new_size])
        else:
            data = bytes(cur) + b"\x00" * (new_size - len(cur))
        self.submit_write(pg, oid, data, version, on_commit)

    # -- client xattrs/omap (do_osd_ops attr families) ----------------
    def submit_setattrs(self, pg: PG, oid: str,
                        sets: dict[str, bytes], rms: list[str],
                        version: int,
                        on_commit: Callable[[int], None]) -> None:
        """Apply client xattr mutations at ``version`` across the
        acting set (CEPH_OSD_OP_SETXATTR/RMXATTR). Creates the object
        if absent (the reference's attr ops imply create)."""
        raise NotImplementedError

    def get_xattrs(self, pg: PG, oid: str) -> dict[str, bytes]:
        """Client xattrs of ``oid`` (degraded-safe). Raises
        NoSuchObject when the object does not exist."""
        raise NotImplementedError

    def omap_supported(self) -> bool:
        """EC pools reject omap exactly as the reference does
        (PrimaryLogPG returns -EOPNOTSUPP on EC pools)."""
        return False

    def submit_omap(self, pg: PG, oid: str, sets: dict[str, bytes],
                    rms: list[str], version: int,
                    on_commit: Callable[[int], None]) -> None:
        raise NotImplementedError

    def get_omap(self, pg: PG, oid: str,
                 keys: "list[str] | None" = None) -> dict[str, bytes]:
        raise NotImplementedError

    def local_cid(self, pg: PG) -> str:
        raise NotImplementedError

    # -- acting-set helpers -------------------------------------------
    def up_positions(self, pg: PG) -> list[int]:
        """Acting-set positions whose OSD is currently up."""
        osdmap = self.parent.get_osdmap()
        out = []
        for pos, osd in enumerate(pg.acting):
            if osd < 0:
                continue
            info = osdmap.osds.get(osd)
            if info is not None and info.up:
                out.append(pos)
        return out

    def min_size_ok(self, pg: PG) -> bool:
        return len(self.up_positions(pg)) >= self.pool.min_size


def object_write_txn(cid: str, oid: str, data: bytes, version: int,
                     attrs: dict[str, bytes] | None = None,
                     replace: bool = False) -> Transaction:
    """Write-full of one store object + its version attr (and extras),
    all in one atomic txn.

    ``replace=False`` (client WRITEFULL semantics,
    CEPH_OSD_OP_WRITEFULL): the data stream is truncated and
    rewritten; client xattrs and omap SURVIVE. ``replace=True``
    (recovery pushes): the object is recreated from exactly the pushed
    state — stale attrs/omap a down shard accumulated must not
    outlive recovery."""
    txn = Transaction()
    txn.create_collection(cid)
    if replace:
        txn.remove(cid, oid)
    txn.touch(cid, oid)
    if not replace:
        txn.truncate(cid, oid, 0)
    if data:
        txn.write(cid, oid, 0, data)
    txn.setattr(cid, oid, "v", version.to_bytes(8, "little"))
    for name, val in (attrs or {}).items():
        txn.setattr(cid, oid, name, val)
    return txn


def object_remove_txn(cid: str, oid: str) -> Transaction:
    txn = Transaction()
    txn.create_collection(cid)
    txn.remove(cid, oid)
    return txn


class ReplicatedBackend(PGBackend):
    """Primary-copy replication (src/osd/ReplicatedBackend.{h,cc}):
    the primary ships the whole mutation to every acting replica and
    acks the client when all up replicas committed."""

    def local_cid(self, pg: PG) -> str:
        return pg_cid(pg.pool, pg.ps, NO_SHARD)

    def _fan_out(self, pg: PG, oid: str, entry: LogEntry,
                 txn_builder: Callable[[str], Transaction],
                 on_commit: Callable[[int], None]) -> None:
        cid = self.local_cid(pg)
        kv, drop = pg.log.stage(entry)
        positions = self.up_positions(pg)
        tid = self.parent.new_tid()
        iw = InflightWrite(tid, pg, oid, entry.version, set(positions),
                           lambda: on_commit(0))
        self.parent.register_write(iw)
        epoch = self.parent.get_osdmap().epoch
        from ceph_tpu_torch.utils import tracing
        op_span = tracing.current()
        for pos in positions:
            osd = pg.acting[pos]
            txn = txn_builder(cid)
            pg.log.apply_to_txn(txn, cid, kv, drop)
            if osd == self.parent.whoami:
                self.parent.queue_local_txn(
                    txn,
                    lambda p=pos: iw.complete(p) and iw.on_all_commit())
            else:
                child = op_span.child(f"repl_sub_write(pos={pos})")
                self.parent.send_osd(osd, M.MECSubWrite(
                    tid=tid, pool=pg.pool, ps=pg.ps, shard=pos,
                    epoch=epoch, oid=oid, version=entry.version,
                    txn_bytes=txn.encode(), trace=child.wire(),
                    flow=_flows.current_flow() or ""))
                child.finish()

    def submit_write(self, pg: PG, oid: str, data: bytes, version: int,
                     on_commit: Callable[[int], None]) -> None:
        from ceph_tpu_torch.osd.ec_util import HINFO_SEED
        from ceph_tpu_torch.utils import checksum
        # self-validating copy: scrub compares each replica's computed
        # crc against the one stored at write time, so a corrupt shard
        # convicts itself even when versions tie (the replicated twin
        # of the EC hinfo)
        crc_attr = checksum.crc32c(data, HINFO_SEED).to_bytes(4, "little")
        entry = LogEntry(version, LOG_WRITE, oid)
        self._fan_out(
            pg, oid, entry,
            lambda cid: object_write_txn(cid, oid, data, version,
                                         attrs={"crc": crc_attr}),
            on_commit)

    def submit_remove(self, pg: PG, oid: str, version: int,
                      on_commit: Callable[[int], None]) -> None:
        entry = LogEntry(version, LOG_REMOVE, oid)
        self._fan_out(pg, oid, entry,
                      lambda cid: object_remove_txn(cid, oid), on_commit)

    def read_object(self, pg: PG, oid: str) -> bytes:
        return self.parent.store.read(self.local_cid(pg), oid)

    def stat_object(self, pg: PG, oid: str) -> int:
        return self.parent.store.stat(self.local_cid(pg), oid)

    # -- client xattrs/omap -------------------------------------------
    def _attr_txn(self, cid: str, oid: str, sets: dict[str, bytes],
                  rms: list[str], version: int,
                  omap_sets: dict[str, bytes] | None = None,
                  omap_rms: list[str] | None = None) -> Transaction:
        txn = Transaction()
        txn.create_collection(cid)
        txn.touch(cid, oid)
        for name, val in sets.items():
            txn.setattr(cid, oid, USER_XATTR + name, val)
        for name in rms:
            txn.rmattr(cid, oid, USER_XATTR + name)
        if omap_sets:
            txn.omap_set(cid, oid, omap_sets)
        if omap_rms:
            txn.omap_rm(cid, oid, omap_rms)
        txn.setattr(cid, oid, "v", version.to_bytes(8, "little"))
        return txn

    def submit_setattrs(self, pg: PG, oid: str,
                        sets: dict[str, bytes], rms: list[str],
                        version: int,
                        on_commit: Callable[[int], None]) -> None:
        entry = LogEntry(version, LOG_WRITE, oid)
        self._fan_out(pg, oid, entry,
                      lambda cid: self._attr_txn(cid, oid, sets, rms,
                                                 version), on_commit)

    def get_xattrs(self, pg: PG, oid: str) -> dict[str, bytes]:
        return user_xattrs(
            self.parent.store.getattrs(self.local_cid(pg), oid))

    def omap_supported(self) -> bool:
        return True

    def submit_omap(self, pg: PG, oid: str, sets: dict[str, bytes],
                    rms: list[str], version: int,
                    on_commit: Callable[[int], None]) -> None:
        entry = LogEntry(version, LOG_WRITE, oid)
        self._fan_out(pg, oid, entry,
                      lambda cid: self._attr_txn(cid, oid, {}, [],
                                                 version,
                                                 omap_sets=sets,
                                                 omap_rms=rms),
                      on_commit)

    def get_omap(self, pg: PG, oid: str,
                 keys: "list[str] | None" = None) -> dict[str, bytes]:
        cid = self.local_cid(pg)
        self.parent.store.stat(cid, oid)       # ENOENT check
        omap = self.parent.store.omap_get(cid, oid)
        if keys:
            return {k: omap[k] for k in keys if k in omap}
        return omap

    def build_push(self, pg: PG, oid: str, shard: int, version: int,
                   tid: int) -> M.MPGPush | None:
        cid = self.local_cid(pg)
        if shard >= len(pg.acting) or pg.acting[shard] < 0:
            return None
        if version <= 0:       # shard missed a removal (v = -version)
            return M.MPGPush(
                pool=pg.pool, ps=pg.ps, shard=NO_SHARD, oid=oid,
                version=-version, data=b"", attrs={}, remove=True,
                tid=tid)
        data = attrs = None
        omap: dict[str, bytes] = {}
        push_version = version
        try:
            attrs = self.parent.store.getattrs(cid, oid)
            v_local = int.from_bytes(attrs.get("v", b""), "little")
            if v_local >= version:
                data = self.parent.store.read(cid, oid)
                push_version = v_local
                try:
                    omap = self.parent.store.omap_get(cid, oid)
                except StoreError:
                    omap = {}
        except StoreError:
            pass
        if data is None:
            # the local copy is absent or stale (the PRIMARY may be the
            # shard being recovered): pull the wanted-or-newer version
            # from a replica that has it (the reference's pull path)
            data, attrs, omap, push_version = self._pull_copy(
                pg, oid, version, exclude={shard})
            if data is None:
                log(1, f"recover {oid}: no replica holds v>={version}")
                return None
        return M.MPGPush(
            pool=pg.pool, ps=pg.ps, shard=NO_SHARD, oid=oid,
            version=push_version, data=data, attrs=dict(attrs),
            remove=False, tid=tid, omap=dict(omap or {}))

    def _pull_copy(self, pg: PG, oid: str, version: int,
                   exclude: set[int]
                   ) -> "tuple[bytes | None, dict | None, dict, int]":
        with pg.lock:
            donors = [p for p in self.up_positions(pg)
                      if p not in exclude
                      and oid not in pg.peer_missing.get(p, {})
                      and pg.acting[p] != self.parent.whoami]
        for pos in donors:
            tid = self.parent.new_tid()
            wait = SubOpWait({pos})
            self.parent.register_wait(tid, wait)
            self.parent.send_osd(pg.acting[pos], M.MECSubRead(
                tid=tid, pool=pg.pool, ps=pg.ps, shard=pos, oid=oid,
                offset=0, length=0, want_attrs=True))
            replies = wait.wait(SUBOP_TIMEOUT)
            self.parent.unregister_wait(tid)
            rep = replies.get(pos)
            if rep is None or rep.code != 0 or rep.version < version:
                continue
            stored = rep.attrs.get("crc")
            if stored is not None:
                from ceph_tpu_torch.osd.ec_util import HINFO_SEED
                from ceph_tpu_torch.utils import checksum
                if checksum.crc32c(rep.data, HINFO_SEED) != \
                        int.from_bytes(stored, "little"):
                    log(1, f"pull {oid}: donor pos {pos} fails its own "
                        "crc, trying next donor")
                    continue      # silently-corrupt donor: never spread
            return rep.data, dict(rep.attrs), \
                dict(getattr(rep, "omap", {}) or {}), rep.version
        return None, None, {}, 0
