"""CrimsonOSD — the shard-per-core, run-to-completion OSD data path
(src/crimson/osd/ role, grown from the memstore prototype).

The reference's crimson is a seastar rewrite exploring one bet: cores
never share mutable state — every PG lives on exactly one reactor,
cross-core work travels as messages (``smp::submit_to``), and within
a reactor nothing preempts between awaits. This subsystem keeps that
discipline and serves the MAINLINE data path the stock objecter
speaks:

- EC writes run through the mainline :class:`ECBackend` against a
  per-reactor ``pg_backend.Listener`` (crimson/reactor.py) — same
  encode, same hinfo, same ``MECSubWrite``/``MECSubWriteBatch`` wire
  fan-out, same PG log — so read-back is byte-identical to the
  threaded OSD and the two flavors interoperate shard-for-shard;
- the device engine's stripe batching is kept (the ONLY async
  boundary on the path); its continuations dispatch straight onto
  the staging PG's owning reactor — no ``wq_continuation``
  re-enqueue, the hop the dispatch X-ray measured at 10.4% of the
  commit-wait envelope;
- each reactor owns a REAL per-shard :class:`ObjectStore` (memstore
  by default, blockstore/kstore for durable runs) with the store's
  ``queue_transaction_group`` group commit; durable shard stores
  share ONE leader-follower barrier across reactors so a flush's
  fsyncs still coalesce;
- the messenger loop only parses and forwards (crimson's
  ms_fast_dispatch rule); commit replies route back through the
  owning connection, batched per connection — one engine flush, ONE
  wakeup per client connection (``MOSDOpReplyBatch``), not one per
  op;
- admission-to-ack runs as one coroutine on the owning reactor under
  a per-PG sequencer, so per-PG order holds across await points with
  zero locks on the op path (the lock witness and the
  ``reactor_affinity`` lint both hold the package to it).

Still out of scope (the threaded OSD remains the full-featured
flavor): peering/recovery, snapshots, cache tiering, watch/notify,
omap, scrub. A crimson cluster serves healthy-path I/O; the bench
A/B (tools/bench.py crimson arm) and the msgr fault family are the
acceptance surface.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time

from ceph_tpu_torch.crimson.reactor import Reactor
from ceph_tpu_torch.crimson import readpath
from ceph_tpu_torch.osd.ec_backend import ECBackend, ECReadError
from ceph_tpu_torch.osd.osd import (
    EAGAIN,
    EBLOCKLISTED,
    EEXIST,
    EINVAL,
    ENODATA,
    ENOENT,
    EOPNOTSUPP,
    ESTALE,
    OSD,
    SNAP_SEP,
    _SelfConn,
)
from ceph_tpu_torch.osd.pg import NO_SHARD, PG, PGMETA, pg_cid
from ceph_tpu_torch.osd.pg_backend import (
    SUBOP_TIMEOUT,
    USER_XATTR,
    object_write_txn,
    user_xattrs,
)
from ceph_tpu_torch.parallel import messages as M
from ceph_tpu_torch.parallel.messenger import Connection, Messenger
from ceph_tpu_torch.parallel.osdmap import OSDMap
from ceph_tpu_torch.store.memstore import MemStore
from ceph_tpu_torch.store.object_store import (
    NoSuchObject,
    StoreError,
    Transaction,
    create_store,
)
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.dispatch_telemetry import telemetry as _dsp_tel
from ceph_tpu_torch.utils import flow_telemetry as _flows
from ceph_tpu_torch.analysis.lock_witness import make_lock
from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.utils.perf_counters import collection

log = Dout("crimson")

#: ops whose effect must not double-apply on a wire resend
_MUTATING_OPS = (M.OSD_OP_WRITE_FULL, M.OSD_OP_WRITE, M.OSD_OP_APPEND,
                 M.OSD_OP_REMOVE, M.OSD_OP_SETXATTR, M.OSD_OP_RMXATTR,
                 M.OSD_OP_CREATE)

#: commit-future guard: a dropped sub-write frame must not wedge the
#: PG sequencer forever — unblock, skip the ack, let the client
#: resend re-execute (versioning makes re-execution idempotent)
_COMMIT_TIMEOUT = 2 * SUBOP_TIMEOUT

#: sentinel for "execute produced no reply" (commit timed out)
_NO_REPLY = object()


class CrimsonOSD:
    """Boot + maps on the messenger loop; client I/O run to
    completion on ``smp`` shared-nothing reactors."""

    def __init__(self, osd_id: int, mon_addr: str,
                 smp: int | None = None,
                 store_kind: str = "memstore",
                 data_dir: str | None = None,
                 shard_stores: list | None = None,
                 beacon_interval: float | None = None,
                 beacon_sleep=None) -> None:
        self.whoami = osd_id
        self.mon_addr = mon_addr
        self.smp = smp if smp is not None else max(
            1, int(g_conf()["crimson_smp"]))
        self.store_kind = store_kind
        self.data_dir = data_dir
        #: pre-made per-shard stores (a revive reuses the killed
        #: OSD's stores so its shards come back with their data, like
        #: the threaded MiniCluster's store cache)
        self._shard_stores = shard_stores
        if shard_stores:
            self.smp = len(shard_stores)
        #: the injectable beacon seam: tests pin the interval and the
        #: sleeper (an async callable) instead of waiting wall-clock
        self._beacon_interval = beacon_interval
        self._beacon_sleep = beacon_sleep or asyncio.sleep
        self.beacons_sent = 0
        #: cached observer targets (the tuner steps these via
        #: the mon config layer; no hot-path g_conf() reads)
        self.flush_bytes = int(g_conf()["crimson_flush_bytes"])
        self._smp_next = self.smp
        g_conf().add_observer("crimson_flush_bytes",
                              self._on_flush_bytes)
        g_conf().add_observer("crimson_smp", self._on_smp)
        self._perf_name = f"osd.{osd_id}"
        try:
            self.logger = OSD._make_perf(self._perf_name)
        except ValueError:
            self._perf_name = f"osd.{osd_id}.{id(self):x}"
            self.logger = OSD._make_perf(self._perf_name)
        self.msgr = Messenger(f"osd.{osd_id}")
        self.msgr.set_dispatcher(self._dispatch)
        self.addr = ""
        self.osdmap: OSDMap | None = None
        self._map_event = threading.Event()
        self._map_waiters: list = []
        self._map_waiters_lock = make_lock("crimson.map_waiters")
        self.reactors: list[Reactor] = []
        self._beacon_task = None
        self._tid = 0
        self._tid_lock = make_lock("crimson.tid")
        self._stopping = False

    # -- knob observers (cached: read per boot / per flush window) ----
    def _on_flush_bytes(self, value) -> None:
        self.flush_bytes = int(value)

    def _on_smp(self, value) -> None:
        # live reactors never reshard (PGs are pinned); a step lands
        # on the NEXT started OSD, or on this one if not yet started
        self._smp_next = max(1, int(value))
        if not self.reactors:
            self.smp = self._smp_next

    # -- lifecycle ----------------------------------------------------
    def _make_shard_store(self, idx: int):
        if self._shard_stores and idx < len(self._shard_stores):
            return self._shard_stores[idx]
        if self.store_kind == "memstore" or self.data_dir is None:
            return MemStore()
        return create_store(
            self.store_kind,
            f"{self.data_dir}/osd.{self.whoami}.shard{idx}")

    def _share_barriers(self) -> None:
        """Durable shard stores coalesce their group-commit fsyncs:
        every per-shard store syncs through reactor 0's leader-
        follower barrier, so one flush's cross-reactor txn groups
        cost one barrier round, not one per reactor."""
        shared = getattr(self.reactors[0].store, "_shared", None)
        if shared is None:
            return
        for r in self.reactors[1:]:
            if hasattr(r.store, "_shared"):
                r.store._shared = shared

    def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        for r in self.reactors or []:
            r.stop()
        self.reactors = [Reactor(i, self) for i in range(self.smp)]
        for r in self.reactors:
            try:
                r.store.mount()
            except Exception:
                pass
        self._share_barriers()
        self.addr = self.msgr.bind(host, port)
        # boot must land on the mon and come back as a map showing us
        # up: fire-and-forget + confirmation loop (the stub's boot
        # never confirmed, so a dropped first frame lost the OSD)
        deadline = time.monotonic() + 30
        while True:
            self.msgr.send_message(M.MOSDBoot(
                osd_id=self.whoami, addr=self.addr), self.mon_addr)
            self.msgr.send_message(M.MMonSubscribe(), self.mon_addr)
            if self._map_event.wait(timeout=1.0):
                m = self.osdmap
                info = m.osds.get(self.whoami) if m else None
                if info is not None and info.up \
                        and info.addr == self.addr:
                    break
                self._map_event.clear()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"crimson osd.{self.whoami} failed to boot")
        fut = asyncio.run_coroutine_threadsafe(
            self._start_beacon(), self.msgr._loop)
        fut.result(timeout=10)
        log(1, f"crimson osd.{self.whoami} up at {self.addr} "
            f"(smp={self.smp}, store={self.store_kind})")
        return self.addr

    async def _start_beacon(self) -> None:
        self._beacon_task = asyncio.get_running_loop().create_task(
            self._beacon_loop())

    async def _beacon_loop(self) -> None:
        """Satellite 2: the interval resolves through the injectable
        seam each lap (a test pins ``beacon_interval`` + a fake
        sleeper; production reads the heartbeat Option), so fault and
        partition tests never wait wall-clock."""
        while not self._stopping:
            interval = self._beacon_interval \
                if self._beacon_interval is not None \
                else g_conf()["osd_heartbeat_interval"]
            await self._beacon_sleep(interval)
            if self._stopping:
                return
            epoch = self.osdmap.epoch if self.osdmap else 0
            self.msgr.send_message(
                M.MOSDAlive(osd_id=self.whoami, epoch=epoch),
                self.mon_addr)
            self.beacons_sent += 1

    def stop(self) -> None:
        self._stopping = True
        if self._beacon_task is not None:
            self.msgr._loop.call_soon_threadsafe(
                self._beacon_task.cancel)
            self._beacon_task = None
        g_conf().remove_observer("crimson_flush_bytes",
                                 self._on_flush_bytes)
        g_conf().remove_observer("crimson_smp", self._on_smp)
        for r in self.reactors:
            r.services.detach_engine()
        self.msgr.shutdown()
        for r in self.reactors:
            r.stop()
        collection().remove(self._perf_name)

    # -- identity / shared services -----------------------------------
    def new_tid(self) -> int:
        with self._tid_lock:
            self._tid += 1
            return self._tid

    def get_osdmap(self) -> OSDMap:
        return self.osdmap

    @property
    def pgs(self) -> dict:
        """Merged reactor PG tables (harness/introspection only — the
        authoritative copies live on their owning reactors)."""
        out: dict = {}
        for r in self.reactors:
            out.update(r.pgs)
        return out

    def send_osd(self, osd: int, msg: M.Message) -> None:
        """Thread-safe peer send (flush-group ships may run on any
        reactor): self-sends loop through a re-encode so the handler
        sees a fresh message object, exactly like the wire."""
        osdmap = self.osdmap
        info = osdmap.osds.get(osd) if osdmap else None
        if info is None or not info.up or not info.addr:
            return
        if osd == self.whoami:
            self._dispatch(M.decode_message(
                msg.MSG_TYPE, msg.encode_payload()), _SelfConn(self))
            return
        self.msgr.send_message(msg, info.addr)

    # -- shard placement (PGShardManager pg_to_shard role) ------------
    def shard_of(self, pgid: tuple[int, int]) -> Reactor:
        return self.reactors[hash(pgid) % len(self.reactors)]

    # -- dispatch: parse and forward, nothing else --------------------
    def _dispatch(self, msg: M.Message, conn: Connection) -> None:
        if isinstance(msg, M.MOSDMap):
            newmap = OSDMap.decode(msg.map_bytes)
            if self.osdmap is None or newmap.epoch > self.osdmap.epoch:
                self.osdmap = newmap
                self._reconcile_pgs()
                self._drain_map_waiters(newmap.epoch)
            self._map_event.set()
        elif isinstance(msg, M.MOSDOp):
            self._admit_op(msg, conn)
        elif isinstance(msg, M.MOSDOpBatch):
            self._admit_batch(msg, conn)
        elif isinstance(msg, M.MECSubWrite):
            self._serve_sub_write(msg, conn)
        elif isinstance(msg, M.MECSubWriteBatch):
            self._serve_sub_write_batch(msg, conn)
        elif isinstance(msg, M.MECSubWriteReply):
            reactor = self.shard_of((msg.pool, msg.ps))
            reactor.call(self._complete_sub_write, reactor,
                         msg.tid, int(msg.shard))
        elif isinstance(msg, M.MECSubWriteBatchReply):
            self._route_sub_write_batch_reply(msg)
        elif isinstance(msg, M.MECSubRead):
            self._serve_sub_read(msg, conn)
        elif isinstance(msg, M.MECSubReadReply):
            reactor = self.shard_of((msg.pool, msg.ps))
            reactor.call(self._resolve_read_wait, reactor, msg)
        else:
            log(5, f"crimson: unhandled message {msg!r}")

    # -- PG reconciliation (instantiate-on-map, like the threaded
    # -- OSD's peering pass: wait_for_clean requires every mapped PG
    # -- to EXIST on its primary with a current acting set) -----------
    def _reconcile_pgs(self) -> None:
        osdmap = self.osdmap
        if osdmap is None or not self.reactors:
            return
        plans: dict[int, list] = {i: [] for i in
                                  range(len(self.reactors))}
        for pid, pool in osdmap.pools.items():
            for ps in range(pool.pg_num):
                _, acting, primary = osdmap.pg_to_up_acting(pid, ps)
                pgid = (pid, ps)
                plans[self.shard_of(pgid).idx].append(
                    (pgid, list(acting), primary == self.whoami))
        for idx, entries in plans.items():
            reactor = self.reactors[idx]
            reactor.call(self._apply_pg_plan, reactor, entries)

    def _apply_pg_plan(self, reactor: Reactor, entries: list) -> None:
        """Runs ON the owning reactor: create newly-mapped primary
        PGs, refresh the acting set of every PG this shard holds
        (primary or replica — a stale replica copy reads as dirty to
        the health check after a remap), drop PGs of deleted pools."""
        osdmap = self.osdmap
        for pgid in list(reactor.pgs):
            if pgid[0] not in osdmap.pools:
                reactor.pgs.pop(pgid, None)
        for pgid, acting, is_primary in entries:
            pg = reactor.pgs.get(pgid)
            if pg is None:
                if not is_primary:
                    continue
                pg = PG(pgid[0], pgid[1])
                pg.acting = acting
                pg.epoch = osdmap.epoch
                pg.state = PG.ACTIVE
                if osdmap.pools[pgid[0]].is_ec:
                    pg.backend = reactor.services.backend_for(pgid[0])
                reactor.pgs[pgid] = pg
            elif pg.acting != acting:
                pg.acting = acting
                pg.epoch = osdmap.epoch

    # -- map fence ----------------------------------------------------
    def _park_for_map(self, epoch: int, fn) -> None:
        with self._map_waiters_lock:
            self._map_waiters.append((epoch, fn))
            while len(self._map_waiters) > 10000:
                self._map_waiters.pop(0)
        cur = self.osdmap.epoch if self.osdmap else 0
        if cur >= epoch:
            self._drain_map_waiters(cur)

    def _drain_map_waiters(self, epoch: int) -> None:
        with self._map_waiters_lock:
            ready = [f for e, f in self._map_waiters if e <= epoch]
            self._map_waiters = [(e, f) for e, f in self._map_waiters
                                 if e > epoch]
        for f in ready:
            f()

    # -- admission (runs on the messenger loop: route only) -----------
    def _admit_op(self, msg: M.MOSDOp, conn: Connection) -> None:
        osdmap = self.osdmap
        if osdmap is None or msg.epoch > osdmap.epoch:
            self._park_for_map(
                msg.epoch, lambda m=msg, c=conn: self._admit_op(m, c))
            return
        if osdmap.is_blocklisted(msg.client):
            conn.send_message(M.MOSDOpReply(
                tid=msg.tid, code=EBLOCKLISTED, epoch=osdmap.epoch,
                data=b"", version=0))
            return
        if msg.pool not in osdmap.pools:
            conn.send_message(M.MOSDOpReply(
                tid=msg.tid, code=ENOENT, epoch=osdmap.epoch,
                data=b"", version=0))
            return
        ps = osdmap.object_to_pg(msg.pool, msg.oid) \
            if msg.op != M.OSD_OP_LIST else msg.ps
        pgid = (msg.pool, ps)
        self.shard_of(pgid).submit(self._handle_op(pgid, msg, conn))

    def _admit_batch(self, msg: M.MOSDOpBatch, conn: Connection
                     ) -> None:
        osdmap = self.osdmap
        if osdmap is None or msg.epoch > osdmap.epoch:
            self._park_for_map(
                msg.epoch,
                lambda m=msg, c=conn: self._admit_batch(m, c))
            return
        if not len(msg.tids):
            return
        if msg.pool not in osdmap.pools \
                or osdmap.is_blocklisted(msg.client):
            code = EBLOCKLISTED \
                if osdmap.is_blocklisted(msg.client) else ENOENT
            conn.send_message(M.MOSDOpReplyBatch(
                tid=msg.tid, tids=list(msg.tids),
                codes=[code] * len(msg.tids),
                epochs=[osdmap.epoch] * len(msg.tids),
                versions=[0] * len(msg.tids),
                datas=[b""] * len(msg.tids),
                stages=[""] * len(msg.tids)))
            return
        pgid = (msg.pool, int(msg.ps))
        self.shard_of(pgid).submit(
            self._handle_batch(pgid, msg, conn))

    # -- the run-to-completion op path --------------------------------
    async def _handle_op(self, pgid, msg: M.MOSDOp,
                         conn: Connection) -> None:
        reactor = self.shard_of(pgid)
        hops = ["reactor_submit"]
        self.logger.inc("op")
        ft = _flows.flows_if_active()
        if ft is not None and not getattr(msg, "_flow_noted", False):
            # once per op even when the map park re-admits this msg
            msg._flow_noted = True
            try:
                ft.note_op(msg.flow, bytes_in=len(msg.data or b""))
            except Exception:
                pass
        t0 = time.perf_counter()
        cache_key = (msg.client, msg.tid)
        if msg.op in _MUTATING_OPS:
            cached = reactor.op_cache.get(cache_key)
            if cached is not None:
                reactor.queue_ack(conn, self._make_reply(msg, *cached))
                return
            t_adm = reactor.op_inflight.get(cache_key)
            if msg.op == M.OSD_OP_APPEND and t_adm is not None \
                    and time.monotonic() - t_adm < _COMMIT_TIMEOUT:
                # a resend raced the original append's still-running
                # execution: drop it — the original's reply answers
                # this tid, later resends hit the dup cache
                return
            reactor.op_inflight[cache_key] = time.monotonic()
        pg = self._ensure_pg(reactor, pgid, msg)
        if pg is None:
            reactor.op_inflight.pop(cache_key, None)
            reactor.queue_ack(conn, self._make_reply(msg, ESTALE,
                                                     b"", 0))
            return
        reactor.services.sweep_stale_writes(3 * SUBOP_TIMEOUT)
        await reactor.pg_enter(pgid)
        # OrderedExclusivePhase discipline: exclusivity covers the
        # ordering-critical prefix (version alloc + txn/sub-write
        # SUBMISSION, or a RMW's read). Ops hand the sequencer to the
        # next op the moment order is pinned — commit waits and read
        # fan-outs overlap across ops of one PG.
        released = False

        def release() -> None:
            nonlocal released
            if not released:
                released = True
                reactor.pg_exit(pgid)

        try:
            result = await self._execute(reactor, pg, msg, hops,
                                         release)
        except Exception as exc:
            result = (self._errno_for(exc), b"", 0)
        finally:
            release()
        reactor.ops_served += 1
        reactor.op_inflight.pop(cache_key, None)
        if result is _NO_REPLY:
            return                 # commit timed out: client resends
        code, data, version = result
        if msg.op in _MUTATING_OPS and code == 0:
            reactor.cache_op(cache_key, (code, data, version))
        _dsp_tel().note_op_hops(hops)
        if ft is not None:
            try:
                ft.note_op_done(msg.flow, bytes_out=len(data or b""),
                                latency_s=time.perf_counter() - t0)
            except Exception:
                pass
        reactor.queue_ack(conn, self._make_reply(msg, code, data,
                                                 version))

    async def _handle_batch(self, pgid, msg: M.MOSDOpBatch,
                            conn: Connection) -> None:
        """One MOSDOpBatch = N same-PG client writes (the streaming
        objecter's frame). The batch enters its PG ONCE; WRITE_FULL
        entries pipeline through the engine window (submit all, then
        await all — the stripe-batch amortization crimson exists
        for), other ops run in order between pipeline drains. All
        acks coalesce through the per-connection batcher into one
        MOSDOpReplyBatch."""
        reactor = self.shard_of(pgid)
        n = len(msg.tids)
        first = M.MOSDOp(
            tid=msg.tids[0], client=msg.client, epoch=msg.epoch,
            pool=msg.pool, ps=int(msg.ps), oid=msg.oids[0],
            op=msg.ops[0], offset=msg.offsets[0],
            length=msg.lengths[0], data=msg.datas[0])
        pg = self._ensure_pg(reactor, pgid, first)
        if pg is None:
            for i in range(n):
                reactor.queue_ack(conn, M.MOSDOpReply(
                    tid=msg.tids[i], code=ESTALE,
                    epoch=self.osdmap.epoch, data=b"", version=0))
            return
        reactor.services.sweep_stale_writes(3 * SUBOP_TIMEOUT)
        await reactor.pg_enter(pgid)
        released = False

        def release() -> None:
            nonlocal released
            if not released:
                released = True
                reactor.pg_exit(pgid)

        pending: list = []      # (sub, hops, commit fut, version)

        async def drain() -> None:
            for sub, hops, fut, version in pending:
                result = await self._await_commit(fut, version)
                self._finish_batch_entry(reactor, conn, sub, hops,
                                         result)
            pending.clear()

        try:
            for i in range(n):
                sub = M.MOSDOp(
                    tid=msg.tids[i], client=msg.client,
                    epoch=msg.epoch, pool=msg.pool, ps=int(msg.ps),
                    oid=msg.oids[i], op=msg.ops[i],
                    offset=msg.offsets[i], length=msg.lengths[i],
                    data=msg.datas[i],
                    flow=msg.flows[i] if i < len(msg.flows) else "")
                hops = ["reactor_submit"]
                self.logger.inc("op")
                ft = _flows.flows_if_active()
                if ft is not None:
                    try:
                        ft.note_op(sub.flow,
                                   bytes_in=len(sub.data or b""))
                    except Exception:
                        pass
                cache_key = (msg.client, sub.tid)
                if sub.op in _MUTATING_OPS:
                    cached = reactor.op_cache.get(cache_key)
                    if cached is not None:
                        reactor.queue_ack(
                            conn, self._make_reply(sub, *cached))
                        continue
                    t_adm = reactor.op_inflight.get(cache_key)
                    if sub.op == M.OSD_OP_APPEND \
                            and t_adm is not None \
                            and time.monotonic() - t_adm \
                            < _COMMIT_TIMEOUT:
                        continue    # resend racing the original
                    reactor.op_inflight[cache_key] = time.monotonic()
                if sub.op == M.OSD_OP_WRITE_FULL \
                        and pg.backend is not None:
                    # submit NOW (stage into the engine window — the
                    # stripe-batch amortization), await with the rest
                    # of the frame after the sequencer is released
                    self.logger.inc("op_w")
                    fut, version = self._ec_write_submit(
                        reactor, pg, sub, hops)
                    pending.append((sub, hops, fut, version))
                    continue
                await drain()
                try:
                    result = await self._execute(reactor, pg, sub,
                                                 hops, None)
                except Exception as exc:
                    result = (self._errno_for(exc), b"", 0)
                self._finish_batch_entry(reactor, conn, sub, hops,
                                         result)
            # every entry's order is pinned (submitted in frame
            # order): let the next frame into the PG while this one
            # awaits its commits
            release()
            await drain()
        finally:
            release()

    def _finish_batch_entry(self, reactor, conn, sub, hops,
                            result) -> None:
        reactor.ops_served += 1
        cache_key = (sub.client, sub.tid)
        reactor.op_inflight.pop(cache_key, None)
        if result is _NO_REPLY:
            return
        code, data, version = result
        if sub.op in _MUTATING_OPS and code == 0:
            reactor.cache_op(cache_key, (code, data, version))
        _dsp_tel().note_op_hops(hops)
        ft = _flows.flows_if_active()
        if ft is not None:
            try:
                ft.note_op_done(sub.flow,
                                bytes_out=len(data or b""))
            except Exception:
                pass
        reactor.queue_ack(conn, self._make_reply(sub, code, data,
                                                 version))

    def _make_reply(self, msg: M.MOSDOp, code: int, data: bytes,
                    version: int) -> M.MOSDOpReply:
        return M.MOSDOpReply(
            tid=msg.tid, code=code,
            epoch=self.osdmap.epoch if self.osdmap else 0,
            data=bytes(data), version=version)

    def _ensure_pg(self, reactor: Reactor, pgid,
                   msg: M.MOSDOp) -> PG | None:
        """Create-or-get the PG on its owning reactor. Returns None
        when this OSD is not the primary (ESTALE — the client
        refreshes its map and retargets)."""
        pg = reactor.pgs.get(pgid)
        osdmap = self.osdmap
        _, acting, primary = osdmap.pg_to_up_acting(pgid[0], pgid[1])
        if primary != self.whoami:
            return None
        if pg is None:
            pg = PG(pgid[0], pgid[1])
            pg.acting = list(acting)
            pg.epoch = osdmap.epoch
            pg.state = PG.ACTIVE
            pool = osdmap.pools[pgid[0]]
            if pool.is_ec:
                pg.backend = reactor.services.backend_for(pgid[0])
            reactor.pgs[pgid] = pg
        elif pg.acting != list(acting):
            pg.acting = list(acting)
            pg.epoch = osdmap.epoch
        return pg

    @staticmethod
    def _errno_for(exc: Exception) -> int:
        if isinstance(exc, NoSuchObject):
            return ENOENT
        if isinstance(exc, ECReadError):
            return EAGAIN
        if isinstance(exc, StoreError):
            return ENOENT
        log(1, f"crimson op failed: {exc!r}")
        return EINVAL

    # -- op execution (on the owning reactor, between awaits) ---------
    async def _execute(self, reactor: Reactor, pg: PG, msg: M.MOSDOp,
                       hops: list, release=None):
        if pg.backend is not None:
            return await self._execute_ec(reactor, pg, msg, hops,
                                          release)
        return await self._execute_flat(reactor, pg, msg)

    async def _execute_ec(self, reactor: Reactor, pg: PG,
                          msg: M.MOSDOp, hops: list, release=None):
        """``release`` hands the PG sequencer to the next op once THIS
        op's place in the apply order is pinned: a WRITE_FULL after
        submission, a READ immediately (it orders against committed
        state via the version ladder, like the threaded read path).
        RMW ops (WRITE/APPEND) and existence-checked mutations never
        release early — their read must not interleave with a racing
        write's commit window (the lost-update hazard the threaded
        OSD only papers over with the racing-resend drop)."""
        svc = reactor.services
        be: ECBackend = pg.backend
        op = msg.op
        if op == M.OSD_OP_WRITE_FULL:
            self.logger.inc("op_w")
            return await self._ec_write_full(reactor, pg, msg, hops,
                                             release=release)
        if op in (M.OSD_OP_WRITE, M.OSD_OP_APPEND):
            # RMW as read-splice-writefull on the owning reactor (the
            # per-PG sequencer serializes it against racing writes)
            self.logger.inc("op_w")
            try:
                cur, _ = await readpath.read_object(svc, be, pg,
                                                    msg.oid)
            except NoSuchObject:
                cur = b""
            off = len(cur) if op == M.OSD_OP_APPEND else msg.offset
            if off > len(cur):
                cur = cur + b"\x00" * (off - len(cur))
            new = cur[:off] + bytes(msg.data) \
                + cur[off + len(msg.data):]
            return await self._ec_write_full(reactor, pg, msg, hops,
                                             data=new)
        if op == M.OSD_OP_READ:
            self.logger.inc("op_r")
            if release:
                release()
            data, version = await readpath.read_object(svc, be, pg,
                                                       msg.oid)
            if msg.length:
                data = data[msg.offset:msg.offset + msg.length]
            elif msg.offset:
                data = data[msg.offset:]
            return 0, data, version
        if op == M.OSD_OP_STAT:
            if release:
                release()
            attrs = await readpath.object_attrs(svc, be, pg, msg.oid)
            size = be._attr_size(attrs)
            version = int.from_bytes(attrs.get("v", b""), "little")
            return 0, json.dumps({"size": size}).encode(), version
        if op == M.OSD_OP_REMOVE:
            await readpath.object_attrs(svc, be, pg, msg.oid)
            return await self._ec_mutate(
                reactor, pg, hops,
                lambda version, on_commit: be.submit_remove(
                    pg, msg.oid, version, on_commit),
                flow=msg.flow)
        if op == M.OSD_OP_CREATE:
            try:
                await readpath.object_attrs(svc, be, pg, msg.oid)
                if msg.xop == 1:
                    return EEXIST, b"", 0
                return 0, b"", 0
            except NoSuchObject:
                pass
            return await self._ec_write_full(reactor, pg, msg, hops,
                                             data=b"")
        if op == M.OSD_OP_SETXATTR:
            return await self._ec_mutate(
                reactor, pg, hops,
                lambda version, on_commit: be.submit_setattrs(
                    pg, msg.oid, {msg.xname: bytes(msg.data)}, [],
                    version, on_commit),
                flow=msg.flow)
        if op == M.OSD_OP_RMXATTR:
            return await self._ec_mutate(
                reactor, pg, hops,
                lambda version, on_commit: be.submit_setattrs(
                    pg, msg.oid, {}, [msg.xname], version,
                    on_commit),
                flow=msg.flow)
        if op == M.OSD_OP_GETXATTR:
            if release:
                release()
            attrs = await readpath.object_attrs(svc, be, pg, msg.oid)
            version = int.from_bytes(attrs.get("v", b""), "little")
            val = user_xattrs(attrs).get(msg.xname)
            if val is None:
                return ENODATA, b"", version
            return 0, val, version
        if op == M.OSD_OP_GETXATTRS:
            if release:
                release()
            attrs = await readpath.object_attrs(svc, be, pg, msg.oid)
            version = int.from_bytes(attrs.get("v", b""), "little")
            out = {k: v.hex() for k, v in user_xattrs(attrs).items()}
            return 0, json.dumps(out).encode(), version
        if op == M.OSD_OP_LIST:
            mypos = be.my_position(pg)
            cid = pg_cid(pg.pool, pg.ps, mypos if mypos >= 0 else 0)
            try:
                oids = sorted(
                    o for o in reactor.store.list_objects(cid)
                    if o != PGMETA and SNAP_SEP not in o)
            except StoreError:
                oids = []
            return 0, json.dumps(oids).encode(), 0
        if op in (M.OSD_OP_OMAPGET, M.OSD_OP_OMAPSET,
                  M.OSD_OP_OMAPRMKEYS, M.OSD_OP_OMAPGETKEYS,
                  M.OSD_OP_OMAPGETHEADER, M.OSD_OP_OMAPSETHEADER):
            return EOPNOTSUPP, b"", 0
        return EINVAL, b"", 0

    def _ec_write_submit(self, reactor: Reactor, pg: PG,
                         msg: M.MOSDOp, hops: list,
                         data: bytes | None = None):
        """The synchronous half of the mainline EC write: version
        alloc + encode staged into the engine window + fan-out armed
        via the ECBackend's flush-group batching. Returns the commit
        future + version; once this returns, the op's place in the
        per-shard apply order is fixed."""
        be: ECBackend = pg.backend
        payload = bytes(msg.data) if data is None else data
        fut = reactor.loop.create_future()

        def on_commit(code: int) -> None:
            # may fire on a store/engine thread for durable stores;
            # always resolve on the owning reactor (inline when the
            # completion swept there — the common case)
            reactor.call(lambda: fut.done() or fut.set_result(code))

        # flow context installed for the SYNCHRONOUS submit half only:
        # engine staging + sub-write fan-out self-
        # attribute; scoping across awaits would leak the label onto
        # interleaved coroutines of this run-to-completion reactor
        with _flows.flow_scope(msg.flow):
            with pg.lock:
                version = pg.alloc_version()
                be.submit_write(pg, msg.oid, payload, version,
                                on_commit)
        if be.device is not None:
            hops += ["engine_stage", "reactor_submit"]
        if len(be.up_positions(pg)) > 1:
            hops += ["msgr_send"]
        return fut, version

    async def _ec_write_full(self, reactor: Reactor, pg: PG,
                             msg: M.MOSDOp, hops: list,
                             data: bytes | None = None,
                             release=None):
        """The mainline EC write, run to completion: submit, hand the
        sequencer to the next op, await every shard's commit, ack."""
        fut, version = self._ec_write_submit(reactor, pg, msg, hops,
                                             data)
        if release:
            release()
        return await self._await_commit(fut, version)

    async def _ec_mutate(self, reactor: Reactor, pg: PG, hops: list,
                         submit, flow: str = "") -> tuple:
        be: ECBackend = pg.backend
        fut = reactor.loop.create_future()

        def on_commit(code: int) -> None:
            reactor.call(lambda: fut.done() or fut.set_result(code))

        with _flows.flow_scope(flow):
            with pg.lock:
                version = pg.alloc_version()
                submit(version, on_commit)
        if be.device is not None:
            hops += ["engine_stage", "reactor_submit"]
        if len(be.up_positions(pg)) > 1:
            hops += ["msgr_send"]
        return await self._await_commit(fut, version)

    async def _await_commit(self, fut, version: int):
        try:
            code = await asyncio.wait_for(fut, _COMMIT_TIMEOUT)
        except asyncio.TimeoutError:
            # a shard ack never came (dropped frame / dead peer): do
            # NOT ack, do NOT wedge the sequencer — the client's
            # resend re-executes at a fresh version and the stale
            # InflightWrite sweep unpins the abandoned one
            log(1, f"crimson: commit wait timed out at v{version}")
            return _NO_REPLY
        return code, b"", version

    # -- flat (replicated size-1) pools: the prototype scenarios ------
    async def _execute_flat(self, reactor: Reactor, pg: PG,
                            msg: M.MOSDOp):
        store = reactor.store
        cid = pg_cid(pg.pool, pg.ps, NO_SHARD)
        op = msg.op

        async def commit(txn: Transaction) -> None:
            fut = reactor.loop.create_future()
            store.queue_transaction(
                txn, lambda: reactor.call(
                    lambda: fut.done() or fut.set_result(0)))
            await asyncio.wait_for(fut, _COMMIT_TIMEOUT)

        def attrs_of(oid: str) -> dict[str, bytes] | None:
            try:
                return store.getattrs(cid, oid)
            except StoreError:
                return None

        if op in (M.OSD_OP_WRITE_FULL, M.OSD_OP_APPEND,
                  M.OSD_OP_WRITE):
            self.logger.inc("op_w")
            with pg.lock:
                version = pg.alloc_version()
            if op == M.OSD_OP_WRITE_FULL:
                new = bytes(msg.data)
            else:
                try:
                    cur = store.read(cid, msg.oid)
                except StoreError:
                    cur = b""
                off = len(cur) if op == M.OSD_OP_APPEND \
                    else msg.offset
                if off > len(cur):
                    cur = cur + b"\x00" * (off - len(cur))
                new = cur[:off] + bytes(msg.data) \
                    + cur[off + len(msg.data):]
            await commit(object_write_txn(cid, msg.oid, new, version))
            return 0, b"", version
        if op == M.OSD_OP_READ:
            self.logger.inc("op_r")
            attrs = attrs_of(msg.oid)
            if attrs is None:
                return ENOENT, b"", 0
            data = store.read(cid, msg.oid)
            version = int.from_bytes(attrs.get("v", b""), "little")
            if msg.length:
                data = data[msg.offset:msg.offset + msg.length]
            elif msg.offset:
                data = data[msg.offset:]
            return 0, data, version
        if op == M.OSD_OP_STAT:
            attrs = attrs_of(msg.oid)
            if attrs is None:
                return ENOENT, b"", 0
            version = int.from_bytes(attrs.get("v", b""), "little")
            return 0, json.dumps(
                {"size": store.stat(cid, msg.oid)}).encode(), version
        if op == M.OSD_OP_REMOVE:
            if attrs_of(msg.oid) is None:
                return ENOENT, b"", 0
            with pg.lock:
                version = pg.alloc_version()
            txn = Transaction()
            txn.remove(cid, msg.oid)
            await commit(txn)
            return 0, b"", version
        if op == M.OSD_OP_SETXATTR:
            with pg.lock:
                version = pg.alloc_version()
            txn = Transaction()
            txn.create_collection(cid)
            txn.touch(cid, msg.oid)
            txn.setattr(cid, msg.oid, USER_XATTR + msg.xname,
                        bytes(msg.data))
            txn.setattr(cid, msg.oid, "v",
                        version.to_bytes(8, "little"))
            await commit(txn)
            return 0, b"", version
        if op == M.OSD_OP_GETXATTR:
            attrs = attrs_of(msg.oid)
            if attrs is None:
                return ENOENT, b"", 0
            version = int.from_bytes(attrs.get("v", b""), "little")
            val = user_xattrs(attrs).get(msg.xname)
            if val is None:
                return ENODATA, b"", version
            return 0, val, version
        if op == M.OSD_OP_LIST:
            try:
                oids = sorted(o for o in store.list_objects(cid)
                              if o != PGMETA and SNAP_SEP not in o)
            except StoreError:
                oids = []
            return 0, json.dumps(oids).encode(), 0
        return EINVAL, b"", 0

    # -- replica side: serve sub-ops on the owning reactor ------------
    def _serve_sub_write(self, msg: M.MECSubWrite,
                         conn: Connection) -> None:
        reactor = self.shard_of((msg.pool, int(msg.ps)))

        def apply() -> None:
            txn = Transaction.decode(msg.txn_bytes)
            self.logger.inc("subop_w")
            ft = _flows.flows_if_active()
            if ft is not None:
                try:
                    ft.note_store_txn(msg.flow, len(msg.txn_bytes))
                except Exception:
                    pass

            def committed() -> None:
                conn.send_message(M.MECSubWriteReply(
                    tid=msg.tid, pool=msg.pool, ps=msg.ps,
                    shard=msg.shard, committed=True,
                    version=msg.version))

            reactor.store.queue_transaction(txn, committed)

        reactor.call(apply)

    def _serve_sub_write_batch(self, msg: M.MECSubWriteBatch,
                               conn: Connection) -> None:
        """One frame = every sub-write of one peer engine flush.
        Entries group by contained PG onto their owning reactors;
        each reactor applies its group as ONE store txn group, and
        the LAST entry committed (cross-reactor counter under a brief
        lock — reply assembly state, not PG state) acks every
        contained tid in ONE MECSubWriteBatchReply."""
        n = len(msg.tids)
        groups: dict = {}
        for i in range(n):
            groups.setdefault((msg.pools[i], int(msg.pss[i])),
                              []).append(i)
        state = {"left": n,
                 "lock": make_lock("crimson.subwrite_batch")}

        def apply_group(reactor: Reactor, idxs: list[int]) -> None:
            pairs = []
            ft = _flows.flows_if_active()
            for i in idxs:
                txn = Transaction.decode(msg.txns[i])
                self.logger.inc("subop_w")
                if ft is not None:
                    try:
                        # per-entry wire flow: one frame, many tenants
                        ft.note_store_txn(
                            msg.flows[i] if i < len(msg.flows)
                            else "", len(msg.txns[i]))
                    except Exception:
                        pass

                def entry_committed(i=i) -> None:
                    with state["lock"]:
                        state["left"] -= 1
                        last = state["left"] == 0
                    if last:
                        conn.send_message(M.MECSubWriteBatchReply(
                            tid=msg.tid, committed=True,
                            tids=list(msg.tids),
                            pools=list(msg.pools),
                            pss=list(msg.pss),
                            shards=list(msg.shards),
                            versions=list(msg.versions)))

                pairs.append((txn, entry_committed))
            if len(pairs) > 1:
                reactor.store.queue_transaction_group(pairs)
            else:
                reactor.store.queue_transaction(*pairs[0])

        self.logger.inc("subwrite_batches")
        self.logger.hinc("subwrite_batch_size", n)
        for pgid, idxs in groups.items():
            reactor = self.shard_of(pgid)
            reactor.call(apply_group, reactor, idxs)

    def _route_sub_write_batch_reply(
            self, msg: M.MECSubWriteBatchReply) -> None:
        """One batched ack = N singleton completions, each routed to
        its PG's owning reactor (grouped: one hop per reactor per
        frame, then the completions sweep inline)."""
        groups: dict = {}
        for i in range(len(msg.tids)):
            pgid = (msg.pools[i], int(msg.pss[i]))
            groups.setdefault(pgid, []).append(
                (msg.tids[i], int(msg.shards[i])))

        for pgid, entries in groups.items():
            reactor = self.shard_of(pgid)

            def sweep(reactor=reactor, entries=entries) -> None:
                for tid, shard in entries:
                    self._complete_sub_write(reactor, tid, shard)

            reactor.call(sweep)

    def _complete_sub_write(self, reactor: Reactor, tid: int,
                            shard: int) -> None:
        """Runs ON the owning reactor: the inflight table is reactor-
        local and on_all_commit resumes the op's coroutine inline —
        the run-to-completion commit reply, no wq re-enqueue."""
        iw = reactor.services._inflight.get(tid)
        if iw is None:
            return
        if iw.complete(shard):
            reactor.services._inflight.pop(tid, None)
            iw.on_all_commit()

    def _serve_sub_read(self, msg: M.MECSubRead,
                        conn: Connection) -> None:
        reactor = self.shard_of((msg.pool, int(msg.ps)))

        def serve() -> None:
            osdmap = self.osdmap
            pool = osdmap.pools.get(msg.pool) if osdmap else None
            shard = msg.shard if (pool is not None and pool.is_ec) \
                else NO_SHARD
            cid = pg_cid(msg.pool, int(msg.ps), shard)
            conn.send_message(
                ECBackend.serve_sub_read(reactor.store, msg, cid))

        reactor.call(serve)

    def _resolve_read_wait(self, reactor: Reactor,
                           msg: M.MECSubReadReply) -> None:
        fut = reactor.read_waits.pop((msg.tid, int(msg.shard)), None)
        if fut is not None and not fut.done():
            fut.set_result(msg)

    # -- introspection -------------------------------------------------
    def shard_stats(self) -> list[dict]:
        out = []
        for r in self.reactors:
            try:
                colls = r.store.list_collections()
            except Exception:
                colls = []
            out.append({"reactor": r.idx, "pgs": len(r.pgs),
                        "collections": len(colls),
                        "ops": r.ops_served})
        return out
