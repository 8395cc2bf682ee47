"""Reactor + per-shard services — crimson's shared-nothing core.

One :class:`Reactor` is one seastar shard: an asyncio event loop on
its own thread owning a disjoint set of PGs, a REAL per-shard
:class:`ObjectStore`, and every piece of mutable per-op state those
PGs touch — dup-op cache, inflight-write table, read-wait table, the
reply batcher. Nothing here is ever touched from two threads: work
arrives only through :meth:`Reactor.submit` (coroutines) or
:meth:`Reactor.call` (plain fns), both of which run INLINE when the
caller is already the owning reactor — the run-to-completion rule
that makes ``wq_continuation`` hops structurally zero. Every genuine
cross-thread crossing is counted on the ``reactor_submit`` dispatch
seam, so gap_report can compare hop counts honestly against the
threaded OSD.

:class:`ReactorServices` is the per-shard ``pg_backend.Listener``
implementation the MAINLINE ``ECBackend`` programs against: same
fan-out, same wire messages, same group-commit store calls — but
every completion is routed back to the owning reactor instead of a
work queue, and the device engine's continuations dispatch straight
onto the reactor loop (the engine window is the only async boundary).
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque

from ceph_tpu_torch.osd import device_engine as _dev_engine
from ceph_tpu_torch.store.object_store import group_commit_enabled
from ceph_tpu_torch.utils.dispatch_telemetry import telemetry as _dsp_tel
from ceph_tpu_torch.utils import flow_telemetry as _flow_tel
from ceph_tpu_torch.utils.dout import Dout

log = Dout("crimson")

#: applied mutating-op replies remembered per reactor for wire resends
OP_CACHE_MAX = 1024


class Reactor:
    """One shared-nothing core: an event loop + its shard's PGs +
    its shard's store and op-state tables."""

    def __init__(self, idx: int, osd) -> None:
        self.idx = idx
        self.osd = osd
        self.loop = asyncio.new_event_loop()
        self.store = osd._make_shard_store(idx)
        #: pgid -> PG; only this reactor creates or reads entries
        #: mid-op (the OSD's ``pgs`` property snapshots for tests)
        self.pgs: dict[tuple[int, int], object] = {}
        #: per-PG op sequencers (OrderedExclusivePhase role): a deque
        #: of waiter futures keeps ops of one PG in arrival order
        self._pg_seq: dict[tuple[int, int], deque] = {}
        self.ops_served = 0
        #: (client, tid) -> (code, data, version) for applied
        #: mutating ops — a resent frame re-ships the SAME reply
        #: instead of double-applying (threaded _op_cache role)
        self.op_cache: dict[tuple, tuple] = {}
        self._op_cache_order: deque = deque()
        #: (client, tid) -> admission monotonic time while executing
        self.op_inflight: dict[tuple, float] = {}
        #: tid -> asyncio future for MECSubReadReply fan-in
        self.read_waits: dict[int, asyncio.Future] = {}
        #: conn id -> (conn, [MOSDOpReply]) — the reply batcher
        self._pending_acks: dict[int, tuple] = {}
        self._ack_scheduled = False
        self.services = ReactorServices(self, osd)
        self._thread = threading.Thread(
            target=self._run,
            name=f"crimson-reactor-{osd.whoami}.{idx}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def on_loop(self) -> bool:
        return threading.current_thread() is self._thread

    def submit(self, coro) -> None:
        """submit_to(shard, coroutine) — how an op enters its owning
        reactor. Always a cross-thread hop (the messenger loop only
        parses and forwards), counted on the ``reactor_submit``
        seam."""
        t0 = time.monotonic()

        async def entry():
            _dsp_tel().note_handoff(
                "reactor_submit", time.monotonic() - t0)
            await coro

        asyncio.run_coroutine_threadsafe(entry(), self.loop)

    def call(self, fn, *args) -> None:
        """Run ``fn(*args)`` on this reactor: INLINE when the caller
        already is this reactor (the run-to-completion rule — engine
        continuations and local commit sweeps never re-enqueue), one
        counted ``reactor_submit`` hop otherwise."""
        if self.on_loop():
            fn(*args)
            return
        t0 = time.monotonic()

        def run():
            _dsp_tel().note_handoff(
                "reactor_submit", time.monotonic() - t0)
            fn(*args)

        self.loop.call_soon_threadsafe(run)

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)
        try:
            self.store.umount()
        except Exception:
            pass

    # -- per-PG ordering ----------------------------------------------
    async def pg_enter(self, pgid) -> None:
        q = self._pg_seq.setdefault(pgid, deque())
        if not q:
            q.append(None)            # running marker, no waiters
            return
        fut = self.loop.create_future()
        q.append(fut)
        await fut

    def pg_exit(self, pgid) -> None:
        q = self._pg_seq.get(pgid)
        q.popleft()
        if q:
            nxt = q[0]
            if nxt is not None:
                nxt.set_result(None)
                q[0] = None           # promoted to running marker
        else:
            self._pg_seq.pop(pgid, None)

    # -- dup-op cache (reactor-local: a PG's ops always land here) ----
    def cache_op(self, key: tuple, reply: tuple) -> None:
        if key not in self.op_cache:
            self._op_cache_order.append(key)
            while len(self._op_cache_order) > OP_CACHE_MAX:
                self.op_cache.pop(self._op_cache_order.popleft(), None)
        self.op_cache[key] = reply

    # -- the reply batcher --------------------------------------------
    def queue_ack(self, conn, reply) -> None:
        """Batch commit replies per client connection: the first ack
        of a completion sweep schedules ONE drain behind the ready
        callbacks, so every op retired by the same engine flush (or
        the same reply frame) ships home in one MOSDOpReplyBatch —
        one wakeup per connection per flush, not one per op."""
        ent = self._pending_acks.get(id(conn))
        if ent is None:
            ent = self._pending_acks[id(conn)] = (conn, [])
        ent[1].append(reply)
        if not self._ack_scheduled:
            self._ack_scheduled = True
            self.loop.call_soon(self._drain_acks)

    def _drain_acks(self) -> None:
        from ceph_tpu_torch.parallel import messages as M
        self._ack_scheduled = False
        pending, self._pending_acks = self._pending_acks, {}
        for conn, replies in pending.values():
            if len(replies) == 1:
                out = replies[0]
            else:
                out = M.MOSDOpReplyBatch(
                    tid=replies[0].tid,
                    tids=[r.tid for r in replies],
                    codes=[r.code for r in replies],
                    epochs=[r.epoch for r in replies],
                    versions=[r.version for r in replies],
                    datas=[r.data for r in replies],
                    stages=[r.stages for r in replies])
            # Connection.send_message is thread-safe (it submits to
            # the messenger loop) — the socket is never touched here
            try:
                conn.send_message(out)
            except Exception as exc:
                log(1, f"crimson ack send failed: {exc!r}")


class ReactorServices:
    """The per-shard ``pg_backend.Listener`` the mainline EC write
    pipeline runs against. One instance per reactor; its inflight /
    wait tables are reactor-local (completions are ROUTED to the
    owning reactor before they touch them), so they need no locks —
    the shared-nothing bet, kept honest by the ``reactor_affinity``
    lint and the lock witness."""

    def __init__(self, reactor: Reactor, osd) -> None:
        self.reactor = reactor
        self.osd = osd
        self.whoami = osd.whoami
        self.store = reactor.store
        self.logger = osd.logger
        #: tid -> InflightWrite (reactor-local, no lock)
        self._inflight: dict[int, object] = {}
        #: tid -> SubOpWait (Listener protocol; the crimson read path
        #: uses reactor.read_waits futures instead)
        self._waits: dict[int, object] = {}
        self._backends: dict[int, object] = {}
        self._engine = None
        self._last_sweep = time.monotonic()

    # -- Listener protocol --------------------------------------------
    def get_osdmap(self):
        return self.osd.osdmap

    def new_tid(self) -> int:
        return self.osd.new_tid()

    def send_osd(self, osd: int, msg) -> None:
        self.osd.send_osd(osd, msg)

    def register_write(self, iw) -> None:
        self._inflight[iw.tid] = iw

    def register_wait(self, tid: int, wait) -> None:
        self._waits[tid] = wait

    def unregister_wait(self, tid: int) -> None:
        self._waits.pop(tid, None)

    def queue_local_txn(self, txn, on_commit) -> None:
        # flow attribution happens HERE, while the submitter's flow
        # context is still installed — the deferred reactor.call runs
        # after the scope closed
        self._note_txn_flow(txn)
        self.reactor.call(self.store.queue_transaction, txn, on_commit)

    @staticmethod
    def _note_txn_flow(txn) -> None:
        """Charge a store txn's payload bytes to its flow.
        A label stamped on the txn at defer time (the engine flush-
        group local leg) wins over the reactor thread's context —
        group ship runs flow-less."""
        ft = _flow_tel.flows_if_active()
        if ft is None:
            return
        try:
            label = getattr(txn, "_flow", None)
            if label is None:
                label = _flow_tel.current_flow() or ""
            ft.note_store_txn(label, _flow_tel.txn_nbytes(txn))
        except Exception:
            pass

    def queue_local_txn_group(self, pairs) -> None:
        """One engine flush's local txns as ONE store group — the store's
        ``queue_transaction_group`` (shared leader-follower barrier
        rounds on durable stores), applied on the owning reactor. The
        FlushGroup may ship from whichever reactor finished last, so
        this routes: one counted hop at worst, then commit callbacks
        sweep inline."""
        for txn, _cb in pairs:
            self._note_txn_flow(txn)

        def apply():
            if len(pairs) > 1 and group_commit_enabled():
                self.store.queue_transaction_group(pairs)
            else:
                for txn, cb in pairs:
                    self.store.queue_transaction(txn, cb)
        self.reactor.call(apply)

    def device_engine(self):
        """Attach to the process-shared device engine with a
        dispatcher that resumes continuations ON the owning reactor —
        no work queue between engine retire and commit fan-out."""
        if self._engine is None:
            self._engine = _dev_engine.shared_engine_attach(
                self._engine_dispatch,
                flush_bytes=self.osd.flush_bytes)
        return self._engine

    def _engine_dispatch(self, _key, fn) -> None:
        self.reactor.call(fn)

    def detach_engine(self) -> None:
        if self._engine is not None:
            try:
                self._engine.stop()
            except Exception:
                pass
            self._engine = None

    # -- crimson extras -----------------------------------------------
    def backend_for(self, pool_id: int):
        be = self._backends.get(pool_id)
        if be is None:
            from ceph_tpu_torch.osd.ec_backend import ECBackend
            pool = self.get_osdmap().pools[pool_id]
            be = ECBackend(self, pool)
            self._backends[pool_id] = be
        return be

    def sweep_stale_writes(self, max_age: float) -> None:
        """Expire inflight writes whose shard acks never arrived
        (dropped frames under msgr faults): unpins their extent-cache
        entries so the table stays bounded. Runs on the reactor at
        admission, amortized to one scan per timeout window."""
        now = time.monotonic()
        if now - self._last_sweep < max_age:
            return
        self._last_sweep = now
        for tid, iw in list(self._inflight.items()):
            if now - iw.created_at > max_age:
                self._inflight.pop(tid, None)
                try:
                    iw.expire()
                except Exception:
                    pass
