"""OSD daemon — distributed object service (src/osd/OSD.{h,cc} role).

Wiring mirrors the reference (collapsed from 7 messengers to 1):
messenger fast-dispatch (OSD::ms_fast_dispatch, OSD.cc:6728) routes
every message either to the mon client, to tid-routed completion
(sub-op replies), or onto the sharded op queue (op_shardedwq role,
OSD.cc:2095): N worker threads, ops hashed by pgid so one PG's ops
stay ordered on one worker (enqueue_op :9271 -> dequeue_op :9324).

Primary-side PG flow: an MOSDOp creates/looks up the PG, which peers
(query shards -> choose authority -> compute per-shard missing;
the statechart of PG.h:1831+ collapsed to CREATED/PEERING/ACTIVE)
and then executes ops through its PGBackend (ReplicatedBackend or
ECBackend, built per pool like build_pg_backend, PGBackend.cc:532-569).
Recovery runs behind ACTIVE (async recovery): reconstruct + push, then
a log-sync txn marks the shard caught up.

Failure detection: periodic MPing to every up peer
(handle_osd_ping role, OSD.cc:4642); silent peers past the grace are
reported to the mon, which needs two reporters or beacon silence to
mark the OSD down (OSDMonitor semantics). Beacons ride MOSDAlive.
"""

from __future__ import annotations

import collections
import json
import threading
import time

from ceph_tpu_torch.analysis.lock_witness import (
    make_condition, make_lock, make_rlock)
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.ec_backend import ECBackend
from ceph_tpu_torch.osd.pg import (
    LOG_REMOVE,
    NO_SHARD,
    PG,
    PGMETA,
    LogEntry,
    PGLog,
    pg_cid,
    read_shard_info,
)
from ceph_tpu_torch.osd.pg_backend import (
    SUBOP_TIMEOUT,
    InflightWrite,
    PGBackend,
    ReplicatedBackend,
    SubOpWait,
    object_write_txn,
)
from ceph_tpu_torch.parallel import messages as M
from ceph_tpu_torch.parallel.messenger import Connection, Messenger
from ceph_tpu_torch.parallel.mon_client import MonClient
from ceph_tpu_torch.parallel.osdmap import OSDMap
from ceph_tpu_torch.store.object_store import (
    NoSuchCollection,
    NoSuchObject,
    ObjectStore,
    StoreError,
    Transaction,
    group_commit_enabled,
)
from ceph_tpu_torch.utils.admin_socket import (
    AdminSocket,
    register_common_commands,
)
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.utils import stage_clock, tracing
from ceph_tpu_torch.utils import profiler as _prof
from ceph_tpu_torch.utils.dataplane import dataplane
from ceph_tpu_torch.utils.msgr_telemetry import telemetry as _msgr_telemetry
from ceph_tpu_torch.utils import store_telemetry as _store_telemetry
from ceph_tpu_torch.utils import dispatch_telemetry as _dsp
from ceph_tpu_torch.utils import flow_telemetry as _flows
from ceph_tpu_torch.utils.optracker import OpTracker
from ceph_tpu_torch.utils.perf_counters import PerfCounters, collection

log = Dout("osd")

# static tracepoints (src/tracing/{osd,oprequest}.tp role): declared
# at import like a compiled-in provider; near-zero cost when disabled
from ceph_tpu_torch.utils import tracepoints as _tracepoints  # noqa: E402

_TP_OP_DEQUEUE = _tracepoints.provider("oprequest").point(
    "op_dequeue", "oid", "op", "client")
_TP_OP_REPLY = _tracepoints.provider("oprequest").point(
    "op_reply", "oid", "code", "lat_us")
_TP_RECOVERY_PUSH = _tracepoints.provider("osd").point(
    "recovery_push", "oid", "shard", "version")

# errno-style codes carried in MOSDOpReply.code
EAGAIN = -11
EIO = -5
ENOENT = -2
ESTALE = -116
EINVAL = -22
EEXIST = -17
ENODATA = -61
EOPNOTSUPP = -95
ECANCELED = -125
#: the fencing rejection (the reference's EBLACKLISTED, 108): the
#: sending client instance is blocklisted in the osdmap — its ops
#: must never land (src/osd/OSDMap.h:561 enforcement at admission)
EBLOCKLISTED = -108

#: separator for internal snapshot companion objects (clone bodies
#: and snapset metadata live as ordinary versioned/recoverable
#: objects next to the head; the separator is outside the client
#: namespace and PGLS filters it)
SNAP_SEP = "\x1e"

#: wq-worker marker (group commit, ROADMAP 1a): local store commits
#: issued FROM a wq item may defer their barrier to the worker's
#: end-of-item drain (prompt, lock-free); commits from other threads
#: (scrub, asok, tests) keep the inline barrier
_wq_tls = threading.local()


def _on_wq_thread() -> bool:
    return getattr(_wq_tls, "active", False)


def snap_clone_oid(oid: str, snapid: int) -> str:
    return f"{oid}{SNAP_SEP}{snapid:016x}"


def snapset_oid(oid: str) -> str:
    return f"{oid}{SNAP_SEP}ss"


#: reserved omap key carrying the OMAP HEADER (the reference keeps the
#: header in its own kv row; riding a reserved key lets recovery,
#: scrub and EC-rejection apply unchanged). Filtered from every
#: key/value listing the client sees.
OMAP_HDR_KEY = "\x00hdr"


#: QoS classes of the sharded queue (the reference's op classes:
#: client ops vs recovery vs scrub, src/osd/OSD.cc:2095 + dmclock)
QOS_CLIENT = "client"
QOS_RECOVERY = "recovery"
QOS_SCRUB = "scrub"


class _WQShard:
    """One worker's weighted-priority queues (the WPQ seat of the
    reference's mClock/WPQ sharded queue)."""

    __slots__ = ("cv", "queues", "credits")

    def __init__(self, weights: dict[str, int]) -> None:
        self.cv = make_condition("osd.wq_shard")
        self.queues = {cls: collections.deque() for cls in weights}
        self.credits = dict(weights)


class _MClockShard:
    """One worker's dmclock state (src/dmclock + osd_op_queue=
    mclock_* role): per class a (reservation ρ, weight w, limit λ)
    triple and three tag clocks. Each enqueue stamps the item with

        R = max(now, R_prev + 1/ρ)   (reservation clock; ∞ if ρ=0)
        P = max(now, P_prev + 1/w)   (proportional clock)
        L = max(now, L_prev + 1/λ)   (limit clock; item INELIGIBLE
                                      before its L — λ=0 means none)

    and dequeue serves (1) the smallest R-tag at or past now — the
    RESERVATION phase, which is what turns 'recovery still trickles'
    into 'recovery gets ≥ρ ops/s, guaranteed'; else (2) the smallest
    P-tag among classes whose head is limit-eligible; else sleeps to
    the earliest R/L tag. That is the dual-clock guarantee/limit
    structure WPQ's proportional shares cannot express."""

    __slots__ = ("cv", "queues", "clocks", "profile")

    def __init__(self, profile: dict[str, tuple]) -> None:
        self.cv = make_condition("osd.wq_shard")
        self.profile = dict(profile)
        #: cls -> deque of (r_tag, p_tag, l_tag, fn)
        self.queues = {cls: collections.deque() for cls in profile}
        #: cls -> [last_r, last_p, last_l]
        self.clocks = {cls: [0.0, 0.0, 0.0] for cls in profile}

    def stamp(self, cls: str, fn) -> None:
        res, wgt, lim = self.profile[cls]
        now = time.monotonic()
        ck = self.clocks[cls]
        r = max(now, ck[0] + 1.0 / res) if res > 0 else float("inf")
        p = max(now, ck[1] + 1.0 / max(wgt, 1e-9))
        li = max(now, ck[2] + 1.0 / lim) if lim > 0 else 0.0
        if res > 0:
            ck[0] = r
        ck[1] = p
        if lim > 0:
            ck[2] = li
        self.queues[cls].append((r, p, li, fn))

    def pick(self, pace: bool = True):
        """(fn, None) when runnable now, (None, wake_at) when only
        future-eligible work exists, (None, None) when empty.
        ``pace=False`` (drain/shutdown): serve any head immediately,
        ignoring reservation/limit clocks — a limited backlog must
        not outlive the daemon and race its store teardown."""
        now = time.monotonic()
        if not pace:
            for q in self.queues.values():
                if q:
                    return q.popleft()[3], None
            return None, None
        best_r = best_p = None
        wake = None
        for cls, q in self.queues.items():
            if not q:
                continue
            r, p, li, _fn = q[0]
            if r <= now:
                if best_r is None or r < best_r[0]:
                    best_r = (r, cls)
            if li <= now:
                if best_p is None or p < best_p[0]:
                    best_p = (p, cls)
            else:
                wake = li if wake is None else min(wake, li)
            if r != float("inf"):
                wake = r if wake is None else min(wake, r)
        choice = best_r or best_p
        if choice is not None:
            return self.queues[choice[1]].popleft()[3], None
        return None, wake


class ShardedOpWQ:
    """The sharded op queue (OSD.cc:2095): work is hashed by pgid onto
    one of N worker threads, giving per-PG ordering with cross-PG
    parallelism. Within a shard, classes share the worker by weighted
    round-robin (WPQ semantics, options.cc osd_client_op_priority=63
    vs osd_recovery_op_priority=3): under client load recovery still
    trickles (never starves) but cannot crowd out client latency —
    the property the reference gets from its mClock/WPQ queue."""

    def __init__(self, name: str, num_shards: int,
                 weights: dict[str, int] | None = None,
                 mode: str | None = None,
                 after_item=None) -> None:
        conf = g_conf()
        self.mode = mode or conf["osd_op_queue"]
        #: end-of-item hook (group commit, ROADMAP 1a): runs after
        #: every work item, OUTSIDE every lock the item took — the
        #: drain point where barriers deferred during the item (store
        #: commits queued under pg.lock) fsync and ack
        self._after_item = after_item
        self._weights = weights or {
            QOS_CLIENT: max(1, conf["osd_client_op_priority"]),
            QOS_RECOVERY: max(1, conf["osd_recovery_op_priority"]),
            QOS_SCRUB: max(1, conf["osd_scrub_priority"]),
        }
        if self.mode == "mclock_scheduler":
            def _cls(prefix: str) -> tuple:
                # res/lim are OSD-wide ops/s; tag clocks are per
                # shard, so distribute the rates across shards (the
                # reference divides configured IOPS the same way)
                return (conf[f"{prefix}_res"] / num_shards,
                        conf[f"{prefix}_wgt"],
                        conf[f"{prefix}_lim"] / num_shards)

            self._profile = {
                QOS_CLIENT: _cls("osd_mclock_scheduler_client"),
                QOS_RECOVERY: _cls(
                    "osd_mclock_scheduler_background_recovery"),
                QOS_SCRUB: _cls(
                    "osd_mclock_scheduler_background_best_effort"),
            }
            self._shards = [_MClockShard(self._profile)
                            for _ in range(num_shards)]
        else:
            self._shards = [_WQShard(self._weights)
                            for _ in range(num_shards)]
        self._running = True
        self._threads = [
            threading.Thread(target=self._worker, args=(sh,),
                             name=f"{name}-wq-{i}", daemon=True)
            for i, sh in enumerate(self._shards)]
        for t in self._threads:
            t.start()

    def enqueue(self, key, fn, qos: str = QOS_CLIENT) -> None:
        if not self._running:
            return
        try:
            # handoff stamp (ISSUE 17): consumed by the worker to
            # attribute the cross-thread queue wait. Closures take
            # attributes; bound methods may not — skip silently.
            fn._dsp_enq = (time.monotonic(),
                           threading.current_thread().name)
            # flow seat capture (ISSUE 20): the tenant context of the
            # enqueuing thread rides the work item, so the worker can
            # charge this seat's WPQ/dmclock credit to the flow and
            # re-install the context for the item's own attribution
            fn._flow = _flows.capture_flow(qos)
        except AttributeError:
            pass
        sh = self._shards[hash(key) % len(self._shards)]
        with sh.cv:
            if isinstance(sh, _MClockShard):
                sh.stamp(qos if qos in sh.queues else QOS_CLIENT, fn)
            else:
                sh.queues.get(qos, sh.queues[QOS_CLIENT]).append(fn)
            sh.cv.notify()
        # dispatch-queue depth (process-wide gauge over every sharded
        # queue): decremented by the worker at dequeue, so the gauge
        # reads the enqueued-not-yet-served backlog and returns to 0
        # at idle — the dispatch-wait saturation signal
        _msgr_telemetry().dispatch_queue_delta(1)

    def _dequeue(self, sh: _WQShard):
        """Weighted round-robin pick (caller holds sh.cv): serve each
        class up to its weight per cycle; refill when every non-empty
        class is out of credit. Strict priority would starve recovery
        outright; WRR bounds it to weight_r/(sum weights) of slots."""
        while True:
            any_waiting = False
            for cls, q in sh.queues.items():
                if q and sh.credits[cls] > 0:
                    sh.credits[cls] -= 1
                    return q.popleft()
                if q:
                    any_waiting = True
            if any_waiting:
                sh.credits.update(self._weights)   # new WRR cycle
                continue
            return None

    def _worker(self, sh) -> None:
        mclock = isinstance(sh, _MClockShard)
        _wq_tls.active = True      # marks this thread as a wq worker
        while True:
            # profiler join: a worker parked on its cv is idle, not
            # pg_process work (the classifier would otherwise charge
            # the wait to this file's stage bucket)
            _pidle = _prof.push_stage("idle")
            with sh.cv:
                if mclock:
                    fn, wake = sh.pick(pace=self._running)
                    while fn is None:
                        if not self._running:
                            return         # fully drained
                        # sleep to the earliest tag eligibility (the
                        # dual-clock pacing), or until new work
                        timeout = None if wake is None else max(
                            wake - time.monotonic(), 0.0)
                        sh.cv.wait(timeout)
                        fn, wake = sh.pick(pace=self._running)
                else:
                    fn = self._dequeue(sh)
                    while fn is None:
                        # queues fully drained (every class): exit
                        # only then, so no queued recovery/scrub item
                        # is abandoned on shutdown
                        if not self._running:
                            return
                        sh.cv.wait()
                        fn = self._dequeue(sh)
            _prof.pop_stage(_pidle)
            _msgr_telemetry().dispatch_queue_delta(-1)
            # handoff attribution (ISSUE 17): the enqueue->dequeue
            # span is one cross-thread hop; the seam (op vs engine
            # continuation) classifies from the profiler tag, and the
            # hop is published thread-locally so the EC fan-out can
            # mark commit_handoff at the absolute dequeue time
            enq = getattr(fn, "_dsp_enq", None)
            if enq is not None:
                _dsp.note_wq_dequeue(fn, enq)
            # flow seat grant (ISSUE 20): one dequeue = one unit of
            # queue credit charged to the item's captured flow; the
            # captured context becomes current for the item so store
            # txns / engine staging attribute without replumbing
            fctx = getattr(fn, "_flow", None)
            _flows.note_wq_grant(fctx)
            # profiler stage join: a worker sample belongs to the
            # stage of the work it runs — PG/op processing by default,
            # or the stage a producer tagged on the continuation
            # (device-engine commit fan-out tags commit_wait)
            _pstage = _prof.push_stage(
                getattr(fn, "_profile_stage", "pg_process"))
            try:
                fn()
            except Exception as exc:
                log(0, f"op worker exception: {exc!r}")
            finally:
                _prof.pop_stage(_pstage)
                _flows.note_wq_done(fctx)
                if enq is not None:
                    _dsp.clear_current_hop()
                if self._after_item is not None:
                    try:
                        self._after_item()
                    except Exception as exc:
                        log(0, f"wq after-item hook failed: {exc!r}")

    def drain_stop(self) -> None:
        self._running = False
        for sh in self._shards:
            with sh.cv:
                sh.cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        # gauge reconciliation: an item enqueued after a worker's
        # final drain check is dropped with the daemon — settle its
        # share so the process dispatch_queue_depth gauge still reads
        # 0 at idle
        leftover = 0
        for sh in self._shards:
            with sh.cv:
                for q in sh.queues.values():
                    leftover += len(q)
                    q.clear()
        if leftover:
            _msgr_telemetry().dispatch_queue_delta(-leftover)


class OSD:
    """One OSD daemon (also the backends' Listener)."""

    def __init__(self, osd_id: int, store: ObjectStore,
                 mon_addr: str, keyring=None) -> None:
        self.whoami = osd_id
        self.store = store
        self.msgr = Messenger(f"osd.{osd_id}")
        self._keyring = keyring
        if keyring is not None:
            from ceph_tpu_torch.parallel import auth as A
            A.daemon_auth(self.msgr, keyring, f"osd.{osd_id}")
        self.msgr.set_dispatcher(self._dispatch)
        self.monc = MonClient(self.msgr, mon_addr)
        self.monc.add_map_callback(self._on_map)
        self.addr = ""
        self.osdmap: OSDMap | None = None
        self._map_lock = make_rlock("osd.map")
        self.pgs: dict[tuple[int, int], PG] = {}
        self._pgs_lock = make_rlock("osd.pgs")
        self._pgscan_lock = make_lock("osd.pgscan")
        self._pgscan_pending = False
        self._pgscan_running = False
        # recovery reservation (recovery_reservation.rst role): bound
        # concurrent recovery rounds per OSD so a mass failure does
        # not fan out unbounded push traffic; throttled PGs are
        # requeued by the heartbeat tick's _kick_recovery
        self._recovery_res_lock = make_lock("osd.recovery_res")
        self._recovery_active = 0
        self._backends: dict[int, PGBackend] = {}
        # device stripe-batch engine (SURVEY.md §7.5): created lazily
        # by the first EC pool whose profile selects a device backend
        self._device_engine = None
        self._device_engine_lock = make_lock("osd.device_engine")
        self._tid = 0
        self._tid_lock = make_lock("osd.tid")
        self._inflight: dict[int, InflightWrite] = {}
        self._waits: dict[int, SubOpWait] = {}
        self._sub_lock = make_lock("osd.sub")
        # watch/notify state (Watch.h role; in-memory, see
        # _handle_watch): (pool, oid) -> {(peer, cookie): conn}
        self._watch_lock = make_lock("osd.watch")
        self._watchers: dict[tuple, dict] = {}
        self._notifies: dict[int, dict] = {}
        # inval watchers (the librados cache tier's coherence channel,
        # round 19): (pool, oid) -> {(peer, cookie): conn}. A mutating
        # op's reply is HELD until every one acked the invalidation
        # notify or timed out — see _inval_hold
        self._inval_watchers: dict[tuple, dict] = {}
        # placement-affine read serving (ROADMAP 3): non-primary
        # acting members serve plain head reads through per-OSD proxy
        # PG shells — never the authoritative self.pgs entries, whose
        # lifecycle (peering, waiting_for_active) is primary-side
        self._read_pgs: dict[tuple[int, int], PG] = {}
        self._read_pgs_lock = make_lock("osd.read_pgs")
        self._read_affinity = bool(g_conf()["objecter_read_affinity"])
        self._inval_timeout_ms = \
            int(g_conf()["osd_cache_inval_timeout_ms"])
        # any-k rotation width (tuner-managed: consumed through a
        # cached observer, never re-read per op; backends read it via
        # read_set_spread())
        self._read_set_spread = int(g_conf()["osd_read_set_spread"])
        g_conf().add_observer("osd_read_set_spread",
                              self._on_read_spread)
        self.op_wq = ShardedOpWQ(f"osd.{osd_id}",
                                 g_conf()["osd_op_num_shards"],
                                 after_item=self._drain_store_barrier)
        from ceph_tpu_torch.osd.tiering import TierService
        self.tier = TierService(self)
        # replica-side service ops (shard reads, peering queries) are
        # read-only and must never starve behind a primary-side task
        # blocked in a fan-out wait on the same op_wq shard — they get
        # their own workers (the reference's fast-dispatch isolation)
        # always WPQ: these are INTERNAL sub-op reads/peering queries
        # on the critical path of every client op — a configured
        # client limit must throttle clients, not the fan-outs
        # serving them
        self.reader_wq = ShardedOpWQ(f"osd.{osd_id}-svc", 2,
                                     mode="wpq",
                                     after_item=self._drain_store_barrier)
        # completed-mutation replies by (client, tid): a client resend
        # of an already-applied write/remove gets the cached reply
        # instead of re-executing (the reference's dup-op detection via
        # pg log reqids). Bounded LRU.
        self._op_cache: dict[tuple[str, int], M.MOSDOpReply] = {}
        self._op_cache_order: list[tuple[str, int]] = []
        self._op_cache_lock = make_lock("osd.op_cache")
        # APPENDs currently executing, by (client, tid) -> admit time:
        # the dup cache only covers COMPLETED ops and re-execution of
        # an incomplete write is the documented lost-subop recovery
        # path — safe for offset writes (idempotent), but a resend
        # racing a still-running APPEND would double-apply it. Racing
        # append dups are dropped while the entry is FRESH (under
        # 2x SUBOP_TIMEOUT); a stale entry means the original is
        # stuck and re-execution is the liveness path again.
        self._op_inflight: dict[tuple[str, int], float] = {}
        # messages carrying a newer map epoch than ours park here
        # until the mon's push catches us up
        # (require_same_or_newer_map role, src/osd/OSD.cc): executing
        # them against the stale map could miss a blocklist fence the
        # client's epoch already carries. Entries are
        # (epoch, wq_key, redispatch_fn).
        self._map_waiters: list[tuple[int, tuple, object]] = []
        self._map_waiters_lock = make_lock("osd.map_waiters")
        self._hb_last_rx: dict[int, float] = {}
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        self._stopping = False
        self.op_tracker = OpTracker(
            complaint_time=g_conf()["osd_op_complaint_time"],
            history_size=g_conf()["op_history_size"],
            name=f"osd.{osd_id}")
        self.asok = AdminSocket(
            f"osd.{osd_id}", g_conf()["admin_socket_dir"] or None)
        self._perf_name = f"osd.{osd_id}"
        try:
            self.logger = self._make_perf(self._perf_name)
        except ValueError:
            # same osd id alive in another in-process cluster (qa runs
            # several MiniClusters side by side): disambiguate
            self._perf_name = f"osd.{osd_id}.{id(self):x}"
            self.logger = self._make_perf(self._perf_name)

    @staticmethod
    def _make_perf(name: str) -> PerfCounters:
        perf = collection().create(name)
        perf.add_u64_counter("op", "client ops")
        perf.add_u64_counter("op_w", "client writes")
        perf.add_u64_counter("op_r", "client reads")
        perf.add_u64_counter("subop_w", "sub-writes applied")
        perf.add_u64_counter("recovery_ops", "objects recovered/pushed")
        perf.add_u64_counter("recovery_subchunk_reads",
                             "repairs served by fragmented sub-chunk "
                             "reads (clay repair-bandwidth path)")
        perf.add_u64_counter("snap_clones", "snapshot COW clones made")
        perf.add_u64_counter("snap_trims", "snapshot clones trimmed")
        perf.add_u64_counter("tier_promote",
                             "cache-tier objects promoted from base")
        perf.add_u64_counter("tier_flush",
                             "cache-tier objects flushed to base")
        perf.add_u64_counter("tier_evict",
                             "cache-tier clean objects evicted")
        perf.add_u64_counter("tier_proxy_read",
                             "cache-tier reads proxied to base "
                             "without promotion")
        perf.add_u64_counter("device_batches",
                             "stripe-batch device kernel launches")
        perf.add_u64_counter("device_batch_ops",
                             "ops encoded through the device engine")
        perf.add_u64_counter("device_decode_batches",
                             "signature-grouped device decode launches")
        perf.add_u64_counter("device_decode_ops",
                             "reconstructs decoded through the device "
                             "engine (degraded reads + recovery)")
        perf.add_u64_counter("device_fused_fallbacks",
                             "mesh/fused flush failures that fell back "
                             "to the plain encode path")
        # bulk-ingest fan-out (ISSUE 9): one message per (peer,
        # flush) instead of one MECSubWrite per (op, shard)
        perf.add_u64_counter("subwrite_batches",
                             "MECSubWriteBatch messages shipped (one "
                             "per peer per engine flush)")
        perf.add_histogram("subwrite_batch_size",
                           "sub-writes per MECSubWriteBatch (the "
                           "fan-out amortization factor)")
        # the degraded path's previously-silent signals (ISSUE 8):
        # how often EC shard reads had to re-fan-out, how deep each
        # op's retry ladder went, and how many client reads took the
        # reconstruct route at all
        perf.add_u64_counter("read_retries",
                             "EC shard-read fan-outs repeated (shard "
                             "EIO/timeout/version disagreement)")
        perf.add_histogram("read_retry_attempts",
                           "attempts one EC read op needed before a "
                           "consistent shard set (bucket 1 = first "
                           "try)")
        perf.add_u64_counter("degraded_reads",
                             "client reads served through shard "
                             "reconstruction (decode-on-read)")
        perf.add_u64_counter("read_version_splits",
                             "EC reads that resolved a persistent "
                             "shard-version split (unacked write cut "
                             "short) to a k-agreed version")
        # the planet-scale read path (round 19): affine serving,
        # any-k rotation, and the cache tier's write-hold channel
        perf.add_u64_counter("affine_reads",
                             "client reads served on a non-primary "
                             "acting member (placement-affine "
                             "routing)")
        perf.add_u64_counter("anyk_rotated_reads",
                             "EC reads planned on a rotated any-k "
                             "shard set (hot-object read balance)")
        perf.add_u64_counter("cache_inval_notifies",
                             "mutating-op replies held for cache-tier "
                             "invalidation acks")
        perf.add_u64_counter("xor_fast_decodes",
                             "reconstructs served by the host XOR "
                             "fast path (all-ones decode rows)")
        perf.add_u64_counter("hot_shard_cache_hits",
                             "hot-read partner chunks served from the "
                             "version-checked shard cache (no sub-op)")
        perf.add_time_avg("op_latency", "client op latency")
        return perf

    # -- lifecycle ----------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self.store.mount()
        register_common_commands(self.asok, self.logger)
        self.asok.register_command(
            "dump_ops_in_flight",
            lambda a: self.op_tracker.dump_in_flight(),
            "ops currently executing (TrackedOp.h:134 role)")
        self.asok.register_command(
            "dump_historic_ops",
            lambda a: self.op_tracker.dump_historic(),
            "recently finished ops with event timelines")
        self.asok.register_command(
            "dump_historic_slow_ops",
            lambda a: self.op_tracker.dump_slowest(),
            "top-K slowest finished ops by age")
        self.asok.register_command(
            "status", lambda a: self._asok_status(), "daemon status")
        self.asok.register_command(
            "dump_pgs", lambda a: self._asok_dump_pgs(),
            "primary-side pg states")
        self.asok.register_command(
            "dump_traces",
            lambda a: tracing.tracer().dump(a.get("trace_id")),
            "finished dataflow-trace spans (blkin role)")
        tracing.register_asok(self.asok)
        from ceph_tpu_torch.utils import autopsy as _autopsy
        _autopsy.register_asok(self.asok)
        self.asok.register_command(
            "deep-scrub",
            lambda a: self._asok_deep_scrub(a),
            "device deep scrub of one pg ({pool, ps, [repair]}): "
            "fused crc + parity-re-encode verify with batched "
            "sparse repair")
        from ceph_tpu_torch.utils import device_telemetry as _dt
        _dt.register_asok(self.asok)
        from ceph_tpu_torch.utils import tracepoints as _tp
        _tp.register_asok(self.asok)
        from ceph_tpu_torch.utils import dataplane as _dp
        _dp.register_asok(self.asok)
        from ceph_tpu_torch.utils import msgr_telemetry as _mt
        _mt.register_asok(self.asok)
        from ceph_tpu_torch.utils import store_telemetry as _st
        _st.register_asok(self.asok)
        _dsp.register_asok(self.asok)
        _flows.register_asok(self.asok)
        from ceph_tpu_torch.utils import faults as _faults
        _faults.register_asok(self.asok)
        self.asok.start()
        self.addr = self.msgr.bind(host, port)
        self._refresh_rotating()   # before boot: fetched-mode daemons
        # cannot sign a single frame until the window arrives
        self.monc.subscribe()
        # boot must land on a live (leader-reachable) mon: retry until
        # a map shows us up at this address (the MonClient rotates
        # targets underneath us when one is dead)
        deadline = time.monotonic() + 30
        while True:
            self.monc.boot_osd(self.whoami, self.addr)
            try:
                m = self.monc.wait_for_map(1, timeout=2.0)
                info = m.osds.get(self.whoami)
                if info is not None and info.up \
                        and info.addr == self.addr:
                    break
            except TimeoutError:
                pass
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"osd.{self.whoami} failed to boot (no mon "
                    "acknowledged)")
            time.sleep(0.2)
        with self._map_lock:
            self.osdmap = self.monc.osdmap
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name=f"osd.{self.whoami}-hb",
            daemon=True)
        self._hb_thread.start()
        log(1, f"osd.{self.whoami} up at {self.addr}")
        return self.addr

    def stop(self) -> None:
        self._stopping = True
        g_conf().remove_observer("osd_read_set_spread",
                                 self._on_read_spread)
        self._hb_stop.set()
        if self._hb_thread:
            self._hb_thread.join(timeout=5)
        self.tier.shutdown()
        if self._device_engine is not None:
            self._device_engine.stop()
        self.op_wq.drain_stop()
        self.reader_wq.drain_stop()
        self.msgr.shutdown()
        self.store.umount()
        self.asok.stop()
        collection().remove(self._perf_name)

    # -- Listener interface (what backends use) -----------------------
    def device_engine(self):
        """Lazy device engine (the stripe-batch accumulator of
        SURVEY.md §0): continuations dispatch onto the sharded op
        queue keyed by pgid, preserving per-PG order. Under bulk
        ingest (default) co-located OSDs ATTACH to one process-wide
        shared engine — cross-OSD flushes aggregate into bigger
        batches — instead of running one engine each; the handle
        routes this OSD's continuations back to its own op queue."""
        with self._device_engine_lock:
            if self._device_engine is None:
                from ceph_tpu_torch.osd import device_engine as de
                if de.bulk_ingest_enabled():
                    self._device_engine = de.shared_engine_attach(
                        self.op_wq.enqueue)
                else:
                    self._device_engine = de.DeviceEncodeEngine(
                        self.op_wq.enqueue, counters=self.logger)
            return self._device_engine

    def get_osdmap(self) -> OSDMap:
        with self._map_lock:
            return self.osdmap

    def send_osd(self, osd: int, msg: M.Message) -> None:
        osdmap = self.get_osdmap()
        info = osdmap.osds.get(osd) if osdmap else None
        if info is None or not info.up or not info.addr:
            return
        if osd == self.whoami:
            # loop locally without a socket round trip
            self._dispatch(M.decode_message(
                msg.MSG_TYPE, msg.encode_payload()), _SelfConn(self))
            return
        self.msgr.send_message(msg, info.addr)

    def new_tid(self) -> int:
        with self._tid_lock:
            self._tid += 1
            return self._tid

    def register_write(self, iw: InflightWrite) -> None:
        with self._sub_lock:
            self._inflight[iw.tid] = iw

    def register_wait(self, tid: int, wait: SubOpWait) -> None:
        with self._sub_lock:
            self._waits[tid] = wait

    def unregister_wait(self, tid: int) -> None:
        with self._sub_lock:
            self._waits.pop(tid, None)

    def _drain_store_barrier(self) -> None:
        """The wq end-of-item drain: flush barriers deferred during
        the item (commits issued under pg.lock park their fsync +
        ack here, where no lock is held — the witness contract)."""
        if self.store.barrier_pending():
            self.store.barrier()
            ft = _flows.flows_if_active()
            if ft is not None:
                try:
                    # one durability barrier: amortize the fsync over
                    # the flows whose txn bytes rode this window
                    ft.note_fsync()
                except Exception:
                    pass

    @staticmethod
    def _note_txn_flow(txn) -> None:
        """Charge a queued store txn's payload bytes to its flow
        (ISSUE 20); the same bytes feed the fsync amortization window
        the barrier drain settles. A label stamped on the txn at
        defer time (the engine flush-group local leg) wins over the
        calling thread's context — group ship runs flow-less."""
        ft = _flows.flows_if_active()
        if ft is None:
            return
        try:
            label = getattr(txn, "_flow", None)
            if label is None:
                label = _flows.current_flow() or ""
            ft.note_store_txn(label, _flows.txn_nbytes(txn))
        except Exception:
            pass

    def queue_local_txn(self, txn: Transaction, on_commit) -> None:
        """One local shard txn. From a wq item (the op/sub-op paths —
        which may hold pg.lock) the barrier + ack defer to the
        worker's end-of-item drain, where the shared leader-follower
        rounds coalesce them with everything else the item (and its
        shard neighbors) committed; other threads commit inline."""
        self._note_txn_flow(txn)
        if group_commit_enabled() and _on_wq_thread():
            self.store.queue_transaction_group([(txn, on_commit)],
                                               defer=True)
        else:
            self.store.queue_transaction(txn, on_commit)

    def queue_local_txn_group(self, pairs: list) -> None:
        """Apply many (txn, on_commit) pairs as ONE store group
        commit (the bulk-ingest local-shard leg: a flush's local
        sub-writes share one apply pass, one WAL append, one barrier
        set — ``ObjectStore.queue_transaction_group``, ROADMAP 1a —
        with completions swept in list order by the store)."""
        if len(pairs) != 1:
            # txn-byte attribution to the current flow; the single-
            # pair delegation below lands in queue_local_txn, which
            # notes its own
            for txn, _cb in pairs:
                self._note_txn_flow(txn)
        if len(pairs) == 1 or not group_commit_enabled():
            if len(pairs) > 1:
                # A/B fallback (CEPH_TPU_GROUP_COMMIT=0): the pre-15
                # merged-txn path — one store txn, wrapper callback
                merged = Transaction()
                cbs = []
                for txn, cb in pairs:
                    merged.ops.extend(txn.ops)
                    cbs.append(cb)
                self.store.queue_transaction(
                    merged, lambda: _store_telemetry.sweep_completions(
                        cbs))
                return
            txn, cb = pairs[0]
            self.queue_local_txn(txn, cb)
            return
        if _on_wq_thread():
            # flush continuations run as wq items: defer to the
            # end-of-item drain so the frame's other legs share the
            # barrier round
            self.store.queue_transaction_group(pairs, defer=True)
        else:
            self.store.queue_transaction_group(pairs)

    # -- asok backends -------------------------------------------------
    def _asok_status(self) -> dict:
        osdmap = self.get_osdmap()
        with self._pgs_lock:
            num_pgs = len(self.pgs)
        return {"whoami": self.whoami, "addr": self.addr,
                "osdmap_epoch": osdmap.epoch if osdmap else 0,
                "num_primary_pgs": num_pgs,
                "slow_ops": len(self.op_tracker.get_slow_ops())}

    def _asok_deep_scrub(self, args: dict) -> dict:
        try:
            pool = int(args["pool"])
            ps = int(args["ps"])
        except (KeyError, TypeError, ValueError):
            return {"error": "need integer 'pool' and 'ps' args"}
        repair = bool(int(args.get("repair", 1)))
        timeout = float(args.get("timeout", 120.0))
        try:
            res = self.scrub_pg((pool, ps), repair=repair,
                                timeout=timeout, deep=True)
        except TimeoutError as exc:
            return {"error": repr(exc)}
        res["engine_stats"] = dict(self.scrub_engine().stats)
        return res

    def _asok_dump_pgs(self) -> list[dict]:
        with self._pgs_lock:
            pgs = list(self.pgs.values())
        out = []
        for pg in pgs:
            with pg.lock:
                out.append({
                    "pgid": f"{pg.pool}.{pg.ps}", "state": pg.state,
                    "acting": list(pg.acting),
                    "last_version": pg.log.last_version,
                    "missing": {str(p): len(m) for p, m in
                                pg.peer_missing.items() if m}})
        return out

    # -- backends ------------------------------------------------------
    def backend_for(self, pool_id: int) -> PGBackend:
        be = self._backends.get(pool_id)
        if be is None:
            pool = self.get_osdmap().pools[pool_id]
            be = (ECBackend(self, pool) if pool.is_ec
                  else ReplicatedBackend(self, pool))
            self._backends[pool_id] = be
        return be

    # -- map handling --------------------------------------------------
    def _on_map(self, newmap: OSDMap) -> None:
        with self._map_lock:
            oldmap, self.osdmap = self.osdmap, newmap
        # messages that were parked waiting for this (or an older)
        # epoch re-enter admission from the top against the fresh map
        self._drain_map_waiters(newmap.epoch)
        # a peer that (re)booted gets a fresh heartbeat grace window:
        # without this, a down->up map pair arriving between two ticks
        # leaves the pre-kill silence clock running and we'd report the
        # reborn daemon failed with the NEW epoch (re-killing it)
        for osd, info in newmap.osds.items():
            old = oldmap.osds.get(osd) if oldmap else None
            if info.up and (old is None or not old.up
                            or old.addr != info.addr):
                self._hb_last_rx.pop(osd, None)
        # writes waiting on now-dead shards complete on survivors.
        # NOTE: this runs on the messenger event loop — it must never
        # block (no pg.lock, which peering holds for seconds); the
        # missing-shard bookkeeping is deferred to the PG's wq shard.
        with self._sub_lock:
            inflight = list(self._inflight.values())
        for iw in inflight:
            finished, dropped = iw.drop_down_shards(newmap)
            if dropped:
                self.op_wq.enqueue(
                    iw.pg.pgid,
                    lambda w=iw, d=dropped: self._record_missing(w, d))
            if finished:
                with self._sub_lock:
                    self._inflight.pop(iw.tid, None)
                self.op_wq.enqueue(iw.pg.pgid, iw.on_all_commit)
        # snap-trim trigger: pools whose snap set SHRANK get their
        # primary PGs trimmed (the snap trim queue role) — clones of
        # deleted snaps are reclaimed as scrub-class background work
        shrunk = set()
        if oldmap is not None:
            for pid, pool in newmap.pools.items():
                old = oldmap.pools.get(pid)
                if old is None:
                    continue
                if set(old.snaps) - set(pool.snaps):
                    shrunk.add(pid)
                # self-managed mode: trimming is triggered by snapids
                # ENTERING removed_snaps (pg_pool_t removed_snaps)
                if set(pool.removed_snaps) - set(old.removed_snaps):
                    shrunk.add(pid)
        if shrunk:
            with self._pgs_lock:
                trim_pgs = [pg for pg in self.pgs.values()
                            if pg.pool in shrunk and pg.acting
                            and pg.acting[0] == self.whoami]
            for pg in trim_pgs:
                self.op_wq.enqueue(pg.pgid,
                                   lambda p=pg: self._snap_trim(p),
                                   qos=QOS_SCRUB)
        # re-evaluate every primary PG against the new acting set
        with self._pgs_lock:
            pgids = list(self.pgs)
        for pgid in pgids:
            self.op_wq.enqueue(pgid, lambda p=pgid: self._check_pg(p))
        # proactively instantiate PGs this OSD just became primary for
        # (OSD::handle_pg_create / split-from-map role): after a remap —
        # e.g. a balancer upmap — recovery must start on the new primary
        # immediately, not when the next client op happens to touch it.
        # The O(pools * pg_num) CRUSH scan must NOT run on this thread
        # (the messenger event loop — see the note above), and a burst
        # of epochs must coalesce into one scan of the newest map.
        self._kick_pgscan()

    def _kick_pgscan(self) -> None:
        """Request a primary-PG scan; bursts of map epochs coalesce
        into one scan (which always reads the current map)."""
        with self._pgscan_lock:
            self._pgscan_pending = True
            if self._pgscan_running:
                return
            self._pgscan_running = True
        threading.Thread(target=self._pgscan_worker,
                         name=f"osd.{self.whoami}-pgscan",
                         daemon=True).start()

    def _pgscan_worker(self) -> None:
        while True:
            with self._pgscan_lock:
                if not self._pgscan_pending:
                    self._pgscan_running = False
                    return
                self._pgscan_pending = False
            self._scan_new_primaries(self.get_osdmap())

    def _scan_new_primaries(self, newmap: OSDMap) -> None:
        """Instantiate + queue peering for mapped PGs newly primary
        here (runs off the event loop; stale scans are harmless —
        _check_pg re-validates against the CURRENT map)."""
        for pid, pool in newmap.pools.items():
            for ps in range(pool.pg_num):
                pgid = (pid, ps)
                with self._pgs_lock:
                    if pgid in self.pgs:
                        continue
                _, _, primary = newmap.pg_to_up_acting(pid, ps)
                if primary != self.whoami:
                    continue
                try:
                    backend = self.backend_for(pid)
                except Exception:
                    continue     # pool raced away
                with self._pgs_lock:
                    if pgid not in self.pgs:
                        pg = PG(pid, ps)
                        pg.backend = backend
                        self.pgs[pgid] = pg
                self.op_wq.enqueue(pgid,
                                   lambda p=pgid: self._check_pg(p))

    @staticmethod
    def _record_missing(iw: InflightWrite, dropped: list[int]) -> None:
        with iw.pg.lock:
            for pos in dropped:
                iw.pg.peer_missing.setdefault(pos, {})[
                    iw.oid] = iw.version

    def _check_pg(self, pgid: tuple[int, int]) -> None:
        pool_id, ps = pgid
        osdmap = self.get_osdmap()
        with self._pgs_lock:
            pg = self.pgs.get(pgid)
        if pg is None:
            return
        if pool_id not in osdmap.pools:
            with self._pgs_lock:
                self.pgs.pop(pgid, None)
            return
        _, acting, primary = osdmap.pg_to_up_acting(pool_id, ps)
        with pg.lock:
            if primary != self.whoami:
                log(10, f"{pg} no longer primary here")
                with self._pgs_lock:
                    self.pgs.pop(pgid, None)
                return
            if acting != pg.acting or pg.state == PG.CREATED:
                pg.acting = list(acting)
                pg.epoch = osdmap.epoch
                self._peer(pg)
            elif pg.state == PG.ACTIVE and pg.waiting_for_active:
                self._flush_waiting(pg)

    # -- dispatch ------------------------------------------------------
    def _dispatch(self, msg: M.Message, conn: Connection) -> None:
        if self.monc.handle_message(msg, conn):
            return
        if isinstance(msg, M.MPing):
            conn.send_message(M.MPingReply(
                osd_id=self.whoami, epoch=msg.epoch, stamp=msg.stamp))
            return
        if isinstance(msg, M.MPingReply):
            self._hb_last_rx[msg.osd_id] = time.monotonic()
            return
        if isinstance(msg, M.MOSDOpReply):
            # replies to our INTERNAL client (cache-tier promote /
            # flush ops against the base pool)
            self.tier.handle_reply(msg, conn)
            return
        if isinstance(msg, M.MECSubWriteReply):
            self._handle_sub_write_reply(msg)
            return
        if isinstance(msg, M.MECSubWriteBatchReply):
            self._handle_sub_write_batch_reply(msg)
            return
        if isinstance(msg, M.MECSubReadReply):
            with self._sub_lock:
                wait = self._waits.get(msg.tid)
            if wait is not None:
                wait.complete(msg.shard, msg)
            return
        if isinstance(msg, M.MPGNotify):
            with self._sub_lock:
                wait = self._waits.get(msg.tid)
            if wait is not None:
                wait.complete(msg.shard, msg)
            return
        if isinstance(msg, M.MPGPushReply):
            with self._sub_lock:
                wait = self._waits.get(msg.tid)
            if wait is not None:
                wait.complete(msg.oid, msg)
            return
        pgid = (msg.pool, msg.ps) if hasattr(msg, "pool") else None
        if isinstance(msg, M.MOSDOp):
            pgid = (msg.pool, msg.ps)
            # the wire flow label becomes current across enqueue so
            # the wq seam captures it — the op's WPQ/dmclock seat
            # credit lands on the tenant, not on "" (ISSUE 20)
            with _flows.flow_scope(msg.flow):
                self.op_wq.enqueue(
                    pgid, lambda: self._handle_osd_op(msg, conn))
        elif isinstance(msg, M.MOSDOpBatch):
            # the streaming client leg (ROADMAP 1b): one frame of
            # same-PG writes — one wq traversal on the PG's key, so
            # FIFO against singleton MOSDOps is preserved. The frame
            # consumed ONE seat grant; charge it to the lead entry's
            # flow (streaming frames are single-tenant in practice)
            with _flows.flow_scope(msg.flows[0] if msg.flows else ""):
                self.op_wq.enqueue(
                    pgid, lambda: self._handle_osd_op_batch(msg, conn))
        elif isinstance(msg, M.MECSubWrite):
            with _flows.flow_scope(msg.flow):
                self.op_wq.enqueue(
                    pgid, lambda: self._handle_sub_write(msg, conn))
        elif isinstance(msg, M.MECSubWriteBatch):
            self._handle_sub_write_batch(msg, conn)
        elif isinstance(msg, M.MECSubRead):
            self.reader_wq.enqueue(
                pgid, lambda: self._handle_sub_read(msg, conn))
        elif isinstance(msg, M.MPGQuery):
            self.reader_wq.enqueue(
                pgid, lambda: self._handle_pg_query(msg, conn))
        elif isinstance(msg, M.MPGPush):
            self.op_wq.enqueue(pgid,
                               lambda: self._handle_pg_push(msg, conn),
                               qos=QOS_RECOVERY)
        elif isinstance(msg, M.MWatch):
            self._handle_watch(msg, conn)
        elif isinstance(msg, M.MNotify):
            self._handle_notify(msg, conn)
        elif isinstance(msg, M.MWatchNotifyAck):
            self._handle_notify_ack(msg, conn)
        else:
            log(5, f"unhandled message {msg!r}")

    def _park_for_map(self, epoch: int, key: tuple, fn) -> None:
        """Park a message needing map ``epoch``; re-dispatched by the
        map push. Re-checks after the append so a push that drained
        concurrently cannot strand the entry until the next push or
        client resend (the park-after-drain race)."""
        with self._map_waiters_lock:
            self._map_waiters.append((epoch, key, fn))
            # backstop: clients resend, so shed oldest on overflow
            while len(self._map_waiters) > 10000:
                self._map_waiters.pop(0)
        cur = self.get_osdmap().epoch
        if cur >= epoch:
            self._drain_map_waiters(cur)

    def _drain_map_waiters(self, epoch: int) -> None:
        with self._map_waiters_lock:
            ready = [(k, f) for e, k, f in self._map_waiters
                     if e <= epoch]
            self._map_waiters = [(e, k, f) for e, k, f
                                 in self._map_waiters if e > epoch]
        for k, f in ready:
            self.op_wq.enqueue(k, f)

    # -- watch/notify (Watch.h / rados_watch+notify roles) ------------
    def _handle_watch(self, msg: M.MWatch, conn: Connection) -> None:
        """Register/unregister a watcher on this primary. Watch state
        is IN-MEMORY and connection-scoped (documented lite of the
        reference's per-obc persisted watches): a primary change or
        OSD restart drops it, and clients re-watch on the epoch bump
        their map subscription delivers."""
        key = (msg.pool, msg.oid)
        osdmap = self.get_osdmap()
        if msg.watch and msg.epoch > osdmap.epoch:
            # same stale-map fence as ops: the client's epoch may
            # carry a blocklist entry this map misses
            self._park_for_map(
                msg.epoch, (msg.pool, msg.ps),
                lambda m=msg, c=conn: self._handle_watch(m, c))
            return
        if msg.watch and osdmap.is_blocklisted(
                msg.client or conn.peer_name):
            conn.send_message(M.MWatchAck(tid=msg.tid,
                                          code=EBLOCKLISTED))
            return
        # inval watches (cache-tier coherence) live in their own
        # registry: user notifies never fan to them, and only they
        # hold mutating-op replies (_inval_hold)
        reg = self._inval_watchers if getattr(msg, "inval", False) \
            else self._watchers
        with self._watch_lock:
            if msg.watch:
                reg.setdefault(key, {})[
                    (conn.peer_name, msg.cookie)] = conn
            else:
                # unregistration sweeps BOTH registries: the ghost-
                # watch cleanup path sends watch=False without knowing
                # which kind the stale cookie was
                for r in (self._watchers, self._inval_watchers):
                    watchers = r.get(key, {})
                    watchers.pop((conn.peer_name, msg.cookie), None)
                    if not watchers:
                        r.pop(key, None)
        conn.send_message(M.MWatchAck(tid=msg.tid, code=0))

    def _handle_notify(self, msg: M.MNotify, conn: Connection) -> None:
        """Fan the payload to every watcher; answer the notifier once
        every watcher acked or the timeout passed (notify semantics:
        the caller knows watchers SAW it — or which count did not)."""
        key = (msg.pool, msg.oid)
        dead = 0
        with self._watch_lock:
            watchers = dict(self._watchers.get(key, {}))
            # age out watchers whose connection already closed (the
            # reference discards un-pinging watchers the same way):
            # counted MISSED once, then gone
            for who, wconn in list(watchers.items()):
                if getattr(wconn, "closed", False):
                    watchers.pop(who)
                    dead += 1
                    ws = self._watchers.get(key, {})
                    ws.pop(who, None)
                    if not ws:
                        self._watchers.pop(key, None)
            if not watchers:
                conn.send_message(M.MNotifyComplete(
                    tid=msg.tid, code=0, acked=0, missed=dead))
                return
            notify_id = self.new_tid()
            self._notifies[notify_id] = {
                "conn": conn, "tid": msg.tid,
                "pending": set(watchers),
                "acked": 0, "missed": dead,
                "deadline": time.monotonic() +
                (msg.timeout_ms or 5000) / 1000.0,
            }
        # fan out (fire-and-forget sends: a dead-but-not-yet-closed
        # connection surfaces through the timeout sweep as MISSED;
        # already-closed connections were aged out above)
        for (_peer, cookie), wconn in watchers.items():
            wconn.send_message(M.MWatchNotify(
                notify_id=notify_id, pool=msg.pool, oid=msg.oid,
                cookie=cookie, payload=msg.payload))

    def _handle_notify_ack(self, msg: M.MWatchNotifyAck,
                           conn: Connection) -> None:
        # acks match on (peer, cookie): cookies are PER-CLIENT
        # counters, so two clients' cookies collide routinely
        self._notify_resolve(msg.notify_id,
                             (conn.peer_name, msg.cookie), acked=True)

    def _notify_resolve(self, notify_id: int, who: tuple,
                        acked: bool) -> None:
        with self._watch_lock:
            ent = self._notifies.get(notify_id)
            if ent is None or who not in ent["pending"]:
                return
            ent["pending"].discard(who)
            ent["acked" if acked else "missed"] += 1
            if ent["pending"]:
                return
            del self._notifies[notify_id]
        self._notify_complete(ent)

    @staticmethod
    def _notify_complete(ent: dict, late: int = 0) -> None:
        """Deliver a settled notify's completion: the notifier's
        MNotifyComplete, or — for an internal inval-hold entry — the
        held reply's ``done`` continuation."""
        done = ent.get("done")
        if done is not None:
            done()
            return
        ent["conn"].send_message(M.MNotifyComplete(
            tid=ent["tid"], code=0, acked=ent["acked"],
            missed=ent["missed"] + late))

    def _sweep_notifies(self) -> None:
        """Timeout expiry (run from the tick): a dead watcher must not
        block the notifier — or a held mutating-op reply — forever."""
        now = time.monotonic()
        done = []
        with self._watch_lock:
            for nid, ent in list(self._notifies.items()):
                if now >= ent["deadline"]:
                    done.append(ent)
                    del self._notifies[nid]
        for ent in done:
            self._notify_complete(ent, late=len(ent["pending"]))

    def _inval_hold(self, pool: int, oid: str, deliver) -> bool:
        """Cache-tier write coherence (round 19): fan an invalidation
        notify to this object's inval watchers and HOLD the mutating
        op's reply — ``deliver`` runs — until every cached copy acked
        or the timeout wrote the laggards off. Returns False when
        nobody inval-watches the object (the common case: one dict
        probe, no hold). Read-your-writes follows: once the writer's
        ack arrives, no cache anywhere still serves pre-write bytes."""
        key = (pool, oid)
        with self._watch_lock:
            watchers = dict(self._inval_watchers.get(key, {}))
            for who, wconn in list(watchers.items()):
                if getattr(wconn, "closed", False):
                    watchers.pop(who)
                    ws = self._inval_watchers.get(key, {})
                    ws.pop(who, None)
                    if not ws:
                        self._inval_watchers.pop(key, None)
            if not watchers:
                return False
            notify_id = self.new_tid()
            self._notifies[notify_id] = {
                "done": deliver, "tid": 0, "conn": None,
                "pending": set(watchers), "acked": 0, "missed": 0,
                "deadline": time.monotonic() +
                self._inval_timeout_ms / 1000.0,
            }
        self.logger.inc("cache_inval_notifies")
        for (_peer, cookie), wconn in watchers.items():
            wconn.send_message(M.MWatchNotify(
                notify_id=notify_id, pool=pool, oid=oid,
                cookie=cookie, payload=b"inval"))
        return True

    # -- replica-side handlers ----------------------------------------
    def _handle_sub_write(self, msg: M.MECSubWrite, conn: Connection
                          ) -> None:
        txn = Transaction.decode(msg.txn_bytes)
        self.logger.inc("subop_w")
        span = tracing.tracer().from_wire(
            msg.trace, f"sub_write(shard={msg.shard})",
            f"osd.{self.whoami}")
        # the sub-op's child stage timeline (anchor set on the
        # primary): wire interval ends at the messenger rx stamp,
        # dispatch wait ends here; the commit mark rides the reply
        # back for the primary to merge under the client op
        sclock = stage_clock.StageClock.from_wire(msg.stages)
        rx_t = getattr(msg, "_rx_t", None)
        if rx_t is not None:
            sclock.mark("subop_wire", t=rx_t)
        sclock.mark("subop_dispatch_wait")

        def committed() -> None:
            span.event("committed")
            span.finish()
            sclock.mark("subop_commit")
            try:
                dataplane().record_stages(
                    sclock.own_durations(),
                    trace_id=getattr(span, "trace_id", "") or None)
            except Exception:
                pass
            conn.send_message(M.MECSubWriteReply(
                tid=msg.tid, pool=msg.pool, ps=msg.ps, shard=msg.shard,
                committed=True, version=msg.version,
                stages=sclock.to_wire()))

        self.queue_local_txn(txn, committed)

    def _handle_sub_write_batch(self, msg: M.MECSubWriteBatch,
                                conn: Connection) -> None:
        """One frame = every sub-write of one engine flush aimed at
        this OSD (ISSUE 9). Entries group by contained PG; each group
        enqueues ONE handler on its own pgid key (per-PG FIFO against
        singleton MECSubWrites is preserved) and queues its txns as
        ONE store txn group. Under group commit (ROADMAP 1a, default)
        the groups DEFER their durability barrier to the worker's
        end-of-item drain, where the store's shared leader-follower
        rounds coalesce the whole frame's PG groups (and any
        neighbors) onto one barrier set — one data fdatasync + one
        WAL fsync instead of a set per PG — after which the store
        sweeps every entry's completion and the last entry acks all
        contained tids in ONE MECSubWriteBatchReply."""
        n = len(msg.tids)
        groups: dict[tuple, list[int]] = {}
        for i in range(n):
            groups.setdefault((msg.pools[i], int(msg.pss[i])),
                              []).append(i)
        state = {"left": n, "lock": make_lock("osd.logsync_group"),
                 "stages": [""] * n}
        rx_t = getattr(msg, "_rx_t", None)
        for pgid, idxs in groups.items():
            self.op_wq.enqueue(
                pgid, lambda idxs=idxs: self._apply_sub_write_group(
                    msg, conn, idxs, state, rx_t))

    def _apply_sub_write_group(self, msg: M.MECSubWriteBatch,
                               conn: Connection, idxs: list[int],
                               state: dict, rx_t) -> None:
        grouped = group_commit_enabled()
        ft = _flows.flows_if_active()
        pairs = []
        for i in idxs:
            txn = Transaction.decode(msg.txns[i])
            self.logger.inc("subop_w")
            if ft is not None:
                try:
                    # per-entry wire flow (ISSUE 20): charge this
                    # entry's encoded txn bytes to its own tenant —
                    # one frame may carry many flows
                    ft.note_store_txn(
                        msg.flows[i] if i < len(msg.flows) else "",
                        len(msg.txns[i]))
                except Exception:
                    pass
            span = tracing.tracer().from_wire(
                msg.traces[i] if i < len(msg.traces) else "",
                f"sub_write(shard={int(msg.shards[i])})",
                f"osd.{self.whoami}")
            # per-entry child timeline forked from the batch's shared
            # clock: every entry rode the same frame, so the send/
            # wire marks ARE shared; the commit mark lands when the
            # shared barrier releases this entry's completion
            sclock = stage_clock.StageClock.from_wire(msg.stages)
            if rx_t is not None:
                sclock.mark("subop_wire", t=rx_t)
            sclock.mark("subop_dispatch_wait")

            def entry_committed(i=i, span=span, sclock=sclock) -> None:
                span.event("committed")
                span.finish()
                sclock.mark("subop_commit")
                try:
                    dataplane().record_stages(
                        sclock.own_durations(),
                        trace_id=getattr(span, "trace_id", "")
                        or None)
                except Exception:
                    pass
                state["stages"][i] = sclock.to_wire()
                with state["lock"]:
                    state["left"] -= 1
                    last = state["left"] == 0
                if last:
                    conn.send_message(M.MECSubWriteBatchReply(
                        tid=msg.tid, committed=True,
                        tids=list(msg.tids), pools=list(msg.pools),
                        pss=list(msg.pss), shards=list(msg.shards),
                        versions=list(msg.versions),
                        stages=list(state["stages"])))

            pairs.append((txn, entry_committed))
        if not grouped:
            # A/B fallback (CEPH_TPU_GROUP_COMMIT=0): the pre-15
            # per-PG machinery — one merged sync store txn per group
            merged = Transaction()
            cbs = []
            for txn, cb in pairs:
                merged.ops.extend(txn.ops)
                cbs.append(cb)
            self.store.queue_transaction(
                merged,
                lambda: _store_telemetry.sweep_completions(cbs))
            return
        # barrier + acks defer to the wq end-of-item drain (this
        # handler IS a wq item), where the shared rounds merge every
        # PG group of the frame onto one barrier set
        self.store.queue_transaction_group(pairs, defer=True)

    def _handle_sub_write_batch_reply(
            self, msg: M.MECSubWriteBatchReply) -> None:
        """One batched ack = N singleton acks: complete every
        contained (tid, shard), merging each entry's child timeline
        under its client op exactly like _handle_sub_write_reply."""
        for i in range(len(msg.tids)):
            tid = msg.tids[i]
            shard = int(msg.shards[i])
            with self._sub_lock:
                iw = self._inflight.get(tid)
            if iw is None:
                continue
            st = msg.stages[i] if i < len(msg.stages) else ""
            if st and iw.clock is not None:
                iw.clock.merge_child(
                    f"shard{shard}",
                    stage_clock.StageClock.from_wire(st))
            if iw.complete(shard):
                with self._sub_lock:
                    self._inflight.pop(tid, None)
                # same rule as the singleton path: completion
                # callbacks may take pg.lock — never run them on the
                # messenger event loop
                self.op_wq.enqueue(iw.pg.pgid, iw.on_all_commit)

    def _handle_sub_read(self, msg: M.MECSubRead, conn: Connection) -> None:
        # msg.shard is the acting position; replicated PGs store in the
        # unsharded collection (scrub fans csum reads over replicas)
        osdmap = self.get_osdmap()
        pool = osdmap.pools.get(msg.pool) if osdmap else None
        shard = msg.shard if (pool is not None and pool.is_ec) \
            else NO_SHARD
        cid = pg_cid(msg.pool, msg.ps, shard)
        conn.send_message(
            ECBackend.serve_sub_read(self.store, msg, cid))

    def _handle_pg_query(self, msg: M.MPGQuery, conn: Connection) -> None:
        # msg.shard is the acting-set POSITION (a routing tag echoed in
        # the notify); the store collection depends on the pool type
        osdmap = self.get_osdmap()
        pool = osdmap.pools.get(msg.pool) if osdmap else None
        shard = msg.shard if (pool is not None and pool.is_ec) \
            else NO_SHARD
        cid = pg_cid(msg.pool, msg.ps, shard)
        shard_log = PGLog.load(self.store, cid)
        last_version, objects = read_shard_info(self.store, cid,
                                                log=shard_log)
        ents = [shard_log.entries[v] for v in sorted(shard_log.entries)]
        oids = sorted(objects)
        conn.send_message(M.MPGNotify(
            pool=msg.pool, ps=msg.ps, shard=msg.shard, epoch=msg.epoch,
            objects=oids, versions=[objects[o] for o in oids],
            last_version=last_version, tid=msg.tid,
            log_versions=[e.version for e in ents],
            log_ops=[e.op for e in ents],
            log_oids=[e.oid for e in ents]))

    def _handle_pg_push(self, msg: M.MPGPush, conn: Connection) -> None:
        cid = pg_cid(msg.pool, msg.ps, msg.shard)
        # never let a stale push clobber newer committed state (a
        # recovery round built from pre-write reads could arrive after
        # the write's own sub-op); equal versions DO apply — that is
        # how scrub repairs a wrong-data-right-version shard
        try:
            existing_v = int.from_bytes(
                self.store.getattr(cid, msg.oid, "v"), "little")
        except StoreError:
            existing_v = -1
        if existing_v > msg.version:
            # refuse honestly: the primary keeps the object in
            # peer_missing, and the next peering round pulls OUR newer
            # copy instead of pretending the push repaired us
            conn.send_message(M.MPGPushReply(
                pool=msg.pool, ps=msg.ps, shard=msg.shard, oid=msg.oid,
                committed=False, tid=msg.tid))
            return
        if msg.remove:
            txn = Transaction()
            txn.create_collection(cid)
            txn.remove(cid, msg.oid)
        else:
            txn = object_write_txn(cid, msg.oid, msg.data, msg.version,
                                   attrs={k: v for k, v in
                                          msg.attrs.items()
                                          if k != "v"},
                                   replace=True)
            if msg.omap:
                txn.omap_set(cid, msg.oid, dict(msg.omap))
        self.logger.inc("recovery_ops")

        def committed() -> None:
            conn.send_message(M.MPGPushReply(
                pool=msg.pool, ps=msg.ps, shard=msg.shard, oid=msg.oid,
                committed=True, tid=msg.tid))

        self.store.queue_transaction(txn, committed)

    def _handle_sub_write_reply(self, msg: M.MECSubWriteReply) -> None:
        with self._sub_lock:
            iw = self._inflight.get(msg.tid)
        if iw is None:
            return
        if msg.stages and iw.clock is not None:
            # fold the shard's completed sub-op timeline under the
            # client op (the cross-daemon merge: client + primary +
            # shard OSDs in one dump)
            iw.clock.merge_child(
                f"shard{msg.shard}",
                stage_clock.StageClock.from_wire(msg.stages))
        if iw.complete(msg.shard):
            with self._sub_lock:
                self._inflight.pop(msg.tid, None)
            # completion callbacks may take pg.lock (e.g. recovery's
            # _mark_recovered) and pg.lock can be held for seconds by a
            # blocked fan-out — NEVER run them on this messenger event
            # loop, or beacons/pings freeze and peers call us dead
            self.op_wq.enqueue(iw.pg.pgid, iw.on_all_commit)

    # -- primary-side client op handling ------------------------------
    _MUTATING_OPS = (M.OSD_OP_WRITE_FULL, M.OSD_OP_WRITE,
                     M.OSD_OP_APPEND, M.OSD_OP_REMOVE, M.OSD_OP_CALL,
                     M.OSD_OP_SETXATTR, M.OSD_OP_RMXATTR,
                     M.OSD_OP_OMAPSET, M.OSD_OP_OMAPRMKEYS,
                     M.OSD_OP_CREATE, M.OSD_OP_TRUNCATE,
                     M.OSD_OP_ZERO, M.OSD_OP_ROLLBACK,
                     M.OSD_OP_WRITESAME, M.OSD_OP_OMAPSETHEADER)
    _OP_CACHE_MAX = 10000

    def _handle_osd_op_batch(self, msg: M.MOSDOpBatch,
                             conn: Connection) -> None:
        """One MOSDOpBatch = N client writes for one PG (the
        streaming objecter's frame). Each contained op runs the FULL
        singleton admission path — map fence, blocklist, dup-op
        cache, PG state, QoS — as its own MOSDOp through a collecting
        connection shim; when every op has replied, ONE
        MOSDOpReplyBatch sweeps all of them home."""
        n = len(msg.tids)
        if not n:
            return
        rx_t = getattr(msg, "_rx_t", None)
        state = {"left": n, "replies": [None] * n,
                 "lock": make_lock("osd.op_batch")}
        for i in range(n):
            sub = M.MOSDOp(
                tid=msg.tids[i], client=msg.client, epoch=msg.epoch,
                pool=msg.pool, ps=msg.ps, oid=msg.oids[i],
                op=msg.ops[i], offset=msg.offsets[i],
                length=msg.lengths[i], data=msg.datas[i],
                trace=msg.traces[i] if i < len(msg.traces) else "",
                stages=msg.stages[i] if i < len(msg.stages) else "",
                flow=msg.flows[i] if i < len(msg.flows) else "")
            if rx_t is not None:
                sub._rx_t = rx_t
            self._handle_osd_op(
                sub, _BatchOpConn(conn, msg, i, state))

    def _handle_osd_op(self, msg: M.MOSDOp, conn: Connection) -> None:
        osdmap = self.get_osdmap()
        t0 = time.perf_counter()
        _TP_OP_DEQUEUE(msg.oid, msg.op, msg.client)
        self.logger.inc("op")
        ft = _flows.flows_if_active()
        if ft is not None and not getattr(msg, "_flow_noted", False):
            # admission: ops/bytes-in land once per op even when the
            # handler re-runs (map park, waiting_for_active requeue)
            msg._flow_noted = True
            try:
                ft.note_op(msg.flow, bytes_in=len(msg.data or b""))
            except Exception:
                pass
        track = self.op_tracker.create(
            f"osd_op(client={msg.client} tid={msg.tid} op={msg.op} "
            f"oid={msg.oid})")
        track.mark_event("dequeued")
        span = tracing.tracer().from_wire(
            msg.trace, f"handle_osd_op(oid={msg.oid})",
            f"osd.{self.whoami}")
        # continue the op's stage timeline (NOOP when the client sent
        # none): the ``wire`` interval ends at the messenger's receive
        # stamp, the dispatch-queue wait ends here on the op worker
        clock = stage_clock.StageClock.from_wire(msg.stages)
        rx_t = getattr(msg, "_rx_t", None)
        if rx_t is not None:
            clock.mark("wire", t=rx_t)
        clock.mark("dispatch_queue_wait")
        track.stages = clock
        # a slow-op report links straight to its kept trace/autopsy
        track.trace_id = getattr(span, "trace_id", "")
        if msg.epoch > osdmap.epoch:
            # the client targeted a newer map than we hold — park
            # until the mon push catches us up. Required for the
            # blocklist fence: the newer epoch may carry an entry this
            # map misses, and once we HAVE processed any op at epoch E
            # every later-arriving op from a client fenced at E is
            # rejected below (the fencing linearization argument)
            track.mark_event("waiting_for_map")
            track.finish()
            span.event("waiting_for_map")
            span.finish()
            self._park_for_map(
                msg.epoch, (msg.pool, msg.ps),
                lambda m=msg, c=conn: self._handle_osd_op(m, c))
            return
        if osdmap.is_blocklisted(msg.client):
            # the cluster fenced this client instance (a deposed MDS,
            # a broken rbd lock holder): nothing from it may land,
            # not even a dup-cache hit
            track.mark_event("blocklisted")
            track.finish()
            span.event("blocklisted")
            span.finish()
            conn.send_message(M.MOSDOpReply(
                tid=msg.tid, code=EBLOCKLISTED, epoch=osdmap.epoch,
                data=b"", version=0))
            return
        cache_key = (msg.client, msg.tid)
        if msg.op in self._MUTATING_OPS:
            racing = False
            with self._op_cache_lock:
                cached = self._op_cache.get(cache_key)
                if cached is None and msg.op == M.OSD_OP_APPEND:
                    t0_adm = self._op_inflight.get(cache_key)
                    racing = (t0_adm is not None
                              and time.monotonic() - t0_adm
                              < 2 * SUBOP_TIMEOUT
                              and not getattr(msg, "_admitted",
                                              False))
                    if not racing:
                        # committing to execute: marked BEFORE any
                        # park/async leg so a wire dup cannot double-
                        # apply; ``_admitted`` tags THIS message
                        # object so its own re-runs (map park,
                        # waiting_for_active, tier requeue) pass
                        # back through
                        self._op_inflight[cache_key] = \
                            time.monotonic()
                        msg._admitted = True
            if cached is not None:     # client resend of an applied op
                track.mark_event("dup_op_cached_reply")
                track.finish()
                span.event("dup_op_cached_reply")
                span.finish()
                conn.send_message(cached)
                return
            if racing:
                # a resend raced the ORIGINAL append's still-running
                # execution (the double-apply class): drop it — the
                # original's reply answers this tid, and a later
                # resend hits the dup cache
                track.mark_event("dup_op_in_flight_dropped")
                track.finish()
                span.event("dup_op_in_flight_dropped")
                span.finish()
                return

        def reply(code: int, data: bytes = b"", version: int = 0) -> None:
            self.logger.tinc("op_latency", time.perf_counter() - t0)
            _TP_OP_REPLY(msg.oid, code,
                         int((time.perf_counter() - t0) * 1e6))
            # close the primary's side of the stage timeline: the
            # interval since the last mark is the commit wait (shard
            # fan-out for writes, op execution for reads); record the
            # stages THIS daemon owns and ship the merged timeline
            # home in the reply
            clock.mark("commit_wait")
            try:
                dataplane().record_stages(
                    clock.own_durations(),
                    trace_id=getattr(span, "trace_id", "") or None)
            except Exception:
                pass           # telemetry faults never cost an op
            if ft is not None:
                try:
                    ft.note_op_done(
                        msg.flow, bytes_out=len(data),
                        latency_s=time.perf_counter() - t0,
                        trace_id=getattr(span, "trace_id", "") or None,
                        stages=clock.own_durations())
                except Exception:
                    pass
            track.finish()
            span.event(f"reply code={code}")
            if code in (EIO,):
                # infrastructure failure server-side: even if the
                # client never reads the reply, the trace survives
                # the tail decision (semantic errnos like ENOENT are
                # normal outcomes — see objecter.TRACE_ERRNOS)
                span.set_error(f"code={code}")
            span.finish()
            out = M.MOSDOpReply(
                tid=msg.tid, code=code, epoch=osdmap.epoch, data=data,
                version=version, stages=clock.to_wire())

            def deliver(code=code, out=out):
                if msg.op in self._MUTATING_OPS:
                    with self._op_cache_lock:
                        # execution obligation settled either way: a
                        # failed op may be re-executed by a resend
                        self._op_inflight.pop(cache_key, None)
                        if code == 0:
                            if cache_key not in self._op_cache:
                                self._op_cache_order.append(cache_key)
                            self._op_cache[cache_key] = out
                            while len(self._op_cache_order) > \
                                    self._OP_CACHE_MAX:
                                old = self._op_cache_order.pop(0)
                                self._op_cache.pop(old, None)
                conn.send_message(out)

            # cache-tier coherence: a successful mutation's reply is
            # held until every inval watcher dropped its cached copy
            # (the dup-cache insert rides deliver, so a resend racing
            # the hold cannot leak the ack early)
            if code == 0 and msg.op in self._MUTATING_OPS and \
                    self._inval_hold(msg.pool, msg.oid, deliver):
                return
            deliver()

        pool = osdmap.pools.get(msg.pool)
        if pool is None:
            reply(ENOENT)
            return
        ps = osdmap.object_to_pg(msg.pool, msg.oid) \
            if msg.op != M.OSD_OP_LIST else msg.ps
        _, acting, primary = osdmap.pg_to_up_acting(msg.pool, ps)
        if primary != self.whoami:
            if (msg.op == M.OSD_OP_READ and self._read_affinity
                    and not msg.snapid and not msg.gname
                    and not pool.is_cache_tier
                    and self.whoami in acting):
                # placement-affine routing (ROADMAP 3): any acting
                # member serves plain head reads — consistency holds
                # because every acked write committed on EVERY acting
                # position before the client saw the ack
                self._serve_affine_read(msg, ps, acting, reply,
                                        clock=clock, span=span)
                return
            reply(ESTALE)
            return
        pgid = (msg.pool, ps)
        with self._pgs_lock:
            pg = self.pgs.get(pgid)
            if pg is None:
                pg = PG(msg.pool, ps)
                pg.backend = self.backend_for(msg.pool)
                self.pgs[pgid] = pg
        with pg.lock:
            if pg.state != PG.ACTIVE:
                track.mark_event("waiting_for_active")
                track.finish()       # the re-run tracks a fresh op
                pg.waiting_for_active.append((msg, conn, t0))
                if pg.state == PG.CREATED:
                    pg.acting = list(acting)
                    pg.epoch = osdmap.epoch
                    self._peer(pg)
                return
            if not pg.backend.min_size_ok(pg):
                # park until enough shards return (the reference holds
                # ops while the PG is below min_size)
                track.mark_event("waiting_for_min_size")
                track.finish()
                pg.waiting_for_active.append((msg, conn, t0))
                return
            track.mark_event("reached_pg")
            span.event("reached_pg")
            if pool.is_cache_tier:
                handled = self.tier.intercept(pg, pool, msg, conn,
                                              reply)
                if handled == "parked":
                    # the promote's requeue tracks a fresh op; this
                    # entry must not linger as in-flight forever
                    track.mark_event("waiting_for_tier_promote")
                    track.finish()
                    span.finish()
                    return
                if handled:
                    return        # replied by the intercept
            tracing.set_current(span)
            stage_clock.set_current(clock)
            try:
                # the op's tenant context is current across execution
                # so store txns and engine staging self-attribute
                with _flows.flow_scope(msg.flow):
                    self._execute_op(pg, msg, reply)
            finally:
                tracing.set_current(tracing.NOOP)
                stage_clock.set_current(stage_clock.NOOP)

    def _serve_affine_read(self, msg: M.MOSDOp, ps: int,
                           acting: list, reply, clock=None,
                           span=None) -> None:
        """Serve a plain head read on a NON-PRIMARY acting member
        (placement-affine routing, ROADMAP 3). The read plans through
        a proxy PG shell — acting set + backend, nothing else — kept
        apart from self.pgs, whose entries carry primary-side
        lifecycle (a later promotion to primary peers from scratch).
        ANY failure degrades to ESTALE so the client retries at the
        primary: a replica mid-backfill must not turn its missing
        local shard into a spurious ENOENT.

        ``clock``/``span`` are the op's stage clock and trace span:
        the primary path installs them as thread-currents around PG
        processing (below); this path must do the same or an affine
        degraded read's engine decode stages under the NOOPs and
        drops out of the dataplane timeline entirely."""
        self.logger.inc("op_r")
        pgid = (msg.pool, ps)
        with self._read_pgs_lock:
            pg = self._read_pgs.get(pgid)
            if pg is None:
                pg = PG(msg.pool, ps)
                pg.backend = self.backend_for(msg.pool)
                pg.state = PG.ACTIVE
                self._read_pgs[pgid] = pg

        def read_done(data, err, msg=msg, reply=reply):
            if err is not None:
                reply(ESTALE)
                return
            if msg.length:
                data = data[msg.offset:msg.offset + msg.length]
            elif msg.offset:
                data = data[msg.offset:]
            self.logger.inc("affine_reads")
            reply(0, bytes(data))

        try:
            with pg.lock:
                pg.acting = list(acting)
                if span is not None:
                    tracing.set_current(span)
                if clock is not None:
                    stage_clock.set_current(clock)
                pg.backend.read_object_async(pg, msg.oid, read_done)
        except Exception:
            reply(ESTALE)
        finally:
            tracing.set_current(tracing.NOOP)
            stage_clock.set_current(stage_clock.NOOP)

    def _on_read_spread(self, _name: str, value) -> None:
        try:
            self._read_set_spread = max(int(value), 1)
        except (TypeError, ValueError):
            pass

    def read_set_spread(self) -> int:
        """Cached osd_read_set_spread (the config observer keeps it
        hot — backends must never re-read config per op)."""
        return self._read_set_spread

    def _flush_waiting(self, pg: PG) -> None:
        """Re-run parked ops (caller holds pg.lock, state ACTIVE)."""
        waiting, pg.waiting_for_active = pg.waiting_for_active, []
        for msg, conn, _t0 in waiting:
            self.op_wq.enqueue((msg.pool, pg.ps),
                               lambda m=msg, c=conn:
                               self._handle_osd_op(m, c))

    @staticmethod
    def _errno_for(exc: Exception) -> int:
        """Map a backend read failure to the wire errno (the async
        read continuation cannot rely on _execute_op's except ladder)."""
        if isinstance(exc, (NoSuchObject, NoSuchCollection)):
            return ENOENT
        return EIO

    @staticmethod
    def _cmpxattr(stored: bytes | None, xop: int, operand: bytes) -> int:
        """CEPH_OSD_OP_CMPXATTR comparison: 0 = match, ECANCELED =
        mismatch, EINVAL = bad mode/operand. EQ/NE compare bytes;
        GT/GTE/LT/LTE compare u64 (decimal operands), where a missing
        attr counts as 0 (the reference's u64 mode)."""
        if xop == M.CMPXATTR_EQ:
            return 0 if stored == operand else ECANCELED
        if xop == M.CMPXATTR_NE:
            return 0 if stored != operand else ECANCELED
        if xop not in (M.CMPXATTR_GT, M.CMPXATTR_GTE,
                       M.CMPXATTR_LT, M.CMPXATTR_LTE):
            return EINVAL
        try:
            have = int(stored.decode()) if stored else 0
            want = int(operand.decode())
        except (ValueError, UnicodeDecodeError):
            return EINVAL
        ok = {M.CMPXATTR_GT: have > want,
              M.CMPXATTR_GTE: have >= want,
              M.CMPXATTR_LT: have < want,
              M.CMPXATTR_LTE: have <= want}[xop]
        return 0 if ok else ECANCELED

    def _execute_op(self, pg: PG, msg: M.MOSDOp, reply) -> None:
        """do_osd_ops role (PrimaryLogPG.cc:5664). Caller holds pg.lock."""
        be = pg.backend
        op = msg.op
        try:
            if msg.gname:
                # optional guard, evaluated atomically with the op
                # under pg.lock (the single-guard reduction of the
                # reference's op vectors, where a failed CMPXATTR /
                # OMAP_CMP aborts the ops after it). GUARD_OMAP
                # compares an omap value instead of an xattr.
                if msg.gflags & M.GUARD_OMAP:
                    if not be.omap_supported():
                        reply(EOPNOTSUPP)
                        return
                    try:
                        stored = be.get_omap(
                            pg, msg.oid, [msg.gname]).get(msg.gname)
                    except (NoSuchObject, NoSuchCollection):
                        stored = None
                else:
                    try:
                        stored = be.get_xattrs(pg,
                                               msg.oid).get(msg.gname)
                    except (NoSuchObject, NoSuchCollection):
                        stored = None
                code = self._cmpxattr(stored, msg.gop or M.CMPXATTR_EQ,
                                      msg.gval)
                if code != 0:
                    reply(code)
                    return
            if msg.snap_seq and op in (M.OSD_OP_WRITE_FULL,
                                       M.OSD_OP_WRITE,
                                       M.OSD_OP_APPEND,
                                       M.OSD_OP_REMOVE,
                                       M.OSD_OP_TRUNCATE,
                                       M.OSD_OP_ZERO,
                                       M.OSD_OP_ROLLBACK,
                                       M.OSD_OP_WRITESAME,
                                       # cls methods mutate object
                                       # data too (CephFS dir entries
                                       # live behind fs.dir_link)
                                       M.OSD_OP_CALL):
                # snapshot COW (PrimaryLogPG::make_writeable role):
                # first mutation under a newer snap context clones the
                # head before the write lands
                self._make_writeable(pg, be, msg)
            if msg.snapid and op in (M.OSD_OP_READ, M.OSD_OP_STAT):
                # snap read: resolve through the snapset to the clone
                # covering the wanted snap (find_object_context role)
                oid = self._resolve_snap_oid(pg, be, msg.oid,
                                             msg.snapid)
                if op == M.OSD_OP_STAT:
                    reply(0, json.dumps(
                        {"size": be.stat_object(pg, oid)}).encode())
                    return
                data = be.read_object(pg, oid)
                if msg.length:
                    data = data[msg.offset:msg.offset + msg.length]
                elif msg.offset:
                    data = data[msg.offset:]
                reply(0, bytes(data))
                return
            if op == M.OSD_OP_WRITE_FULL:
                self.logger.inc("op_w")
                version = pg.alloc_version()
                be.submit_write(pg, msg.oid, msg.data, version,
                                lambda code, v=version: reply(code, b"", v))
            elif op in (M.OSD_OP_WRITE, M.OSD_OP_APPEND,
                        M.OSD_OP_WRITESAME):
                wdata = bytes(msg.data)
                if op == M.OSD_OP_WRITESAME:
                    # CEPH_OSD_OP_WRITESAME: tile the pattern across
                    # [offset, offset+length) (length must be a
                    # positive multiple of the pattern), then ride
                    # the ordinary ranged-write path
                    if not wdata or not msg.length or \
                            msg.length % len(wdata):
                        reply(EINVAL)
                        return
                    wdata = wdata * (msg.length // len(wdata))
                self.logger.inc("op_w")
                version = pg.alloc_version()
                if isinstance(be, ECBackend):
                    # partial-stripe RMW: only the touched stripe
                    # window is read, re-encoded, and range-written
                    # (start_rmw / get_write_plan roles). ENOENT means
                    # a fresh object; any OTHER stat failure must fail
                    # the op, or a transient shard outage would make
                    # this write silently truncate/overwrite from 0.
                    try:
                        old_size = be.stat_object(pg, msg.oid)
                    except (NoSuchObject, NoSuchCollection):
                        old_size = 0
                    # fold in-flight writes into the size BEFORE
                    # choosing the append offset: with pipelined
                    # overwrites, the committed stat lags and two
                    # back-to-back appends would land on the same
                    # offset (losing the first)
                    old_size = pg.extent_cache.effective_size(
                        msg.oid, old_size, -1)
                    off = old_size if op == M.OSD_OP_APPEND \
                        else msg.offset
                    be.submit_partial_write(
                        pg, msg.oid, off, wdata, version,
                        lambda code, v=version: reply(code, b"", v),
                        old_size=old_size)
                else:
                    # replicated: reconstruct, splice, rewrite
                    try:
                        cur = bytearray(be.read_object(pg, msg.oid))
                    except (NoSuchObject, NoSuchCollection):
                        cur = bytearray()
                    off = len(cur) if op == M.OSD_OP_APPEND \
                        else msg.offset
                    if off > len(cur):
                        cur.extend(b"\x00" * (off - len(cur)))
                    cur[off:off + len(wdata)] = wdata
                    be.submit_write(
                        pg, msg.oid, bytes(cur), version,
                        lambda code, v=version: reply(code, b"", v))
            elif op == M.OSD_OP_READ:
                self.logger.inc("op_r")

                def read_done(data, err, msg=msg, reply=reply):
                    # may run inline (intact object / host decode) or
                    # on the engine thread when a degraded read rode
                    # the signature-batched decode flush — either way
                    # reply() owns the timeline close and the send
                    if err is not None:
                        log(1, f"read {msg.oid} failed: {err}")
                        reply(self._errno_for(err),
                              b"" if isinstance(err, NoSuchObject)
                              else str(err).encode())
                        return
                    if msg.length:
                        data = data[msg.offset:msg.offset + msg.length]
                    elif msg.offset:
                        data = data[msg.offset:]
                    reply(0, bytes(data))

                # batched decode-on-read (ISSUE 8): a degraded read
                # STAGES its reconstruct on the device engine and
                # frees this op worker, so concurrent degraded reads
                # sharing an erasure signature coalesce into ONE
                # engine flush instead of serial decode_sync launches
                be.read_object_async(pg, msg.oid, read_done)
            elif op == M.OSD_OP_STAT:
                size = be.stat_object(pg, msg.oid)
                reply(0, json.dumps({"size": size}).encode())
            elif op == M.OSD_OP_REMOVE:
                be.stat_object(pg, msg.oid)   # ENOENT check
                version = pg.alloc_version()
                be.submit_remove(pg, msg.oid, version,
                                 lambda code, v=version: reply(code, b"", v))
            elif op == M.OSD_OP_CALL:
                # in-OSD object class (src/cls role): the method runs
                # here on the primary, atomically with respect to other
                # ops of this PG (we hold pg.lock); a mutation goes
                # back out through the normal versioned write path
                from ceph_tpu_torch import cls as cls_mod
                if isinstance(be, ECBackend):
                    # with this object's in-flight writes laid over
                    # the committed shards (a device pool's writes
                    # commit after the lock is released)
                    cur = be.read_object_current(pg, msg.oid)
                else:
                    try:
                        cur = bytes(be.read_object(pg, msg.oid))
                    except (NoSuchObject, NoSuchCollection):
                        cur = None
                code, out, new_obj = cls_mod.call(
                    msg.cls, msg.method, msg.data, cur)
                if code < 0:
                    reply(code)
                elif new_obj is cls_mod.REMOVE:
                    # the method dropped the object (cls_cxx_remove
                    # role, e.g. refcount.put on the last reference)
                    self.logger.inc("op_w")
                    version = pg.alloc_version()
                    be.submit_remove(
                        pg, msg.oid, version,
                        lambda c, v=version, o=out: reply(c, o, v))
                elif new_obj is not None:
                    self.logger.inc("op_w")
                    version = pg.alloc_version()
                    be.submit_write(
                        pg, msg.oid, new_obj, version,
                        lambda c, v=version, o=out: reply(c, o, v))
                else:
                    reply(0, out)
            elif op == M.OSD_OP_LIST:
                oids = self._list_pg(pg)
                reply(0, json.dumps(oids).encode())
            elif op == M.OSD_OP_GETXATTR:
                val = be.get_xattrs(pg, msg.oid).get(msg.xname)
                if val is None:
                    reply(ENODATA)
                else:
                    reply(0, val)
            elif op == M.OSD_OP_GETXATTRS:
                attrs = be.get_xattrs(pg, msg.oid)
                reply(0, json.dumps({n: v.hex() for n, v in
                                     attrs.items()}).encode())
            elif op == M.OSD_OP_CMPXATTR:
                try:
                    stored = be.get_xattrs(pg, msg.oid).get(msg.xname)
                except (NoSuchObject, NoSuchCollection):
                    stored = None
                reply(self._cmpxattr(stored,
                                     msg.xop or M.CMPXATTR_EQ,
                                     msg.data))
            elif op == M.OSD_OP_SETXATTR:
                if not msg.xname:
                    reply(EINVAL)
                    return
                self.logger.inc("op_w")
                version = pg.alloc_version()
                be.submit_setattrs(
                    pg, msg.oid, {msg.xname: bytes(msg.data)}, [],
                    version,
                    lambda code, v=version: reply(code, b"", v))
            elif op == M.OSD_OP_RMXATTR:
                if msg.xname not in be.get_xattrs(pg, msg.oid):
                    reply(ENODATA)
                    return
                self.logger.inc("op_w")
                version = pg.alloc_version()
                be.submit_setattrs(
                    pg, msg.oid, {}, [msg.xname], version,
                    lambda code, v=version: reply(code, b"", v))
            elif op in (M.OSD_OP_OMAPGET, M.OSD_OP_OMAPGETKEYS,
                        M.OSD_OP_OMAPSET, M.OSD_OP_OMAPRMKEYS):
                if not be.omap_supported():
                    # EC pools reject omap, matching the reference
                    # (PrimaryLogPG: -EOPNOTSUPP on EC pools)
                    reply(EOPNOTSUPP)
                    return
                if op == M.OSD_OP_OMAPGET:
                    spec = json.loads(msg.data) if msg.data else []
                    if isinstance(spec, dict):
                        # ranged page (omap-get-vals start_after/
                        # filter_prefix/max_return semantics): the
                        # wire transfer stays proportional to the
                        # page, not the object's whole omap
                        omap = be.get_omap(pg, msg.oid)
                        start = str(spec.get("start_after", ""))
                        pref = str(spec.get("prefix", ""))
                        mx = int(spec.get("max", 0)) or len(omap)
                        page = {}
                        for k in sorted(omap):
                            if k == OMAP_HDR_KEY:
                                continue
                            if len(page) >= mx:
                                break
                            if k <= start or not k.startswith(pref):
                                continue
                            page[k] = omap[k]
                        omap = page
                    else:
                        omap = be.get_omap(pg, msg.oid, spec or None)
                        omap.pop(OMAP_HDR_KEY, None)
                    reply(0, json.dumps({k: v.hex() for k, v in
                                         omap.items()}).encode())
                elif op == M.OSD_OP_OMAPGETKEYS:
                    omap = be.get_omap(pg, msg.oid)
                    reply(0, json.dumps(
                        sorted(k for k in omap
                               if k != OMAP_HDR_KEY)).encode())
                elif op == M.OSD_OP_OMAPSET:
                    kv = {k: bytes.fromhex(v) for k, v in
                          json.loads(msg.data).items()}
                    if not kv or OMAP_HDR_KEY in kv:
                        # the reserved header key is invisible to
                        # listings, so letting a client write it
                        # would silently clobber the omap header
                        reply(EINVAL)
                        return
                    self.logger.inc("op_w")
                    version = pg.alloc_version()
                    be.submit_omap(
                        pg, msg.oid, kv, [], version,
                        lambda code, v=version: reply(code, b"", v))
                else:                      # OMAPRMKEYS
                    keys = json.loads(msg.data) if msg.data else []
                    if OMAP_HDR_KEY in keys:
                        reply(EINVAL)
                        return
                    be.get_omap(pg, msg.oid)     # ENOENT check
                    self.logger.inc("op_w")
                    version = pg.alloc_version()
                    be.submit_omap(
                        pg, msg.oid, {}, list(keys), version,
                        lambda code, v=version: reply(code, b"", v))
            elif op == M.OSD_OP_ZERO:
                # CEPH_OSD_OP_ZERO = a ranged write of zeros, riding
                # the SAME RMW/extent-cache path as OSD_OP_WRITE so
                # pipelined in-flight writes order correctly; zeroing
                # past the end never extends (reference semantics)
                try:
                    old_size = be.stat_object(pg, msg.oid)
                except (NoSuchObject, NoSuchCollection):
                    reply(ENOENT)
                    return
                old_size = pg.extent_cache.effective_size(
                    msg.oid, old_size, -1)
                if msg.offset >= old_size or not msg.length:
                    reply(0)
                    return
                zlen = min(msg.length, old_size - msg.offset)
                self.logger.inc("op_w")
                version = pg.alloc_version()
                zeros = b"\x00" * zlen
                if isinstance(be, ECBackend):
                    be.submit_partial_write(
                        pg, msg.oid, msg.offset, zeros, version,
                        lambda code, v=version: reply(code, b"", v),
                        old_size=old_size)
                else:
                    cur = bytearray(be.read_object(pg, msg.oid))
                    cur[msg.offset:msg.offset + zlen] = zeros
                    be.submit_write(
                        pg, msg.oid, bytes(cur), version,
                        lambda code, v=version: reply(code, b"", v))
            elif op == M.OSD_OP_TRUNCATE:
                # CEPH_OSD_OP_TRUNCATE as a versioned full rewrite —
                # correct under EC stripe alignment (no stale bytes
                # survive in the final partial stripe for a later
                # append to leak). The backend orders it behind any
                # pipelined in-flight writes (EC: engine barrier).
                self.logger.inc("op_w")
                version = pg.alloc_version()
                be.submit_truncate(
                    pg, msg.oid, msg.offset, version,
                    lambda code, v=version: reply(code, b"", v))
            elif op == M.OSD_OP_CREATE:
                try:
                    be.stat_object(pg, msg.oid)
                    exists = True
                except (NoSuchObject, NoSuchCollection):
                    exists = False
                if exists:
                    # xop=1: exclusive create (CEPH_OSD_OP_CREATE with
                    # EXCL); plain create of an existing object is a
                    # no-op success
                    reply(EEXIST if msg.xop == 1 else 0)
                    return
                self.logger.inc("op_w")
                version = pg.alloc_version()
                be.submit_write(
                    pg, msg.oid, b"", version,
                    lambda code, v=version: reply(code, b"", v))
            elif op == M.OSD_OP_SPARSE_READ:
                # CEPH_OSD_OP_SPARSE_READ: extent map + data. Stores
                # here keep objects as full buffers, so the extent map
                # is the ZERO-SUPPRESSED runs of the requested range —
                # holes read back as absent extents, exactly what a
                # sparse-aware client (rbd export-diff role) wants.
                self.logger.inc("op_r")
                oid = msg.oid
                if msg.snapid:
                    oid = self._resolve_snap_oid(pg, be, msg.oid,
                                                 msg.snapid)
                data = bytes(be.read_object(pg, oid))
                end = min(len(data), msg.offset + msg.length) \
                    if msg.length else len(data)
                start = min(msg.offset, len(data))
                # C-speed run detection (a per-byte Python loop under
                # pg.lock would stall the whole PG on MB objects)
                import re as _re
                extents, payload = [], []
                for m in _re.finditer(rb"[^\x00]+", data[start:end]):
                    extents.append([start + m.start(),
                                    m.end() - m.start()])
                    payload.append(m.group())
                reply(0, json.dumps(
                    {"extents": extents,
                     "data": b"".join(payload).hex()}).encode())
            elif op == M.OSD_OP_ROLLBACK:
                # CEPH_OSD_OP_ROLLBACK (PrimaryLogPG::_rollback_to):
                # restore the head from the clone covering snapid —
                # SERVER-side and atomic under pg.lock, replacing the
                # old client-side read+rewrite. _make_writeable above
                # already preserved the pre-rollback head if the snap
                # context calls for it. Reduction (clones carry data
                # only here): attrs/omap are untouched; no covering
                # clone means the head already has the snap state.
                src = self._resolve_snap_oid(pg, be, msg.oid,
                                             msg.snapid)
                if src == msg.oid:
                    be.stat_object(pg, msg.oid)   # ENOENT check
                    reply(0)
                    return
                data = bytes(be.read_object(pg, src))
                self.logger.inc("op_w")
                version = pg.alloc_version()
                be.submit_write(
                    pg, msg.oid, data, version,
                    lambda code, v=version: reply(code, b"", v))
            elif op == M.OSD_OP_LIST_SNAPS:
                # CEPH_OSD_OP_LIST_SNAPS: the object's snapset
                ss = self._load_snapset(pg, be, msg.oid)
                try:
                    be.stat_object(pg, msg.oid)
                    head = True
                except (NoSuchObject, NoSuchCollection):
                    head = False
                if not head and not ss.get("clones"):
                    reply(ENOENT)
                    return
                reply(0, json.dumps(
                    {"seq": ss.get("seq", 0),
                     "clones": ss.get("clones", []),
                     "head_exists": head}).encode())
            elif op == M.OSD_OP_OMAPGETHEADER:
                if not be.omap_supported():
                    reply(EOPNOTSUPP)
                    return
                hdr = be.get_omap(pg, msg.oid,
                                  [OMAP_HDR_KEY]).get(OMAP_HDR_KEY)
                reply(0, hdr or b"")
            elif op == M.OSD_OP_OMAPSETHEADER:
                if not be.omap_supported():
                    reply(EOPNOTSUPP)
                    return
                self.logger.inc("op_w")
                version = pg.alloc_version()
                be.submit_omap(
                    pg, msg.oid, {OMAP_HDR_KEY: bytes(msg.data)}, [],
                    version,
                    lambda code, v=version: reply(code, b"", v))
            elif op == M.OSD_OP_OMAPCMP:
                if not be.omap_supported():
                    reply(EOPNOTSUPP)
                    return
                try:
                    stored = be.get_omap(
                        pg, msg.oid, [msg.xname]).get(msg.xname)
                except (NoSuchObject, NoSuchCollection):
                    stored = None
                reply(self._cmpxattr(stored,
                                     msg.xop or M.CMPXATTR_EQ,
                                     msg.data))
            else:
                reply(EINVAL)
        except (NoSuchObject, NoSuchCollection):
            reply(ENOENT)
        except StoreError as exc:
            log(1, f"op {msg.oid} failed: {exc}")
            # carry the diagnostic to the client (ISSUE 8: the
            # terminal ECReadError names the unreachable shard set —
            # useless if the wire flattens it to a bare errno)
            reply(EIO, str(exc).encode())

    def _list_pg(self, pg: PG) -> list[str]:
        cid = pg.backend.local_cid(pg)
        try:
            return sorted(o for o in self.store.list_objects(cid)
                          if o != PGMETA and SNAP_SEP not in o)
        except StoreError:
            return []

    # -- peering (PG.h:1831+ statechart, collapsed) -------------------
    def _peer(self, pg: PG) -> None:
        """Caller holds pg.lock. Query shards, pick the authority,
        compute per-shard missing, activate, kick recovery."""
        pg.state = PG.PEERING
        be = pg.backend
        is_ec = isinstance(be, ECBackend)
        mypos = -1
        if self.whoami in pg.acting:
            mypos = pg.acting.index(self.whoami)
        if mypos < 0:
            log(1, f"{pg}: we are not in acting, dropping")
            with self._pgs_lock:
                self.pgs.pop(pg.pgid, None)
            return

        def shard_of(pos: int) -> int:
            return pos if is_ec else NO_SHARD

        # own shard state
        my_cid = pg_cid(pg.pool, pg.ps, shard_of(mypos))
        pg.log = PGLog.load(self.store, my_cid)
        my_lv, my_objects = read_shard_info(self.store, my_cid,
                                            log=pg.log)
        # pos -> (last_version, {oid: v}, [LogEntry])
        infos: dict[int, tuple] = {
            mypos: (pg.log.last_version, my_objects,
                    list(pg.log.entries.values()))}

        # query the other up acting shards
        remote = [p for p in be.up_positions(pg) if p != mypos]
        if remote:
            tid = self.new_tid()
            wait = SubOpWait(set(remote))
            self.register_wait(tid, wait)
            for pos in remote:
                self.send_osd(pg.acting[pos], M.MPGQuery(
                    pool=pg.pool, ps=pg.ps, shard=pos,
                    epoch=pg.epoch, tid=tid))
            replies = wait.wait(SUBOP_TIMEOUT)
            self.unregister_wait(tid)
            silent = []
            for pos in remote:
                rep = replies.get(pos)
                if rep is None:
                    silent.append(pos)
                    continue
                infos[pos] = (rep.last_version,
                              dict(zip(rep.objects, rep.versions)),
                              [LogEntry(v, op, oid) for v, op, oid in
                               zip(rep.log_versions, rep.log_ops,
                                   rep.log_oids)])
            if silent:
                # an unheard shard may hold STALE data; treating it as
                # caught-up would let reads mix old chunks into a
                # decode. Stay PEERING and retry; a map change (shard
                # marked down) also re-peers us.
                log(1, f"{pg}: no notify from positions {silent} "
                    f"(osds {[pg.acting[p] for p in silent]}); "
                    "retrying peering")
                self._schedule_repeer(pg)
                return

        # authority = shard that saw the most committed ops; but all
        # per-object decisions use the MERGED survivor log, so a shard
        # whose last_version raced ahead (later writes while an old
        # push was pending) can never cause an acked object's deletion
        auth_pos = max(infos, key=lambda p: infos[p][0])
        auth_lv, auth_objects, auth_entries = infos[auth_pos]
        auth_tail = min((e.version for e in auth_entries),
                        default=auth_lv)
        # log-vs-backfill split (doc/dev/osd_internals/pg.rst): a shard
        # whose log ends below the authority's tail cannot replay the
        # gap — the entries that would bridge it were trimmed — and its
        # own entries describe possibly-since-removed objects; merging
        # them would resurrect acked deletions. Such shards are
        # BACKFILLED: their logs are ignored and the authority's
        # listing is the truth for them.
        backfill = {pos for pos, (lv, _, _) in infos.items()
                    if lv < auth_tail - 1}
        merged: dict[int, LogEntry] = {}
        for pos, (_, _, entries) in infos.items():
            if pos in backfill:
                continue
            for ent in entries:
                merged.setdefault(ent.version, ent)
        pg.log.entries = merged
        if merged:
            pg.log.tail = min(merged)
        pg.log.last_version = max(auth_lv, max(merged, default=0))

        # latest merged log entry per object = the truth for it
        latest: dict[str, LogEntry] = {}
        for v in sorted(merged):
            ent = merged[v]
            latest[ent.oid] = ent

        pg.peer_missing = {}
        pg.rollback_pending.clear()
        for pos, (lv, objects, _) in infos.items():
            missing: dict[str, int] = {}
            if pos in backfill:
                # authority listing overlaid with the surviving log
                truth = dict(auth_objects)
                for oid, ent in latest.items():
                    if ent.op == LOG_REMOVE:
                        truth.pop(oid, None)
                    else:
                        truth[oid] = ent.version
                for oid, v in truth.items():
                    if objects.get(oid, 0) != v:
                        missing[oid] = v
                for oid in objects:
                    if oid not in truth:
                        # object the truth doesn't hold on a log-gapped
                        # shard: a trimmed removal — delete it (any
                        # racing new write carries version > auth_lv
                        # and survives the push guard)
                        missing[oid] = -max(auth_lv, 1)
                if missing:
                    pg.peer_missing.setdefault(pos, {}).update(missing)
                continue
            for oid, ent in latest.items():
                have_v = objects.get(oid, 0)
                if ent.op == LOG_REMOVE:
                    if oid in objects:
                        # missed the removal; negative version marks a
                        # delete-push carrying the removal's log version
                        # so the push guard can order it vs later writes
                        missing[oid] = -ent.version
                elif have_v != ent.version:
                    missing[oid] = ent.version
            # objects older than every surviving log (stable ancient
            # data): push to shards that lack them, NEVER delete on a
            # bare listing difference
            for oid, v in auth_objects.items():
                if oid not in latest and objects.get(oid, 0) != v:
                    missing[oid] = v
            for oid, v in objects.items():
                if oid not in latest and oid not in auth_objects:
                    # a survivor holds data the authority never saw and
                    # no log explains: resurrect it everywhere
                    for other, (_, other_objs, _) in infos.items():
                        if other != pos and other_objs.get(oid, 0) < v:
                            pg.peer_missing.setdefault(
                                other, {})[oid] = v
            if missing:
                pg.peer_missing.setdefault(pos, {}).update(missing)
        if backfill:
            log(1, f"{pg}: backfilling positions {sorted(backfill)} "
                f"(logs end below authority tail {auth_tail})")
        # acting positions that answered nothing stay unknown: retried
        # on the next map change / op
        pg.state = PG.ACTIVE
        log(1, f"{pg}: peered, authority pos {auth_pos} v{auth_lv}, "
            f"missing={ {p: len(m) for p, m in pg.peer_missing.items()} }")
        self._flush_waiting(pg)
        if pg.peer_missing:
            self.op_wq.enqueue(pg.pgid, lambda: self._recover(pg),
                               qos=QOS_RECOVERY)
        # trim-on-activation (durability: the map-shrink trigger is
        # in-memory only, so an rmsnap committed while this primary
        # was down would otherwise leak its clones forever): any pool
        # that ever had snaps gets a scan after peering
        osdmap = self.get_osdmap()
        pool = osdmap.pools.get(pg.pool) if osdmap else None
        if pool is not None and pool.snap_seq and \
                pg.acting and pg.acting[0] == self.whoami:
            self.op_wq.enqueue(pg.pgid,
                               lambda p=pg: self._snap_trim(p),
                               qos=QOS_SCRUB)

    # -- scrub (PGBackend::be_compare_scrubmaps role) -----------------
    def scrub_engine(self):
        """Lazy per-OSD deep-scrub engine (osd/scrub_engine.py: the
        batched device verify + sparse-repair subsystem)."""
        engine = getattr(self, "_scrub_engine", None)
        if engine is None:
            from ceph_tpu_torch.osd.scrub_engine import DeepScrubEngine
            engine = self._scrub_engine = DeepScrubEngine(self)
        return engine

    def scrub_pg(self, pgid: tuple[int, int], repair: bool = True,
                 timeout: float = 60.0, deep: bool = False) -> dict:
        """Primary-side scrub of one PG: fan checksum reads over every
        up shard of every object, compare against the authoritative
        hinfo (EC) or the self-validating replica crcs (replicated),
        and optionally repair divergent shards through the recovery
        path. ``deep`` runs the device deep-scrub engine instead
        (fused crc + parity-re-encode verify, batched sparse repair;
        host shallow stays the fallback for pools the device path
        cannot take). Blocking external entry (harness/admin socket);
        the work runs on its own thread — scrub fan-outs can block for
        many SUBOP_TIMEOUTs and must not occupy an op_wq worker
        (client ops for unrelated PGs hash onto the same shards)."""
        done = threading.Event()
        result: dict = {}

        def run() -> None:
            try:
                result.update(self._do_scrub(pgid, repair, deep=deep))
            except Exception as exc:          # surface, don't vanish
                result["error"] = repr(exc)
            finally:
                done.set()

        threading.Thread(target=run, name=f"scrub-{pgid}",
                         daemon=True).start()
        if not done.wait(timeout):
            raise TimeoutError(f"scrub of pg {pgid} timed out")
        return result

    def _scrub_resolve_pg(self, pgid: tuple[int, int]):
        """Shared scrub entry: resolve + activate the PG on demand.
        Returns (pg, None) or (None, error dict)."""
        pool_id, ps = pgid
        osdmap = self.get_osdmap()
        _, acting, primary = osdmap.pg_to_up_acting(pool_id, ps)
        if primary != self.whoami:
            return None, {"error": "not primary"}
        with self._pgs_lock:
            pg = self.pgs.get(pgid)
            if pg is None:
                # a PG that served no op since failover still needs
                # scrubbing: instantiate + peer it on demand
                pg = PG(pool_id, ps)
                pg.backend = self.backend_for(pool_id)
                self.pgs[pgid] = pg
        with pg.lock:
            if pg.state == PG.CREATED:
                pg.acting = list(acting)
                pg.epoch = osdmap.epoch
                self._peer(pg)
            if pg.state != PG.ACTIVE:
                return None, {"error": "pg not active here"}
        return pg, None

    def _do_scrub(self, pgid: tuple[int, int], repair: bool,
                  deep: bool = False) -> dict:
        pg, err = self._scrub_resolve_pg(pgid)
        if err is not None:
            return err
        if deep:
            res = self.scrub_engine().deep_scrub_pg(pg, repair=repair)
            if res is not None:
                return res
            # pool/codec the device path cannot take: the host
            # shallow scrub below is the documented fallback
        listing = self._scrub_listing(pg)
        with pg.lock:
            latest: dict[str, int] = {}
            for v in sorted(pg.log.entries):
                latest[pg.log.entries[v].oid] = pg.log.entries[v].op
        inconsistent: dict[str, list[int]] = {}
        repairable: dict[str, list[int]] = {}
        for oid in listing:
            if latest.get(oid) == LOG_REMOVE:
                # the log says this object is deleted: a lingering
                # copy is recovery's cleanup, not an inconsistency
                # to "repair" back into existence
                continue
            bad, auth_version = self._scrub_object(pg, oid)
            if not bad:
                continue
            inconsistent[oid] = sorted(bad)
            if repair and auth_version > 0:
                # auth_version 0 = no shard produced a judgeable copy
                # (all EIO): report unrepairable, and never push a
                # version-0 entry that build_push would read as removal
                repairable[oid] = sorted(bad)
                with pg.lock:
                    for pos in bad:
                        pg.peer_missing.setdefault(pos, {})[
                            oid] = auth_version
        out = {"objects": len(listing),
               "inconsistent": inconsistent, "repaired": []}
        if repair and repairable:
            self._repair_primary_copies(pg, repairable)
            # the heartbeat's _kick_recovery may already be running a
            # round (in which case _recover returns immediately): keep
            # kicking until the repair targets drain or time runs out,
            # and judge "repaired" from peer_missing, not from one
            # round's acks
            deadline = time.monotonic() + SUBOP_TIMEOUT * 4
            while time.monotonic() < deadline:
                self._recover(pg)
                with pg.lock:
                    pending = [
                        oid for oid, bad in repairable.items()
                        if any(oid in pg.peer_missing.get(pos, {})
                               for pos in bad)]
                if not pending:
                    break
                time.sleep(0.05)
            with pg.lock:
                out["repaired"] = [
                    oid for oid, bad in repairable.items()
                    if all(oid not in pg.peer_missing.get(pos, {})
                           for pos in bad)]
        return out

    # -- pool snapshots (PrimaryLogPG snapset + snap trimming) --------
    # Reference roles: SnapSet/clone handling in PrimaryLogPG.cc
    # (make_writeable, find_object_context) and snap_mapper.h. The
    # reduction here: clones and the snapset ride as ORDINARY objects
    # through the backend (so replication/EC, recovery, scrub and the
    # log all apply to them unchanged), and the trimmer finds work by
    # scanning the primary shard's listing instead of a SnapMapper
    # index — right for this scale, O(objects) per trim pass.

    def _load_snapset(self, pg: PG, be, oid: str) -> dict:
        try:
            return json.loads(bytes(be.read_object(pg,
                                                   snapset_oid(oid))))
        except (NoSuchObject, NoSuchCollection):
            return {"seq": 0, "clones": []}

    def _store_snapset(self, pg: PG, be, oid: str, ss: dict) -> None:
        version = pg.alloc_version()
        be.submit_write(pg, snapset_oid(oid),
                        json.dumps(ss, sort_keys=True).encode(),
                        version, lambda code: None)

    def _make_writeable(self, pg: PG, be, msg: M.MOSDOp) -> None:
        """First mutation under a snap context newer than the object's
        snapset seq: preserve the head as a clone object covering the
        new snaps (PrimaryLogPG::make_writeable). Caller holds
        pg.lock; the clone/snapset writes take their own versions, so
        the actual op's version allocation must happen AFTER this."""
        ss = self._load_snapset(pg, be, msg.oid)
        seq = ss.get("seq", 0)
        if msg.snap_seq <= seq:
            return
        try:
            head = bytes(be.read_object(pg, msg.oid))
        except (NoSuchObject, NoSuchCollection):
            # no head to preserve: advance seq so a later write under
            # this context does not clone a head born after the snap
            ss["seq"] = msg.snap_seq
            self._store_snapset(pg, be, msg.oid, ss)
            return
        covered = sorted(s for s in msg.snaps if s > seq) or \
            [msg.snap_seq]
        clone_id = covered[-1]
        version = pg.alloc_version()
        be.submit_write(pg, snap_clone_oid(msg.oid, clone_id), head,
                        version, lambda code: None)
        ss["seq"] = msg.snap_seq
        ss.setdefault("clones", []).append(
            {"id": clone_id, "snaps": covered, "size": len(head)})
        self._store_snapset(pg, be, msg.oid, ss)
        self.logger.inc("snap_clones")

    def _resolve_snap_oid(self, pg: PG, be, oid: str,
                          snapid: int) -> str:
        """Object name serving a read at ``snapid``: the FIRST clone
        (ascending) whose id >= snapid covers it; no such clone means
        the head is unchanged since the snap."""
        ss = self._load_snapset(pg, be, oid)
        for c in ss.get("clones", []):
            if c["id"] >= snapid:
                return snap_clone_oid(oid, c["id"])
        return oid

    def _snap_trim(self, pg: PG) -> int:
        """Reclaim clones whose snaps were all deleted (snap trimmer
        role): runs on the primary from the map-change hook, as
        scrub-class queue work. Returns clones removed."""
        osdmap = self.get_osdmap()
        pool = osdmap.pools.get(pg.pool)
        if pool is None:
            return 0
        with pg.lock:
            if pg.state != PG.ACTIVE:
                return 0
            be = pg.backend
            cid = be.local_cid(pg)
            try:
                names = self.store.list_objects(cid)
            except StoreError:
                return 0
            suffix = SNAP_SEP + "ss"
            removed = 0
            for name in names:
                if not name.endswith(suffix):
                    continue
                oid = name[:-len(suffix)]
                try:
                    ss = self._load_snapset(pg, be, oid)
                except StoreError:
                    continue
                keep, changed = [], False
                for c in ss.get("clones", []):
                    live = [s for s in c["snaps"]
                            if pool.snap_is_live(s)]
                    if not live:
                        version = pg.alloc_version()
                        be.submit_remove(
                            pg, snap_clone_oid(oid, c["id"]), version,
                            lambda code: None)
                        removed += 1
                        changed = True
                    elif live != c["snaps"]:
                        keep.append({**c, "snaps": live})
                        changed = True
                    else:
                        keep.append(c)
                if not changed:
                    continue
                ss["clones"] = keep
                if not keep:
                    # no clones left: the snapset survives only to
                    # carry seq for a LIVE head; a deleted head's
                    # snapset goes too
                    try:
                        be.stat_object(pg, oid)
                        self._store_snapset(pg, be, oid, ss)
                    except (NoSuchObject, NoSuchCollection):
                        version = pg.alloc_version()
                        be.submit_remove(pg, snapset_oid(oid), version,
                                         lambda code: None)
                else:
                    self._store_snapset(pg, be, oid, ss)
            if removed:
                log(1, f"{pg}: snap trim removed {removed} clones")
                self.logger.inc("snap_trims", removed)
        return removed

    def _scrub_listing(self, pg: PG) -> list[str]:
        """Union of every up shard's object listing (the reference
        builds scrubmaps from EVERY shard and compares them,
        be_compare_scrubmaps): an object present only on a replica —
        stale leftover, or lost from the primary — still gets judged."""
        oids = set(self._list_pg(pg))
        positions = [p for p in pg.backend.up_positions(pg)
                     if pg.acting[p] != self.whoami]
        if positions:
            tid = self.new_tid()
            wait = SubOpWait(set(positions))
            self.register_wait(tid, wait)
            for pos in positions:
                self.send_osd(pg.acting[pos], M.MPGQuery(
                    pool=pg.pool, ps=pg.ps, shard=pos,
                    epoch=pg.epoch, tid=tid))
            replies = wait.wait(SUBOP_TIMEOUT)
            self.unregister_wait(tid)
            for rep in replies.values():
                oids.update(rep.objects)
        return sorted(oids)

    SCRUB_ATTEMPTS = 3

    def _scrub_object(self, pg: PG, oid: str
                      ) -> tuple[set[int], int]:
        """Compare one object across shards; returns (bad positions,
        authoritative version).

        Scrub runs ONLINE, so the observation can race an in-flight
        write or removal. Two defenses: (a) version disagreement is
        retried, and never by itself convicts a shard — a laggard
        mid-commit shard is catching up, not corrupt (missed-write
        divergence is peering's job, via the log); (b) conviction
        requires SELF-inconsistency — computed crc mismatching the
        shard's own stored hinfo (EC) / crc attr (replicated) — or a
        read error (EIO / unexpected ENOENT)."""
        be = pg.backend
        is_ec = isinstance(be, ECBackend)
        for attempt in range(self.SCRUB_ATTEMPTS):
            positions = be.up_positions(pg)
            tid = self.new_tid()
            wait = SubOpWait(set(positions))
            self.register_wait(tid, wait)
            for pos in positions:
                self.send_osd(pg.acting[pos], M.MECSubRead(
                    tid=tid, pool=pg.pool, ps=pg.ps, shard=pos, oid=oid,
                    offset=0, length=0, want_attrs=True, csum_only=True))
            replies = wait.wait(SUBOP_TIMEOUT)
            self.unregister_wait(tid)

            obs: dict[int, tuple[int, int, dict]] = {}  # pos->(v,crc,attrs)
            bad: set[int] = set()
            enoent: set[int] = set()
            for pos in positions:
                rep = replies.get(pos)
                if rep is None:
                    continue           # silent shard: not judged
                if rep.code == -2:
                    enoent.add(pos)
                    continue
                if rep.code != 0:
                    bad.add(pos)       # EIO
                    continue
                obs[pos] = (rep.version, rep.crc, dict(rep.attrs))
            vers = {v for v, _, _ in obs.values()}
            settled = len(vers) <= 1 and not (obs and enoent)
            if settled or attempt == self.SCRUB_ATTEMPTS - 1:
                break
            time.sleep(0.05 * (attempt + 1))   # mid-write: re-observe

        if not obs:
            # nothing judgeable: all-ENOENT = concurrently removed (or
            # never existed here) — clean; EIO-everywhere = bad but
            # unrepairable (auth 0 ⇒ caller won't push)
            return bad, 0
        # shards that still lack the object while others hold it
        bad |= enoent
        auth_version = 0
        if is_ec:
            # each shard carries the full hinfo vector; a shard whose
            # chunk crc mismatches its OWN stored hinfo is corrupt. A
            # shard WITHOUT hinfo (partial-stripe overwrites drop it)
            # has no app-level self-check — integrity rests on the
            # store's blob checksums, as the reference's EC-overwrite
            # pools rest on bluestore csums (surfaced as EIO above).
            clean: dict[int, int] = {}
            for pos, (v, crc, attrs) in obs.items():
                hraw = attrs.get("hinfo")
                if not hraw:
                    clean[pos] = v
                    continue
                try:
                    hinfo = ec_util.HashInfo.from_dict(json.loads(hraw))
                    ok = crc == hinfo.get_chunk_hash(pos)
                except (ValueError, KeyError, TypeError):
                    ok = False         # unparseable hinfo: corrupt
                if ok:
                    clean[pos] = v
                else:
                    bad.add(pos)
            if clean:
                auth_version = max(clean.values())
        else:
            # a replica whose computed crc mismatches the crc stored at
            # write time convicts itself — no vote needed, which is what
            # saves a size=2 pool from electing the corrupt copy
            clean = {}
            for pos, (v, crc, attrs) in obs.items():
                stored = attrs.get("crc")
                if stored is not None and \
                        int.from_bytes(stored, "little") != crc:
                    bad.add(pos)
                else:
                    clean[pos] = v
            if clean:
                # deepest self-consistent version is the authority
                # (be_select_auth_object prefers deepest version)
                auth_version = max(clean.values())
        if bad:
            log(1, f"{pg}: scrub found {oid} inconsistent at "
                f"positions {sorted(bad)}")
        return bad, auth_version

    def _repair_primary_copies(self, pg: PG,
                               inconsistent: dict[str, list[int]]) -> None:
        """Replicated repair reads the PRIMARY copy; if the primary's
        own copy is the bad one, pull a good replica's first (the bad
        positions are already in peer_missing, so _pull_copy skips
        them as donors)."""
        be = pg.backend
        if isinstance(be, ECBackend):
            return                      # EC reconstructs around any shard
        mypos = pg.acting.index(self.whoami) \
            if self.whoami in pg.acting else -1
        for oid, bad in inconsistent.items():
            if mypos not in bad:
                continue
            with pg.lock:
                want = pg.peer_missing.get(mypos, {}).get(oid, 1)
            data, attrs, omap, version = be._pull_copy(
                pg, oid, max(want, 1), exclude={mypos})
            if data is None:
                continue
            cid = be.local_cid(pg)
            txn = object_write_txn(
                cid, oid, data, version,
                attrs={k: v for k, v in attrs.items() if k != "v"},
                replace=True)
            if omap:
                txn.omap_set(cid, oid, dict(omap))
            self.queue_local_txn(txn, lambda: None)
            with pg.lock:
                missing = pg.peer_missing.get(mypos)
                if missing:
                    missing.pop(oid, None)
                    if not missing:
                        pg.peer_missing.pop(mypos, None)

    def _schedule_repeer(self, pg: PG, delay: float = 0.5) -> None:
        def retry() -> None:
            if self._stopping:
                return
            with pg.lock:
                if pg.state == PG.PEERING:
                    self._peer(pg)

        timer = threading.Timer(
            delay, lambda: self.op_wq.enqueue(pg.pgid, retry))
        timer.daemon = True
        timer.start()

    # -- recovery (continue_recovery_op role) -------------------------
    def _reserve_recovery(self) -> bool:
        limit = g_conf()["osd_max_backfills"]
        with self._recovery_res_lock:
            if self._recovery_active >= limit:
                return False
            self._recovery_active += 1
            return True

    def _unreserve_recovery(self) -> None:
        with self._recovery_res_lock:
            self._recovery_active -= 1

    def _recover(self, pg: PG) -> dict[int, list[str]]:
        acked_by_pos: dict[int, list[str]] = {}
        with pg.lock:
            # prune positions whose missing set emptied (e.g. a
            # full-shard write superseded the recovery)
            for pos in [p for p, m in pg.peer_missing.items() if not m]:
                del pg.peer_missing[pos]
            if pg.state != PG.ACTIVE or not pg.peer_missing \
                    or pg.recovery_in_flight:
                return acked_by_pos
            if not self._reserve_recovery():
                # over the per-OSD reservation budget: leave the PG
                # dirty; the tick requeues it when a slot frees
                return acked_by_pos
            pg.recovery_in_flight = True
            # cap the round (osd_recovery_max_single_start role): a
            # queue item pushes at most this many objects PER POSITION
            # then yields the wq shard back — the granularity the WPQ
            # needs to keep client latency bounded during recovery
            cap = max(1, g_conf()["osd_recovery_max_single_start"])
            work: dict[int, dict[str, int]] = {}
            truncated_pos: set[int] = set()
            for pos, missing in pg.peer_missing.items():
                take = dict(list(missing.items())[:cap])
                if len(take) < len(missing):
                    # THIS position has more beyond the cap; others
                    # that fit fully may still log-sync this round
                    truncated_pos.add(pos)
                if take:
                    work[pos] = take
            truncated = bool(truncated_pos)
            # snapshot: a peering mid-round swaps which OSD holds a
            # position and recomputes peer_missing; a stale round must
            # neither push to the new holder as if it were the old one
            # nor clear entries the new peering computed
            acting = list(pg.acting)
            epoch = pg.epoch
        try:
            self._recover_work(pg, work, acked_by_pos, acting, epoch,
                               truncated_pos=truncated_pos)
        finally:
            with pg.lock:
                pg.recovery_in_flight = False
            self._unreserve_recovery()
            if truncated:
                # more missing objects remain: continue as a NEW
                # recovery-class item (client ops interleave between
                # chunks via the WPQ credits)
                self.op_wq.enqueue(pg.pgid,
                                   lambda: self._recover(pg),
                                   qos=QOS_RECOVERY)
        return acked_by_pos

    def _recover_work(self, pg: PG, work: dict[int, dict[str, int]],
                      acked_by_pos: dict[int, list[str]],
                      acting: list[int], epoch: int,
                      truncated_pos: set[int] | None = None) -> None:
        unrebuildable: dict[str, int] = {}    # oid -> wanted version
        for pos, missing in work.items():
            osd = acting[pos] if pos < len(acting) else -1
            if osd < 0:
                continue
            tid = self.new_tid()
            wait = SubOpWait(set(missing))
            self.register_wait(tid, wait)
            # build the round's pushes CONCURRENTLY: shard-read fan-
            # outs overlap their network round trips, and the decode
            # of every reconstruct lands in the device engine inside
            # one batching window — a mass-recovery round flushes as
            # a few signature-grouped kernel launches instead of one
            # launch per object (the RecoveryMessages batching idea,
            # src/osd/ECBackend.cc:253, applied to the compute)
            def build(item):
                oid, version = item
                try:
                    return oid, version, pg.backend.build_push(
                        pg, oid, pos, version, tid)
                except StoreError as exc:
                    log(1, f"{pg}: recover {oid}->pos {pos} failed: "
                        f"{exc}")
                    return oid, version, None

            if len(missing) > 1:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(
                        max_workers=min(8, len(missing)),
                        thread_name_prefix="recover-build") as pool:
                    built = list(pool.map(build, missing.items()))
            else:
                built = [build(item) for item in missing.items()]
            for oid, version, push in built:
                if push is None:
                    wait.drop(oid)
                    if version > 0:
                        unrebuildable[oid] = max(
                            unrebuildable.get(oid, 0), version)
                    continue
                with pg.lock:
                    pg.rollback_pending.pop(oid, None)
                _TP_RECOVERY_PUSH(oid, pos, version)
                if osd == self.whoami:
                    # apply inline (we run on this PG's wq thread; the
                    # self-reply completes the wait synchronously)
                    self._handle_pg_push(push, _SelfConn(self))
                else:
                    self.send_osd(osd, push)
            replies = wait.wait(SUBOP_TIMEOUT * 2)
            self.unregister_wait(tid)
            acked = [oid for oid, rep in replies.items()
                     if getattr(rep, "committed", False)]
            acked_by_pos[pos] = acked
            # the shard's pgmeta only advances once every pushed object
            # is acked durable — a lost push leaves it visibly behind,
            # so the next peering retries instead of trusting it.
            # A position truncated by the round cap can never
            # log-sync yet: objects beyond the cap are still missing.
            if set(acked) == set(missing) and \
                    pos not in (truncated_pos or ()):
                self._log_sync_shard(pg, pos, acked, acting, epoch)
            elif acked:
                with pg.lock:
                    if pg.epoch == epoch:
                        m = pg.peer_missing.get(pos)
                        if m:
                            for oid in acked:
                                m.pop(oid, None)
                log(1, f"{pg}: pos {pos} partial recovery "
                    f"({len(acked)}/{len(missing)}), log-sync deferred")
        if unrebuildable:
            self._try_rollback(pg, unrebuildable, acting, epoch)

    def _try_rollback(self, pg: PG, failed: dict[str, int],
                      acting: list[int], epoch: int) -> None:
        """Objects no recovery round can rebuild (a write that died
        before reaching enough shards): after two consecutive failed
        rounds, roll them back cluster-wide through the backend (EC
        log-rollback role). Hysteresis matters — a single failure may
        just be a fan-out still in flight."""
        for oid, wanted in failed.items():
            with pg.lock:
                n = pg.rollback_pending.get(oid, 0) + 1
                pg.rollback_pending[oid] = n
            if n < 2:
                continue
            pushes = pg.backend.recover_rollback(pg, oid, wanted)
            if not pushes:
                continue
            waits = []
            for pos, push in pushes.items():
                tid = self.new_tid()
                push.tid = tid
                w = SubOpWait({oid})
                self.register_wait(tid, w)
                osd = acting[pos] if pos < len(acting) else -1
                if osd == self.whoami:
                    self._handle_pg_push(push, _SelfConn(self))
                elif osd >= 0:
                    self.send_osd(osd, push)
                else:
                    self.unregister_wait(tid)
                    continue
                waits.append((pos, tid, w))
            for pos, tid, w in waits:
                reps = w.wait(SUBOP_TIMEOUT)
                self.unregister_wait(tid)
                rep = reps.get(oid)
                if rep is not None and getattr(rep, "committed", False):
                    with pg.lock:
                        if pg.epoch != epoch:
                            continue
                        m = pg.peer_missing.get(pos)
                        if m:
                            m.pop(oid, None)
                            if not m:
                                pg.peer_missing.pop(pos, None)
            with pg.lock:
                pg.rollback_pending.pop(oid, None)

    def _log_sync_shard(self, pg: PG, pos: int, oids: list[str],
                        acting: list[int], epoch: int) -> None:
        # build the sync under the lock so a concurrent re-peer can't
        # swap the log (or the position's holder) between the epoch
        # check and the txn construction; destination comes from the
        # round's acting SNAPSHOT, never the live acting
        with pg.lock:
            if pg.epoch != epoch:
                # a peering ran mid-round: the position may name a
                # different OSD now, and peer_missing was recomputed —
                # this round's bookkeeping no longer applies
                log(1, f"{pg}: pos {pos} recovery round from epoch "
                    f"{epoch} superseded, not log-syncing")
                return
            is_ec = isinstance(pg.backend, ECBackend)
            shard = pos if is_ec else NO_SHARD
            cid = pg_cid(pg.pool, pg.ps, shard)
            kv: dict[str, bytes] = {}
            from ceph_tpu_torch.utils.encoding import Encoder
            for v, ent in pg.log.entries.items():
                ee = Encoder(); ent.encode(ee)
                kv[f"log/{v:016d}"] = ee.getvalue()
            kv["info"] = PGLog._info_bytes(pg.log.last_version,
                                           pg.log.tail)
            last_version = pg.log.last_version
        txn = Transaction()
        txn.create_collection(cid)
        txn.touch(cid, PGMETA)
        # REPLACE the shard's log namespace: a backfilled shard's stale
        # pre-gap entries must not survive the sync (omap_set merges),
        # or the next peering would merge them back in as truth
        txn.omap_rmrange(cid, PGMETA, "log/")
        txn.omap_set(cid, PGMETA, kv)
        tid = self.new_tid()
        iw = InflightWrite(tid, pg, "", last_version, {pos},
                           lambda: self._mark_recovered(
                               pg, pos, oids, epoch))
        self.register_write(iw)
        osd = acting[pos] if pos < len(acting) else -1
        if osd == self.whoami:
            self.queue_local_txn(
                txn, lambda: iw.complete(pos) and iw.on_all_commit())
        elif osd >= 0:
            self.send_osd(osd, M.MECSubWrite(
                tid=tid, pool=pg.pool, ps=pg.ps, shard=pos,
                epoch=epoch, oid="", version=last_version,
                txn_bytes=txn.encode()))

    def _mark_recovered(self, pg: PG, pos: int, oids: list[str],
                        epoch: int) -> None:
        with pg.lock:
            if pg.epoch != epoch:
                log(1, f"{pg}: pos {pos} recovery completion from "
                    f"epoch {epoch} superseded, not clearing")
                return
            missing = pg.peer_missing.get(pos)
            if missing:
                for oid in oids:
                    missing.pop(oid, None)
                if not missing:
                    del pg.peer_missing[pos]
            log(1, f"{pg}: pos {pos} recovered {len(oids)} objects")

    def _expire_inflight(self, now: float) -> None:
        """Abandon write fan-outs that never completed (lost sub-op or
        reply with the shard still up): record the unheard shards as
        missing and drop the entry. No client reply is sent — the
        client resends, and the dup-op cache only answers for writes
        that DID fully commit."""
        stale_after = 6 * SUBOP_TIMEOUT
        # prune abandoned append admissions (their suppression window
        # closed long ago; entries whose op never replied must not
        # accumulate for the process lifetime)
        with self._op_cache_lock:
            for key in [k for k, t in self._op_inflight.items()
                        if now - t > stale_after]:
                del self._op_inflight[key]
        with self._sub_lock:
            stale = [iw for iw in self._inflight.values()
                     if now - iw.created_at > stale_after]
            for iw in stale:
                del self._inflight[iw.tid]
        for iw in stale:
            dropped, fire = iw.expire()
            if dropped:
                log(1, f"write tid {iw.tid} ({iw.oid}) expired with "
                    f"positions {dropped} unheard")
            if dropped or fire is not None:
                # one wq job, ordered with the PG's client ops: record
                # the dropped shards missing BEFORE the extent-cache
                # unpin fires, or a racing RMW could snapshot a cache
                # lacking the expired version yet still read the stale
                # shard as its floor (lost update)
                def _expired(w=iw, d=dropped, f=fire):
                    self._record_missing(w, d)
                    if f is not None:
                        f()
                self.op_wq.enqueue(iw.pg.pgid, _expired)

    def _kick_recovery(self) -> None:
        """Retry recovery for PGs whose missing set persists (a push
        failed or a shard was unreachable last round) — the reference's
        recovery-reservation requeue. Runs from the heartbeat tick."""
        with self._pgs_lock:
            pgs = list(self.pgs.values())
        for pg in pgs:
            # lock-free peek (pg.lock may be held for seconds by a
            # blocked fan-out and this runs on the heartbeat thread —
            # blocking here would stall beacons); _recover re-checks
            # everything under the lock
            if pg.state == PG.ACTIVE and not pg.recovery_in_flight \
                    and pg.missing_dirty():
                self.op_wq.enqueue(pg.pgid,
                                   lambda p=pg: self._recover(p),
                                   qos=QOS_RECOVERY)

    def _report_pg_stats(self, epoch: int) -> None:
        """Ship primary-side PG stats to the mon (MgrClient report
        role; the reference reports to the mgr, which feeds pgmap
        into 'ceph -s'). Lock-free peek — the mon tolerates slightly
        stale numbers."""
        with self._pgs_lock:
            pgs = list(self.pgs.values())
        stats = []
        for pg in pgs:
            try:
                missing = sum(len(m) for m in pg.peer_missing.values())
            except RuntimeError:
                missing = -1          # mutating right now: report dirty
            cid = pg.backend.local_cid(pg) if pg.backend else ""
            try:
                objects = sum(1 for o in self.store.list_objects(cid)
                              if o != PGMETA)
            except StoreError:
                objects = 0
            stats.append({"pgid": f"{pg.pool}.{pg.ps}",
                          "state": pg.state,
                          "missing": missing, "objects": objects,
                          "version": pg.log.last_version})
        self.monc.msgr.send_message(
            M.MPGStats(osd_id=self.whoami, epoch=epoch,
                       stats=json.dumps(stats).encode()),
            self.monc.mon_addr)

    def _refresh_rotating(self) -> None:
        """Keep a fetched-mode rotating-key window warm (the
        reference daemon's periodic rotating-secrets refresh). A
        denial means WE were revoked: keep running — once the cached
        window ages out, peers refuse our frames (the fence)."""
        from ceph_tpu_torch.parallel import auth as A
        provider = getattr(self.msgr, "rotating_provider", None)
        if not isinstance(provider, A.FetchedKeyProvider) or \
                not provider.needs_refresh():
            return
        entity = f"osd.{self.whoami}"
        try:
            gens = self.monc.fetch_rotating(
                entity, self._keyring.get(entity))
            provider.install(gens)
        except A.AuthError as exc:
            log(1, f"rotating-key refresh denied (revoked?): {exc}")
        except Exception as exc:
            log(5, f"rotating-key refresh failed: {exc!r}")

    # -- heartbeats ----------------------------------------------------
    def _heartbeat_loop(self) -> None:
        interval = g_conf()["osd_heartbeat_interval"]
        grace = g_conf()["osd_heartbeat_grace"]
        while not self._hb_stop.wait(interval):
            osdmap = self.get_osdmap()
            if osdmap is None:
                continue
            self._refresh_rotating()
            self.tier.agent_tick()
            self.monc.beacon(self.whoami, osdmap.epoch)
            now = time.monotonic()
            self._expire_inflight(now)
            # stranded-barrier backstop (group commit, ROADMAP 1a): a
            # deferred txn group whose last-group barrier died (wq
            # handler exception, shutdown race) must not strand acked
            # writes — flush it on the tick (cheap attribute check
            # when nothing is parked)
            if self.store.barrier_pending():
                self.store.barrier()
            self._sweep_notifies()
            self._kick_recovery()
            self.op_tracker.check_slow()
            self._report_pg_stats(osdmap.epoch)
            for osd, info in osdmap.osds.items():
                if osd == self.whoami:
                    continue
                if not info.up or not info.addr:
                    # forget silence history so a rejoining peer gets a
                    # fresh grace window
                    self._hb_last_rx.pop(osd, None)
                    continue
                last = self._hb_last_rx.setdefault(osd, now)
                if now - last > grace:
                    log(5, f"osd.{osd} silent {now - last:.1f}s, "
                        "reporting failure")
                    self.monc.report_failure(
                        osd, self.whoami, osdmap.epoch, now - last)
                self.msgr.send_message(
                    M.MPing(osd_id=self.whoami, epoch=osdmap.epoch,
                            stamp=now), info.addr)


class _BatchOpConn:
    """Connection shim for one entry of an MOSDOpBatch: collects the
    entry's MOSDOpReply and, once every entry of the frame has
    replied, ships ONE MOSDOpReplyBatch on the real connection.
    Everything else (peer identity, tier intercepts, parking in
    ``waiting_for_active``) delegates to the inbound connection, so
    the singleton op path runs unchanged underneath."""

    __slots__ = ("_conn", "_msg", "_i", "_state")

    def __init__(self, conn: Connection, msg: "M.MOSDOpBatch",
                 i: int, state: dict) -> None:
        self._conn = conn
        self._msg = msg
        self._i = i
        self._state = state

    def __getattr__(self, name):
        return getattr(self._conn, name)

    def send_message(self, reply: M.Message) -> None:
        if not isinstance(reply, M.MOSDOpReply):
            self._conn.send_message(reply)
            return
        state = self._state
        with state["lock"]:
            if state["replies"][self._i] is not None:
                return          # dup reply for this entry: drop
            state["replies"][self._i] = reply
            state["left"] -= 1
            if state["left"]:
                return
            replies = state["replies"]
        m = self._msg
        self._conn.send_message(M.MOSDOpReplyBatch(
            tid=m.tid,
            tids=[r.tid for r in replies],
            codes=[r.code for r in replies],
            epochs=[r.epoch for r in replies],
            versions=[r.version for r in replies],
            datas=[r.data for r in replies],
            stages=[r.stages for r in replies]))


class _SelfConn:
    """Connection stand-in for messages an OSD sends to itself."""

    def __init__(self, osd: OSD) -> None:
        self._osd = osd
        self.peer_name = osd.msgr.entity_name
        self.peer_addr = osd.addr
        self.closed = False

    def send_message(self, msg: M.Message) -> None:
        self._osd._dispatch(
            M.decode_message(msg.MSG_TYPE, msg.encode_payload()), self)
