"""Dispatch telemetry — the dispatch-path X-ray (ISSUE 17).

PR 15 closed the commit path's durability cost; what is left of
``commit_wait`` on the CPU loopback is pure dispatch machinery — wq
handoffs, engine continuations bouncing between threads, per-op
completion wakeups, and lock ping-pong. ROADMAP item 1(a) demands the
residue be profile-attributed BEFORE the run-to-completion rewrite;
this registry is the instrument, PR 14's ``store`` registry aimed at
dispatch instead of durability. Three attribution planes:

1. **Causal handoff tracing.** Every queue seam an op crosses records
   a handoff span into per-seam counters (exact time_avg sums + pow2
   microsecond histograms), and the per-op stage timeline grows the
   hop marks — ``dispatch_queue_wait`` (wq_op), ``engine_stage_wait``
   (engine_stage), and the NEW ``commit_handoff`` child stage (the
   engine-retire -> op-wq continuation re-enqueue, split out of
   ``commit_dispatch``) — so each completed op yields a causal chain
   ``admission -> N hops -> commit reply`` (:func:`chain_of`), counted
   into ``hops_per_op`` when the client records it.

2. **Wakeup + lock-wait attribution.** The objecter's completion
   wakeups are counted per client connection — reply frames vs ops
   woken (wakeups-per-flush) and the signal->wake latency — and the
   opt-in lock-timing layer (``analysis/lock_witness``'s timing mode)
   feeds per-named-lock wait/hold sums and condvar signal->wake
   latency into the same registry.

3. **A run-to-completion what-if ledger.** :meth:`rtc_projection`
   replays the measured counts under the item-1 design rules —
   continuations run inline on the owning shard (the continuation
   handoff disappears), the engine window is the only async boundary,
   one flush => one wakeup per client connection — and projects hops
   saved, wakeups saved, and a first-order ``whatif_rtc_MBps`` with
   exactly PR 14's latency-scaling model.

Everything time-valued takes an injectable ``now``/explicit duration
so the scripted-schedule tests need no sleeping. Plain counters live
in the process PerfCounters collection (prometheus / perf dump /
flight recorder for free); side tables (per-connection wakeups,
per-lock waits, the recent-chain ring) are bounded.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ceph_tpu_torch.utils.perf_counters import PerfCounters, collection

#: every queue seam a handoff span can land on. A "handoff" is one
#: cross-thread hop: enqueue on the producer thread -> dequeue on the
#: consumer thread; the span is the wait between them.
SEAMS = (
    "wq_op",            # ShardedOpWQ enqueue -> worker dequeue (ops)
    "wq_continuation",  # engine retire -> op-wq continuation dequeue
    "engine_stage",     # producer stage_* put -> engine thread pickup
    "msgr_send",        # send_message() -> messenger loop pickup
    "msgr_dispatch",    # rx stamp -> dispatcher entry (loopback hop)
    "reply_wakeup",     # completion event.set -> waiter running
    "reactor_submit",   # cross-thread submit onto an owning reactor
)

#: one-line glossary served by ``dump_dispatch`` and BASELINE.md
GLOSSARY = {
    "wq_op": "ShardedOpWQ enqueue -> worker dequeue (client ops)",
    "wq_continuation": "engine-retire continuation re-enqueue -> "
                       "op-wq worker dequeue (the commit_handoff hop)",
    "engine_stage": "producer stage_encode/decode put -> engine "
                    "thread queue pickup",
    "msgr_send": "send_message() hand-off -> messenger loop pickup",
    "msgr_dispatch": "receive stamp -> dispatcher entry (the "
                     "loopback cross-thread hop)",
    "reply_wakeup": "completion event.set -> waiting client thread "
                    "running again",
    "reactor_submit": "cross-thread submit onto the PG's owning "
                      "crimson reactor (seastar submit_to role: "
                      "admission, engine continuation, and reply "
                      "routing each cross it at most once)",
    "hops_per_op": "cross-thread handoffs one completed client op "
                   "crossed (admission -> N hops -> commit reply)",
    "wakeups_per_frame": "client threads woken per reply frame "
                         "(run-to-completion target: one per flush)",
}

#: stage-timeline -> causal-chain hop mapping: (stage key, seam,
#: source track, destination track). Tracks are the logical threads
#: of the MiniCluster data path; the Chrome-trace export renders one
#: track per entry and a flow arrow per hop.
HOP_STAGES = (
    ("send_queue_wait", "msgr_send", "client", "msgr-loop"),
    ("wire", "msgr_dispatch", "msgr-loop", "peer-loop"),
    ("dispatch_queue_wait", "wq_op", "peer-loop", "op-wq"),
    ("engine_stage_wait", "engine_stage", "op-wq", "engine"),
)

#: hop stages that live in child timelines (label, stage, seam,
#: source track, destination track)
CHILD_HOP_STAGES = (
    ("commit", "commit_handoff", "wq_continuation", "engine-retire",
     "op-wq"),
    ("*", "subop_dispatch_wait", "wq_op", "peer-loop", "subop-wq"),
)

_RECENT_CHAINS = 64
_MAX_CONNS = 64
_MAX_LOCKS = 128

_tls = threading.local()


class DispatchTelemetry:
    """One per process, like the ``store`` and ``dataplane``
    registries (daemons share the process here)."""

    def __init__(self, name: str = "dispatch") -> None:
        self.name = name
        self._lock = threading.Lock()
        perf = collection().get(name)
        if perf is None:
            perf = collection().create(name)
            self._declare(perf)
        self.perf = perf
        #: conn key -> {"wakeups", "frames", "latency_s"} (bounded)
        self._conns: dict[str, dict] = {}
        #: lock name -> {"waits", "wait_s", "hold_s", "max_wait_s",
        #: "cv_wakeups", "cv_latency_s"} (bounded; names are a closed
        #: class set like the witness's)
        self._locks: dict[str, dict] = {}
        self._conns_dropped = 0
        self._locks_dropped = 0
        #: recent per-op causal chains (trace export / dashboard)
        self._recent: deque[dict] = deque(maxlen=_RECENT_CHAINS)

    @staticmethod
    def _declare(perf: PerfCounters) -> None:
        for seam in SEAMS:
            perf.add_time_avg(
                f"handoff_{seam}",
                f"seconds (exact sum): {GLOSSARY.get(seam, '')}")
            perf.add_histogram(
                f"handoff_{seam}_us",
                f"microseconds: {GLOSSARY.get(seam, '')}")
            perf.add_u64_counter(
                f"ophop_{seam}",
                f"completed client ops whose causal chain crossed "
                f"this seam: {GLOSSARY.get(seam, '')}")
        perf.add_u64_counter("hops",
                             "cross-thread handoffs observed at the "
                             "queue seams (all seams)")
        perf.add_u64_counter("op_chains",
                             "completed client ops with a recorded "
                             "causal handoff chain")
        perf.add_histogram("hops_per_op", GLOSSARY["hops_per_op"])
        perf.add_u64_counter("wakeups",
                             "client completion wakeups (one per op "
                             "event.set)")
        perf.add_time_avg("wakeup_latency",
                          "completion signal -> waiter running again")
        perf.add_histogram("wakeup_latency_us",
                           "microseconds: completion signal -> "
                           "waiter running")
        perf.add_u64_counter("reply_frames",
                             "reply frames received (MOSDOpReply or "
                             "one MOSDOpReplyBatch sweep)")
        perf.add_histogram("wakeups_per_frame",
                           GLOSSARY["wakeups_per_frame"])
        perf.add_u64_counter("lock_waits",
                             "timed-lock acquisitions (lock-timing "
                             "mode only; 0 when off)")
        perf.add_time_avg("lock_wait_time",
                          "seconds blocked acquiring timed locks")
        perf.add_time_avg("lock_hold_time",
                          "seconds timed locks were held")
        perf.add_u64_counter("condvar_wakeups",
                             "timed-condvar wakeups (signal observed "
                             "by a waiter)")
        perf.add_time_avg("condvar_wakeup_latency",
                          "condvar notify -> waiter running again")

    # -- plane 1: handoff seams ---------------------------------------
    def note_handoff(self, seam: str, wait_s: float) -> None:
        """One cross-thread hop crossed ``seam`` after waiting
        ``wait_s`` in the queue. Unknown seams are dropped (an old
        caller must not raise)."""
        if seam not in SEAMS or wait_s < 0:
            return
        self.perf.inc("hops")
        self.perf.tinc(f"handoff_{seam}", wait_s)
        self.perf.hinc(f"handoff_{seam}_us", wait_s * 1e6)

    def note_op_chain(self, dump: dict) -> None:
        """Client-side completion: derive the op's causal chain from
        its merged timeline dump (:func:`chain_of`), count the per-op
        hop histogram + per-seam presence counters, and stash the
        chain for the trace export."""
        chain = chain_of(dump)
        if not chain:
            return
        self.perf.inc("op_chains")
        self.perf.hinc("hops_per_op", float(len(chain)))
        for hop in chain:
            self.perf.inc(f"ophop_{hop['seam']}")
        with self._lock:
            self._recent.append({
                "wall_epoch": dump.get("wall_epoch", 0.0),
                "total_us": dump.get("total_us", 0.0),
                "hops": chain,
            })

    def note_op_hops(self, seams: list[str]) -> None:
        """Server-side chain accounting for run-to-completion paths:
        a crimson op never re-enters a wq, so there is no merged stage
        timeline to derive a chain from — the owning reactor counted
        each cross-thread hop as it happened and reports the seam
        list at commit-reply time. Feeds the same ``op_chains`` /
        ``hops_per_op`` / ``ophop_*`` counters as
        :meth:`note_op_chain`, so gap_report's hops-per-op mean is
        comparable across OSD flavors. Zero-hop chains count too
        (they pull the mean DOWN, which is the whole point)."""
        known = [s for s in seams if s in SEAMS]
        self.perf.inc("op_chains")
        self.perf.hinc("hops_per_op", float(len(known)))
        for seam in known:
            self.perf.inc(f"ophop_{seam}")

    # -- plane 2a: completion wakeups ---------------------------------
    def note_reply_frame(self, conn: str, n_ops: int) -> None:
        """One reply frame arrived on ``conn`` carrying ``n_ops``
        completions (1 for a singleton MOSDOpReply, N for one
        MOSDOpReplyBatch sweep)."""
        if n_ops <= 0:
            return
        self.perf.inc("reply_frames")
        self.perf.hinc("wakeups_per_frame", float(n_ops))
        with self._lock:
            ent = self._ensure_conn(conn)
            if ent is not None:
                ent["frames"] += 1

    def note_wakeup(self, conn: str, latency_s: float) -> None:
        """One waiter on ``conn`` observed its completion signal
        ``latency_s`` after it was raised."""
        if latency_s < 0:
            latency_s = 0.0
        self.perf.inc("wakeups")
        self.perf.tinc("wakeup_latency", latency_s)
        self.perf.hinc("wakeup_latency_us", latency_s * 1e6)
        with self._lock:
            ent = self._ensure_conn(conn)
            if ent is not None:
                ent["wakeups"] += 1
                ent["latency_s"] += latency_s

    def _ensure_conn(self, conn: str) -> dict | None:
        ent = self._conns.get(conn)
        if ent is None:
            if len(self._conns) >= _MAX_CONNS:
                self._conns_dropped += 1
                return None
            ent = self._conns[conn] = {
                "wakeups": 0, "frames": 0, "latency_s": 0.0}
        return ent

    # -- plane 2b: lock wait / condvar wakeups ------------------------
    def note_lock_wait(self, name: str, wait_s: float) -> None:
        if wait_s < 0:
            return
        self.perf.inc("lock_waits")
        self.perf.tinc("lock_wait_time", wait_s)
        with self._lock:
            ent = self._ensure_lock(name)
            if ent is not None:
                ent["waits"] += 1
                ent["wait_s"] += wait_s
                if wait_s > ent["max_wait_s"]:
                    ent["max_wait_s"] = wait_s

    def note_lock_hold(self, name: str, hold_s: float) -> None:
        if hold_s < 0:
            return
        self.perf.tinc("lock_hold_time", hold_s)
        with self._lock:
            ent = self._ensure_lock(name)
            if ent is not None:
                ent["hold_s"] += hold_s

    def note_condvar_wakeup(self, name: str, latency_s: float) -> None:
        if latency_s < 0:
            latency_s = 0.0
        self.perf.inc("condvar_wakeups")
        self.perf.tinc("condvar_wakeup_latency", latency_s)
        with self._lock:
            ent = self._ensure_lock(name)
            if ent is not None:
                ent["cv_wakeups"] += 1
                ent["cv_latency_s"] += latency_s

    def _ensure_lock(self, name: str) -> dict | None:
        ent = self._locks.get(name)
        if ent is None:
            if len(self._locks) >= _MAX_LOCKS:
                self._locks_dropped += 1
                return None
            ent = self._locks[name] = {
                "waits": 0, "wait_s": 0.0, "hold_s": 0.0,
                "max_wait_s": 0.0, "cv_wakeups": 0,
                "cv_latency_s": 0.0}
        return ent

    # -- plane 3: the run-to-completion what-if ------------------------
    def rtc_projection(self, ops: int, mean_ms: float, mbps: float,
                       handoff_ms_per_op: float | None = None) -> dict:
        """Replay the measured counts under ROADMAP item 1's design
        rules and project the first-order win:

        - *continuations run inline on the owning shard*: every
          per-op continuation handoff (``ophop_wq_continuation``)
          disappears, saving its measured queue wait
          (``handoff_ms_per_op`` — the dataplane's per-op
          ``commit_handoff`` mean when the caller has it, else this
          registry's per-hop seam mean);
        - *one flush => one wakeup per client connection*: wakeups
          collapse to one per reply frame, saving the measured
          signal->wake latency for each excess wakeup.

        Hops/wakeups saved are totals over the window; the projected
        MB/s uses exactly PR 14's first-order latency-scaling model
        (per-op savings subtract from the measured mean, throughput
        scales inversely). Honest numbers, not promises — the
        projection-honesty convention."""
        snap = self.perf.dump()
        cont_hops = snap["ophop_wq_continuation"]
        wakeups = snap["wakeups"]
        frames = snap["reply_frames"]
        wakeups_saved = max(wakeups - frames, 0)
        hops_saved = cont_hops + wakeups_saved
        if handoff_ms_per_op is None:
            seam = snap["handoff_wq_continuation"]
            handoff_ms_per_op = (seam["avg"] * 1e3) \
                if seam["avgcount"] else 0.0
        wake_ms = snap["wakeup_latency"]["avg"] * 1e3 \
            if snap["wakeup_latency"]["avgcount"] else 0.0
        saved_handoff_ms = handoff_ms_per_op * (cont_hops / ops) \
            if ops else 0.0
        saved_wakeup_ms = wake_ms * (wakeups_saved / ops) \
            if ops else 0.0
        saved_ms = saved_handoff_ms + saved_wakeup_ms
        proj_mean = max(mean_ms - saved_ms, mean_ms * 0.05, 1e-6)
        return {
            "model": "first-order latency scaling",
            "rules": "continuations inline on owning shard; engine "
                     "window the only async boundary; one flush => "
                     "one wakeup per connection",
            "ops": ops,
            "hops_saved": hops_saved,
            "continuation_hops_saved": cont_hops,
            "wakeups_saved": wakeups_saved,
            "saved_handoff_ms_per_op": round(saved_handoff_ms, 4),
            "saved_wakeup_ms_per_op": round(saved_wakeup_ms, 4),
            "saved_ms_per_op": round(saved_ms, 4),
            "whatif_rtc_MBps": round(mbps * mean_ms / proj_mean, 1)
            if mean_ms and mbps else 0.0,
        }

    # -- views ---------------------------------------------------------
    def seam_table(self) -> dict:
        """Per-seam handoff summary (exact sums)."""
        snap = self.perf.dump()
        out = {}
        for seam in SEAMS:
            ent = snap[f"handoff_{seam}"]
            if not ent["avgcount"]:
                continue
            out[seam] = {
                "hops": ent["avgcount"],
                "mean_us": round(ent["avg"] * 1e6, 1),
                "total_ms": round(ent["sum"] * 1e3, 3),
                "per_op_hops": snap[f"ophop_{seam}"],
            }
        return out

    def wakeup_table(self) -> dict:
        """Per-connection wakeup accounting + the process totals."""
        snap = self.perf.dump()
        with self._lock:
            conns = {
                k: {"wakeups": v["wakeups"], "frames": v["frames"],
                    "wakeups_per_frame":
                        round(v["wakeups"] / v["frames"], 2)
                        if v["frames"] else 0.0,
                    "mean_latency_us":
                        round(v["latency_s"] / v["wakeups"] * 1e6, 1)
                        if v["wakeups"] else 0.0}
                for k, v in self._conns.items()}
            dropped = self._conns_dropped
        wl = snap["wakeup_latency"]
        return {
            "wakeups": snap["wakeups"],
            "reply_frames": snap["reply_frames"],
            "wakeups_per_frame":
                round(snap["wakeups"] / snap["reply_frames"], 2)
                if snap["reply_frames"] else 0.0,
            "mean_latency_us": round(wl["avg"] * 1e6, 1)
            if wl["avgcount"] else 0.0,
            "connections": conns,
            "connections_dropped": dropped,
        }

    def lock_table(self, top: int = 12) -> dict:
        """Per-named-lock wait/hold totals (timing mode), worst
        waiters first."""
        with self._lock:
            rows = {
                name: {
                    "waits": v["waits"],
                    "wait_ms": round(v["wait_s"] * 1e3, 3),
                    "hold_ms": round(v["hold_s"] * 1e3, 3),
                    "max_wait_us": round(v["max_wait_s"] * 1e6, 1),
                    "cv_wakeups": v["cv_wakeups"],
                    "cv_mean_latency_us":
                        round(v["cv_latency_s"] / v["cv_wakeups"]
                              * 1e6, 1) if v["cv_wakeups"] else 0.0,
                }
                for name, v in self._locks.items()}
            dropped = self._locks_dropped
        ordered = dict(sorted(rows.items(),
                              key=lambda kv: -kv[1]["wait_ms"])[:top])
        return {"locks": ordered, "locks_dropped": dropped,
                "total_wait_ms": round(sum(
                    r["wait_ms"] for r in rows.values()), 3)}

    def recent_chains(self) -> list[dict]:
        with self._lock:
            return list(self._recent)

    def snapshot(self) -> dict:
        """Full JSON-able view (the ``dump_dispatch`` payload)."""
        return {"glossary": dict(GLOSSARY),
                "seams": self.seam_table(),
                "wakeups": self.wakeup_table(),
                "locks": self.lock_table(),
                "counters": self.perf.dump(),
                "recent_chains": self.recent_chains()}

    def snapshot_brief(self) -> dict:
        """The bench metric-line brief: zero counters dropped."""
        c = self.perf.dump()
        out = {}
        for key in ("hops", "op_chains", "wakeups", "reply_frames",
                    "lock_waits", "condvar_wakeups"):
            if c[key]:
                out[key] = c[key]
        if c["op_chains"]:
            # hops_per_op is a pow2 histogram (buckets, not a sum);
            # the exact mean comes from the per-seam presence counters
            total = sum(c[f"ophop_{s}"] for s in SEAMS)
            out["hops_per_op"] = round(total / c["op_chains"], 2)
        return out

    def reset(self) -> None:
        """Test/report hook: drop the logger and side tables (a fresh
        telemetry() call re-creates both)."""
        collection().remove(self.name)
        global _telemetry
        with _module_lock:
            _telemetry = None


# -- per-op chain extraction -------------------------------------------

def chain_of(dump: dict) -> list[dict]:
    """Derive the causal handoff chain from one merged timeline dump
    (``StageClock.dump`` shape): every hop stage present with a
    positive duration becomes one cross-thread hop, in timeline
    order. Child timelines contribute their hop stages too (the
    ``commit`` child's ``commit_handoff``, shard children's
    ``subop_dispatch_wait``)."""
    chain: list[dict] = []

    def scan(rows, specs, base_us=0.0):
        by_stage = {}
        for spec in specs:
            by_stage[spec[0]] = spec
        for row in rows or ():
            spec = by_stage.get(row.get("stage"))
            if spec is None:
                continue
            dur = row.get("dur_us", 0.0)
            if dur <= 0:
                continue
            _, seam, src, dst = spec
            chain.append({"seam": seam, "stage": row["stage"],
                          "src": src, "dst": dst,
                          "t_us": base_us + row.get("t_us", 0.0),
                          "wait_us": dur})

    scan(dump.get("stages"), HOP_STAGES)
    children = dump.get("children") or {}
    for label, rows in sorted(children.items()):
        for (want, stage, seam, src, dst) in CHILD_HOP_STAGES:
            if want != "*" and label != want:
                continue
            # child rows' t_us are relative to the child anchor; the
            # anchor's offset inside the op is not carried in the dump
            # rows, so child hops sort after the main chain — order
            # within the child is still exact
            scan(rows, ((stage, seam, src, dst),),
                 base_us=dump.get("total_us", 0.0))
    chain.sort(key=lambda h: h["t_us"])
    return chain


# -- the wq-worker hop hand-off (thread-local) --------------------------

def set_current_hop(seam: str, t_deq: float, wait_s: float) -> None:
    """A wq worker just dequeued an item: record the hop it crossed so
    downstream code holding the op's clock (the EC fan-out) can mark
    the absolute dequeue time onto the commit envelope."""
    _tls.hop = (seam, t_deq, wait_s)


def clear_current_hop() -> None:
    _tls.hop = None


def current_hop() -> tuple[str, float, float] | None:
    """(seam, t_deq, wait_s) of the hop the running wq item crossed,
    or None off the wq."""
    return getattr(_tls, "hop", None)


_module_lock = threading.Lock()
_telemetry: DispatchTelemetry | None = None


def telemetry() -> DispatchTelemetry:
    global _telemetry
    with _module_lock:
        if _telemetry is None:
            _telemetry = DispatchTelemetry()
        return _telemetry


def telemetry_if_exists() -> DispatchTelemetry | None:
    return _telemetry


def note_wq_dequeue(fn, enq: tuple[float, str],
                    now: float | None = None) -> str:
    """The ShardedOpWQ worker-side hop: classify the seam from the
    item's profiler stage tag (engine continuations are tagged
    ``commit_wait``), record the handoff, and publish it as the
    thread's current hop. Returns the seam (tests)."""
    t_deq = time.monotonic() if now is None else now
    seam = "wq_continuation" \
        if getattr(fn, "_profile_stage", None) == "commit_wait" \
        else "wq_op"
    wait = max(t_deq - enq[0], 0.0)
    telemetry().note_handoff(seam, wait)
    set_current_hop(seam, t_deq, wait)
    return seam


def register_asok(asok) -> None:
    """``dump_dispatch`` on every daemon."""
    asok.register_command(
        "dump_dispatch", lambda a: telemetry().snapshot(),
        "dispatch-path X-ray: per-seam handoff spans, per-connection "
        "wakeup accounting, timed-lock waits, recent per-op causal "
        "chains")
