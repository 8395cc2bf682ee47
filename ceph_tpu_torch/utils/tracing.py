"""Always-on tail-sampled dataflow tracing (the Blkin/ZTracer role,
grown into a Jaeger-style tail sampler).

Reference: trace spans ride INSIDE messages (src/msg/Message.h:264) so
one client op's causality chain is visible across daemons: the EC write
path opens a span per shard sub-op (ECBackend.cc:1939, 2022-2026).

A ``Span`` carries (trace_id, span_id, parent_id); the wire form is the
``"trace_id:span_id"`` string stored in a message's ``trace`` field.

The sampling model (ISSUE 10). Every client op opens a REAL span tree
— a span is two clock reads and a list append — but whether the trace
is *retained* is decided only when the ROOT span completes (tail
sampling: by then the op's fate is known). A trace is kept when:

- the op **errored** (``Span.set_error``: errno replies, timeouts,
  engine host-fallbacks);
- a **fault-registry event** fired during the op's window (the chaos
  harness of utils/faults — an op that overlapped an injected fault is
  exactly the op worth an autopsy);
- the op was **slow** relative to an adaptive per-op-type threshold:
  ``max(trace_slow_min_ms, trace_slow_factor x base)`` where ``base``
  is a per-op-type EWMA of observed durations, seeded from the PR-6
  ``dataplane`` p99 when the type has no history yet;
- it won the 1-in-N **head sample** (``trace_sample_every``) — the
  steady drip that keeps normal ops represented.

Everything else is dropped with zero retained allocations: finished
spans buffer as plain dicts in a bounded per-trace pending map, and a
drop discards the whole buffer (``trace_kept`` / ``trace_dropped`` /
``trace_evicted`` counters in the ``tracing`` PerfCounters registry —
fixed memory throughout, pinned by tests/test_trace_sampling.py).

Kept traces land in a bounded keep ring, from which the mgr trace
module pulls (``kept_after`` cursor — the MMgrReport-style leg), slow/
error/fault keeps additionally snapshot an autopsy (utils/autopsy),
and the prometheus exposition resolves histogram exemplars against
``is_kept``. ``trace_all`` still forces keep-everything (the old
blkin_trace_all mode); ``trace_enabled=false`` restores literal NOOP
spans (zero allocations).

Timestamps are monotonic for exactness plus a wall-clock epoch anchor
per span (``wall`` in dumps) so the Perfetto export and cross-daemon
assembly can align rows; daemons here share one process, so monotonic
is one clock and the merge is exact (a multi-process port would need
the usual offset handshake).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict

_seq = itertools.count(1)

#: keep reasons, also the trace_kept_<reason> counter suffixes
#: ("forced": an owner declared the trace load-bearing — tuner
#: decisions ride this so every actuation survives the sampler)
KEEP_REASONS = ("error", "fault", "slow", "sample", "all", "forced")

#: EWMA smoothing for the per-op-type slowness baseline
_EWMA_ALPHA = 0.2


def _fault_fire_count() -> int:
    """The chaos registry's monotonic fire counter (0 when no registry
    was ever instantiated — probing must not create one)."""
    try:
        from ceph_tpu_torch.utils import faults
        return faults.fire_count()
    except Exception:
        return 0


def _wall_of(t_mono: float) -> float:
    """Epoch time of a monotonic stamp (exact in-process: one clock)."""
    return time.time() - (time.monotonic() - t_mono)


class Span:
    __slots__ = ("trace_id", "span_id", "parent_id", "name", "service",
                 "op_type", "start", "end", "events",
                 "error", "_fault_mark", "_clock", "_tracer",
                 "_forced", "__weakref__")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: int,
                 parent_id: int, name: str, service: str,
                 op_type: str = "") -> None:
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.service = service
        self.op_type = op_type
        self.start = time.monotonic()
        self.end = 0.0
        #: lazily created on the first event — most spans carry none
        self.events: list[tuple[float, str]] | None = None
        #: error detail ("" = clean) — a set error forces the tail
        #: decision to KEEP
        self.error = ""
        #: fault-registry fire count at root open (None on children):
        #: a delta at root finish means a fault fired in the window
        self._fault_mark: int | None = None
        #: the op's StageClock, attached by the owner so a slow/error
        #: keep can autopsy the stage timeline alongside the spans
        self._clock = None
        #: owner-declared keep (ISSUE 13: control-plane decisions)
        self._forced = False

    @property
    def start_wall(self) -> float:
        """Wall-clock epoch anchor, derived (not stored: one fewer
        clock read on the always-on allocation path)."""
        return _wall_of(self.start)

    def event(self, name: str) -> None:
        if self.events is None:
            self.events = []
        self.events.append((time.monotonic() - self.start, name))

    def set_error(self, detail: str = "error") -> None:
        """Mark the op failed — the trace survives the tail decision."""
        self.error = detail or "error"

    def force_keep(self) -> None:
        """Declare this (root) trace load-bearing: the tail decision
        keeps it with reason "forced" regardless of outcome. For
        rare, operator-facing events (tuner steps/reverts) — NOT a
        sampling bypass for data-path ops."""
        self._forced = True

    def attach_clock(self, clock) -> None:
        """Hang the op's (merged) StageClock on the root span so the
        autopsy can snapshot the stage timeline."""
        self._clock = clock

    def child(self, name: str, service: str | None = None) -> "Span":
        return Span(self._tracer, self.trace_id, next(_seq),
                    self.span_id, name, service or self.service,
                    self.op_type)

    def wire(self) -> str:
        """The context string a message carries (Message.h:264 role)."""
        return f"{self.trace_id}:{self.span_id}"

    def finish(self):
        """Close the span. For a ROOT span this runs the tail-sampling
        decision and returns whether the trace was kept; children
        return None. Idempotent — a second finish is a no-op."""
        if self.end:
            return None
        self.end = time.monotonic()
        return self._tracer._record(self)

    def dump(self) -> dict:
        out = {"trace_id": self.trace_id, "span_id": self.span_id,
               "parent_id": self.parent_id, "name": self.name,
               "service": self.service,
               # monotonic start for exact in-process ordering plus
               # the wall-clock anchor the export/assembly needs
               "t0": round(self.start, 9),
               "wall": round(_wall_of(self.start), 6),
               "duration": round((self.end or time.monotonic())
                                 - self.start, 6),
               "events": [{"t": round(t, 6), "event": e}
                          for t, e in (self.events or ())]}
        if self.error:
            out["error"] = self.error
        return out


class _NoopSpan:
    """Returned when tracing is fully disabled: every operation is
    free and zero Spans are allocated."""
    __slots__ = ()
    trace_id = ""

    def event(self, name: str) -> None: ...
    def set_error(self, detail: str = "error") -> None: ...
    def force_keep(self) -> None: ...
    def attach_clock(self, clock) -> None: ...
    def finish(self) -> None: ...
    def wire(self) -> str:
        return ""

    def child(self, name: str, service: str | None = None) -> "_NoopSpan":
        return self


NOOP = _NoopSpan()


def _make_perf():
    """Get-or-create the process ``tracing`` counter registry."""
    from ceph_tpu_torch.utils.perf_counters import collection
    perf = collection().get("tracing")
    if perf is None:
        perf = collection().create("tracing")
        perf.add_u64_counter("trace_kept",
                             "root traces retained by the tail sampler")
        perf.add_u64_counter("trace_dropped",
                             "root traces dropped at completion (zero "
                             "retained span objects)")
        perf.add_u64_counter("trace_evicted",
                             "traces evicted by the pending/keep-ring "
                             "memory bounds")
        perf.add_u64_counter("trace_spans_truncated",
                             "spans discarded by the per-trace span cap")
        for reason in KEEP_REASONS:
            perf.add_u64_counter(f"trace_kept_{reason}",
                                 f"keeps decided by the {reason} rule")
        perf.add_gauge("trace_pending",
                       "traces buffered awaiting their root's tail "
                       "decision")
        perf.add_u64_counter("autopsies_recorded",
                             "slow/error/fault keeps that snapshotted "
                             "an autopsy")
    return perf


class Tracer:
    """One per process. All daemons share it (they share the process),
    so the pending buffer and keep ring already span client, primary,
    shard OSDs and the engine — the cluster-wide assembly the mgr
    trace module serves is a pull over ``kept_after``."""

    #: config keys mirrored into the hot-path cache: a span finish
    #: must not pay the config proxy's RLock + schema lookup per key
    #: (the always-on contract is "< 5% on the CPU quick run");
    #: observers keep the cache live under runtime ``config set``
    _CFG_KEYS = ("trace_enabled", "trace_all", "trace_sample_every",
                 "trace_slow_factor", "trace_slow_min_ms",
                 "trace_pending_traces", "trace_max_spans",
                 "trace_keep_ring")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: trace_id -> finished Span OBJECTS awaiting the root
        #: decision (insertion-ordered: eviction takes the oldest
        #: trace). Objects, not dumps: only kept traces pay the
        #: dump-to-dict cost, a drop just releases the buffer.
        self._pending: dict[str, list[Span]] = {}
        #: trace_id -> kept-trace record, oldest first
        self._kept: "OrderedDict[str, dict]" = OrderedDict()
        self._keep_seq = 0       # mgr pull cursor
        self._root_seq = 0       # head-sample counter
        self._ewma: dict[str, float] = {}
        self.perf = _make_perf()
        from ceph_tpu_torch.utils.config import g_conf
        conf = g_conf()
        self._cfg = {k: conf[k] for k in self._CFG_KEYS}
        for key in self._CFG_KEYS:
            conf.add_observer(key, self._on_config)

    def _on_config(self, name: str, value) -> None:
        self._cfg[name] = value

    # -- gating --------------------------------------------------------
    @property
    def enabled(self) -> bool:
        cfg = self._cfg
        return bool(cfg["trace_enabled"]) or bool(cfg["trace_all"])

    # -- span creation -------------------------------------------------
    def new_trace(self, name: str, service: str, op_type: str = ""):
        if not self.enabled:
            return NOOP
        span = Span(self, os.urandom(8).hex(), next(_seq), 0, name,
                    service, op_type)
        span._fault_mark = _fault_fire_count()
        return span

    def from_wire(self, ctx: str, name: str, service: str):
        """Continue a trace carried in a message; noop when the sender
        did not trace (empty ctx) or tracing is off here."""
        if not ctx or not self.enabled:
            return NOOP
        trace_id, _, parent = ctx.partition(":")
        if not trace_id:
            # malformed ctx like ":7": a span with an empty trace_id
            # could never be queried by dump(trace_id) and would
            # orphan the chain — treat it as untraced
            return NOOP
        try:
            parent_id = int(parent)
        except ValueError:
            return NOOP
        return Span(self, trace_id, next(_seq), parent_id, name, service)

    # -- recording + the tail decision ---------------------------------
    def _record(self, span: Span):
        conf = self._cfg
        tid = span.trace_id
        if span.parent_id != 0:
            # hot path, deliberately LOCK-FREE: dict reads and
            # list.append are GIL-atomic, so the common case is two
            # dict probes + one append of the span OBJECT (dumping to
            # a dict is deferred to the keep decision — the vastly
            # more common dropped traces never pay it). Benign race:
            # an append into a buffer the root is concurrently
            # popping loses that one span from a KEPT trace, exactly
            # like any other late finisher — never a leak, because
            # the orphaned buffer itself is garbage.
            max_spans = conf["trace_max_spans"]
            rec = self._kept.get(tid)
            if rec is not None:
                # late child of an already-kept trace (harvest after
                # the root's reply): append to the record
                d = span.dump()
                with self._lock:
                    rec = self._kept.get(tid)
                    if rec is not None and \
                            len(rec["spans"]) < max_spans:
                        rec["spans"].append(d)
                return None
            buf = self._pending.get(tid)
            if buf is None:
                with self._lock:     # buffer birth + eviction only
                    evicted = 0
                    while len(self._pending) >= \
                            conf["trace_pending_traces"]:
                        self._pending.pop(next(iter(self._pending)))
                        evicted += 1
                    buf = self._pending.setdefault(tid, [])
                    pending_n = len(self._pending)
                if evicted:
                    self.perf.inc("trace_evicted", evicted)
                self.perf.set_gauge("trace_pending", pending_n)
            if len(buf) < max_spans:
                buf.append(span)
            else:
                self.perf.inc("trace_spans_truncated")
            return None

        # root span: the whole trace's fate is decided here
        autopsy_rec = None
        duration = span.end - span.start
        with self._lock:
            pend = self._pending.pop(tid, None)
            keep, reason = self._decide_locked(span, duration, conf)
            if keep:
                spans = [s.dump() for s in pend] if pend else []
                spans.append(span.dump())
                evicted = 0
                while len(self._kept) >= conf["trace_keep_ring"]:
                    self._kept.popitem(last=False)
                    evicted += 1
                self._keep_seq += 1
                rec = {"seq": self._keep_seq, "trace_id": tid,
                       "reason": reason, "root": span.name,
                       "service": span.service,
                       "op_type": span.op_type,
                       "duration_s": round(duration, 6),
                       "wall": round(span.start_wall, 6),
                       "error": span.error,
                       "spans": spans}
                self._kept[tid] = rec
                if reason in ("slow", "error", "fault"):
                    autopsy_rec = rec
            pending_n = len(self._pending) if pend is not None \
                else None
        # counters + autopsy run off-lock (the autopsy snapshots other
        # subsystems; holding the tracer lock there invites inversion)
        if pending_n is not None:
            self.perf.set_gauge("trace_pending", pending_n)
        if keep:
            self.perf.inc("trace_kept")
            self.perf.inc(f"trace_kept_{reason}")
            if evicted:
                self.perf.inc("trace_evicted", evicted)
            if autopsy_rec is not None:
                self._autopsy(autopsy_rec, span)
        else:
            # the popped span buffer dies with this frame: a dropped
            # trace retains zero span objects and zero dicts
            self.perf.inc("trace_dropped")
        return keep

    def _decide_locked(self, span: Span, dur: float, conf):
        """The tail-sampling policy. Caller holds the lock."""
        self._root_seq += 1
        if conf["trace_all"]:
            return True, "all"
        if span._forced:
            return True, "forced"
        if span.error:
            return True, "error"
        if span._fault_mark is not None and \
                _fault_fire_count() != span._fault_mark:
            return True, "fault"
        op = span.op_type or span.name.split("(", 1)[0]
        base = self._ewma.get(op)
        self._ewma[op] = dur if base is None else \
            _EWMA_ALPHA * dur + (1.0 - _EWMA_ALPHA) * base
        if base is None:
            base = self._dataplane_p99_s()
        if base and base > 0:
            threshold = max(conf["trace_slow_min_ms"] / 1e3,
                            conf["trace_slow_factor"] * base)
            if dur >= threshold:
                return True, "slow"
        n = conf["trace_sample_every"]
        if n > 0 and self._root_seq % n == 0:
            return True, "sample"
        return False, ""

    @staticmethod
    def _dataplane_p99_s() -> float:
        """Seed the slowness baseline from the PR-6 dataplane op_total
        p99 when an op type has no EWMA history yet."""
        try:
            from ceph_tpu_torch.utils.dataplane import dataplane
            return dataplane().percentile_ms("op_total_us", 0.99) / 1e3
        except Exception:
            return 0.0

    def _autopsy(self, rec: dict, span: Span) -> None:
        try:
            # utils/autopsy is not ported (ROADMAP A.6)
            from ceph_tpu_torch.utils.noop_hooks import \
                autopsy_store as store
            clock = span._clock
            store().record(rec,
                           clock.dump() if clock is not None else None)
            self.perf.inc("autopsies_recorded")
        except Exception:
            pass           # diagnosis must never cost the op path

    # -- views ---------------------------------------------------------
    def is_kept(self, trace_id: str) -> bool:
        with self._lock:
            return trace_id in self._kept

    def keep_reason(self, trace_id: str) -> str | None:
        with self._lock:
            rec = self._kept.get(trace_id)
            return rec["reason"] if rec else None

    def kept(self) -> list[dict]:
        """Kept-trace records, oldest first (copies of the rows, the
        span lists shared read-only)."""
        with self._lock:
            return [dict(rec) for rec in self._kept.values()]

    def kept_after(self, seq: int) -> tuple[int, list[dict]]:
        """The mgr trace module's pull: records newer than ``seq``
        plus the new cursor. A cursor ahead of ``_keep_seq`` means the
        tracer was cleared — the caller restarts from zero."""
        with self._lock:
            cur = self._keep_seq
            if seq > cur:
                seq = 0
            out = [dict(rec) for rec in self._kept.values()
                   if rec["seq"] > seq]
        return cur, out

    def dump(self, trace_id: str | None = None) -> list[dict]:
        """Flat finished-span dicts of kept traces (the historical
        ``dump_traces`` shape); with ``trace_id``, that trace's spans
        (searching the pending buffer too, so an in-flight trace can
        be inspected)."""
        with self._lock:
            if trace_id is not None:
                rec = self._kept.get(trace_id)
                if rec is not None:
                    return list(rec["spans"])
                pend = list(self._pending.get(trace_id, ()))
            else:
                pend = None
        if pend is not None:
            return [s.dump() for s in pend]
        with self._lock:
            return [s for rec in self._kept.values()
                    for s in rec["spans"]]

    def tree(self, trace_id: str) -> dict | None:
        """One merged tree for a kept trace — client, primary, shard
        OSDs and engine spans nested by parent link."""
        with self._lock:
            rec = self._kept.get(trace_id)
            if rec is None:
                return None
            rec = dict(rec)
            spans = list(rec["spans"])
        rec["services"] = sorted({s["service"] for s in spans})
        rec["tree"] = build_tree(spans)
        rec.pop("spans", None)
        rec["num_spans"] = len(spans)
        return rec

    def stats(self) -> dict:
        with self._lock:
            kept, pending = len(self._kept), len(self._pending)
            seq = self._keep_seq
        return {"enabled": self.enabled, "kept": kept,
                "pending": pending, "keep_seq": seq,
                "counters": self.perf.dump()}

    def clear(self) -> None:
        """Drop pending + kept traces and reset the sampling state
        (tests and 'fresh run' entry points; the perf counters stay
        monotonic like every other registry)."""
        with self._lock:
            self._pending.clear()
            self._kept.clear()
            self._keep_seq = 0
            self._root_seq = 0
            self._ewma.clear()
        self.perf.set_gauge("trace_pending", 0)


def build_tree(spans: list[dict]) -> list[dict]:
    """Nest span dicts by parent link, children ordered by monotonic
    start. Returns the root list (normally one: the client op span;
    orphans whose parent is missing surface as extra roots rather
    than vanishing)."""
    nodes = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots: list[dict] = []
    for node in sorted(nodes.values(),
                       key=lambda s: s.get("t0", 0.0)):
        parent = nodes.get(node["parent_id"])
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots


_tracer = Tracer()


def tracer() -> Tracer:
    return _tracer


def register_asok(asok) -> None:
    """``trace status`` on every daemon (``dump_traces`` stays the
    flat-span command the OSD has served since PR 2)."""
    asok.register_command(
        "trace status", lambda a: tracer().stats(),
        "tail-sampled tracer: keep/drop/evict counters, pending and "
        "kept-ring occupancy")
    asok.register_command(
        "trace tree",
        lambda a: tracer().tree(a.get("trace_id", ""))
        or {"error": f"trace {a.get('trace_id', '')!r} not kept"},
        "one kept trace as a merged cross-daemon span tree")


# -- per-thread current span (how a backend picks up the op's span
# without threading it through every call signature) ------------------

_tls = threading.local()


def set_current(span) -> None:
    _tls.span = span


def current():
    return getattr(_tls, "span", NOOP)
