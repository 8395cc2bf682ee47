"""OpTracker — per-op event timelines and slow-op detection.

Reference: src/common/TrackedOp.{h,cc} + src/osd/OpRequest.h. Every
client op gets a TrackedOp; code marks named events as the op moves
through the pipeline (queued -> reached_pg -> sub_op_sent -> commit).
Ops alive longer than ``osd_op_complaint_time`` are reported as slow;
finished ops land in a bounded history ring served over the admin
socket (dump_historic_ops), like the reference's. A separate TOP-K
table keeps the record slowest ops by age (dump_historic_slow_ops
role) — a true top-K heap, not a ring, so a burst of mildly-slow ops
can never evict the record holder.

Trackers register in a process-wide weak registry so the mgr health
engine (mgr/health.py SLOW_OPS check) can aggregate slow ops across
every daemon in the process — the aggregation seam the reference
routes through mgr daemon state.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
import weakref
from collections import deque

from ceph_tpu_torch.utils.dout import Dout

log = Dout("optracker")

#: process-wide tracker registry (weak: a stopped daemon's tracker
#: unregisters itself by dying)
_registry_lock = threading.Lock()
_registry: "weakref.WeakSet[OpTracker]" = weakref.WeakSet()


def all_slow_ops() -> list[tuple[str, dict]]:
    """Every registered tracker's slow ops as (tracker_name, op dump)
    pairs — the mgr health engine's SLOW_OPS input."""
    with _registry_lock:
        trackers = list(_registry)
    out = []
    for t in trackers:
        for op in t.get_slow_ops():
            out.append((t.name, op))
    return out


def dump_all_trackers() -> dict:
    """Per-tracker in-flight + historic + slowest ops (the diagnostic
    bundle's ops section)."""
    with _registry_lock:
        trackers = list(_registry)
    return {t.name: {"in_flight": t.dump_in_flight(),
                     "historic": t.dump_historic(),
                     "slowest": t.dump_slowest()}
            for t in sorted(trackers, key=lambda t: t.name)}


class TrackedOp:
    __slots__ = ("seq", "desc", "start", "events", "stages",
                 "trace_id", "_tracker")

    def __init__(self, seq: int, desc: str, tracker: "OpTracker") -> None:
        self.seq = seq
        self.desc = desc
        self.start = time.monotonic()
        self.events: list[tuple[float, str]] = [(self.start, "initiated")]
        #: the op's StageClock (utils/stage_clock) when the data-plane
        #: timeline rides this op — dumped alongside the event list so
        #: dump_historic_ops shows the per-stage decomposition
        self.stages = None
        #: the op's dataflow trace id (ISSUE 10): a slow-op report
        #: links straight to its kept trace / autopsy
        self.trace_id = ""
        self._tracker = tracker

    def mark_event(self, name: str) -> None:
        self.events.append((time.monotonic(), name))

    def finish(self) -> None:
        self.mark_event("done")
        self._tracker._finish(self)

    @property
    def age(self) -> float:
        return time.monotonic() - self.start

    def dump(self) -> dict:
        out = {
            "seq": self.seq,
            "desc": self.desc,
            "age": round(self.age, 6),
            "events": [{"t": round(t - self.start, 6), "event": e}
                       for t, e in self.events],
        }
        if self.stages is not None:
            timeline = self.stages.dump()
            if timeline:
                out["stages"] = timeline
        if self.trace_id:
            out["trace_id"] = self.trace_id
            try:
                from ceph_tpu_torch.utils.tracing import tracer
                out["trace_kept"] = tracer().is_kept(self.trace_id)
            except Exception:
                pass
        return out


def _refresh_trace_links(ops: list[dict]) -> list[dict]:
    """Historic dumps freeze at op finish, but the TAIL keep decision
    lands later (the client root completes after the primary replied)
    — re-resolve trace_kept at serve time so a slow-op report links
    to the trace that actually survived."""
    try:
        from ceph_tpu_torch.utils.tracing import tracer
        t = tracer()
    except Exception:
        return ops
    for d in ops:
        tid = d.get("trace_id")
        if tid:
            d["trace_kept"] = t.is_kept(tid)
    return ops


class OpTracker:
    def __init__(self, complaint_time: float = 30.0,
                 history_size: int = 20,
                 name: str = "optracker") -> None:
        self.name = name
        self.complaint_time = complaint_time
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._in_flight: dict[int, TrackedOp] = {}
        self._history: deque[dict] = deque(maxlen=history_size)
        # true top-K by age: a min-heap of (age, seq, dump) whose root
        # is the CHEAPEST record to beat. The old deque gated on
        # ``age >= min(...)`` but evicted FIFO at maxlen, so a burst
        # of mildly-slow ops pushed the record slowest op out.
        self._slowest_k = history_size
        self._slowest: list[tuple[float, int, dict]] = []
        with _registry_lock:
            _registry.add(self)

    def create(self, desc: str) -> TrackedOp:
        op = TrackedOp(next(self._seq), desc, self)
        with self._lock:
            self._in_flight[op.seq] = op
        return op

    def _finish(self, op: TrackedOp) -> None:
        with self._lock:
            self._in_flight.pop(op.seq, None)
            d = op.dump()
            self._history.append(d)
            ent = (d["age"], d["seq"], d)
            if len(self._slowest) < self._slowest_k:
                heapq.heappush(self._slowest, ent)
            elif d["age"] > self._slowest[0][0]:
                heapq.heapreplace(self._slowest, ent)

    # -- introspection (asok command backends) ------------------------
    def dump_in_flight(self) -> dict:
        with self._lock:
            ops = [op.dump() for op in self._in_flight.values()]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic(self) -> dict:
        with self._lock:
            ops = list(self._history)
        return {"num_ops": len(ops),
                "ops": _refresh_trace_links(ops)}

    def dump_slowest(self) -> dict:
        """Top-K finished ops by age, slowest first (the reference's
        dump_historic_slow_ops)."""
        with self._lock:
            ops = [d for _, _, d in sorted(self._slowest,
                                           reverse=True)]
        return {"num_ops": len(ops), "ops": _refresh_trace_links(ops)}

    def get_slow_ops(self) -> list[dict]:
        """Ops in flight longer than the complaint time (the reference
        logs these as 'slow requests')."""
        with self._lock:
            return [op.dump() for op in self._in_flight.values()
                    if op.age > self.complaint_time]

    def check_slow(self) -> int:
        slow = self.get_slow_ops()
        for s in slow:
            log(1, f"slow request {s['desc']} "
                f"in flight for {s['age']:.1f}s")
        return len(slow)
