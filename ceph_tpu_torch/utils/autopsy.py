"""Slow-op autopsies — the post-mortem record a kept-for-cause trace
leaves behind.

A tail-kept trace (utils/tracing: reason slow / error / fault) answers
"which spans were long", but diagnosing WHY needs the context around
the op: what the rest of the system was doing (counter deltas), what
chaos was firing (fault events), and where the CPU actually was
(profiler hot frames). This module snapshots all of that at keep time
into one bounded ring entry:

- the op's merged **stage timeline** (StageClock dump, wall-anchored);
- the **span tree** (the kept trace's span dicts);
- the **flight-recorder counter window** around the op — a sample is
  forced so the window always brackets the keep moment even when no
  mgr is ticking the recorder;
- the tail of the **fault-registry event log**;
- the **profiler hot frames** when a profiler exists (never allocates
  one — the OFF-cost contract of utils/profiler).

Served via the ``dump_autopsies`` asok command on every daemon and
folded into the health diagnostics bundle. Fixed memory: the ring
holds ``autopsy_ring_size`` entries, each bounded (counter window
capped at the last ``_WINDOW_SAMPLES`` samples, fault log tail capped).
"""

from __future__ import annotations

import threading
import time
from collections import deque

#: flight-recorder samples retained per autopsy (each is one flat
#: counter dict — the memory bound that keeps an autopsy small)
_WINDOW_SAMPLES = 8
#: fault-registry events retained per autopsy
_FAULT_TAIL = 32
#: profiler hot frames retained per autopsy
_HOT_FRAMES = 10


def _make_perf():
    from ceph_tpu_torch.utils.perf_counters import collection
    perf = collection().get("autopsy")
    if perf is None:
        perf = collection().create("autopsy")
        perf.add_u64_counter("autopsy_recorded",
                             "autopsies snapshotted for slow/error/"
                             "fault keeps")
        perf.add_u64_counter("autopsy_evicted",
                             "autopsies pushed out of the bounded ring")
        perf.add_gauge("autopsy_ring",
                       "autopsies currently held")
    return perf


class AutopsyStore:
    """Bounded ring of autopsy entries; one per process (daemons share
    the process, like the tracer and the counter collection)."""

    def __init__(self, ring_size: int | None = None) -> None:
        if ring_size is None:
            from ceph_tpu_torch.utils.config import g_conf
            ring_size = g_conf()["autopsy_ring_size"]
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=ring_size)
        self.perf = _make_perf()

    # -- recording (called by the tracer's keep decision) -------------
    def record(self, trace_rec: dict, timeline: dict | None = None
               ) -> dict:
        entry = {
            "trace_id": trace_rec.get("trace_id", ""),
            "reason": trace_rec.get("reason", ""),
            "root": trace_rec.get("root", ""),
            "service": trace_rec.get("service", ""),
            "duration_s": trace_rec.get("duration_s", 0.0),
            "error": trace_rec.get("error", ""),
            "ts": round(time.time(), 3),
            "timeline": timeline or {},
            "spans": list(trace_rec.get("spans", ())),
            "counter_window": self._counter_window(),
            "fault_events": self._fault_tail(),
        }
        frames = self._hot_frames()
        if frames is not None:
            entry["hot_frames"] = frames
        store_brief = self._store_brief()
        if store_brief is not None:
            entry["store"] = store_brief
        decisions = self._tuner_tail()
        if decisions is not None:
            entry["tuner_decisions"] = decisions
        with self._lock:
            evicted = len(self._ring) == self._ring.maxlen
            self._ring.append(entry)
            n = len(self._ring)
        self.perf.inc("autopsy_recorded")
        if evicted:
            self.perf.inc("autopsy_evicted")
        self.perf.set_gauge("autopsy_ring", n)
        return entry

    @staticmethod
    def _counter_window() -> list[dict]:
        """The flight-recorder window around the keep moment. A sample
        is forced so even a recorder nobody ticks yields at least the
        'now' snapshot; each sample is a flat counter dict."""
        try:
            from ceph_tpu_torch.utils.flight_recorder import recorder
            rec = recorder()
            rec.sample(force=True)
            return rec.window()[-_WINDOW_SAMPLES:]
        except Exception:
            return []

    @staticmethod
    def _fault_tail() -> list[dict]:
        try:
            from ceph_tpu_torch.utils import faults
            reg = faults.registry_if_exists()
            if reg is None:
                return []
            return reg.fired()[-_FAULT_TAIL:]
        except Exception:
            return []

    @staticmethod
    def _tuner_tail():
        """Recent closed-loop tuner decisions, only when a tuner is
        live: a slow op autopsied mid-adjustment should
        say so — a knob step is exactly the kind of context that
        explains an outlier. Never instantiates a tuner."""
        try:
            from ceph_tpu_torch.mgr import tuner as _tuner
            return _tuner.decisions_tail_if_active()
        except Exception:
            return None

    @staticmethod
    def _store_brief():
        """The commit-path state at the keep moment: txn /
        fsync counts plus the sub-stage means — a slow op whose
        commit waited on fsyncs should say so in its autopsy. Only
        when the store registry already exists (diagnosing must not
        allocate one)."""
        try:
            from ceph_tpu_torch.utils import store_telemetry
            tel = store_telemetry.telemetry_if_exists()
            if tel is None:
                return None
            brief = tel.snapshot_brief()
            brief["txn_breakdown"] = tel.txn_breakdown()
            return brief
        except Exception:
            return None

    @staticmethod
    def _hot_frames():
        """Stage-attributed hot frames, only when a profiler already
        exists (diagnosing must not allocate one)."""
        try:
            from ceph_tpu_torch.utils import profiler as _profiler
            prof = _profiler.profiler_if_exists()
            if prof is None:
                return None
            return prof.top_frames(_HOT_FRAMES)
        except Exception:
            return None

    # -- views ---------------------------------------------------------
    def dump(self) -> list[dict]:
        """All held autopsies, oldest first."""
        with self._lock:
            return list(self._ring)

    def get(self, trace_id: str) -> dict | None:
        with self._lock:
            for entry in reversed(self._ring):
                if entry["trace_id"] == trace_id:
                    return entry
        return None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
        self.perf.set_gauge("autopsy_ring", 0)


_module_lock = threading.Lock()
_store: AutopsyStore | None = None


def store() -> AutopsyStore:
    global _store
    with _module_lock:
        if _store is None:
            _store = AutopsyStore()
        return _store


def reset_for_tests() -> None:
    global _store
    with _module_lock:
        _store = None


def register_asok(asok) -> None:
    """``dump_autopsies`` on every daemon: the counters dump rides
    along so the schema lint holds this registry to the same
    exported-everywhere bar as the others."""
    asok.register_command(
        "dump_autopsies",
        lambda a: {"counters": store().perf.dump(),
                   "autopsies": store().dump()},
        "slow-op autopsies: stage timeline, span tree, counter "
        "window, fault events, hot frames per kept-for-cause op")
