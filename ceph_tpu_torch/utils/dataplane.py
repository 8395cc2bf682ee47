"""Data-plane telemetry — process-wide stage-latency decomposition.

The consumer side of :mod:`ceph_tpu.utils.stage_clock`: every daemon
records the stage intervals IT owns (``StageClock.own_durations``)
into one process-wide ``dataplane`` PerfCounters logger — a pow2
histogram (microseconds; p50/p99 via the existing bucket machinery)
plus an exact time_avg (sum/count; the gap report's attribution math
needs true sums, not bucket mids) per stage, and an ``op_total``
pair recorded by the client when the merged timeline comes home.
Because consecutive stage intervals partition the op end-to-end, the
stage sums account for the whole measured latency — the >= 90%
coverage property ``tools/gap_report.py`` asserts.

Also kept: a bounded ring of recently completed full timelines (the
``dump_op_timeline`` asok payload / dashboard data-plane panel), so
"show me one op's decomposition" needs no tracing session.

The plain counters live in the process PerfCounters collection, so
``perf dump``, the prometheus exporter, and the flight recorder pick
them up for free.
"""

from __future__ import annotations

import threading
from collections import deque

from ceph_tpu_torch.utils import stage_clock
from ceph_tpu_torch.utils.perf_counters import PerfCounters, collection

#: every stage a timeline can carry (op stages + sub-op child stages
#: + the commit-wait envelope children), anchor marks excluded (they
#: have no duration)
STAGE_KEYS = tuple(
    s for s in stage_clock.EC_WRITE_STAGES + stage_clock.SUBOP_STAGES
    + stage_clock.COMMIT_STAGES
    if s not in ("client_submit", "subop_send", "commit_start"))

#: child-vocabulary stages: they nest INSIDE commit_wait, so the main
#: breakdown (whose stage sums partition the op end-to-end) skips
#: them — they get their own commit-path view instead
_CHILD_STAGES = stage_clock.SUBOP_STAGES + stage_clock.COMMIT_STAGES

#: the client-owned stages (recorded by the Objecter; everything else
#: is recorded by the daemon that marked it)
CLIENT_STAGES = ("objecter_encode", "send_queue_wait", "commit_reply")

_RECENT_TIMELINES = 64


class DataplaneTelemetry:
    """One per process (daemons share the process here, so the stage
    registry is process-wide like the device registry)."""

    def __init__(self, name: str = "dataplane") -> None:
        self.name = name
        self._lock = threading.Lock()
        perf = collection().get(name)
        if perf is None:
            perf = collection().create(name)
            self._declare(perf)
        self.perf = perf
        self._recent: deque[dict] = deque(maxlen=_RECENT_TIMELINES)

    @staticmethod
    def _declare(perf: PerfCounters) -> None:
        for stage in STAGE_KEYS:
            perf.add_histogram(
                f"stage_{stage}_us",
                f"microseconds: {stage_clock.GLOSSARY.get(stage, '')}")
            perf.add_time_avg(
                f"stage_{stage}",
                f"seconds (exact sum): "
                f"{stage_clock.GLOSSARY.get(stage, '')}")
        perf.add_histogram("op_total_us",
                           "end-to-end client op latency (op age "
                           "histogram source)")
        perf.add_time_avg("op_total",
                          "end-to-end client op latency, exact sum")
        perf.add_u64_counter("ops_timed",
                             "client ops with a completed timeline")

    # -- recording -----------------------------------------------------
    def record_stages(self, durations: list[tuple[str, float]],
                      trace_id: str | None = None) -> None:
        """Record (stage, seconds) intervals; unknown stage names are
        dropped (an old peer's custom mark must not raise).
        ``trace_id`` rides into the stage histograms as the bucket
        exemplar (ISSUE 10: dashboard p99 -> trace link)."""
        for stage, dt in durations:
            if stage in STAGE_KEYS and dt >= 0:
                self.perf.hinc(f"stage_{stage}_us", dt * 1e6,
                               exemplar=trace_id)
                self.perf.tinc(f"stage_{stage}", dt)

    def record_op(self, clock, trace_id: str | None = None) -> None:
        """Client-side completion: record the client-owned stages,
        the end-to-end total, and stash the full merged timeline."""
        durs = clock.durations()
        self.record_stages([(s, dt) for s, dt in durs
                            if s in CLIENT_STAGES],
                           trace_id=trace_id)
        total = clock.total()
        if total < 0:
            return
        self.perf.hinc("op_total_us", total * 1e6, exemplar=trace_id)
        self.perf.tinc("op_total", total)
        self.perf.inc("ops_timed")
        with self._lock:
            self._recent.append(clock.dump())

    # -- views ---------------------------------------------------------
    def recent(self) -> list[dict]:
        with self._lock:
            return list(self._recent)

    @staticmethod
    def _hist_percentile(buckets: list[int], q: float) -> float:
        """Estimate the q-quantile (microseconds) from a pow2 bucket
        histogram (bucket 0 = non-positive, bucket b >= 1 covers
        [2^(b-1), 2^b)); geometric-ish bucket mid, good to ~1.5x —
        plenty for a latency decomposition."""
        total = sum(buckets)
        if total == 0:
            return 0.0
        target = q * total
        cum = 0
        for b, count in enumerate(buckets):
            cum += count
            if cum >= target:
                if b == 0:
                    return 0.0
                return 1.5 * (1 << (b - 1))
        return 1.5 * (1 << (len(buckets) - 1))

    def percentile_ms(self, key: str, q: float) -> float:
        return round(
            self._hist_percentile(self.perf.get(key), q) / 1e3, 3)

    def stage_breakdown(self) -> dict:
        """The gap-attribution view: per-stage mean and share of the
        summed end-to-end latency (exact sums, so shares add to the
        coverage_pct — the >= 90% acceptance bar), plus total-latency
        percentiles from the histogram."""
        snap = self.perf.dump()
        tot = snap["op_total"]
        out = {"ops": tot["avgcount"],
               "mean_ms": round(tot["avg"] * 1e3, 3),
               "p50_ms": self.percentile_ms("op_total_us", 0.50),
               "p99_ms": self.percentile_ms("op_total_us", 0.99),
               "stages": {}}
        total_sum = tot["sum"]
        covered = 0.0
        for stage in STAGE_KEYS:
            if stage in _CHILD_STAGES:
                continue          # children nest inside commit_wait
            ent = snap[f"stage_{stage}"]
            if not ent["avgcount"]:
                continue
            share = (100.0 * ent["sum"] / total_sum) if total_sum \
                else 0.0
            covered += ent["sum"]
            out["stages"][stage] = {
                "mean_ms": round(ent["avg"] * 1e3, 4),
                "share_pct": round(share, 1),
                "p99_ms": self.percentile_ms(f"stage_{stage}_us",
                                             0.99),
            }
        out["coverage_pct"] = round(
            100.0 * covered / total_sum, 1) if total_sum else 0.0
        subops = {}
        for stage in stage_clock.SUBOP_STAGES:
            if stage in ("subop_send",):
                continue
            ent = snap[f"stage_{stage}"]
            if ent["avgcount"]:
                subops[stage] = {"mean_ms": round(ent["avg"] * 1e3, 4)}
        if subops:
            out["subops"] = subops
        commit = self.commit_path(snap)
        if commit:
            out["commit_path"] = commit
        return out

    def commit_path(self, snap: dict | None = None) -> dict:
        """The commit-wait X-ray (ISSUE 14): each commit-envelope
        child stage's mean and share OF commit_wait, plus the
        coverage those children reach — the >= 90% acceptance bar
        that says the decomposition explains why commit waited.
        Empty when nothing recorded commit children (read-only runs,
        old peers)."""
        if snap is None:
            snap = self.perf.dump()
        cw = snap.get("stage_commit_wait") or {}
        if not cw.get("avgcount"):
            return {}
        cw_sum = cw["sum"]
        out = {"commit_wait_ms": round(cw["avg"] * 1e3, 4),
               "stages": {}}
        covered = 0.0
        for stage in stage_clock.COMMIT_STAGES:
            ent = snap.get(f"stage_{stage}") or {}
            if not ent.get("avgcount"):
                continue
            covered += ent["sum"]
            out["stages"][stage] = {
                "mean_ms": round(ent["avg"] * 1e3, 4),
                "share_of_commit_pct":
                    round(100.0 * ent["sum"] / cw_sum, 1)
                    if cw_sum else 0.0,
                "p99_ms": self.percentile_ms(f"stage_{stage}_us",
                                             0.99),
            }
        if not out["stages"]:
            return {}
        out["coverage_pct"] = round(
            100.0 * covered / cw_sum, 1) if cw_sum else 0.0
        return out

    def exemplar_links(self) -> dict:
        """Per-histogram bucket -> kept trace_id (the dashboard's
        p99 -> trace link payload). Only buckets whose newest
        candidate survived the tail sampler appear."""
        try:
            from ceph_tpu_torch.utils.tracing import tracer
            accept = tracer().is_kept
        except Exception:
            return {}
        out: dict[str, dict] = {}
        for key in ["op_total_us"] + [f"stage_{s}_us"
                                      for s in STAGE_KEYS]:
            links = {}
            for b in self.perf.exemplar_buckets(key):
                ent = self.perf.exemplar(key, b, accept)
                if ent is not None:
                    links[f"le_{0 if b == 0 else (1 << b) - 1}_us"] = {
                        "trace_id": ent[0], "value_us": ent[1]}
            if links:
                out[key] = links
        return out

    def snapshot(self) -> dict:
        """Full JSON-able view (``dump_op_timeline`` payload)."""
        return {"glossary": dict(stage_clock.GLOSSARY),
                "breakdown": self.stage_breakdown(),
                "counters": self.perf.dump(),
                "exemplars": self.exemplar_links(),
                "recent": self.recent()}

    def op_age_histogram(self) -> dict:
        """The ``op age histogram`` asok command: readable bucket
        edges over the op_total histogram (built from the same stage
        machinery, zero extra accounting)."""
        buckets = self.perf.get("op_total_us")
        rows = []
        for b, count in enumerate(buckets):
            if not count:
                continue
            lo = 0 if b == 0 else (1 << (b - 1))
            hi = 0 if b == 0 else (1 << b)
            rows.append({"le_us": hi, "ge_us": lo, "count": count})
        return {"total_ops": sum(buckets),
                "p50_ms": self.percentile_ms("op_total_us", 0.50),
                "p99_ms": self.percentile_ms("op_total_us", 0.99),
                "buckets": rows}

    def reset(self) -> None:
        """Test/report hook: drop the logger and ring (a fresh
        dataplane() call re-creates both)."""
        collection().remove(self.name)
        global _dataplane
        with _module_lock:
            _dataplane = None


_module_lock = threading.Lock()
_dataplane: DataplaneTelemetry | None = None


def dataplane() -> DataplaneTelemetry:
    global _dataplane
    with _module_lock:
        if _dataplane is None:
            _dataplane = DataplaneTelemetry()
        return _dataplane


def register_asok(asok) -> None:
    """``dump_op_timeline`` + ``op age histogram`` on every daemon."""
    asok.register_command(
        "dump_op_timeline", lambda a: dataplane().snapshot(),
        "per-op stage timelines: glossary, stage breakdown, recent "
        "merged client/primary/shard timelines")
    asok.register_command(
        "op age histogram", lambda a: dataplane().op_age_histogram(),
        "client-op end-to-end latency histogram (from the stage "
        "timeline machinery)")
