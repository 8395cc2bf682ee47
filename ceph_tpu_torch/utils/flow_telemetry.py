"""Flow telemetry — the tenant X-ray (ISSUE 20).

ROADMAP item 2 wants per-tenant weighted fairness at the OSD op queue;
nothing below the client could previously say *which tenant* an op,
byte, engine batch or fsync belonged to — the WPQ/dmclock seats know
only three static classes. This registry is the sensor half of that
item, the instrument-then-fix pattern of PR 14 (store X-ray) and
PR 16 (dispatch X-ray) aimed at multi-tenancy. Three planes:

1. **End-to-end cost attribution.** Clients tag ops with a tenant/flow
   label; the objecter rides it on MOSDOp (tail-tolerant appended
   field, per-entry on the batched frames) and every daemon attributes
   its owned costs to the flow: ops and bytes in/out, data-plane stage
   waits (the PR-6 StageClock vocabulary), op-queue credit per
   WPQ/dmclock seat, engine flush occupancy + HBM-staged bytes (the
   flow's share of each FlushGroup), store txn bytes with an amortized
   fsync share, and per-flow p50/p99 with histogram exemplars into
   kept traces.

2. **Fairness + starvation.** Demand (submitted) vs served
   (completed) is accounted per windowed interval; a Jain's index over
   per-flow service ratios scores the cluster, and a starvation
   detector flags any flow whose queued demand was served below a
   floor ratio for N consecutive windows — the ``FLOW_STARVATION``
   health check (mgr/health.py) raises HEALTH_ERR off it, riding the
   existing bundle -> autopsy chain.

3. **SLO burn rates.** Declarative per-flow SLO targets (p99 ms +
   error budget): every completed op is good/bad against its flow's
   target, and the burn rate is error_rate/budget — >1.0 means the
   budget exhausts before the window does.

The registry is process-wide (``flows`` in the PerfCounters
collection) like the store/dispatch/dataplane registries; per-flow
side tables are bounded with drop counters. The off-switch is the
tracer/tuner escape-hatch contract: with ``flows_enabled=false`` (or
``CEPH_TPU_FLOWS=0``) nothing materializes — no registry, no TLS
writes, no wire labels — pinned by tests/test_flow_telemetry.py.
Telemetry faults never cost an op.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.perf_counters import PerfCounters, collection

#: one-line glossary served by ``dump_flows`` and BASELINE.md
GLOSSARY = {
    "flow": "tenant/flow label a client stamped on the op ('' = "
            "unattributed: pre-flows peer or untagged client)",
    "queue_credit": "WPQ/dmclock seat grants consumed by the flow's "
                    "ops at the sharded op queue",
    "stage_wait": "data-plane stage seconds attributed to the flow "
                  "(StageClock vocabulary, utils/stage_clock)",
    "flush_share": "fractional FlushGroup occupancy: the flow's "
                   "byte share of each engine flush it rode",
    "fsync_share": "amortized fsyncs: each store barrier fsync is "
                   "split across flows by txn bytes in the window",
    "service_ratio": "served/demand ops inside one fairness window",
    "jain_index": "(sum x)^2 / (n * sum x^2) over per-flow service "
                  "ratios: 1.0 = perfectly fair, 1/n = one flow "
                  "eats everything",
    "starved": "queued demand served below the floor ratio for N "
               "consecutive windows (flow_starvation_floor/windows)",
    "burn_rate": "SLO error rate / error budget (>1.0 burns the "
                 "budget faster than the window)",
}

#: bounded side tables — a hostile label stream must not grow memory
_MAX_FLOWS = 64
#: per-flow latency ring for p50/p99 (nearest-rank over recent ops)
_LAT_RING = 512

_tls = threading.local()


def _percentile(values: list[float], pct: float) -> float:
    """Nearest-rank percentile (load_gen's convention)."""
    if not values:
        return 0.0
    ordered = sorted(values)
    k = max(0, min(len(ordered) - 1,
                   int(round(pct / 100.0 * len(ordered) + 0.5)) - 1))
    return ordered[k]


def jain_index(shares: list[float]) -> float:
    """Jain's fairness index over non-negative allocations."""
    xs = [max(float(x), 0.0) for x in shares]
    n = len(xs)
    if not n:
        return 1.0
    s = sum(xs)
    sq = sum(x * x for x in xs)
    if sq <= 0.0:
        return 1.0
    return (s * s) / (n * sq)


class FlowTelemetry:
    """One per process, like the store/dispatch/dataplane registries
    (the MiniCluster's daemons share the process)."""

    def __init__(self, name: str = "flows") -> None:
        self.name = name
        self._lock = threading.Lock()
        perf = collection().get(name)
        if perf is None:
            perf = collection().create(name)
            self._declare(perf)
        self.perf = perf
        #: label -> per-flow accounting entry (bounded)
        self._flows: dict[str, dict] = {}
        self._flows_dropped = 0
        #: store-barrier amortization window: label -> txn bytes
        #: accumulated since the last fsync
        self._fsync_window: dict[str, int] = {}
        #: completed fairness windows retained for the dashboard
        self._windows: deque[dict] = deque(maxlen=32)

    @staticmethod
    def _declare(perf: PerfCounters) -> None:
        perf.add_u64_counter("ops", "client ops attributed to a flow")
        perf.add_u64_counter("bytes_in",
                             "payload bytes in attributed to a flow")
        perf.add_u64_counter("bytes_out",
                             "payload bytes out attributed to a flow")
        perf.add_u64_counter("unattributed_ops",
                             "client ops arriving without a flow "
                             "label (pre-flows peers, untagged "
                             "clients)")
        perf.add_u64_counter("unattributed_bytes",
                             "payload bytes riding unattributed ops")
        perf.add_u64_counter("queue_credit",
                             GLOSSARY["queue_credit"])
        perf.add_time_avg("stage_wait", GLOSSARY["stage_wait"])
        perf.add_u64_counter("engine_staged_bytes",
                             "HBM-staged bytes attributed to flows")
        perf.add_u64_counter("flush_groups",
                             "engine FlushGroups with attributed "
                             "occupancy shares")
        perf.add_u64_counter("store_txn_bytes",
                             "store transaction bytes attributed to "
                             "flows")
        perf.add_u64_counter("fsyncs",
                             "store barrier fsyncs amortized across "
                             "flows")
        perf.add_histogram("op_lat_ms",
                           "attributed op completion latency (ms); "
                           "exemplars link buckets to kept traces")
        perf.add_u64_counter("windows",
                             "fairness windows rolled")
        perf.add_u64_counter("starved_windows",
                             "per-flow windows scored starved "
                             "(queued demand, service below floor)")
        perf.add_u64_counter("slo_breaches",
                             "completed ops over their flow's SLO "
                             "target")

    # -- per-flow table -------------------------------------------------
    def _ensure(self, label: str) -> dict | None:
        """Caller holds self._lock."""
        ent = self._flows.get(label)
        if ent is None:
            if len(self._flows) >= _MAX_FLOWS:
                self._flows_dropped += 1
                return None
            ent = self._flows[label] = {
                "ops": 0, "bytes_in": 0, "bytes_out": 0,
                "lat_ring": deque(maxlen=_LAT_RING),
                "credit": {}, "stage_wait_s": {},
                "engine_staged_bytes": 0, "flush_share": 0.0,
                "store_txn_bytes": 0, "fsync_share": 0.0,
                "demand_ops": 0, "served_ops": 0,
                "demand_bytes": 0, "served_bytes": 0,
                "win_demand": 0, "win_served": 0,
                "starve_streak": 0, "windows_starved": 0,
                "slo": None,
            }
        return ent

    # -- plane 1: cost attribution --------------------------------------
    def note_op(self, label: str, bytes_in: int = 0) -> None:
        """Daemon admission: one client op arrived carrying ``label``
        ('' = unattributed) with ``bytes_in`` payload bytes."""
        if not label:
            self.perf.inc("unattributed_ops")
            if bytes_in:
                self.perf.inc("unattributed_bytes", int(bytes_in))
            return
        self.perf.inc("ops")
        if bytes_in:
            self.perf.inc("bytes_in", int(bytes_in))
        with self._lock:
            ent = self._ensure(label)
            if ent is not None:
                ent["ops"] += 1
                ent["bytes_in"] += int(bytes_in)

    def note_op_done(self, label: str, bytes_out: int = 0,
                     latency_s: float | None = None,
                     trace_id: str | None = None,
                     stages=None) -> None:
        """Daemon completion: bytes out, the op's latency into the
        per-flow ring + the exemplar histogram, the op's own stage
        durations (``stages``: a ``{stage: seconds}`` dict or the
        ``[(stage, seconds)]`` list StageClock.own_durations returns;
        repeated stages accumulate), and the SLO good/bad verdict."""
        if not label:
            if bytes_out:
                self.perf.inc("unattributed_bytes", int(bytes_out))
            return
        if bytes_out:
            self.perf.inc("bytes_out", int(bytes_out))
        lat_ms = None
        if latency_s is not None and latency_s >= 0:
            lat_ms = latency_s * 1e3
            self.perf.hinc("op_lat_ms", lat_ms, exemplar=trace_id)
        agg: dict[str, float] = {}
        if stages:
            items = stages.items() if isinstance(stages, dict) \
                else stages
            for stage, dt in items:
                if dt > 0:
                    agg[stage] = agg.get(stage, 0.0) + float(dt)
            total = sum(agg.values())
            if total > 0:
                self.perf.tinc("stage_wait", total)
        breached = False
        with self._lock:
            ent = self._ensure(label)
            if ent is None:
                return
            ent["bytes_out"] += int(bytes_out)
            if lat_ms is not None:
                ent["lat_ring"].append(lat_ms)
            if agg:
                sw = ent["stage_wait_s"]
                for stage, dt in agg.items():
                    sw[stage] = sw.get(stage, 0.0) + dt
            slo = ent["slo"]
            if slo is not None and lat_ms is not None:
                if lat_ms > slo["p99_ms"]:
                    slo["bad"] += 1
                    breached = True
                else:
                    slo["good"] += 1
        if breached:
            self.perf.inc("slo_breaches")

    def note_queue_credit(self, label: str, seat: str,
                          credit: int = 1) -> None:
        """The flow's op consumed ``credit`` grants of a WPQ/dmclock
        ``seat`` (qos class) at the sharded op queue."""
        self.perf.inc("queue_credit", int(credit))
        if not label:
            return
        with self._lock:
            ent = self._ensure(label)
            if ent is not None:
                ent["credit"][seat] = \
                    ent["credit"].get(seat, 0) + int(credit)

    def note_engine_staged(self, label: str, nbytes: int) -> None:
        """The flow staged ``nbytes`` into the device engine's HBM
        window (producer-thread seam, device_engine.stage_*)."""
        if not label or nbytes <= 0:
            return
        self.perf.inc("engine_staged_bytes", int(nbytes))
        with self._lock:
            ent = self._ensure(label)
            if ent is not None:
                ent["engine_staged_bytes"] += int(nbytes)

    def note_flush_group(self, shares: dict[str, int]) -> None:
        """One engine FlushGroup flushed; ``shares`` maps flow label
        -> bytes it contributed. Each flow's fractional occupancy of
        the group accumulates into ``flush_share``."""
        total = sum(v for v in shares.values() if v > 0)
        if total <= 0:
            return
        self.perf.inc("flush_groups")
        with self._lock:
            for label, nbytes in shares.items():
                if not label or nbytes <= 0:
                    continue
                ent = self._ensure(label)
                if ent is not None:
                    ent["flush_share"] += nbytes / total

    def note_store_txn(self, label: str, nbytes: int) -> None:
        """The flow queued ``nbytes`` of store transaction; also feeds
        the fsync amortization window (:meth:`note_fsync`)."""
        if nbytes <= 0:
            return
        if label:
            self.perf.inc("store_txn_bytes", int(nbytes))
        with self._lock:
            if label:
                ent = self._ensure(label)
                if ent is not None:
                    ent["store_txn_bytes"] += int(nbytes)
            self._fsync_window[label or ""] = \
                self._fsync_window.get(label or "", 0) + int(nbytes)

    def note_fsync(self) -> None:
        """One store barrier fsync: amortize it across the flows whose
        txn bytes rode the window since the last fsync, proportional
        to bytes (the group-commit accounting PR 15 landed)."""
        self.perf.inc("fsyncs")
        with self._lock:
            window = self._fsync_window
            self._fsync_window = {}
            total = sum(window.values())
            if total <= 0:
                return
            for label, nbytes in window.items():
                if not label:
                    continue
                ent = self._ensure(label)
                if ent is not None:
                    ent["fsync_share"] += nbytes / total

    # -- plane 2: fairness windows --------------------------------------
    def note_demand(self, label: str, ops: int = 1,
                    nbytes: int = 0) -> None:
        """Client-side submit intent: the flow wants ``ops`` served."""
        if not label:
            return
        with self._lock:
            ent = self._ensure(label)
            if ent is not None:
                ent["demand_ops"] += int(ops)
                ent["demand_bytes"] += int(nbytes)
                ent["win_demand"] += int(ops)

    def note_served(self, label: str, ops: int = 1,
                    nbytes: int = 0) -> None:
        """Client-side completion: ``ops`` of the flow's demand were
        actually served."""
        if not label:
            return
        with self._lock:
            ent = self._ensure(label)
            if ent is not None:
                ent["served_ops"] += int(ops)
                ent["served_bytes"] += int(nbytes)
                ent["win_served"] += int(ops)

    def roll_window(self) -> dict:
        """Close one fairness window: score each flow's service ratio,
        advance starvation streaks (queued demand served below the
        floor), and retain the window for the dashboard. Called by
        the load generator / mgr tick / tests — never implicitly, so
        the accounting is deterministic."""
        floor = float(g_conf()["flow_starvation_floor"])
        self.perf.inc("windows")
        starved_now = []
        rows = {}
        with self._lock:
            for label, ent in self._flows.items():
                demand, served = ent["win_demand"], ent["win_served"]
                if demand <= 0:
                    ent["starve_streak"] = 0
                    continue
                ratio = served / demand
                rows[label] = {"demand": demand, "served": served,
                               "ratio": round(ratio, 4)}
                if ratio < floor:
                    ent["starve_streak"] += 1
                    ent["windows_starved"] += 1
                    starved_now.append(label)
                else:
                    ent["starve_streak"] = 0
                ent["win_demand"] = ent["win_served"] = 0
            window = {"flows": rows, "starved": starved_now}
            self._windows.append(window)
        if starved_now:
            self.perf.inc("starved_windows", len(starved_now))
        return window

    def starved_flows(self) -> dict[str, int]:
        """label -> consecutive starved windows, for flows at or past
        the ``flow_starvation_windows`` threshold."""
        need = int(g_conf()["flow_starvation_windows"])
        with self._lock:
            return {label: ent["starve_streak"]
                    for label, ent in self._flows.items()
                    if ent["starve_streak"] >= max(need, 1)}

    def fairness(self) -> dict:
        """Cumulative demand-vs-served shares + the Jain's index over
        per-flow service ratios."""
        with self._lock:
            flows = {label: dict(demand_ops=ent["demand_ops"],
                                 served_ops=ent["served_ops"])
                     for label, ent in self._flows.items()
                     if ent["demand_ops"] or ent["served_ops"]}
        total_demand = sum(f["demand_ops"] for f in flows.values())
        total_served = sum(f["served_ops"] for f in flows.values())
        ratios = []
        out = {}
        for label, f in sorted(flows.items()):
            ratio = f["served_ops"] / f["demand_ops"] \
                if f["demand_ops"] else 0.0
            ratios.append(ratio)
            out[label] = {
                "demand_ops": f["demand_ops"],
                "served_ops": f["served_ops"],
                "service_ratio": round(ratio, 4),
                "demand_share": round(
                    f["demand_ops"] / total_demand, 4)
                if total_demand else 0.0,
                "served_share": round(
                    f["served_ops"] / total_served, 4)
                if total_served else 0.0,
            }
        return {"flows": out,
                "jain_index": round(jain_index(ratios), 4)
                if ratios else 1.0}

    def starvation_report(self) -> dict:
        conf = g_conf()
        return {"floor": float(conf["flow_starvation_floor"]),
                "windows_needed":
                    int(conf["flow_starvation_windows"]),
                "starved": self.starved_flows(),
                "recent_windows": list(self._windows)[-8:]}

    # -- plane 3: SLO burn ----------------------------------------------
    def set_slo(self, label: str, p99_ms: float,
                error_budget: float | None = None) -> None:
        """Declare the flow's SLO: completed ops over ``p99_ms`` are
        budget burn; ``error_budget`` is the tolerated bad fraction
        (default ``flow_slo_error_budget``)."""
        if not label or p99_ms <= 0:
            return
        budget = float(error_budget
                       if error_budget is not None
                       else g_conf()["flow_slo_error_budget"])
        with self._lock:
            ent = self._ensure(label)
            if ent is not None:
                ent["slo"] = {"p99_ms": float(p99_ms),
                              "budget": max(budget, 1e-9),
                              "good": 0, "bad": 0}

    def slo_table(self) -> dict:
        with self._lock:
            rows = {}
            for label, ent in self._flows.items():
                slo = ent["slo"]
                if slo is None:
                    continue
                total = slo["good"] + slo["bad"]
                err = slo["bad"] / total if total else 0.0
                rows[label] = {
                    "target_p99_ms": slo["p99_ms"],
                    "error_budget": slo["budget"],
                    "ops": total,
                    "breaches": slo["bad"],
                    "error_rate": round(err, 5),
                    "burn_rate": round(err / slo["budget"], 3),
                }
        return rows

    # -- views -----------------------------------------------------------
    def flow_table(self) -> dict:
        """Per-flow cost table — the ``dump_flows`` core."""
        with self._lock:
            out = {}
            for label, ent in sorted(self._flows.items()):
                lats = list(ent["lat_ring"])
                out[label] = {
                    "ops": ent["ops"],
                    "bytes_in": ent["bytes_in"],
                    "bytes_out": ent["bytes_out"],
                    "p50_ms": round(_percentile(lats, 50), 3),
                    "p99_ms": round(_percentile(lats, 99), 3),
                    "queue_credit": dict(ent["credit"]),
                    "stage_wait_ms": {
                        st: round(s * 1e3, 3)
                        for st, s in sorted(
                            ent["stage_wait_s"].items())},
                    "engine_staged_bytes":
                        ent["engine_staged_bytes"],
                    "flush_share": round(ent["flush_share"], 3),
                    "store_txn_bytes": ent["store_txn_bytes"],
                    "fsync_share": round(ent["fsync_share"], 3),
                    "demand_ops": ent["demand_ops"],
                    "served_ops": ent["served_ops"],
                    "starve_streak": ent["starve_streak"],
                    "windows_starved": ent["windows_starved"],
                }
            dropped = self._flows_dropped
        return {"flows": out, "flows_dropped": dropped}

    def attribution(self) -> dict:
        """Coverage: what share of ops/bytes carried a flow label —
        gap_report's ``--tenants`` honesty row (>=95% is the ISSUE-20
        acceptance bar on the CPU quick run)."""
        c = self.perf.dump()
        ops_attr = c["ops"]
        ops_total = ops_attr + c["unattributed_ops"]
        bytes_attr = c["bytes_in"] + c["bytes_out"]
        bytes_total = bytes_attr + c["unattributed_bytes"]
        with self._lock:
            by_flow = {
                label: {"ops": ent["ops"],
                        "bytes": ent["bytes_in"] + ent["bytes_out"]}
                for label, ent in sorted(self._flows.items())}
        for row in by_flow.values():
            row["ops_share"] = round(row["ops"] / ops_attr, 4) \
                if ops_attr else 0.0
            row["bytes_share"] = round(row["bytes"] / bytes_attr, 4) \
                if bytes_attr else 0.0
        return {
            "ops_attributed": ops_attr,
            "ops_total": ops_total,
            "ops_pct": round(100.0 * ops_attr / ops_total, 2)
            if ops_total else 100.0,
            "bytes_attributed": bytes_attr,
            "bytes_total": bytes_total,
            "bytes_pct": round(100.0 * bytes_attr / bytes_total, 2)
            if bytes_total else 100.0,
            "by_flow": by_flow,
        }

    def tenant_series(self) -> list[tuple[str, str, dict]]:
        """Per-tenant exposition rows for the prometheus layer:
        (metric suffix, prom type, {tenant: value}). Labels are raw
        here; utils/prometheus escapes them per the exposition spec."""
        with self._lock:
            flows = {label: (ent["ops"], ent["bytes_in"],
                             ent["bytes_out"])
                     for label, ent in self._flows.items()}
        fair = self.fairness()["flows"]
        slo = self.slo_table()
        return [
            ("ops_total", "counter",
             {t: v[0] for t, v in flows.items()}),
            ("bytes_in_total", "counter",
             {t: v[1] for t, v in flows.items()}),
            ("bytes_out_total", "counter",
             {t: v[2] for t, v in flows.items()}),
            ("served_share", "gauge",
             {t: row["served_share"] for t, row in fair.items()}),
            ("demand_share", "gauge",
             {t: row["demand_share"] for t, row in fair.items()}),
            ("slo_burn_rate", "gauge",
             {t: row["burn_rate"] for t, row in slo.items()}),
        ]

    def snapshot(self) -> dict:
        """Full JSON-able view (the ``dump_flows`` payload)."""
        return {"glossary": dict(GLOSSARY),
                "counters": self.perf.dump(),
                **self.flow_table(),
                "fairness": self.fairness(),
                "starvation": self.starvation_report(),
                "slo": self.slo_table(),
                "attribution": self.attribution()}

    def snapshot_brief(self) -> dict:
        """The bench metric-line brief: zero counters dropped."""
        c = self.perf.dump()
        out = {}
        for key in ("ops", "unattributed_ops", "queue_credit",
                    "fsyncs", "starved_windows", "slo_breaches"):
            if c[key]:
                out[key] = c[key]
        if self._flows:
            out["jain_index"] = self.fairness()["jain_index"]
        return out

    def reset(self) -> None:
        """Test/report hook: drop the logger and side tables (a fresh
        telemetry() call re-creates both)."""
        collection().remove(self.name)
        global _telemetry
        with _module_lock:
            _telemetry = None


# -- enable/disable (the escape-hatch contract) -------------------------

_module_lock = threading.Lock()
_telemetry: FlowTelemetry | None = None
_enabled_cache: bool | None = None
_observing = False


def _resolve_enabled() -> bool:
    env = os.environ.get("CEPH_TPU_FLOWS")
    if env is not None:
        return env.strip().lower() not in ("0", "false", "off", "")
    try:
        return bool(g_conf()["flows_enabled"])
    except Exception:
        return True


def enabled() -> bool:
    """Cached: the per-op fast path reads one bool. The config
    observer invalidates on flows_enabled writes; CEPH_TPU_FLOWS
    wins over the option (the bench/CI kill switch)."""
    global _enabled_cache, _observing
    if _enabled_cache is None:
        with _module_lock:
            if _enabled_cache is None:
                if not _observing:
                    try:
                        g_conf().add_observer("flows_enabled",
                                              _on_conf_change)
                        _observing = True
                    except Exception:
                        pass
                _enabled_cache = _resolve_enabled()
    return _enabled_cache


def _on_conf_change(name, value) -> None:
    global _enabled_cache
    _enabled_cache = None


def telemetry() -> FlowTelemetry:
    global _telemetry
    with _module_lock:
        if _telemetry is None:
            _telemetry = FlowTelemetry()
        return _telemetry


def telemetry_if_exists() -> FlowTelemetry | None:
    return _telemetry


def flows_if_active() -> FlowTelemetry | None:
    """The NOOP seam every attribution site goes through: None when
    flows are disabled — nothing materializes, nothing allocates."""
    if not enabled():
        return None
    tel = _telemetry
    if tel is not None:
        return tel
    return telemetry()


def reset_for_tests() -> None:
    global _telemetry, _enabled_cache
    with _module_lock:
        if _telemetry is not None:
            collection().remove(_telemetry.name)
            _telemetry = None
        _enabled_cache = None


# -- the thread-local flow context --------------------------------------

def set_current_flow(label: str | None) -> None:
    """Install the flow label on this thread (daemon admission /
    crimson inline continuation). NOOP when flows are disabled."""
    if not enabled():
        return
    _tls.flow = label or None


def current_flow() -> str | None:
    return getattr(_tls, "flow", None)


def clear_current_flow() -> None:
    if getattr(_tls, "flow", None) is not None:
        _tls.flow = None


class flow_scope:
    """``with flow_scope('tenant-a'):`` — scoped install+restore."""

    def __init__(self, label: str | None) -> None:
        self._label = label
        self._prev = None

    def __enter__(self):
        self._prev = current_flow()
        set_current_flow(self._label)
        return self

    def __exit__(self, *exc):
        set_current_flow(self._prev)
        if self._prev is None:
            clear_current_flow()
        return False


def capture_flow(qos: str = "client"):
    """Producer-side snapshot for a queued work item: the enqueue
    seam stores this on the item; the worker re-installs it via
    :func:`note_wq_grant`. None when flows are disabled (the NOOP
    contract: one attribute store of the None singleton, nothing
    else)."""
    if not enabled():
        return None
    return (current_flow() or "", qos)


def note_wq_grant(fctx) -> None:
    """Worker-side: the dequeued item consumed one seat grant of its
    qos class; re-install the producer's flow on this thread."""
    if fctx is None:
        return
    label, seat = fctx
    set_current_flow(label)
    try:
        telemetry().note_queue_credit(label, seat)
    except Exception:
        pass


def note_wq_done(fctx) -> None:
    if fctx is not None:
        clear_current_flow()


def txn_nbytes(txn) -> int:
    """Cheap payload-byte estimate of a store Transaction (or encoded
    bytes): sums the bytes/dict payloads in ``txn.ops`` without
    re-encoding — what note_store_txn charges a flow for."""
    if isinstance(txn, (bytes, bytearray, memoryview)):
        return len(txn)
    total = 0
    for op in getattr(txn, "ops", ()):
        for part in op:
            if isinstance(part, (bytes, bytearray, memoryview)):
                total += len(part)
            elif isinstance(part, dict):
                total += sum(len(k) + len(v)
                             for k, v in part.items())
    return total


def register_asok(asok) -> None:
    """``dump_flows`` on every daemon."""
    asok.register_command(
        "dump_flows", lambda a: telemetry().snapshot(),
        "tenant X-ray: per-flow cost attribution (ops/bytes, queue "
        "credit, stage waits, engine + store shares), fairness "
        "windows with Jain's index, starvation streaks, SLO burn "
        "rates")
