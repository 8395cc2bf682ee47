"""health — the cluster health engine (mgr ClusterHealth role).

Reference: src/mon/health_check.h (health_check_map_t: named checks,
each with a severity, a summary and a detail list) + the mgr modules
that raise them. The reference's ``ceph health detail`` answer is a
STRUCTURED set of named checks, not a string; this module grows the
same structure here and feeds it back to the mon, which merges it
with its own up/in accounting and serves it from ``status`` /
``health detail``.

The engine is a registry of named check functions evaluated on the
mgr tick against (a) the mon status JSON, and (b) the process
PerfCounters collection — both the instantaneous values and windowed
deltas/rates derived from the counter flight recorder
(utils/flight_recorder). Built-in checks:

- ``SLOW_OPS``                 ops past osd_op_complaint_time, from
                               every registered OpTracker
- ``OSD_DOWN``                 up/in accounting (ERR when no osd is up)
- ``PG_DEGRADED``              pgmap degraded/not-active counts
- ``DEVICE_RECOMPILE_STORM``   a kernel signature compiled more than once
                               inside the health window (the
                               recompile counter moving)
- ``ENGINE_STALL``             the pipelined engine's launch window is
                               saturated with no retirement progress
- ``SCRUB_MISMATCH``           deep-scrub flagged inconsistent stripes
- ``COMPILE_CACHE_MISS_STORM`` cold persistent-cache misses bursting
                               (the warmup-kill regressing)

Transitions are logged; the first transition *into* ``HEALTH_ERR``
auto-emits a diagnostic bundle (``dump_diagnostics()``): dout ring,
in-flight + historic + slowest ops, traces, counter time-series,
health history, device state — one JSON blob an operator can read
after the fact. The port's bundle reports its unported sources
(``compile_cache``, the tuner) as :data:`NOT_PORTED`, and its autopsy
section comes from the stand-in store, which keeps nothing (ROADMAP
A.6).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from ceph_tpu_torch.mgr.mgr_module import MgrModule
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.utils.flight_recorder import _flatten, recorder
from ceph_tpu_torch.utils.perf_counters import collection

log = Dout("health")

OK, WARN, ERR = "HEALTH_OK", "HEALTH_WARN", "HEALTH_ERR"

#: what a diagnostic-bundle section of an unported module reports
NOT_PORTED = "not ported (A.6)"
_RANK = {OK: 0, WARN: 1, ERR: 2}


def check(name: str, severity: str, summary: str,
          detail: list[str] | None = None) -> dict:
    """One named health check (health_check_t role)."""
    assert severity in _RANK
    return {"severity": severity, "summary": summary,
            "detail": list(detail or [])}


def worst(severities) -> str:
    out = OK
    for s in severities:
        if _RANK.get(s, 0) > _RANK[out]:
            out = s
    return out


class CheckContext:
    """What a check function sees: the mon status JSON (may be {}),
    the osdmap (may be None), instantaneous flat counters, and
    windowed deltas (flight recorder when it spans the window, else
    the engine's previous-evaluation snapshot)."""

    def __init__(self, status: dict, osdmap, flat: dict,
                 prev: dict | None, rec, window_s: float,
                 first_delta_absolute: bool) -> None:
        self.status = status
        self.osdmap = osdmap
        self.flat = flat
        self._prev = prev
        self._rec = rec
        self.window_s = window_s
        self._first_abs = first_delta_absolute

    def value(self, key: str, default: float = 0.0) -> float:
        return self.flat.get(key, default)

    def delta(self, key: str) -> float:
        """Growth of ``key`` over the health window."""
        if self._rec is not None:
            d = self._rec.delta(key, self.window_s)
            if d is not None:
                return d
        cur = self.flat.get(key, 0.0)
        if self._prev is None:
            return cur if self._first_abs else 0.0
        return cur - self._prev.get(key, 0.0)

    def rate(self, key: str) -> float | None:
        if self._rec is None:
            return None
        return self._rec.rate(key, self.window_s)


# -- built-in checks ---------------------------------------------------

def _check_slow_ops(ctx: CheckContext) -> dict | None:
    from ceph_tpu_torch.utils.optracker import all_slow_ops
    slow = all_slow_ops()
    if len(slow) < g_conf()["health_slow_ops_warn"]:
        return None
    detail = [f"{name}: {op['desc']} in flight for {op['age']:.1f}s"
              for name, op in slow[:10]]
    return check("SLOW_OPS", WARN,
                 f"{len(slow)} slow ops, oldest "
                 f"{max(op['age'] for _, op in slow):.1f}s", detail)


def _check_osd_down(ctx: CheckContext) -> dict | None:
    n = ctx.status.get("num_osds", 0)
    up = ctx.status.get("num_up_osds", 0)
    if not n or up >= n:
        return None
    detail = []
    if ctx.osdmap is not None:
        detail = [f"osd.{o} is down"
                  for o, i in sorted(ctx.osdmap.osds.items())
                  if not i.up]
    sev = ERR if up == 0 else WARN
    return check("OSD_DOWN", sev, f"{n - up}/{n} osds down", detail)


def _check_pg_degraded(ctx: CheckContext) -> dict | None:
    pgmap = ctx.status.get("pgmap", {})
    degraded = pgmap.get("degraded_pgs", 0)
    notactive = sum(c for st, c in pgmap.get("by_state", {}).items()
                    if st != "active")
    if not degraded and not notactive:
        return None
    detail = [f"{c} pgs {st}"
              for st, c in sorted(pgmap.get("by_state", {}).items())
              if st != "active"]
    bits = []
    if degraded:
        bits.append(f"{degraded} pgs degraded")
    if notactive:
        bits.append(f"{notactive} pgs not active")
    return check("PG_DEGRADED", WARN, "; ".join(bits), detail)


def _check_recompile_storm(ctx: CheckContext) -> dict | None:
    d = ctx.delta("device.recompiles")
    if d < g_conf()["health_recompile_warn"]:
        return None
    detail = []
    try:
        from ceph_tpu_torch.utils.device_telemetry import telemetry
        snap = telemetry().snapshot()["compiles_by_signature"]
        detail = [f"{sig}: compiled {ent['compiles']}x "
                  f"({ent['seconds']:.2f}s total)"
                  for sig, ent in sorted(
                      snap.items(),
                      key=lambda kv: -kv[1]["compiles"])
                  if ent["compiles"] > 1][:10]
    except Exception:
        pass
    r = ctx.rate("device.recompiles")
    rate_s = f", {r * 60:.1f}/min" if r else ""
    return check("DEVICE_RECOMPILE_STORM", WARN,
                 f"{int(d)} recompiles in the last "
                 f"{ctx.window_s:.0f}s{rate_s} (a shape is leaking "
                 "into a kernel cache)", detail)


def _check_engine_stall(ctx: CheckContext) -> dict | None:
    window = ctx.value("device.engine_window")
    inflight = ctx.value("device.engine_inflight")
    if window <= 0 or inflight < window:
        return None
    if ctx.delta("device.engine_retired") > 0:
        return None
    return check(
        "ENGINE_STALL", WARN,
        f"device engine launch window saturated "
        f"({int(inflight)}/{int(window)} in flight) with no "
        f"retirement progress in the last {ctx.window_s:.0f}s",
        [f"engine_retired total: "
         f"{int(ctx.value('device.engine_retired'))}"])


def _check_scrub_mismatch(ctx: CheckContext) -> dict | None:
    d = ctx.delta("device.scrub_mismatch_stripes")
    if d <= 0:
        return None
    total = int(ctx.value("device.scrub_mismatch_stripes"))
    return check("SCRUB_MISMATCH", WARN,
                 f"deep scrub flagged {int(d)} inconsistent "
                 f"stripes in the last {ctx.window_s:.0f}s "
                 f"({total} total)",
                 [f"scrub_repaired_shards: "
                  f"{int(ctx.value('device.scrub_repaired_shards'))}",
                  f"scrub_host_fallbacks: "
                  f"{int(ctx.value('device.scrub_host_fallbacks'))}"])


def _check_cache_miss_storm(ctx: CheckContext) -> dict | None:
    d = ctx.delta("device.compile_cache_misses")
    if d < g_conf()["health_cache_miss_warn"]:
        return None
    return check(
        "COMPILE_CACHE_MISS_STORM", WARN,
        f"{int(d)} cold compile-cache misses in the last "
        f"{ctx.window_s:.0f}s (persistent compile cache not serving)",
        [f"compile_cache_hits total: "
         f"{int(ctx.value('device.compile_cache_hits'))}"])


def _check_hbm_pressure(ctx: CheckContext) -> dict | None:
    """The device engine's live buffer bytes (staged + launch-window,
    utils/device_telemetry HBM ledger) holding at warning level: the
    encode window is outrunning retirement — op backpressure and,
    on a real chip, HBM exhaustion are next. The gauges reconcile to
    zero at idle, so a raised check always means live load."""
    limit = g_conf()["health_hbm_warn_bytes"]
    if limit <= 0:
        return None
    live = ctx.value("device.hbm_live_bytes")
    if live < limit:
        return None
    staged = int(ctx.value("device.hbm_staged_bytes"))
    inflight = int(ctx.value("device.hbm_inflight_bytes"))
    peak = int(ctx.value("device.hbm_peak_live_bytes"))
    return check(
        "HBM_PRESSURE", WARN,
        f"{live / 1e6:.0f} MB live device buffer bytes "
        f"(staged {staged / 1e6:.0f} MB + in-window "
        f"{inflight / 1e6:.0f} MB) >= {limit / 1e6:.0f} MB",
        [f"hbm_peak_live_bytes: {peak}",
         f"engine_inflight: "
         f"{int(ctx.value('device.engine_inflight'))}/"
         f"{int(ctx.value('device.engine_window'))} batches",
         f"hbm_retired_bytes total: "
         f"{int(ctx.value('device.hbm_retired_bytes'))}"])


def _check_flow_starvation(ctx: CheckContext) -> dict | None:
    """A tenant flow with queued demand has been served below the
    configured floor for N consecutive fairness windows (the flow
    registry's starvation detector). ERR, not WARN: sustained starvation under
    load is an isolation failure, and the first transition into
    HEALTH_ERR auto-emits the diagnostics bundle whose flows section
    carries the per-tenant evidence the autopsy chain needs."""
    from ceph_tpu_torch.utils import flow_telemetry as _flow_tel
    tel = _flow_tel.telemetry_if_exists()
    if tel is None:
        return None
    try:
        starved = tel.starved_flows()
    except Exception:
        return None
    if not starved:
        return None
    floor = g_conf()["flow_starvation_floor"]
    need = g_conf()["flow_starvation_windows"]
    fairness = tel.fairness()
    detail = []
    for label, streak in sorted(starved.items()):
        row = fairness["flows"].get(label, {})
        detail.append(
            f"flow {label!r}: {streak} consecutive windows below "
            f"floor {floor:.2f} (service_ratio "
            f"{row.get('service_ratio', 0.0):.3f}, served_share "
            f"{row.get('served_share', 0.0):.3f}, demand_share "
            f"{row.get('demand_share', 0.0):.3f})")
    detail.append(f"jain_index: {fairness['jain_index']:.4f}")
    return check(
        "FLOW_STARVATION", ERR,
        f"{len(starved)} tenant flow(s) starved: queued demand "
        f"served below floor {floor:.2f} for >= {need} windows",
        detail)


BUILTIN_CHECKS = (
    ("SLOW_OPS", _check_slow_ops),
    ("OSD_DOWN", _check_osd_down),
    ("PG_DEGRADED", _check_pg_degraded),
    ("DEVICE_RECOMPILE_STORM", _check_recompile_storm),
    ("ENGINE_STALL", _check_engine_stall),
    ("SCRUB_MISMATCH", _check_scrub_mismatch),
    ("COMPILE_CACHE_MISS_STORM", _check_cache_miss_storm),
    ("HBM_PRESSURE", _check_hbm_pressure),
    ("FLOW_STARVATION", _check_flow_starvation),
)


class HealthEngine:
    """Registry + evaluator of named health checks, with transition
    history and the auto-emitted HEALTH_ERR diagnostic bundle."""

    def __init__(self, rec=None, clock=time.monotonic,
                 publish_perf: bool = True,
                 bundle_on_err: bool = True,
                 first_delta_absolute: bool = False) -> None:
        self._lock = threading.Lock()
        self._clock = clock
        self._rec = rec
        self._publish = publish_perf
        self._bundle_on_err = bundle_on_err
        self._first_abs = first_delta_absolute
        self._checks: dict[str, object] = dict(BUILTIN_CHECKS)
        self._prev_flat: dict | None = None
        self.current: dict[str, dict] = {}
        self.status = OK
        self.history: deque[dict] = deque(
            maxlen=g_conf()["health_history_size"])
        self.last_bundle: dict | None = None
        self.bundles_emitted = 0
        self._perf = None
        self._perf_checks: set[str] = set()
        self._last_status: dict = {}

    # -- registry -----------------------------------------------------
    def register(self, name: str, fn) -> None:
        """Add/replace a named check: ``fn(ctx) -> check dict | None``."""
        with self._lock:
            self._checks[name] = fn

    def unregister(self, name: str) -> None:
        with self._lock:
            self._checks.pop(name, None)

    # -- evaluation ---------------------------------------------------
    def evaluate(self, status: dict | None = None,
                 osdmap=None) -> dict:
        """Run every registered check; log transitions; auto-bundle on
        entering HEALTH_ERR. Returns the structured report."""
        status = status or {}
        flat = _flatten(collection().dump())
        with self._lock:
            checks = dict(self._checks)
            prev_flat = self._prev_flat
        ctx = CheckContext(status, osdmap, flat, prev_flat, self._rec,
                           g_conf()["health_window_seconds"],
                           self._first_abs)
        raised: dict[str, dict] = {}
        for name, fn in checks.items():
            try:
                out = fn(ctx)
            except Exception as exc:
                log(1, f"health check {name} failed: {exc!r}")
                continue
            if out is not None:
                raised[name] = out
        now_wall = time.time()
        with self._lock:
            old_status = self.status
            old = self.current
            for name, chk in raised.items():
                before = old.get(name, {}).get("severity", OK)
                if before != chk["severity"]:
                    self._transition(name, before, chk["severity"],
                                     chk["summary"], now_wall)
            for name, chk in old.items():
                if name not in raised:
                    self._transition(name, chk["severity"], OK,
                                     "cleared", now_wall)
            self.current = raised
            self.status = worst(c["severity"] for c in raised.values())
            new_status = self.status
            self._last_status = status
        if self._publish:
            self._publish_gauges(raised, new_status)
        if old_status != new_status:
            log(1, f"cluster health {old_status} -> {new_status}"
                + (f" ({', '.join(sorted(raised))})" if raised else ""))
        if self._bundle_on_err and new_status == ERR \
                and old_status != ERR:
            # exactly once per ERR entry: staying in ERR re-emits
            # nothing, leaving and re-entering emits a fresh bundle
            self._emit_bundle("transition_to_HEALTH_ERR")
        with self._lock:
            self._prev_flat = flat
        return self.report()

    def _transition(self, name: str, before: str, after: str,
                    summary: str, now_wall: float) -> None:
        """Caller holds the lock."""
        self.history.append({"ts": round(now_wall, 3), "check": name,
                             "from": before, "to": after,
                             "summary": summary})
        log(1, f"health check {name}: {before} -> {after} ({summary})")

    def _publish_gauges(self, raised: dict, status: str) -> None:
        """health_status + one gauge per check on the prometheus
        endpoint (through the process PerfCounters collection)."""
        try:
            if self._perf is None:
                perf = collection().get("health")
                if perf is None:
                    perf = collection().create("health")
                    perf.add_gauge("health_status",
                                   "0=OK 1=WARN 2=ERR")
                self._perf = perf
            self._perf.set_gauge("health_status", _RANK[status])
            for name in set(raised) | self._perf_checks:
                key = f"check_{name}"
                try:
                    self._perf.add_gauge(key)
                except ValueError:
                    pass           # already declared
                sev = raised.get(name, {}).get("severity", OK)
                self._perf.set_gauge(key, _RANK[sev])
                self._perf_checks.add(name)
        except Exception as exc:
            log(5, f"health gauge publish failed: {exc!r}")

    # -- views --------------------------------------------------------
    def report(self) -> dict:
        """The structured answer (health_check_map_t dump shape)."""
        with self._lock:
            return {"status": self.status,
                    "checks": {n: dict(c)
                               for n, c in self.current.items()}}

    def history_dump(self) -> list[dict]:
        with self._lock:
            return list(self.history)

    # -- diagnostics bundle -------------------------------------------
    def dump_diagnostics(self, reason: str = "on_demand") -> dict:
        """One JSON blob with everything an after-the-fact diagnosis
        needs. Best-effort per section: one faulted source must not
        cost the rest of the bundle."""
        bundle: dict = {"reason": reason,
                        "ts": round(time.time(), 3),
                        "report": self.report(),
                        "health_history": self.history_dump()}
        with self._lock:
            bundle["osdmap_epoch"] = self._last_status.get("epoch")
            bundle["mon_status"] = dict(self._last_status)

        def section(name, fn):
            try:
                bundle[name] = fn()
            except Exception as exc:
                bundle[name] = {"error": repr(exc)}

        rec = self._rec
        if rec is not None:
            section("counter_series", rec.window)
            section("rates", lambda: rec.rates_brief(
                g_conf()["health_window_seconds"]))
            section("recorder", rec.stats)
        from ceph_tpu_torch.utils import dout as _dout
        section("log_recent", lambda: _dout.dump_recent(1000))
        from ceph_tpu_torch.utils.optracker import dump_all_trackers
        section("ops", dump_all_trackers)
        from ceph_tpu_torch.utils.tracing import tracer
        section("traces", lambda: tracer().dump())
        section("trace_stats", lambda: tracer().stats())
        # slow-op autopsies: the per-op post-mortems ride
        # the bundle so one blob answers "which ops were bad and why"
        # (utils/autopsy is not ported: the stand-in keeps nothing,
        # ROADMAP A.6)
        from ceph_tpu_torch.utils.noop_hooks import autopsy_store
        section("autopsies", lambda: autopsy_store().dump())
        from ceph_tpu_torch.utils.device_telemetry import telemetry
        section("device", lambda: telemetry().snapshot())
        # tenant X-ray: per-flow attribution + fairness +
        # starvation evidence ride the bundle ONLY when the flows
        # registry is live — diagnosing must not instantiate one
        from ceph_tpu_torch.utils import flow_telemetry as _flow_tel
        flows_tel = _flow_tel.telemetry_if_exists()
        if flows_tel is not None:
            section("flows", flows_tel.snapshot)
        from ceph_tpu_torch.utils import profiler as _profiler
        # status + hot frames only when a profiler EXISTS — diagnosing
        # must not allocate one (the OFF-cost contract)
        prof = _profiler.profiler_if_exists()
        if prof is not None:
            section("profiler", lambda: {
                "status": prof.status(),
                "top_frames": prof.top_frames(10)})
        # utils/compile_cache and the closed-loop tuner (mgr/tuner)
        # are not ported; their sections say so (the kernel libraries
        # are named by a hash of their source, ops/cuda_build.py)
        section("compile_cache", lambda: {"error": NOT_PORTED})
        bundle["tuner"] = {"error": NOT_PORTED}
        return bundle

    def _emit_bundle(self, reason: str) -> None:
        try:
            bundle = self.dump_diagnostics(reason)
        except Exception as exc:       # diagnosis must not kill ticks
            log(1, f"diagnostic bundle failed: {exc!r}")
            return
        with self._lock:
            self.last_bundle = bundle
            self.bundles_emitted += 1
            n = self.bundles_emitted
        log(0, f"HEALTH_ERR: diagnostic bundle #{n} captured "
            f"({reason})")
        out_dir = g_conf()["health_bundle_dir"]
        if out_dir:
            try:
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(
                    out_dir, f"health_bundle_{int(bundle['ts'])}_{n}"
                             ".json")
                with open(path, "w") as f:
                    json.dump(bundle, f, indent=1, default=str)
                log(0, f"diagnostic bundle written to {path}")
            except OSError as exc:
                log(1, f"bundle write failed: {exc!r}")


# -- bench seam --------------------------------------------------------

_brief_lock = threading.Lock()
_brief_engine: HealthEngine | None = None


def device_health_brief() -> dict:
    """Device-side health for bench metric lines: evaluates the
    counter-driven checks only (no cluster status), so a bench row
    that ran during a recompile storm is self-describing. Deltas are
    since process start on the first call (the bench process begins
    at zero counters). Cheap — no recorder, no sampling, no bundle —
    so it adds nothing to the bench budget."""
    global _brief_engine
    with _brief_lock:
        if _brief_engine is None:
            _brief_engine = HealthEngine(
                rec=None, publish_perf=False, bundle_on_err=False,
                first_delta_absolute=True)
        engine = _brief_engine
    rep = engine.evaluate(status=None)
    return {"status": rep["status"],
            "checks": {n: c["summary"]
                       for n, c in rep["checks"].items()}}


def _reset_brief_for_tests() -> None:
    global _brief_engine
    with _brief_lock:
        _brief_engine = None


# -- the mgr module ----------------------------------------------------

class Module(MgrModule):
    NAME = "health"

    COMMANDS = ("status", "detail", "history", "bundle",
                "diagnostics", "recorder")

    def __init__(self, mgr) -> None:
        super().__init__(mgr)
        self.TICK_PERIOD = g_conf()["health_tick_period"]
        self.recorder = recorder()
        self.engine = HealthEngine(rec=self.recorder)

    def tick(self) -> None:
        self.recorder.sample()
        try:
            status = self.get_status()
        except Exception:
            status = {}
        try:
            osdmap = self.get_osdmap()
        except Exception:
            osdmap = None
        report = self.engine.evaluate(status, osdmap)
        self._push_report(report)

    def _push_report(self, report: dict) -> None:
        """Feed the structured checks back to the mon (the reference's
        MMonMgrReport health_checks payload), so ``ceph status`` /
        ``health detail`` answer them cluster-wide."""
        monc = getattr(getattr(self.mgr, "rados", None), "monc", None)
        if monc is None or not hasattr(monc, "report_health"):
            return
        try:
            monc.report_health(json.dumps(report).encode())
        except Exception as exc:
            log(5, f"health report push failed: {exc!r}")

    def handle_command(self, cmd: dict) -> tuple[int, str, bytes]:
        sub = cmd.get("prefix", "status")
        if sub == "status":
            rep = self.engine.report()
            return 0, rep["status"], json.dumps(rep).encode()
        if sub == "detail":
            rep = self.engine.report()
            rep["history"] = self.engine.history_dump()
            rep["rates"] = self.recorder.rates_brief(
                g_conf()["health_window_seconds"])
            return 0, "", json.dumps(rep).encode()
        if sub == "history":
            return 0, "", json.dumps(
                self.engine.history_dump()).encode()
        if sub in ("bundle", "diagnostics"):
            if sub == "bundle" and self.engine.last_bundle is not None:
                return 0, "last auto-emitted bundle", json.dumps(
                    self.engine.last_bundle, default=str).encode()
            return 0, "", json.dumps(
                self.engine.dump_diagnostics(), default=str).encode()
        if sub == "recorder":
            return 0, "", json.dumps(self.recorder.stats()).encode()
        return super().handle_command(cmd)
