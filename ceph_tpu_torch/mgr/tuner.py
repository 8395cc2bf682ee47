"""tuner — the mgr's closed-loop self-tuning control plane.

Port of ``ceph_tpu/mgr/tuner.py``. The OSD hot path has sensors for
every stage — per-stage p99s (utils/dataplane), the device memory
ledger and occupancy (utils/device_telemetry), windowed counter rates
(the flight recorder), health-check state — and knobs that were
hand-set constants: the engine's launch window and flush thresholds,
the objecter's batch window, the sampling rates. The best setting
moves with the workload: no fixed knob suits both a zipfian read storm
and a bulk write pass.

This module closes the loop as a SLOW outer controller on the mgr
tick. Architecture:

- **Sensors** (:class:`LiveSensors`) fold the existing stack into one
  flat snapshot per tick; :class:`ScriptedSensors` replays a recorded
  trace, which together with the injectable clock makes the whole
  loop deterministic and testable headless (the scenario tests run
  on a scripted clock in milliseconds).
- **Actuators** are the typed :class:`~ceph_tpu_torch.utils.knobs.Knob`
  registry (utils/knobs): bounds, step law, cool-down. Pushes ride
  the config-observer seam (``mon`` layer), so daemons consume them
  through their cached observers — never a hot-path g_conf read —
  and operator pins (env/override layers) win by construction.
- **Control discipline** is first-class, not best-effort:

  * bounded steps — one knob, one step, clamped into the declared
    envelope; ONE actuation in flight at a time, so a regression is
    attributable to the step that caused it;
  * hysteresis — a rule must fire ``tuner_hysteresis_ticks``
    consecutive ticks before its step is taken;
  * per-knob cool-downs — a stepped knob is held for its cool-down,
    then judged; a reverted knob is "burned" (4x cool-down) before
    it may step again;
  * revert-on-regression — the post-step objective window is
    compared against the pre-step rolling baseline with
    ``bench_trend``'s direction-aware delta convention (latency
    regresses up, throughput down); a step that worsened p99 without
    buying throughput is reverted within one cool-down window.

- **Every decision is a structured, traced event**: a bounded history
  ring (asok ``tuner status|history``, dashboard ``/api/tuner``, the
  health diagnostics bundle), ``tuner_*`` counters, and a force-kept
  trace per step/revert so the trace archive carries the control
  plane's actions next to the data-path ops they affected.

Default OFF (``tuner_enabled`` / env ``CEPH_TPU_TUNER``) and a
literal NOOP when off: the mgr module registers no counters, spawns
no threads, writes no knobs, and never ticks.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from statistics import median

from ceph_tpu_torch.client.object_cacher import aggregate_stats as cache_stats
from ceph_tpu_torch.mgr.mgr_module import MgrModule
from ceph_tpu_torch.parallel import placement
from ceph_tpu_torch.tools.bench_trend import lower_is_better
from ceph_tpu_torch.utils import faults, read_heat, store_telemetry
from ceph_tpu_torch.utils.config import ConfigProxy, g_conf
from ceph_tpu_torch.utils.dataplane import dataplane as _dataplane
from ceph_tpu_torch.utils.device_telemetry import \
    telemetry as _device_telemetry
from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.utils.flight_recorder import recorder as _recorder
from ceph_tpu_torch.utils.knobs import TUNER_KNOBS, KnobRegistry
from ceph_tpu_torch.utils.perf_counters import collection
from ceph_tpu_torch.utils.tracing import tracer

log = Dout("mgr")

#: health severity rank the sensors report (mirrors mgr/health._RANK)
_HEALTH_RANK = {"HEALTH_OK": 0, "HEALTH_WARN": 1, "HEALTH_ERR": 2}


def tuner_on() -> bool:
    """The master switch: env CEPH_TPU_TUNER beats the declared
    Option (the same A/B convention as CEPH_TPU_BULK_INGEST)."""
    env = os.environ.get("CEPH_TPU_TUNER")
    if env is not None:
        return env != "0"
    return bool(g_conf()["tuner_enabled"])


# ---------------------------------------------------------------------------
# sensors
# ---------------------------------------------------------------------------

#: the flat snapshot contract every sensor source honors (missing
#: keys read as 0/empty — a partial snapshot must not kill the loop)
SENSOR_KEYS = ("p99_ms", "mbps", "hbm_live", "hbm_limit", "inflight",
               "window", "occupancy", "flush_bytes_mean",
               "health_rank", "fault_events", "mesh_slots",
               "slot_staged", "stream_batch_mean", "read_skew",
               "cache_hit_rate", "cache_lookups")


class LiveSensors:
    """Reads the live observability stack. ``health_source`` is an
    optional callable returning the current cluster health status
    string (the mgr module wires the health engine's).

    Unlike the reference, a sensor that fails raises: the mgr's tick
    loop counts it (``module_errors``) and logs it, so a broken or
    renamed sensor source cannot leave the tuner silently inert. A
    cold stack is not a failure: keys with no data yet are left out
    and read as 0 (:data:`SENSOR_KEYS`)."""

    def __init__(self, health_source=None,
                 window_s: float = 15.0) -> None:
        self._health_source = health_source
        self._window_s = window_s

    def sample(self) -> dict:
        snap: dict = {"p99_ms": _dataplane().percentile_ms(
            "op_total_us", 0.99)}
        tel = _device_telemetry()
        c = tel.perf.dump()
        snap["hbm_live"] = tel.hbm_live_bytes()
        snap["inflight"] = c.get("engine_inflight", 0)
        snap["window"] = c.get("engine_window", 0)
        snap["mesh_slots"] = c.get("placement_slots", 0)
        snap["slot_staged"] = tel.slot_staged_bytes()
        snap["hbm_limit"] = g_conf()["health_hbm_warn_bytes"]
        rec = _recorder()
        r = rec.rate("device.bytes_encoded", self._window_s)
        if r is not None:
            snap["mbps"] = r / 1e6
        db = rec.delta("device.bytes_encoded", self._window_s)
        df = rec.delta("device.encode_batch_ops.count", self._window_s)
        dops = rec.delta("dataplane.ops_timed", self._window_s)
        if df and df > 0:
            if db is not None:
                snap["flush_bytes_mean"] = db / df
            if dops is not None:
                snap["occupancy"] = max(0.0, dops / df)
        # the streaming objecter's measured batch size (the
        # objecter_stream_max_ops actuator's sensor); the if_exists
        # form never allocates the registry from here
        st = store_telemetry.telemetry_if_exists()
        if st is not None:
            snap["stream_batch_mean"] = \
                st.snapshot_brief().get("mean_stream_batch", 0.0)
        # per-object read concentration: the any-k read_set_spread
        # actuator's sensor — zipfian storms score far above 1.0,
        # even traffic sits at it
        snap["read_skew"] = read_heat.skew()
        # client cache-tier hit picture, process-wide (the
        # client_cache_bytes actuator's sensor)
        cs = cache_stats()
        snap["cache_lookups"] = cs["hits"] + cs["misses"]
        if cs["hit_rate"] is not None:
            snap["cache_hit_rate"] = cs["hit_rate"]
        snap["fault_events"] = faults.fire_count()
        if self._health_source is not None:
            snap["health_rank"] = _HEALTH_RANK.get(
                self._health_source(), 0)
        return snap


class ScriptedSensors:
    """Replays a recorded sensor trace (list of snapshot dicts) —
    the determinism seam: same trace + same clock => bit-identical
    decision history. Holds the last sample once exhausted."""

    def __init__(self, trace: list[dict]) -> None:
        assert trace, "a scripted trace needs at least one sample"
        self._trace = [dict(s) for s in trace]
        self._i = 0

    def sample(self) -> dict:
        snap = self._trace[min(self._i, len(self._trace) - 1)]
        self._i += 1
        return dict(snap)


# ---------------------------------------------------------------------------
# rules (the policy table — priority = declaration order)
# ---------------------------------------------------------------------------

class Rule:
    """One sensor condition -> one bounded knob step. ``when`` sees
    the preprocessed snapshot (derived keys: hbm_frac, p99_ref,
    fault_delta) and the engine (for conf lookups)."""

    def __init__(self, name: str, knob: str, direction: str,
                 why: str, when) -> None:
        assert direction in ("up", "down")
        self.name = name
        self.knob = knob
        self.direction = direction
        self.why = why
        self.when = when


def _default_of(eng: "TunerEngine", option: str):
    return eng.conf.schema.get(option).default


DEFAULT_RULES = (
    # safety first: the HBM working set is window x flush_bytes —
    # shed the window, then the batch size, before the HBM_PRESSURE
    # check would fire
    Rule("hbm_window_backoff", "engine_window", "down",
         "HBM live bytes near the warn limit: shrink the launch "
         "window's working set",
         lambda s, e: s["hbm_frac"] >= 0.75),
    Rule("hbm_flush_backoff", "engine_flush_bytes", "down",
         "HBM still climbing with the window already shed: shrink "
         "the per-flush working set",
         lambda s, e: s["hbm_frac"] >= 0.9),
    # throughput levers (the write-burst phase): a saturated launch
    # window with HBM headroom wants more overlap; sustained high
    # occupancy with healthy latency wants bigger batches
    Rule("window_grow", "engine_window", "up",
         "launch window saturated with HBM headroom: deepen the "
         "pipeline for more upload/compute/download overlap",
         lambda s, e: s["window"] > 0 and
         s["inflight"] >= s["window"] and s["hbm_frac"] < 0.5),
    Rule("flush_grow", "engine_flush_bytes", "up",
         "high flush occupancy at healthy latency: amortize "
         "dispatch over bigger batches",
         lambda s, e: s["occupancy"] >= 4 and
         (s["p99_ref"] <= 0 or s["p99_ms"] <= 1.2 * s["p99_ref"])),
    # latency lever (the read-heavy phase): near-empty flushes mean
    # ops pay batching latency nothing amortizes — triggered either
    # by p99 moving off its rolling baseline, or absolutely when the
    # mean flush runs far below the cap (the cap is not earning its
    # latency; a lower threshold flushes snappier when load rises)
    Rule("flush_shrink", "engine_flush_bytes", "down",
         "near-empty flushes: batching latency without "
         "amortization — cut the flush threshold",
         lambda s, e: 0 < s["occupancy"] <= 2 and
         ((s["p99_ref"] > 0 and s["p99_ms"] > 1.5 * s["p99_ref"]) or
          (0 < s["flush_bytes_mean"] <
           0.25 * float(e.conf.get("engine_flush_bytes"))))),
    # mesh crossover: flushes consistently at/above the crossover
    # mean the sharded route would take more of the load
    Rule("mesh_crossover_down", "mesh_flush_bytes", "down",
         "mean flush size at the dense->mesh crossover on a "
         "multi-slot mesh: lower the crossover so more flushes "
         "ride the sharded step",
         lambda s, e: s["mesh_slots"] > 1 and
         s["flush_bytes_mean"] >=
         float(e.conf.get("mesh_flush_bytes"))),
    # the streaming objecter's batch window (ROADMAP 1b/5d): widen
    # while shipped batches clip at the cap with healthy latency;
    # narrow when p99 moves off baseline with batches running far
    # under it (head-of-line batching latency nothing amortizes)
    Rule("stream_window_grow", "objecter_stream_max_ops", "up",
         "streaming batches clip at the window with healthy "
         "latency: widen the client coalescing window",
         lambda s, e: s["stream_batch_mean"] >= 0.75 *
         float(e.conf.get("objecter_stream_max_ops")) and
         (s["p99_ref"] <= 0 or s["p99_ms"] <= 1.2 * s["p99_ref"])),
    Rule("stream_window_shrink", "objecter_stream_max_ops", "down",
         "p99 off baseline with streaming batches far under the "
         "window: cut the head-of-line coalescing wait",
         lambda s, e: s["p99_ref"] > 0 and
         s["p99_ms"] > 1.5 * s["p99_ref"] and
         0 < s["stream_batch_mean"] <= 0.25 *
         float(e.conf.get("objecter_stream_max_ops"))),
    # crimson levers: the run-to-completion flush window
    # rides the same occupancy/latency sensors as the engine's (the
    # crimson OSD attaches to the shared engine with its own
    # threshold); the reactor count steps only for FUTURE boots (the
    # observer caches it — live reactors never reshard), so its rule
    # keys off sustained pressure, not transients
    Rule("crimson_flush_grow", "crimson_flush_bytes", "up",
         "high flush occupancy at healthy latency on the crimson "
         "arm: amortize the one async boundary over bigger stripes",
         lambda s, e: s["occupancy"] >= 4 and
         (s["p99_ref"] <= 0 or s["p99_ms"] <= 1.2 * s["p99_ref"])),
    Rule("crimson_flush_shrink", "crimson_flush_bytes", "down",
         "near-empty crimson flushes: the engine-window wait is "
         "pure latency nothing amortizes — cut the threshold",
         lambda s, e: 0 < s["occupancy"] <= 2 and
         s["p99_ref"] > 0 and s["p99_ms"] > 1.5 * s["p99_ref"]),
    Rule("crimson_smp_grow", "crimson_smp", "up",
         "sustained saturation with healthy memory: more shards for "
         "crimson OSDs started after this step",
         lambda s, e: s["window"] > 0 and
         s["inflight"] >= s["window"] and s["hbm_frac"] < 0.5 and
         s["health_rank"] == 0),
    # read-path levers (ROADMAP 3): the any-k rotation width steps
    # on MEASURED per-object skew — wide only while a storm is
    # actually concentrated (width costs decode-signature reuse, so
    # even traffic walks it back); the cache tier's capacity steps
    # on its measured hit rate
    Rule("read_spread_grow", "osd_read_set_spread", "up",
         "hot-object read skew: rotate shard read sets across more "
         "of the acting set to spread the storm",
         lambda s, e: s["read_skew"] >= 4.0),
    Rule("read_spread_shrink", "osd_read_set_spread", "down",
         "reads even again: narrow the rotation back toward the "
         "canonical read set (shared decode signatures)",
         lambda s, e: 0 < s["read_skew"] <= 1.5 and
         e.conf.get("osd_read_set_spread") >
         _default_of(e, "osd_read_set_spread")),
    Rule("cache_grow", "client_cache_bytes", "up",
         "client cache missing under live lookups: more capacity "
         "for the hot set",
         lambda s, e: s["cache_lookups"] > 0 and
         s["cache_hit_rate"] < 0.5),
    Rule("cache_shrink", "client_cache_bytes", "down",
         "client cache hit rate saturated: hand the surplus "
         "capacity back",
         lambda s, e: s["cache_lookups"] > 0 and
         s["cache_hit_rate"] >= 0.9 and
         e.conf.get("client_cache_bytes") >
         _default_of(e, "client_cache_bytes")),
    # observability levers: keep more evidence while degraded, give
    # the overhead back when healthy
    Rule("trace_keep_more", "trace_sample_every", "down",
         "degraded/faulting cluster: raise the head-sample keep "
         "rate while the evidence is interesting",
         lambda s, e: s["health_rank"] >= 1 or s["fault_delta"] > 0),
    Rule("trace_relax", "trace_sample_every", "up",
         "healthy again: restore the head-sample rate toward its "
         "default",
         lambda s, e: s["health_rank"] == 0 and s["fault_delta"] == 0
         and e.conf.get("trace_sample_every") <
         _default_of(e, "trace_sample_every")),
    Rule("profiler_boost", "profiler_hz", "up",
         "cluster degraded: more profiler resolution while the "
         "incident is live",
         lambda s, e: s["health_rank"] >= 1 and
         e.conf.get("profiler_hz") < 2 *
         _default_of(e, "profiler_hz")),
    Rule("profiler_restore", "profiler_hz", "down",
         "healthy again: walk the profiler rate back toward its "
         "default",
         lambda s, e: s["health_rank"] == 0 and
         e.conf.get("profiler_hz") > _default_of(e, "profiler_hz")),
)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

def _make_perf():
    """Get-or-create the ``tuner`` counter registry. ONLY called by a
    constructed TunerEngine — the off-by-default mgr module never
    creates one (the literal-NOOP contract)."""
    perf = collection().get("tuner")
    if perf is None:
        perf = collection().create("tuner")
        perf.add_u64_counter("tuner_ticks",
                             "control-loop evaluations")
        perf.add_u64_counter("tuner_steps",
                             "bounded knob steps taken")
        perf.add_u64_counter("tuner_reverts",
                             "steps rolled back by "
                             "revert-on-regression")
        perf.add_u64_counter("tuner_confirms",
                             "steps that survived their judgment "
                             "window")
        perf.add_u64_counter("tuner_clamped",
                             "rule firings whose step was already at "
                             "the knob's bound")
        perf.add_u64_counter("tuner_pinned_skips",
                             "steps skipped because an env/override "
                             "layer pins the knob")
        perf.add_u64_counter("tuner_weight_updates",
                             "placement slot-weight vectors "
                             "published from the chip-load signal")
        perf.add_gauge("tuner_active",
                       "1 while a tuner engine is driving the "
                       "actuators")
    return perf


class TunerEngine:
    """The deterministic control loop. Single-threaded by contract —
    the mgr tick drives it; tests drive it directly with a scripted
    clock. The lock only guards the history/status views."""

    def __init__(self, sensors, conf: ConfigProxy | None = None,
                 knobs: KnobRegistry = TUNER_KNOBS,
                 rules=DEFAULT_RULES,
                 clock=time.monotonic, wall=time.time,
                 publish_perf: bool = True) -> None:
        self.conf = conf or g_conf()
        self.knobs = knobs
        self.rules = list(rules)
        self._sensors = sensors
        self._clock = clock
        self._wall = wall
        # control parameters, read once (deterministic for the run)
        self.cooldown_s = self.conf["tuner_cooldown_s"]
        self.threshold_pct = self.conf["tuner_threshold_pct"]
        self.hysteresis_ticks = self.conf["tuner_hysteresis_ticks"]
        self.baseline_window = self.conf["tuner_baseline_window"]
        self._weighting = bool(
            self.conf["tuner_placement_weighting"])
        self._lock = threading.Lock()
        self._samples: deque[tuple[float, dict]] = deque(maxlen=128)
        self._rule_streak: dict[str, int] = {}
        #: the single in-flight actuation awaiting judgment
        self._pending: dict | None = None
        #: knob name -> clock time it may step again
        self._burned: dict[str, float] = {}
        #: (knob, rule) -> consecutive reverts: each revert doubles
        #: the quarantine (escalating backoff — a probe the workload
        #: keeps rejecting is retried ever more rarely, so steady
        #: state is spent at the accepted point, not flapping off it)
        self._revert_counts: dict[tuple[str, str], int] = {}
        self._last_action_t = -1e18
        self._last_faults = None
        self._published_weights: dict[int, float] | None = None
        self._seq = 0
        self.history: deque[dict] = deque(
            maxlen=self.conf["tuner_history_size"])
        self.perf = _make_perf() if publish_perf else None
        self._count_gauge("tuner_active", 1)

    # -- counters ------------------------------------------------------
    def _count(self, key: str, by: int = 1) -> None:
        if self.perf is not None:
            self.perf.inc(key, by)

    def _count_gauge(self, key: str, value) -> None:
        if self.perf is not None:
            self.perf.set_gauge(key, value)

    def _publish_knob_gauges(self) -> None:
        if self.perf is None:
            return
        for name in self.knobs.names():
            key = f"knob_{name}"
            try:
                self.perf.add_gauge(key)
            except ValueError:
                pass           # already declared
            self.perf.set_gauge(key, self.conf.get(name))

    # -- objective windows ---------------------------------------------
    @staticmethod
    def _median_of(samples, key: str) -> float:
        vals = [s.get(key, 0.0) for _t, s in samples
                if s.get(key) is not None]
        return median(vals) if vals else 0.0

    def _objective(self, samples) -> dict:
        return {"p99_ms": round(self._median_of(samples, "p99_ms"), 4),
                "mbps": round(self._median_of(samples, "mbps"), 4)}

    def _baseline(self) -> dict:
        recent = list(self._samples)[-self.baseline_window:]
        return self._objective(recent)

    def _since(self, t: float) -> list:
        return [(ts, s) for ts, s in self._samples if ts > t]

    # -- the judgment (bench_trend's direction-aware deltas) -----------
    @staticmethod
    def _delta_pct(base: float, post: float,
                   lower_better: bool) -> float:
        """Signed percent, positive = better — exactly the
        bench_trend convention (tools/bench_trend.trend), applied to
        the rolling windows instead of checked-in rounds."""
        if not base:
            return 0.0
        return ((base - post) if lower_better else (post - base)) \
            / abs(base) * 100.0

    def _judge(self, base: dict, post: dict) -> tuple[bool, dict]:
        d_p99 = self._delta_pct(base["p99_ms"], post["p99_ms"],
                                lower_is_better("tuner_p99_ms"))
        d_mbps = self._delta_pct(base["mbps"], post["mbps"],
                                 lower_is_better("tuner_MBps"))
        thr = self.threshold_pct
        # a regression is a worsened metric the OTHER metric did not
        # pay for: p99 up without a throughput win, or throughput
        # down without a latency win
        regressed = (d_p99 < -thr and d_mbps < thr) or \
            (d_mbps < -thr and d_p99 < thr)
        return regressed, {"d_p99_pct": round(d_p99, 1),
                           "d_mbps_pct": round(d_mbps, 1),
                           "base": base, "post": post}

    # -- decision recording --------------------------------------------
    def _decide(self, kind: str, **fields) -> dict:
        self._seq += 1
        rec = {"seq": self._seq, "kind": kind,
               "t": round(self._clock(), 3),
               "ts": round(self._wall(), 3), **fields}
        rec["trace_id"] = self._trace(rec)
        with self._lock:
            self.history.append(rec)
        log(1, f"tuner {kind}: " + ", ".join(
            f"{k}={rec[k]}" for k in ("knob", "from", "to", "rule")
            if k in rec))
        return rec

    def _trace(self, rec: dict) -> str:
        """Every decision is a traced event: a force-kept root span
        the mgr trace module archives next to the data-path traces
        (the acceptance chain: revert -> tuner history -> trace
        archive -> health bundle)."""
        span = tracer().new_trace(
            f"tuner_{rec['kind']}", "mgr", op_type="tuner")
        brief = {k: rec[k] for k in
                 ("knob", "from", "to", "rule", "why", "judge")
                 if k in rec}
        span.event(f"{rec['kind']} {brief}")
        span.force_keep()
        span.finish()
        return span.trace_id

    # -- the loop ------------------------------------------------------
    def tick(self) -> list[dict]:
        now = self._clock()
        snap = self._preprocess(self._sensors.sample(), now)
        self._samples.append((now, snap))
        self._count("tuner_ticks")
        decisions: list[dict] = []
        self._judge_pending(now, decisions)
        if self._weighting:
            self._update_weights(snap, decisions)
        if self._pending is None and \
                now - self._last_action_t >= self.cooldown_s:
            self._maybe_step(snap, now, decisions)
        self._publish_knob_gauges()
        return decisions

    def _preprocess(self, snap: dict, now: float) -> dict:
        out = {k: snap.get(k, 0) for k in SENSOR_KEYS}
        out["slot_staged"] = dict(snap.get("slot_staged") or {})
        limit = out["hbm_limit"] or 0
        out["hbm_frac"] = (out["hbm_live"] / limit) if limit > 0 \
            else 0.0
        prior = [s for t, s in self._samples]
        out["p99_ref"] = self._median_of(
            [(0, s) for s in prior[-self.baseline_window:]],
            "p99_ms")
        faults = out["fault_events"]
        out["fault_delta"] = 0 if self._last_faults is None \
            else max(0, faults - self._last_faults)
        self._last_faults = faults
        return out

    def _judge_pending(self, now: float, decisions: list) -> None:
        pending = self._pending
        if pending is None or now - pending["t"] < self.cooldown_s:
            return
        post_samples = self._since(pending["t"])
        if not post_samples:
            return                 # nothing observed yet; next tick
        post = self._objective(post_samples)
        regressed, judge = self._judge(pending["baseline"], post)
        with self._lock:
            self._pending = None
        self._last_action_t = now
        knob = self.knobs.get(pending["knob"])
        if regressed:
            applied, _ = self.knobs.push(
                knob.name, pending["from"], self.conf)
            # a reverted knob is quarantined for 4 cool-downs, and
            # every CONSECUTIVE revert of the same (knob, rule) probe
            # doubles it (capped at 64x) — the flap damper
            key = (knob.name, pending["rule"])
            n = self._revert_counts.get(key, 0) + 1
            self._revert_counts[key] = n
            burn = 4 * self.cooldown_s * min(64, 2 ** (n - 1))
            with self._lock:       # status() iterates _burned
                self._burned[knob.name] = now + burn
            self._count("tuner_reverts")
            decisions.append(self._decide(
                "revert", knob=knob.name, rule=pending["rule"],
                why="regression vs rolling baseline",
                judge=judge, to=applied
                , **{"from": pending["to"]}))
        else:
            # an accepted step clears the probe's revert streak: the
            # workload changed its answer, so the backoff resets
            self._revert_counts.pop((knob.name, pending["rule"]),
                                    None)
            self._count("tuner_confirms")
            decisions.append(self._decide(
                "confirm", knob=knob.name, rule=pending["rule"],
                why="step held: no regression in the judgment window",
                judge=judge, to=pending["to"],
                **{"from": pending["from"]}))

    def _maybe_step(self, snap: dict, now: float,
                    decisions: list) -> None:
        for rule in self.rules:
            try:
                fired = bool(rule.when(snap, self))
            except Exception as exc:
                log(5, f"tuner rule {rule.name} failed: {exc!r}")
                fired = False
            streak = self._rule_streak.get(rule.name, 0) + 1 \
                if fired else 0
            self._rule_streak[rule.name] = streak
            if not fired or streak < self.hysteresis_ticks:
                continue
            if self._burned.get(rule.knob, -1e18) > now:
                continue
            knob = self.knobs.get(rule.knob)
            cur = self.conf.get(knob.name)
            new = knob.stepped(cur, rule.direction, self.conf)
            if new == cur:
                self._count("tuner_clamped")
                with self._lock:
                    self._burned[knob.name] = now + self.cooldown_s
                continue
            applied, landed = self.knobs.push(knob.name, new,
                                              self.conf)
            if not landed:
                self._count("tuner_pinned_skips")
                with self._lock:
                    self._burned[knob.name] = \
                        now + 4 * self.cooldown_s
                continue
            self._count("tuner_steps")
            self._rule_streak[rule.name] = 0
            self._last_action_t = now
            with self._lock:
                self._pending = {"knob": knob.name, "from": cur,
                                 "to": applied, "rule": rule.name,
                                 "t": now,
                                 "baseline": self._baseline()}
            decisions.append(self._decide(
                "step", knob=knob.name, rule=rule.name,
                why=rule.why, to=applied, direction=rule.direction,
                **{"from": cur}))
            return                 # one actuation in flight at a time

    # -- placement weighting -----------------------------------------
    def _update_weights(self, snap: dict, decisions: list) -> None:
        slots = int(snap.get("mesh_slots") or 0)
        staged = snap.get("slot_staged") or {}
        total = sum(max(0, staged.get(s, 0)) for s in range(slots))
        imbalanced = False
        if slots > 1 and total > 0:
            max_share = max(staged.get(s, 0) for s in
                            range(slots)) / total
            # 2x the uniform share, capped at 0.75 so the bar stays
            # reachable on small slot counts (2 slots: 2/slots = 1.0
            # could never fire)
            imbalanced = max_share >= min(0.75, 2.0 / slots)
        if not imbalanced:
            if self._published_weights is not None:
                placement.set_slot_weights(None)
                self._published_weights = None
                self._count("tuner_weight_updates")
                decisions.append(self._decide(
                    "weights", why="slot load rebalanced: back to "
                    "hash-uniform placement", to=None))
            return
        # weight inversely to load share, bounded to a 1:~5 spread so
        # a hot slot is de-preferred for NEW pgids, never excluded
        target = {}
        for s in range(slots):
            share = staged.get(s, 0) / total
            target[s] = round(1.0 / (0.25 + share), 4)
        prev = self._published_weights
        if prev is not None:
            drift = max(abs(target[s] - prev.get(s, 1.0)) /
                        max(prev.get(s, 1.0), 1e-6)
                        for s in target)
            if drift < 0.25:
                return             # materially unchanged: hold
        placement.set_slot_weights(target)
        self._published_weights = dict(target)
        self._count("tuner_weight_updates")
        decisions.append(self._decide(
            "weights", why="per-slot staged-byte imbalance: "
            "load-aware PG->slot weighting",
            to=dict(target)))

    # -- views / lifecycle ---------------------------------------------
    def status(self) -> dict:
        with self._lock:
            pending = dict(self._pending) if self._pending else None
            n = len(self.history)
            burned = dict(self._burned)
        return {"enabled": True,
                "knobs": self.knobs.vector_detail(self.conf),
                "pending": pending,
                "burned": {k: round(t, 3)
                           for k, t in burned.items()
                           if t > self._clock()},
                "decisions": n,
                "weights": self._published_weights,
                "params": {
                    "cooldown_s": self.cooldown_s,
                    "threshold_pct": self.threshold_pct,
                    "hysteresis_ticks": self.hysteresis_ticks,
                    "baseline_window": self.baseline_window},
                "counters": self.perf.dump()
                if self.perf is not None else {}}

    def history_dump(self, limit: int | None = None) -> list[dict]:
        with self._lock:
            out = list(self.history)
        return out[-limit:] if limit else out

    def shutdown(self) -> None:
        """Release the actuators this engine holds: placement weights
        clear back to hash-uniform (the fallback contract). Knob
        VALUES are deliberately left as-is — they are in-bounds by
        construction, and yanking them mid-flight would be a step
        nobody judged."""
        if self._published_weights is not None:
            placement.set_slot_weights(None)
            self._published_weights = None
        self._count_gauge("tuner_active", 0)


# ---------------------------------------------------------------------------
# process-wide surface (health bundle / autopsy / gap_report hooks)
# ---------------------------------------------------------------------------

_active_lock = threading.Lock()
_active: TunerEngine | None = None


def _set_active(engine: TunerEngine | None) -> None:
    global _active
    with _active_lock:
        _active = engine


def active_tuner() -> TunerEngine | None:
    with _active_lock:
        return _active


def status_if_active() -> dict | None:
    """Bundle/autopsy hook: the tuner section when a tuner is live,
    None otherwise — probing must not instantiate anything (the
    off = zero-cost contract)."""
    eng = active_tuner()
    if eng is None:
        return None
    return {"status": eng.status(),
            "history": eng.history_dump(limit=32)}


def decisions_tail_if_active(limit: int = 8) -> list[dict] | None:
    eng = active_tuner()
    if eng is None:
        return None
    return eng.history_dump(limit=limit)


# ---------------------------------------------------------------------------
# the mgr module
# ---------------------------------------------------------------------------

class Module(MgrModule):
    NAME = "tuner"

    COMMANDS = ("status", "history", "knobs")

    def __init__(self, mgr) -> None:
        super().__init__(mgr)
        if not tuner_on():
            # the literal-NOOP contract: no engine, no counters
            # registry, no knob writes, and TICK_PERIOD 0 means the
            # mgr tick loop never calls us
            self.engine = None
            self.TICK_PERIOD = 0.0
            return
        self.TICK_PERIOD = g_conf()["tuner_tick_period"]
        health_mod = mgr.modules.get("health")
        health_source = (lambda: health_mod.engine.status) \
            if health_mod is not None else None
        self.engine = TunerEngine(LiveSensors(health_source))
        _set_active(self.engine)
        log(1, "tuner up: knobs "
            + ", ".join(self.engine.knobs.names()))

    def tick(self) -> None:
        if self.engine is not None:
            self.engine.tick()

    def shutdown(self) -> None:
        if self.engine is not None:
            self.engine.shutdown()
            if active_tuner() is self.engine:
                _set_active(None)
            self.engine = None

    def handle_command(self, cmd: dict) -> tuple[int, str, bytes]:
        import json
        sub = cmd.get("prefix", "status")
        if self.engine is None:
            if sub in ("status", "history", "knobs"):
                return 0, "tuner disabled", json.dumps(
                    {"enabled": False}).encode()
            return super().handle_command(cmd)
        if sub == "status":
            return 0, "", json.dumps(self.engine.status(),
                                     default=str).encode()
        if sub == "history":
            limit = cmd.get("limit")
            return 0, "", json.dumps(
                self.engine.history_dump(
                    int(limit) if limit else None),
                default=str).encode()
        if sub == "knobs":
            return 0, "", json.dumps(
                self.engine.knobs.vector_detail(self.engine.conf),
                default=str).encode()
        return super().handle_command(cmd)
