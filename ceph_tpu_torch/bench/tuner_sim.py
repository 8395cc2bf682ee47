"""tuner_sim — the deterministic plant the tuner scenario runs on.

The acceptance bar is a CONTROLLER property: under a
load_gen-shaped phase shift (read-heavy -> write-burst -> degraded)
the tuned cluster must beat every fixed-knob configuration in the
comparison set on p99 at equal-or-better throughput, deterministic
enough to pin in a CPU test on one core. A live MiniCluster cannot
give that determinism (wall-clock noise swamps 2x knob effects in a
2-second CI window), so the scenario closes the loop against this
PLANT: a stylized, seeded model of the engine's measured cost shape
whose sensors speak the exact dialect the tuner's rules read.

The plant is honest about what it is — a model, not the engine — but
its shape is the repo's measured one (BASELINE.md "Bulk ingest" /
"Pipelined engine"):

- each phase has a distinct optimal (window, flush_bytes) point:
  read-heavy wants small batches (batching latency dominates, ~5 ms
  fixed dispatch is amortized by nothing), write-burst wants deep
  window + big batches (dispatch amortization and overlap), degraded
  tightens the HBM envelope (recovery holds buffers), so window x
  flush_bytes working sets that were fine now blow the limit — no
  fixed vector is good everywhere, which is ROADMAP item 5's whole
  premise (and the all-flash-array study's, arxiv 1906.08602);
- p99 grows with the log-distance of flush_bytes and the linear
  distance of window from the phase optimum; throughput shrinks the
  same way; busting the HBM limit triples p99 and halves throughput
  (the real engine stalls in _wait_window);
- jitter is a deterministic hash of (seed, tick) — same seed, same
  run, bit-exact (the faults-registry convention).

The tuned run drives the REAL control loop (mgr/tuner.TunerEngine on
a private ConfigProxy, scripted clock) — sensors from the plant,
knob pushes back into the plant. Fixed runs hold a vector. The
comparison set contains each phase's own optimum, so "tuned beats
every fixed config" cannot be won by a lucky static choice.

CLI: ``python -m ceph_tpu_torch.bench.tuner_sim [--seed 7]`` (also the
``tools/bench_trend.py --tuned-vs-fixed`` payload).
"""

from __future__ import annotations

import argparse
import json
import math

from ceph_tpu_torch.utils.config import SCHEMA, ConfigProxy

MIB = 1 << 20

#: the canonical load_gen-shaped phase ladder
PHASES = ("read_heavy", "write_burst", "degraded")

#: per-phase plant parameters: offered load, the knob optimum, the
#: HBM envelope, health state and the base (optimally-tuned) p99
PHASE_PARAMS = {
    "read_heavy": {
        "offered_mbps": 60.0, "opt_window": 2, "opt_fb": 2 * MIB,
        "hbm_limit": 1 << 30, "health_rank": 0, "base_p99_ms": 5.0},
    "write_burst": {
        "offered_mbps": 800.0, "opt_window": 8, "opt_fb": 64 * MIB,
        "hbm_limit": 1 << 30, "health_rank": 0, "base_p99_ms": 8.0},
    "degraded": {
        "offered_mbps": 200.0, "opt_window": 3, "opt_fb": 8 * MIB,
        "hbm_limit": 256 * MIB, "health_rank": 1,
        "base_p99_ms": 12.0},
}

#: the fixed-knob comparison set: the shipped default plus each
#: phase's own optimum held for the whole run
FIXED_CONFIGS = {
    "default": {"engine_window": 3, "engine_flush_bytes": 64 * MIB},
    "read_opt": {"engine_window": 2, "engine_flush_bytes": 2 * MIB},
    "burst_opt": {"engine_window": 8, "engine_flush_bytes": 64 * MIB},
    "degraded_opt": {"engine_window": 3,
                     "engine_flush_bytes": 8 * MIB},
}


def _jitter(seed: int, tick: int, tag: int) -> float:
    """Deterministic uniform in [0, 1) — the faults-registry mixer
    shape, dependency-free."""
    x = (seed * 0x9E3779B1 + tick * 0x85EBCA6B + tag * 0xC2B2AE35) \
        & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x45D9F3B) & 0xFFFFFFFF
    x ^= x >> 16
    return x / 4294967296.0


def plant(phase: str, knobs: dict, seed: int, tick: int,
          fault_events: int) -> dict:
    """One plant evaluation: (phase, knob vector) -> the sensor
    snapshot the tuner reads, including the objective (p99_ms, mbps)
    the comparison scores."""
    p = PHASE_PARAMS[phase]
    w = max(1, int(knobs["engine_window"]))
    fb = max(1, int(knobs["engine_flush_bytes"]))
    fb_dist = abs(math.log2(fb / p["opt_fb"]))
    w_dist = abs(w - p["opt_window"])
    p99 = p["base_p99_ms"] * (1.0 + 0.35 * fb_dist + 0.25 * w_dist)
    mbps = p["offered_mbps"] / (1.0 + 0.15 * fb_dist
                                + 0.10 * w_dist)
    # the HBM envelope: staged + in-window working set is window x
    # flush_bytes on both sides of the launch gate
    hbm_live = 2 * w * fb
    if hbm_live > p["hbm_limit"]:
        p99 *= 3.0
        mbps *= 0.5
    # deterministic +-2% jitter: enough to be non-degenerate, far
    # below the >=10% revert threshold
    p99 *= 1.0 + 0.02 * (2 * _jitter(seed, tick, 1) - 1)
    mbps *= 1.0 + 0.02 * (2 * _jitter(seed, tick, 2) - 1)
    # sensors, in the rules' dialect: a too-shallow window reads as
    # saturation, a too-small flush cap reads as high occupancy, a
    # too-big one as near-empty flushes under a mean far below cap
    occupancy = 6.0 * p["opt_fb"] / fb
    flush_bytes_mean = min(fb, int(p["offered_mbps"] * 1e6 * 0.02))
    return {
        "p99_ms": round(p99, 4),
        "mbps": round(mbps, 4),
        "hbm_live": hbm_live,
        "hbm_limit": p["hbm_limit"],
        "inflight": w if w < p["opt_window"] else max(1, w - 1),
        "window": w,
        "occupancy": round(occupancy, 3),
        "flush_bytes_mean": flush_bytes_mean,
        "health_rank": p["health_rank"],
        "fault_events": fault_events,
        "mesh_slots": 0,
        "slot_staged": {},
    }


class PlantSensors:
    """Closes the loop: each sample reads the CURRENT knob vector
    from the run's private config — the tuner's pushes change what
    the next sample sees."""

    def __init__(self, conf: ConfigProxy, seed: int) -> None:
        self.conf = conf
        self.seed = seed
        self.phase = PHASES[0]
        self.tick = 0
        self.fault_events = 0
        self._last: dict = {}

    def sample(self) -> dict:
        self.tick += 1
        self._last = plant(
            self.phase,
            {"engine_window": self.conf["engine_window"],
             "engine_flush_bytes": self.conf["engine_flush_bytes"]},
            self.seed, self.tick, self.fault_events)
        return self._last


def _phase_scores(series: list[tuple[str, dict]]) -> dict:
    """Per-phase median p99 / mean MBps (median p99 so phase-entry
    transients — the tuner converging — are scored, not dominant).
    ``served_frac`` is MBps over the phase's offered load: the
    demand-normalized throughput the cross-phase aggregate uses,
    because a raw MB/s mean over phases whose offered loads differ
    13x is just a measure of the biggest phase."""
    out = {}
    for phase in PHASES:
        rows = [s for ph, s in series if ph == phase]
        p99s = sorted(r["p99_ms"] for r in rows)
        mbps = sum(r["mbps"] for r in rows) / len(rows)
        out[phase] = {
            "p99_ms": round(p99s[len(p99s) // 2], 3),
            "MBps": round(mbps, 3),
            "served_frac": round(
                mbps / PHASE_PARAMS[phase]["offered_mbps"], 4)}
    return out


def run_sim(seed: int = 7, ticks_per_phase: int = 80,
            fixed: dict | None = None) -> dict:
    """One full phase-ladder run. ``fixed`` holds a knob vector for
    the whole run (no controller); None runs the real TunerEngine on
    a scripted clock."""
    from ceph_tpu_torch.mgr.tuner import TunerEngine
    conf = ConfigProxy(SCHEMA)
    # sim pacing: 1 s scripted ticks against a 1 s cool-down and
    # 1-tick hysteresis — every step is judged on the next sample,
    # so convergence (~10 steps) fits well inside one phase and the
    # phase median scores the converged regime, transient included
    conf.set("tuner_cooldown_s", 1.0)
    conf.set("tuner_hysteresis_ticks", 1)
    if fixed:
        for name, value in fixed.items():
            conf.set(name, value)
    sensors = PlantSensors(conf, seed)
    clock = [0.0]
    engine = None
    if fixed is None:
        engine = TunerEngine(sensors, conf=conf,
                             clock=lambda: clock[0],
                             wall=lambda: clock[0],
                             publish_perf=False)
    series: list[tuple[str, dict]] = []
    decisions: list[dict] = []
    for phase in PHASES:
        sensors.phase = phase
        if phase == "degraded":
            sensors.fault_events += 1     # the fault that degraded us
        for _ in range(ticks_per_phase):
            clock[0] += 1.0
            if engine is not None:
                decisions.extend(engine.tick())
                series.append((phase, sensors._last))
            else:
                series.append((phase, sensors.sample()))
    out = {"seed": seed, "ticks_per_phase": ticks_per_phase,
           "phases": _phase_scores(series),
           "knobs_final": {
               "engine_window": conf["engine_window"],
               "engine_flush_bytes": conf["engine_flush_bytes"]}}
    if engine is not None:
        out["decisions"] = len(decisions)
        out["decision_kinds"] = sorted(
            {d["kind"] for d in decisions})
        out["history"] = engine.history_dump()
    return out


def comparison(seed: int = 7, ticks_per_phase: int = 80) -> dict:
    """The acceptance table: the tuned run vs every fixed vector.
    Verdict per fixed config: tuned wins when its worst-phase p99 is
    lower AND its run-wide mean throughput is equal-or-better (>=
    98%, the 'equal' allowance)."""
    tuned = run_sim(seed, ticks_per_phase, fixed=None)
    tuned.pop("history", None)
    rows = {"tuned": tuned}
    verdicts = {}

    def _agg(run):
        return (max(v["p99_ms"] for v in run["phases"].values()),
                sum(v["served_frac"]
                    for v in run["phases"].values()) / len(PHASES))

    t_worst, t_served = _agg(tuned)
    for name, vec in FIXED_CONFIGS.items():
        run = run_sim(seed, ticks_per_phase, fixed=vec)
        rows[name] = run
        f_worst, f_served = _agg(run)
        verdicts[name] = {
            "fixed_worst_p99_ms": round(f_worst, 3),
            "tuned_worst_p99_ms": round(t_worst, 3),
            "fixed_served_frac": round(f_served, 4),
            "tuned_served_frac": round(t_served, 4),
            "tuned_wins": bool(t_worst < f_worst
                               and t_served >= 0.98 * f_served)}
    return {"seed": seed, "runs": rows, "verdicts": verdicts,
            "tuned_beats_all": all(v["tuned_wins"]
                                   for v in verdicts.values())}


def render(report: dict) -> str:
    lines = [f"tuner_sim comparison (seed {report['seed']}): tuned "
             "control loop vs fixed knob vectors", ""]
    for name, run in report["runs"].items():
        ph = "  ".join(
            f"{p}: p99 {v['p99_ms']}ms / {v['MBps']} MB/s"
            for p, v in run["phases"].items())
        lines.append(f"  {name:<14}{ph}")
    lines.append("")
    for name, v in report["verdicts"].items():
        tag = "tuned WINS" if v["tuned_wins"] else "tuned loses"
        lines.append(
            f"  vs {name:<14} worst-p99 {v['tuned_worst_p99_ms']} "
            f"vs {v['fixed_worst_p99_ms']} ms, served "
            f"{v['tuned_served_frac']} vs {v['fixed_served_frac']}"
            f"  [{tag}]")
    lines.append("")
    lines.append("tuned beats all fixed configs: "
                 + str(report["tuned_beats_all"]))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tuner_sim")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--ticks-per-phase", type=int, default=80)
    args = ap.parse_args(argv)
    report = comparison(args.seed, args.ticks_per_phase)
    print(render(report))
    print(json.dumps({"tuner_sim": {
        "seed": report["seed"],
        "verdicts": report["verdicts"],
        "tuned_beats_all": report["tuned_beats_all"]}},
        sort_keys=True), flush=True)
    return 0 if report["tuned_beats_all"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
