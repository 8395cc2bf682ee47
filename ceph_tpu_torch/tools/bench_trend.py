"""bench_trend — per-metric deltas across checked-in bench rounds.

Each bench round leaves one ``BENCH_r<NN>.json`` in the repo root: a single JSON object whose ``tail`` holds the bench run's last
stdout lines — including the one-JSON-line-per-metric records bench.py
emits (``{"metric": ..., "value": ..., "unit": ...}``) — and whose
``parsed`` duplicates the last metric line. A round that timed out
(rc=124) may carry no metrics at all; it must not crash the trend.

This tool lines the rounds up and prints, per metric: the value in
every round it appeared, the latest-vs-best delta, and a REGRESSION
flag when the latest value is >10% worse than the best earlier round
(direction-aware: throughput metrics — GBps/MBps/ops — regress down,
latency metrics — ``*_ms`` — regress up). One human table plus one
machine-readable ``{"bench_trend": ...}`` JSON line, the bench-gate
convention. Port of ``ceph_tpu/tools/bench_trend.py``; the mgr tuner
judges its steps with :func:`lower_is_better`.

``--tuned-vs-fixed`` runs the deterministic tuner
comparison instead: the closed-loop controller against every fixed
knob vector on the phase-shift plant (bench/tuner_sim), printing the
per-phase table plus one ``{"tuner_sim": ...}`` JSON line; with
``--strict`` a tuned loss exits 2 exactly like a metric regression.

CLI::

    python -m ceph_tpu_torch.tools.bench_trend [files...] \
        [--threshold 10] [--strict] [--tuned-vs-fixed [--seed N]]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


#: explicit per-metric direction pins: rows that must gate with a
#: known direction the moment numbers exist, independent of the name
#: heuristic below (the two multichip mesh rows — on a
#: single-card run they land from a host-platform subprocess, and a
#: silent direction flip would let a mesh regression pass)
DIRECTIONS = {
    "multichip_encode_GBps": "higher",
    "multichip_decode_GBps": "higher",
    "multichip_scaling": "higher",
    # commit-path rows derived from the load_gen run —
    # the name heuristic would misread both (no _ms/_GBps suffix on
    # the first; the second must gate UP when store batching lands)
    "store_fsyncs_per_op": "lower",
    "whatif_group_commit_MBps": "higher",
    # dispatch-path rows — cross-thread hops per op must
    # gate DOWN when the run-to-completion refactor lands, and the
    # RTC projection gates UP like the other what-if row
    "dispatch_hops_per_op": "lower",
    "whatif_rtc_MBps": "higher",
    # the measured crimson arm — its throughput gates UP
    # like the other MBps rows (pinned anyway: the projection-honesty
    # fields riding the line must never flip it), and its hops/op
    # gates DOWN (the run-to-completion discipline is the point)
    "crimson_load_gen_MBps": "higher",
    "dispatch_hops_per_op@crimson": "lower",
    # the planet-scale read path — aggregate hot-read GB/s
    # gates UP (any-k balanced reads are the point) and the client
    # cache-hit p99 gates DOWN (the name heuristic would catch the
    # _p99, but the row is the acceptance gate: pin it)
    "hot_object_read_GBps": "higher",
    "cache_hit_p99_us": "lower",
    # multi-tenant fairness — the row's value is the Jain
    # index over served shares under a scripted hot-tenant skew; the
    # name heuristic has no idea what a "jain" is, and the row must
    # gate DOWN-is-bad (silently starving MORE tenants shrinks it)
    "multi_tenant_fairness": "higher",
}


def lower_is_better(metric: str) -> bool:
    """Latency-flavored metrics regress UP; everything this bench
    family emits otherwise (GBps / MBps / ops counts) regresses
    DOWN. Explicit DIRECTIONS pins win over the name heuristic."""
    pin = DIRECTIONS.get(metric)
    if pin is not None:
        return pin == "lower"
    return metric.endswith("_ms") or "_p99" in metric \
        or "_p50" in metric or "latency" in metric


def parse_round(path: str) -> tuple[dict[str, float], int]:
    """One round file -> ({metric: value}, rc). Tolerates timeout
    rounds (no metrics) and garbled tails (best-effort line scan)."""
    with open(path) as f:
        doc = json.load(f)
    metrics: dict[str, float] = {}
    for line in (doc.get("tail", "") or "").splitlines():
        # a metric record is one whole JSON line (bench.py contract);
        # logging prefixes ahead of it are tolerated, nested objects
        # (telemetry/stage_breakdown) parse fine because the whole
        # remainder of the line is the document
        at = line.find('{"metric"')
        if at < 0:
            continue
        try:
            rec = json.loads(line[at:])
        except ValueError:
            continue
        name, value = rec.get("metric"), rec.get("value")
        if isinstance(name, str) and isinstance(value, (int, float)):
            metrics[name] = float(value)
    parsed = doc.get("parsed")
    if isinstance(parsed, dict):
        name, value = parsed.get("metric"), parsed.get("value")
        if isinstance(name, str) and isinstance(value, (int, float)):
            metrics.setdefault(name, float(value))
    return metrics, int(doc.get("rc", 0))


def trend(paths: list[str], threshold_pct: float = 10.0) -> dict:
    """The cross-round comparison. Returns the machine-readable
    report: per metric the per-round values, the latest-vs-best
    delta, and the regression verdict."""
    rounds = []
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        try:
            metrics, rc = parse_round(path)
        except (OSError, ValueError) as exc:
            rounds.append({"round": name, "rc": None,
                           "error": repr(exc), "metrics": {}})
            continue
        rounds.append({"round": name, "rc": rc, "metrics": metrics})
    all_metrics = sorted({m for r in rounds for m in r["metrics"]})
    table = {}
    regressions = []
    for metric in all_metrics:
        series = [(r["round"], r["metrics"][metric])
                  for r in rounds if metric in r["metrics"]]
        values = [v for _, v in series]
        latest = values[-1]
        row = {"values": {rnd: v for rnd, v in series},
               "latest": latest,
               "lower_is_better": lower_is_better(metric)}
        if len(values) >= 2:
            prior = values[:-1]
            best = min(prior) if row["lower_is_better"] \
                else max(prior)
            row["best_prior"] = best
            if best:
                # signed so a gain prints positive either direction
                delta = (best - latest) / abs(best) * 100.0 \
                    if row["lower_is_better"] \
                    else (latest - best) / abs(best) * 100.0
                row["delta_vs_best_pct"] = round(delta, 1)
                row["regressed"] = delta < -threshold_pct
                if row["regressed"]:
                    regressions.append(metric)
        table[metric] = row
    return {"rounds": [{"round": r["round"], "rc": r["rc"],
                        "metrics": len(r["metrics"])}
                       for r in rounds],
            "threshold_pct": threshold_pct,
            "metrics": table,
            "regressions": regressions}


def render(report: dict) -> str:
    """The human table."""
    lines = ["bench trend across "
             f"{len(report['rounds'])} rounds "
             f"(regression = >{report['threshold_pct']:.0f}% worse "
             "than the best earlier round)", ""]
    rounds = [r["round"] for r in report["rounds"]]
    for r in report["rounds"]:
        note = " (no metrics: rc=%s)" % r["rc"] \
            if not r["metrics"] else ""
        lines.append(f"  {r['round']}: {r['metrics']} metrics{note}")
    lines.append("")
    width = max((len(m) for m in report["metrics"]), default=10)
    for metric, row in report["metrics"].items():
        vals = " -> ".join(
            f"{row['values'][rnd]:g}" for rnd in rounds
            if rnd in row["values"])
        delta = row.get("delta_vs_best_pct")
        verdict = ""
        if delta is not None:
            arrow = "better" if delta >= 0 else "worse"
            verdict = f"  [{delta:+.1f}% {arrow} vs best prior]"
            if row.get("regressed"):
                verdict += "  REGRESSION"
        lines.append(f"  {metric:<{width}}  {vals}{verdict}")
    if report["regressions"]:
        lines.append("")
        lines.append("REGRESSED: " + ", ".join(report["regressions"]))
    return "\n".join(lines)


def default_files(root: str = ".") -> list[str]:
    return sorted(glob.glob(os.path.join(root, "BENCH_r*.json")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="compare BENCH_r*.json across rounds: per-metric "
                    "deltas with a >10%% regression flag")
    ap.add_argument("files", nargs="*",
                    help="round files, oldest first (default: "
                         "./BENCH_r*.json sorted)")
    ap.add_argument("--threshold", type=float, default=10.0,
                    help="regression threshold in percent "
                         "(default 10)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 2 when any metric regressed")
    ap.add_argument("--tuned-vs-fixed", action="store_true",
                    help="run the deterministic tuned-vs-fixed "
                         "comparison (bench/tuner_sim) instead of "
                         "the round diff")
    ap.add_argument("--seed", type=int, default=7,
                    help="plant seed for --tuned-vs-fixed")
    args = ap.parse_args(argv)
    if args.tuned_vs_fixed:
        from ceph_tpu_torch.bench import tuner_sim
        report = tuner_sim.comparison(args.seed)
        print(tuner_sim.render(report))
        print(json.dumps({"tuner_sim": {
            "seed": report["seed"],
            "verdicts": report["verdicts"],
            "tuned_beats_all": report["tuned_beats_all"]}},
            sort_keys=True))
        if args.strict and not report["tuned_beats_all"]:
            return 2
        return 0
    files = args.files or default_files()
    if len(files) < 1:
        print("no BENCH_r*.json files found", file=sys.stderr)
        return 1
    report = trend(files, args.threshold)
    print(render(report))
    print(json.dumps({"bench_trend": report}, sort_keys=True))
    if args.strict and report["regressions"]:
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
