"""Run one cell of the benchmark once and print its result line.

    python3 -m ecbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``ecbench/configs/<config>.json``: the
deployment's codec profile, sizes and guarantees) and a traffic mix
(``ecbench/traffic/<traffic>.json``: which operation, how large a ring of
inputs, how many calls are checked and how long a stretch is traced).
The configuration's ``plugin`` and the mix's ``op`` name the entry module
``ecbench/entries/<plugin>_<op>.py``, which builds the inputs on the card
from the seed, hands the timed calls to the port and judges sampled
outputs against the plain reference in ``ecbench/reference/``. Per-layer
metrics are read by ``ecbench/metrics/<metric>.py``, each found by its
name in ``BENCHMARK.json``.

A run: set-up (imports, the port's kernels loaded from the checkout's
build directory, inputs made, every ring slot run once) is ``setup_s``;
then calls go to the card for ``--seconds``, at most ``window`` in flight
(the next call is enqueued once the oldest call's event has completed);
then the sampled outputs are compared. With ``--trace 1`` a stretch of
calls after the window runs under ``torch.profiler`` and the per-layer
metrics are printed instead of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent

#: top-level module names that must not be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ceph_tpu")


class RunError(RuntimeError):
    """The run cannot produce a result."""


def _set_environment() -> None:
    """The deployment's defaults for every knob of the port. (The port's
    kernels are built into ``build/torch_ext/`` inside the checkout.)"""
    for name in [n for n in os.environ if n.startswith("CEPH_TPU_")]:
        print(f"ecbench: ignoring {name} (runs use the defaults)",
              file=sys.stderr)
        del os.environ[name]


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    if not path.is_file():
        raise RunError(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic mix, entry module path and
    metric lists."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    return {
        "cell": cell, "config": cfg, "traffic": traffic,
        "entry": HERE / "entries" / f"{cfg['plugin']}_{traffic['op']}.py",
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def forbidden_loaded() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


class Reservoir:
    """A uniform sample, drawn from the seed, of ``size`` calls of each
    stratum: ``stratum(slot)`` keys a call by its ring slot (one stratum
    where it is None), so that every kind of call a cell makes, such as
    each repair signature, is checked."""

    def __init__(self, size: int, seed: int, stratum=None) -> None:
        self.size = size
        self.rng = random.Random(seed * 2654435761 + 17)
        self.stratum = stratum
        self.strata: dict = {}

    def offer(self, item) -> None:
        key = None if self.stratum is None else self.stratum(item[0])
        kept, seen = self.strata.setdefault(key, ([], [0]))
        if len(kept) < self.size:
            kept.append(item)
        else:
            j = self.rng.randrange(seen[0] + 1)
            if j < self.size:
                kept[j] = item
        seen[0] += 1

    @property
    def kept(self) -> list:
        return [item for key in sorted(self.strata, key=repr)
                for item in self.strata[key][0]]


def drive(work, seconds: float, window: int, sample: Reservoir,
          sync, make_event, span=None) -> dict:
    """Calls on the ring for ``seconds`` of host time, at most ``window``
    in flight; returns calls, wall seconds and summed enqueue seconds."""
    inflight: collections.deque = collections.deque()
    enqueue = 0.0
    calls = 0
    n_slots = work.n_slots
    sync()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        if len(inflight) >= window:
            inflight.popleft().synchronize()
        slot = calls % n_slots
        a = time.perf_counter()
        if span is None:
            out = work.call(slot)
        else:
            with span("ecbench.call"):
                out = work.call(slot)
        enqueue += time.perf_counter() - a
        inflight.append(make_event())
        sample.offer((slot, out))
        calls += 1
    if span is None:
        sync()
    else:
        with span("ecbench.drain"):
            sync()
    return {"calls": calls, "wall_s": time.perf_counter() - t0,
            "enqueue_s": enqueue}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", bench: dict | None = None,
             overrides: dict | None = None, wrap=None) -> dict:
    """One run of ``workload``; returns the result line's object and the
    compared numbers. ``device``, ``overrides`` (keys laid over the
    configuration and traffic) and ``wrap`` (which may replace the timed
    call) are for the tests."""
    import torch

    from ecbench import trace as trace_mod

    phases = {"import": time.perf_counter() - t_start}

    spec = resolve(bench if bench is not None
                   else load_json(ROOT / "BENCHMARK.json"), workload)
    cfg = dict(spec["config"], **(overrides or {}).get("config", {}))
    traffic = dict(spec["traffic"], **(overrides or {}).get("traffic", {}))
    chips = int(spec["cell"]["chips"])
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    if on_cuda:
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise RunError(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell asks for {chips}")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    phases["device"] = time.perf_counter() - t_start

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    events = collections.deque()

    def make_event():
        if not on_cuda:
            return _Done()
        ev = events.popleft() if len(events) > 2 * window else \
            torch.cuda.Event()
        ev.record()
        events.append(ev)
        return ev

    window = int(cfg["window"])
    entry = load_module(spec["entry"], f"ecbench_entry_{cfg['plugin']}_"
                        f"{traffic['op']}")
    work = entry.setup(cfg, traffic, dev, seed)
    sync()
    phases["entry"] = time.perf_counter() - t_start
    if wrap is not None:
        wrap(work)
    for slot in range(work.n_slots):
        work.call(slot)
    sync()
    setup_s = time.perf_counter() - t_start
    phases["warm"] = setup_s
    for line in work.describe():
        print(f"ecbench: {line}", file=sys.stderr)
    print("ecbench: setup clock at the end of each phase (s) " +
          ", ".join(f"{k} {v:.3f}" for k, v in phases.items()),
          file=sys.stderr)

    sample = Reservoir(int(traffic["check_calls"]), seed,
                       getattr(work, "stratum", None))
    timed = drive(work, seconds, window, sample, sync, make_event)
    view = None
    if trace:
        view = _traced_stretch(work, traffic, window, sample, sync,
                               make_event, timed, trace_mod, on_cuda)
    peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    print(f"ecbench: setup_s {setup_s:.3f}; {timed['calls']} calls in "
          f"{timed['wall_s']:.4f} s; enqueue "
          f"{timed['enqueue_s'] / max(timed['calls'], 1) * 1e6:.2f} us a call",
          file=sys.stderr)
    found = forbidden_loaded()
    if found:
        raise RunError(f"forbidden modules loaded: {', '.join(found)}")

    keep = sorted({slot for slot, _out in sample.kept})
    work.release(keep)
    if on_cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    verdict = work.check(sample.kept)
    print(f"ecbench: checked {len(sample.kept)} calls in "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)

    ends = {
        work.rate_metric: timed["calls"] * work.bytes_per_call
        / timed["wall_s"] / 1e9,
        "setup_s": setup_s,
    }
    metrics = {}
    breakdown = None
    if trace:
        for m in spec["per_layer"]:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"ecbench_metric_{m['name']}")
            value = reader.read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = view.breakdown()
    else:
        for m in spec["end_to_end"]:
            if m["name"] not in ends:
                raise RunError(f"cell {workload} lists {m['name']}, which "
                               f"its entry does not measure")
            metrics[m["name"]] = {"value": ends[m["name"]], "unit": m["unit"]}

    checks = verdict["checks"]
    correct = bool(sample.kept) and all(v <= lim
                                        for v, lim in checks.values())
    device_info = {"platform": "gpu" if on_cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_cuda
                   else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak)}
    if trace:
        device_info.update(busy_s=view.busy_s(), window_s=view.window_s)
    result = {"correct": correct,
              "attempted": timed["calls"] * work.objects_per_call,
              "failed": int(verdict["failed"]),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["calls"] = timed["calls"]
    result["checked_calls"] = len(sample.kept)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    return result


class _Done:
    """The event of a call on the CPU, which is done when it returns."""

    def synchronize(self) -> None:
        return None


def _traced_stretch(work, traffic, window, sample, sync, make_event, timed,
                    trace_mod, on_cuda):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CUDA] if on_cuda else [ProfilerActivity.CPU]
    sync()
    with profile(activities=acts) as prof:
        traced = drive(work, float(traffic["trace_seconds"]), window, sample,
                       sync, make_event,
                       span=None if on_cuda else record_function)
    events = trace_mod.export_events(prof)
    enqueue_us = timed["enqueue_s"] / max(timed["calls"], 1) * 1e6
    print(f"ecbench: traced {traced['calls']} calls in "
          f"{traced['wall_s']:.4f} s", file=sys.stderr)
    return trace_mod.view_from_events(events, traced["calls"], work.yard,
                                      enqueue_us)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="ecbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _set_environment()
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start)
    except (RunError, ImportError, OSError, KeyError) as exc:
        print(f"ecbench: no result: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 2
    limit = power_limit()
    if limit:
        result["device"]["nvidia_smi"] = limit
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
