"""Shared device-resident measurement machinery — port of
``ceph_tpu/bench/measure.py``.

One launch timed by the host clock is wrong in both directions (launch
cost, a busy host, a card shared with other work), so the harnesses
measure the same way: a chain of ``step_fn`` calls with a real data
dependency between them, timed at two chain lengths; the slope between
them cancels the fixed costs. Slopes are collected across rounds and any
that implies more memory traffic than the device can move is discarded
as noise.

Here a chain is ``iters`` calls of ``step_fn`` queued on the current CUDA
stream, each consuming the last one's output, timed between two CUDA
events (on the CPU, the plain versions timed by the host clock). A step's
host launch cost is part of its slope: nothing fuses the calls. The noise
guard's ceiling is the card's memory rate (``ops/cost_model.hbm_rate``),
or the CPU peak of ``ops/cost_model.CPU_PEAKS`` for a CPU tensor.

The last-good file (:func:`load_last_good`, :func:`save_last_good`) lives
under ``build/`` and holds only what this machine measured: no figure is
shipped with the code.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import torch

from ceph_tpu_torch.ops import cost_model

#: per-metric last-good GB/s, persisted across runs so a later run can
#: tell a kernel regression from a fully contended window (the
#: contended-plateau guard in :func:`stable_best_slope`); gitignored
LAST_GOOD_PATH = str(Path(__file__).resolve().parents[2] / "build" /
                     "bench" / "last_good.json")


def load_last_good() -> dict:
    try:
        with open(LAST_GOOD_PATH) as f:
            return json.load(f)
    except Exception:
        return {}


def save_last_good(updates: dict) -> None:
    """Merge per-metric GB/s into the persisted last-good file.

    Callers record only clean (not contended) plateaus, and the merge
    ratchets up: contention only ever lowers a clean-looking plateau, so
    the best value seen is the physical expectation. Best-effort: a
    read-only checkout must not fail the bench.
    """
    try:
        cur = load_last_good()
        for k, v in updates.items():
            cur[k] = max(v, cur.get(k, 0.0))
        os.makedirs(os.path.dirname(LAST_GOOD_PATH), exist_ok=True)
        tmp = LAST_GOOD_PATH + ".tmp"
        with open(tmp, "w") as f:
            json.dump(cur, f, indent=1, sort_keys=True)
        os.replace(tmp, LAST_GOOD_PATH)
    except Exception:
        pass


def ceiling_bytes_per_s(x: torch.Tensor) -> float:
    """The noise guard's memory rate for work on ``x``'s device."""
    if x.is_cuda:
        return cost_model.hbm_rate()[0]
    return cost_model.CPU_PEAKS[0] * 1e9


def _plus_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` on a uint32 tensor, wrapping (torch has no uint32 add:
    the same bits through an int32 view)."""
    return (x.view(torch.int32) + 1).view(torch.uint32)


def hbm_probe_gbps(nbytes: int = 64 << 20, budget: float = 25.0,
                   device="cuda") -> float:
    """Independent health probe: a plain elementwise ``+1`` pass over a
    resident ``nbytes`` uint32 tensor (read and written: 2x the bytes a
    step), measured by the same chained slope with a small budget. Being
    a different program from the kernels, it tells "the card is busy"
    from "our kernel broke". Modelled on the reference benchmark shipping
    its own validity recipe (ceph_erasure_code_benchmark.cc:343-356)."""
    x0 = torch.zeros(nbytes // 4, dtype=torch.uint32,
                     device=torch.device(device))
    slope, _, _, _ = stable_best_slope(
        _plus_one, x0, min_traffic_bytes=2 * nbytes, counts=(8, 40),
        time_budget=budget, stable_n=3, sleep=0.2)
    return 2 * nbytes / slope / 1e9


def _chain_seconds(step_fn, x0, iters: int):
    """Seconds for ``iters`` chained calls of ``step_fn`` from ``x0``."""
    x = x0
    if not x0.is_cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            x = step_fn(x)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        x = step_fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _slope(step_fn, x0, counts: tuple[int, int]) -> tuple[float, dict]:
    """One slope (the best of two chains at each count, differenced) and
    the chain times it came from."""
    times = {iters: min(_chain_seconds(step_fn, x0, iters)
                        for _ in range(2)) for iters in counts}
    return ((times[counts[1]] - times[counts[0]]) /
            (counts[1] - counts[0]), times)


def chained_slope(step_fn, x0, *, min_traffic_bytes: int,
                  counts: tuple[int, int] = (5, 25), rounds: int = 12,
                  sleep: float = 1.0) -> float:
    """Seconds per call of ``step_fn`` (device-resident), the best of
    ``rounds`` slopes.

    ``step_fn(x) -> x'`` must carry a data dependency through its return
    value. ``min_traffic_bytes``: the least memory traffic one call can
    move; slopes implying more than the device's rate for it are noise.
    """
    _chain_seconds(step_fn, x0, 2)                     # warm-up
    min_slope = min_traffic_bytes / ceiling_bytes_per_s(x0)
    slopes = []
    times: dict = {}
    for _ in range(rounds):
        s, times = _slope(step_fn, x0, counts)
        if s >= min_slope:
            slopes.append(s)
        time.sleep(sleep)                # spread contention windows
    if not slopes:                       # all noise-dominated: honest
        slopes = [times[counts[1]] / counts[1]]
    return min(slopes)


def stable_best_slope(step_fn, x0, *, min_traffic_bytes: int,
                      counts: tuple[int, int] = (5, 25),
                      time_budget: float = 240.0, stable_n: int = 5,
                      stable_tol: float = 0.10, sleep: float = 0.5,
                      expect_slope: float | None = None,
                      contended_factor: float = 3.0,
                      extended_budget: float = 480.0,
                      deadline: float | None = None,
                      label: str | None = None,
                      settle_s: float = 20.0,
                      ) -> tuple[float, float, int, bool]:
    """Adaptive best-slope estimator for a shared device.

    Samples chained slopes until ``stable_n`` of them agree with the best
    within ``stable_tol`` (the uncontended plateau: contention only ever
    makes slopes worse, so the guarded best is the physical number),
    after at least ``settle_s`` seconds of sampling, or until
    ``time_budget`` runs out; at least one round always runs.

    ``expect_slope`` (the last-good slope of this metric, when known): a
    plateau more than ``contended_factor`` slower than it is contention
    evidence, not signal. Sampling then extends by up to
    ``extended_budget`` seconds with growing sleeps between rounds,
    hunting for a gap in the contention; if that also runs out slow, the
    plateau is returned with ``contended=True``, never as a silent
    collapse.

    ``deadline``: an absolute ``time.perf_counter()`` value past which
    sampling stops whatever else holds (a harness gives every metric the
    same deadline so the whole run is bounded).

    ``label`` names the warm-up in the device telemetry as
    ``bench[label]`` (``utils/device_telemetry.note_compile``).

    Returns (best slope s, spread % of the plateau around its median,
    slopes kept, contended).
    """
    t_warm = time.perf_counter()
    _chain_seconds(step_fn, x0, 2)                     # warm-up
    if label is not None:
        try:
            from ceph_tpu_torch.utils.device_telemetry import telemetry
            telemetry().note_compile(f"bench[{label}]",
                                     time.perf_counter() - t_warm)
        except Exception:
            pass                         # accounting never costs data
    min_slope = min_traffic_bytes / ceiling_bytes_per_s(x0)
    t_start = time.perf_counter()
    hard_deadline = t_start + time_budget + (
        extended_budget if expect_slope is not None else 0.0)
    if deadline is not None:
        hard_deadline = min(hard_deadline, deadline)
        time_budget = min(time_budget, max(deadline - t_start, 0.0))
    cur_sleep = sleep
    slopes: list[float] = []
    times: dict[int, float] = {}
    first = True

    def looks_contended(best: float) -> bool:
        return (expect_slope is not None
                and best > expect_slope * contended_factor)

    def clean_plateau() -> bool:
        # a clean result needs both: the best within the expectation and
        # >= stable_n agreeing samples (one fast outlier past the base
        # budget must not end the extension)
        if not slopes:
            return False
        best = min(slopes)
        if looks_contended(best):
            return False
        plateau = [x for x in slopes if x <= best * (1 + stable_tol)]
        return len(plateau) >= stable_n

    while first or time.perf_counter() - t_start < time_budget or \
            (expect_slope is not None and not clean_plateau()
             and time.perf_counter() < hard_deadline):
        first = False
        s, times = _slope(step_fn, x0, counts)
        if s >= min_slope:               # physically possible only
            slopes.append(s)
            best = min(slopes)
            plateau = [x for x in slopes if x <= best * (1 + stable_tol)]
            if len(plateau) >= stable_n and \
                    time.perf_counter() - t_start > settle_s:
                if not looks_contended(best):
                    break
                # a tight plateau far slower than the last-good slope:
                # the whole window is contended and the low plateau
                # confirms itself; hunt for a gap with longer sleeps
                cur_sleep = min(max(cur_sleep * 1.5, 2.0), 8.0)
        time.sleep(cur_sleep)
    if not slopes:
        return times[counts[1]] / counts[1], 100.0, 0, True
    best = min(slopes)
    plateau = sorted(x for x in slopes if x <= best * (1 + stable_tol))
    med = plateau[len(plateau) // 2]
    spread = 100.0 * (max(plateau) - min(plateau)) / med
    return best, round(spread, 1), len(slopes), looks_contended(best)
