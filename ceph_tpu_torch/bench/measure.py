"""Chained-slope timing on the card — the part of
``ceph_tpu/bench/measure.py`` that ``bench/engine_loop.py`` needs: a
CUDA-event form of ``stable_best_slope``.

The reference runs a kernel inside a jitted ``fori_loop`` with a real data
dependency between iterations, takes the slope between two iteration
counts (fixed launch and fetch costs cancel), collects slopes until enough
agree, and discards any that would move more bytes than the device can.
Here the chain is ``iters`` calls of ``step_fn`` queued on the current
CUDA stream, each consuming the last one's output, timed between two CUDA
events (on the CPU, the plain versions timed by the host clock). A step's
host launch cost is part of its slope: nothing fuses the calls. The
reference's last-good file and HBM probe are not ported.
"""

from __future__ import annotations

import time

import torch

#: one H100 SXM's published device-memory rate: a slope implying more
#: traffic than this is noise, not signal
HBM_BYTES_PER_S = 3.35e12


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


def _slope(step_fn, x0, counts: tuple[int, int]) -> float:
    """One slope: the best of two chains at each count, differenced."""
    times = {iters: min(_chain_seconds(step_fn, x0, iters)
                        for _ in range(2)) for iters in counts}
    return (times[counts[1]] - times[counts[0]]) / (counts[1] - counts[0])


def stable_best_slope(step_fn, x0, *, min_traffic_bytes: int,
                      counts: tuple[int, int] = (5, 25),
                      time_budget: float = 60.0, stable_n: int = 5,
                      stable_tol: float = 0.10
                      ) -> tuple[float, float, int, bool]:
    """Sample slopes until ``stable_n`` agree with the best within
    ``stable_tol`` or ``time_budget`` seconds pass (at least one round).
    Returns (best slope s, spread % of the agreeing slopes around their
    median, slopes kept, contended); ``contended`` is True only when no
    slope passed the traffic guard (the reference also flags a plateau far
    slower than its last-good file, which the port does not keep)."""
    _chain_seconds(step_fn, x0, 2)                     # warm-up
    min_slope = min_traffic_bytes / HBM_BYTES_PER_S
    slopes: list[float] = []
    t_start = time.perf_counter()
    while True:
        s = _slope(step_fn, x0, counts)
        if s >= min_slope:
            slopes.append(s)
            best = min(slopes)
            if len([x for x in slopes if x <= best * (1 + stable_tol)]) \
                    >= stable_n:
                break
        if time.perf_counter() - t_start >= time_budget:
            break
    if not slopes:
        return (_chain_seconds(step_fn, x0, counts[1]) / counts[1], 100.0,
                0, True)
    best = min(slopes)
    plateau = sorted(x for x in slopes if x <= best * (1 + stable_tol))
    med = plateau[len(plateau) // 2]
    spread = 100.0 * (max(plateau) - min(plateau)) / med
    return best, round(spread, 1), len(slopes), False
