"""What a traced run reads from the port itself: the spans the port
recorded over the traced stretch (``ceph_tpu_torch/utils/tracepoints``),
laid on the trace's time axis, and the seconds of the port's own set-up
phases (``ceph_tpu_torch/utils/device_telemetry``).

The port records a span while a ``torch.profiler`` session is live in the
process, so the traced stretch's calls leave theirs in its span store. A span's host times are ``time.time_ns()`` readings, the clock of
the profiler's trace: an event at ``ts`` microseconds of the trace
happened at ``ts * 1000 + baseTimeNanoseconds``, which the port reads
once for its process (``trace_base_ns``). A device span also carries its
CUDA events' elapsed microseconds (``device_us``).

Where the port has no spans or no set-up table (a program older than
them), or dropped a span of the stretch, the helpers return None, and so
do the readers built on them: never a partial figure.
"""

from __future__ import annotations

import bisect

#: the fused flush step's root span and the children the readers sum
STEP = "ec.fused_step"
SEGMENTS = "ec.segments"
COMBINE = "ec.crc_combine"


def spans(view) -> list[dict] | None:
    """The port's span records inside ``view.window``, each with ``ts``
    and ``end`` in trace microseconds; None where the port keeps no
    spans or dropped one. Kept on ``view.extra`` for the next reader."""
    if "program_spans" not in view.extra:
        view.extra["program_spans"] = _spans_in(view.window)
    return view.extra["program_spans"]


def _spans_in(window) -> list[dict] | None:
    try:
        from ceph_tpu_torch.utils import tracepoints as tp
        dump, dropped, base_ns = (tp.dump_spans, tp.spans_dropped,
                                  tp.trace_base_ns)
    except (ImportError, AttributeError):
        return None
    if dropped():
        return None
    base = base_ns()
    out = []
    for rec in dump():
        ts = (rec["start_ns"] - base) / 1e3
        end = (rec["end_ns"] - base) / 1e3
        if ts >= window[0] and end <= window[1]:
            out.append(dict(rec, ts=ts, end=end))
    return out


def steps(view) -> list[dict] | None:
    """The root ``ec.fused_step`` spans of the stretch (None if none)."""
    recs = spans(view)
    if recs is None:
        return None
    roots = [r for r in recs if r["span"] == STEP and r["parent"] is None]
    return roots or None


def per_step(view, names, key: str) -> float | None:
    """Summed ``key`` (``device_us`` or ``host_us``) of the spans named
    in ``names`` under the stretch's fused steps, a step; None where a
    step has none of them or one lacks ``key``."""
    roots = steps(view)
    if roots is None:
        return None
    calls = {r["call"] for r in roots}
    kids = [r for r in spans(view)
            if r["span"] in names and r["call"] in calls]
    if {r["call"] for r in kids} != calls or \
            any(key not in r for r in kids):
        return None
    return sum(r[key] for r in kids) / len(roots)


def idle_in_steps_pct(view) -> float | None:
    """The share of ``view.window`` in which the card ran nothing while
    the host was inside a fused step."""
    roots = steps(view)
    if roots is None or view.window_s <= 0:
        return None
    busy = _union([(ts, ts + dur) for _n, ts, dur in view.ops])
    starts = [lo for lo, _hi in busy]
    idle = 0.0
    for r in roots:
        lo, hi = r["ts"], r["end"]
        covered = 0.0
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(busy) and busy[i][0] < hi:
            covered += max(0.0, min(hi, busy[i][1]) - max(lo, busy[i][0]))
            i += 1
        idle += (hi - lo) - covered
    return 100.0 * idle / (view.window[1] - view.window[0])


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def setup_s() -> float | None:
    """Seconds of the port's own set-up phases in this process (kernel
    library loads, Clay's calibration and encode tables); None where the
    port keeps no such table or it is empty."""
    try:
        from ceph_tpu_torch.utils.device_telemetry import telemetry
        table = telemetry().setup_seconds()
    except (ImportError, AttributeError):
        return None
    if not table:
        return None
    return sum(v["seconds"] for v in table.values())
