"""What a traced run reads: the device operations of a traced stretch of
calls, from ``torch.profiler``'s trace, and the helpers the per-layer
metric readers share.

The traced stretch starts from an idle card (the calls before it have
been waited for) and ends with a synchronize, so every device operation
it holds belongs to its calls. On the card only the device's activity and
the CUDA runtime's calls are recorded, not every PyTorch operator on the
host, whose recording would slow the host's enqueue several times over
and show the card idle where an untraced run keeps it busy.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

from ecbench import yardstick

#: trace categories of work on the device
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
#: trace categories of host work a device gap can be laid to
HOST_CATS = frozenset({"cpu_op", "user_annotation", "cuda_runtime",
                       "cuda_driver"})

CALL_SPAN = "ecbench.call"
DRAIN_SPAN = "ecbench.drain"
SYNC_CALL = "cudaDeviceSynchronize"


@dataclass
class TraceView:
    """One traced stretch: ``ops`` are (name, start_us, dur_us) of device
    operations inside the window; ``host`` the host events, same form."""

    ops: list
    host: list
    window: tuple
    calls: int
    yard: dict
    enqueue_us: float | None = None
    extra: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union
        of their intervals)."""
        busy, end = 0.0, self.window[0]
        for _name, ts, dur in sorted(self.ops, key=lambda o: o[1]):
            lo, hi = max(ts, end), min(ts + dur, self.window[1])
            if hi > lo:
                busy += hi - lo
            end = max(end, ts + dur)
        return busy / 1e6

    def device_s(self, match: str | None = None) -> float:
        """Summed duration of the device operations whose name holds
        ``match`` (all with None), seconds."""
        return sum(d for n, _t, d in self.ops
                   if match is None or match in n) / 1e6

    def per_call_s(self, match: str | None = None) -> float:
        return self.device_s(match) / self.calls

    def roofline_pct(self, yard_key: str, match: str | None = None):
        """The bound of ``yard[yard_key]`` bytes a call over the measured
        device time a call of the matching operations, in percent; None
        where the stretch ran none of them or the entry states no bytes."""
        nbytes = self.yard.get(yard_key)
        t = self.per_call_s(match)
        if not nbytes or t <= 0:
            return None
        return 100.0 * yardstick.bound_s(nbytes) / t

    def breakdown(self) -> dict:
        """The ten device operations with the most summed time, and the
        device's idle gaps summed by the innermost host event open at
        each gap's start."""
        by_op: dict[str, float] = {}
        for name, _ts, dur in self.ops:
            by_op[name] = by_op.get(name, 0.0) + dur / 1e6
        gaps: dict[str, float] = {}
        end = self.window[0]
        for _name, ts, dur in sorted(self.ops, key=lambda o: o[1]) + \
                [("", self.window[1], 0.0)]:
            if ts > end:
                label = self._host_at(end)
                gaps[label] = gaps.get(label, 0.0) + (ts - end) / 1e6
            end = max(end, ts + dur)
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n[:160], s] for n, s in idle]}

    def _host_at(self, t: float) -> str:
        if "host_sorted" not in self.extra:
            hs = sorted(self.host, key=lambda h: h[1])
            self.extra["host_sorted"] = hs
            self.extra["host_ts"] = [h[1] for h in hs]
            self.extra["host_maxdur"] = max((h[2] for h in hs), default=0.0)
        hs, starts = self.extra["host_sorted"], self.extra["host_ts"]
        lo = t - self.extra["host_maxdur"]
        inner = None
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and starts[i] >= lo:
            name, ts, dur = hs[i]
            if t < ts + dur and (inner is None or dur < inner[1]):
                inner = (name, dur)
            i -= 1
        return inner[0] if inner else "host outside any traced event"


def read_chrome_trace(path: str) -> list[dict]:
    with open(path) as fh:
        data = json.load(fh)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def view_from_events(events: list[dict], calls: int, yard: dict,
                     enqueue_us: float | None) -> TraceView:
    """The window and the events inside it. The window runs from the
    first ``ecbench.call`` span to the end of the ``ecbench.drain`` span
    where the trace holds host spans; in a trace of the card alone, from
    the end of the stretch's first ``cudaDeviceSynchronize`` (the card is
    idle there) to the end of its last."""
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    starts = [float(e["ts"]) for e in spans if e["name"] == CALL_SPAN]
    drains = [float(e["ts"]) + float(e["dur"]) for e in spans
              if e["name"] == DRAIN_SPAN]
    if not starts or not drains:
        syncs = sorted(float(e["ts"]) + float(e["dur"]) for e in events
                       if e.get("cat") == "cuda_runtime"
                       and e["name"] == SYNC_CALL)
        if len(syncs) < 2:
            raise RuntimeError("trace holds neither ecbench spans nor two "
                               f"{SYNC_CALL} calls to bound its window")
        starts, drains = syncs[:1], syncs[-1:]
    window = (min(starts), max(drains))

    def inside(e):
        ts = float(e["ts"])
        return ts < window[1] and ts + float(e["dur"]) > window[0]

    ops = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
           if e.get("cat") in DEVICE_CATS and inside(e)]
    host = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") in HOST_CATS and inside(e)]
    return TraceView(ops=ops, host=host, window=window, calls=calls,
                     yard=yard, enqueue_us=enqueue_us)


def export_events(prof) -> list[dict]:
    """The finished profiler's events, through a chrome trace written to
    and removed from the temporary directory."""
    fd, path = tempfile.mkstemp(prefix="ecbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome_trace(path)
    finally:
        os.unlink(path)
