"""Counter flight recorder — fixed-memory time-series of PerfCounters.

Device telemetry gives the hot path point-in-time telemetry; what it cannot
answer is *what was happening when it went wrong*: a recompile storm
or an engine stall is invisible unless someone runs ``device perf
dump`` at the right moment. "Understanding System Characteristics of
Online Erasure Coding" (PAPERS.md) shows EC pathologies are emergent,
system-level behaviors that only show up in sustained observation —
so this module keeps one.

A :class:`FlightRecorder` samples every registered PerfCounters dict
(``collection().dump()``) into a bounded ring on an interval (the mgr
tick drives it; the clock is injectable for tests). Each sample is a
FLAT ``{"daemon.key": scalar}`` dict — u64 counters and gauges
verbatim, time-avgs as ``.sum``/``.avgcount``, histograms reduced to
their total observation ``.count`` (fixed memory per sample, no
bucket arrays). Windowed queries and rate derivation over the ring
are what the mgr health checks consume (recompiles/min, GB/s encoded,
flushes/s) and what the diagnostic bundle snapshots.

Recorder OFF means ZERO overhead: ``sample()`` returns without
touching the collection and nothing is retained.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ceph_tpu_torch.utils.perf_counters import collection


def _flatten(dump: dict) -> dict[str, float]:
    """One fixed-size scalar view of a full collection dump."""
    flat: dict[str, float] = {}
    for daemon, counters in dump.items():
        for key, val in counters.items():
            name = f"{daemon}.{key}"
            if isinstance(val, dict):          # time_avg
                flat[name + ".sum"] = val.get("sum", 0.0)
                flat[name + ".avgcount"] = val.get("avgcount", 0)
            elif isinstance(val, list):        # histogram -> total obs
                flat[name + ".count"] = sum(val)
            else:
                flat[name] = val
    return flat


class FlightRecorder:
    """Bounded ring of flattened counter samples with rate queries."""

    def __init__(self, capacity: int = 600, interval: float = 1.0,
                 clock=time.monotonic, enabled: bool = True) -> None:
        self._lock = threading.Lock()
        self._clock = clock
        self.interval = interval
        self.enabled = enabled
        #: (t, flat-counters) tuples, oldest first
        self._ring: deque[tuple[float, dict]] = deque(maxlen=capacity)

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    # -- producer side (mgr tick) -------------------------------------
    def sample(self, force: bool = False) -> bool:
        """Take one sample if the interval elapsed (or ``force``).
        Returns whether a sample landed. Disabled => no work at all."""
        if not self.enabled:
            return False
        now = self._clock()
        with self._lock:
            if not force and self._ring and \
                    now - self._ring[-1][0] < self.interval:
                return False
        flat = _flatten(collection().dump())   # off-lock: dump locks
        with self._lock:
            if not force and self._ring and \
                    now - self._ring[-1][0] < self.interval:
                return False                   # raced another sampler
            self._ring.append((now, flat))
        return True

    # -- queries -------------------------------------------------------
    def window(self, seconds: float | None = None) -> list[dict]:
        """Samples from the last ``seconds`` (all when None), oldest
        first, as ``{"t": rel_age_s, "counters": {...}}`` — JSON-able
        (relative ages, not monotonic stamps, so a bundle is
        meaningful outside this process)."""
        now = self._clock()
        with self._lock:
            items = list(self._ring)
        if seconds is not None:
            items = [it for it in items if now - it[0] <= seconds]
        return [{"t": round(now - t, 3), "counters": dict(flat)}
                for t, flat in items]

    def series(self, key: str,
               seconds: float | None = None) -> list[tuple[float, float]]:
        """(age_seconds, value) points for one flat key, oldest first."""
        now = self._clock()
        with self._lock:
            items = list(self._ring)
        out = []
        for t, flat in items:
            if seconds is not None and now - t > seconds:
                continue
            if key in flat:
                out.append((round(now - t, 3), flat[key]))
        return out

    def _points(self, key: str,
                seconds: float | None) -> list[tuple[float, float]]:
        """Every in-window sample as (age, value). A sample that
        predates the counter's registration reads 0 — counters are
        born at zero, so a key appearing mid-window must yield its
        full growth as the delta, not None."""
        now = self._clock()
        with self._lock:
            items = list(self._ring)
        return [(round(now - t, 3), flat.get(key, 0.0))
                for t, flat in items
                if seconds is None or now - t <= seconds]

    def delta(self, key: str, seconds: float | None = None
              ) -> float | None:
        """last - first over the window; None without >= 2 samples."""
        pts = self._points(key, seconds)
        if len(pts) < 2:
            return None
        return pts[-1][1] - pts[0][1]

    def rate(self, key: str, seconds: float | None = None
             ) -> float | None:
        """Per-second derivative over the window (the storm/stall
        inputs: recompiles/min = ``rate(...) * 60``); None without a
        measurable span."""
        pts = self._points(key, seconds)
        if len(pts) < 2:
            return None
        dt = pts[0][0] - pts[-1][0]            # ages: oldest - newest
        if dt <= 0:
            return None
        return (pts[-1][1] - pts[0][1]) / dt

    def rates_brief(self, seconds: float = 60.0) -> dict:
        """The derived rates the health checks and dashboard read."""
        with self._lock:
            newest = self._ring[-1][1] if self._ring else {}
        out = {}
        for label, key, scale in (
                ("recompiles_per_min", "device.recompiles", 60.0),
                ("cache_misses_per_min",
                 "device.compile_cache_misses", 60.0),
                ("encode_GBps", "device.bytes_encoded", 1e-9),
                ("decode_GBps", "device.bytes_decoded", 1e-9),
                ("flushes_per_s",
                 "device.encode_batch_ops.count", 1.0),
                ("scrub_GBps", "device.scrub_bytes_verified", 1e-9)):
            if key not in newest:
                continue               # counter never registered
            r = self.rate(key, seconds)
            if r is not None:
                out[label] = round(r * scale, 6)
        return out

    def stats(self) -> dict:
        with self._lock:
            n = len(self._ring)
            span = (self._ring[-1][0] - self._ring[0][0]) if n > 1 \
                else 0.0
        return {"enabled": self.enabled, "samples": n,
                "capacity": self.capacity,
                "interval_s": self.interval,
                "span_s": round(span, 3)}

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


_module_lock = threading.Lock()
_recorder: FlightRecorder | None = None


def recorder() -> FlightRecorder:
    """The process-global recorder (mirrors ``device_telemetry``: the
    device — and the counter collection — are per-process)."""
    global _recorder
    with _module_lock:
        if _recorder is None:
            from ceph_tpu_torch.utils.config import g_conf
            _recorder = FlightRecorder(
                capacity=g_conf()["flight_recorder_capacity"],
                interval=g_conf()["flight_recorder_interval"],
                enabled=g_conf()["flight_recorder_enabled"])
        return _recorder


def reset_for_tests() -> None:
    global _recorder
    with _module_lock:
        _recorder = None
