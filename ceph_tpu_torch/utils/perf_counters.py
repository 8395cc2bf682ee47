"""Typed performance counters — the PerfCounters role. A copy of
``ceph_tpu/utils/perf_counters.py`` (host only).

Reference: src/common/perf_counters.{h,cc} (398 LoC): per-daemon counter
collections with u64 counters, gauges, time-averages and histograms,
exposed via the admin socket ``perf dump``. Counters here are
threading-safe and cheap; the admin registry (utils/admin.py) serves the
dump, and the mgr/prometheus layer reads the same structures.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from enum import Enum


class CounterType(Enum):
    U64 = "u64"            # monotonically increasing counter
    GAUGE = "gauge"        # settable level
    TIME_AVG = "time_avg"  # (sum, count) pair -> average latency
    # power-of-2 buckets: bucket 0 = non-positive values, bucket
    # b >= 1 = [2^(b-1), 2^b) (positive sub-1.0 values join bucket 1)
    HISTOGRAM = "hist"


class PerfCounters:
    """One daemon/subsystem's counters (PerfCounters, perf_counters.h:83)."""

    _HIST_BUCKETS = 32

    #: exemplar candidates retained per histogram bucket (newest
    #: first); the exposition layer picks the newest one whose trace
    #: survived the tail sampler
    _EXEMPLAR_DEPTH = 4

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._types: dict[str, CounterType] = {}
        self._values: dict[str, object] = {}
        #: key -> bucket -> deque[(trace_id, value, wall_ts)] — only
        #: populated for observations that carried an exemplar, so
        #: exemplar-free histograms cost nothing extra
        self._exemplars: dict[str, dict[int, object]] = {}

    def add_u64_counter(self, key: str, desc: str = "") -> None:
        self._add(key, CounterType.U64, 0)

    def add_gauge(self, key: str, desc: str = "") -> None:
        self._add(key, CounterType.GAUGE, 0.0)

    def add_time_avg(self, key: str, desc: str = "") -> None:
        self._add(key, CounterType.TIME_AVG, (0.0, 0))

    def add_histogram(self, key: str, desc: str = "") -> None:
        self._add(key, CounterType.HISTOGRAM, [0] * self._HIST_BUCKETS)

    def _add(self, key: str, t: CounterType, init) -> None:
        with self._lock:
            if key in self._types:
                raise ValueError(f"duplicate counter {key}")
            self._types[key] = t
            self._values[key] = init

    def inc(self, key: str, by: int = 1) -> None:
        with self._lock:
            assert self._types[key] == CounterType.U64
            self._values[key] += by

    def set_gauge(self, key: str, value: float) -> None:
        with self._lock:
            assert self._types[key] == CounterType.GAUGE
            self._values[key] = value

    def ginc(self, key: str, by: float) -> None:
        """Adjust a gauge by a (possibly negative) delta atomically —
        the live-level accounting pattern (queue depths, HBM buffer
        bytes): producers inc, consumers dec, idle reads 0."""
        with self._lock:
            assert self._types[key] == CounterType.GAUGE
            self._values[key] += by

    def tinc(self, key: str, seconds: float) -> None:
        with self._lock:
            assert self._types[key] == CounterType.TIME_AVG
            s, c = self._values[key]
            self._values[key] = (s + seconds, c + 1)

    def hinc(self, key: str, value: float,
             exemplar: str | None = None) -> None:
        """Record one observation. Bucket edges (pinned by
        tests/test_device_telemetry.py): bucket 0 holds non-positive
        values only; bucket b >= 1 holds [2^(b-1), 2^b). Positive
        sub-1.0 observations count in bucket 1 with the 1s — they are
        real observations and must not masquerade as zeros (the old
        ``int(value)`` truncation sent 0.5 to the zero bucket).

        ``exemplar`` (a trace_id) attaches the observation's identity
        to its bucket — the prometheus histogram-exemplar role: a
        dashboard's p99 bucket links to the trace that landed there."""
        with self._lock:
            assert self._types[key] == CounterType.HISTOGRAM
            if value <= 0:
                bucket = 0
            elif value < 1:
                bucket = 1
            else:
                bucket = min(self._HIST_BUCKETS - 1,
                             int(value).bit_length())
            self._values[key][bucket] += 1
            if exemplar:
                per = self._exemplars.setdefault(key, {})
                dq = per.get(bucket)
                if dq is None:
                    dq = per[bucket] = deque(
                        maxlen=self._EXEMPLAR_DEPTH)
                dq.appendleft((str(exemplar), float(value),
                               time.time()))

    def exemplar(self, key: str, bucket: int, accept=None):
        """The newest (trace_id, value, wall_ts) candidate for one
        bucket passing ``accept(trace_id)`` (all pass when None);
        None when the bucket has no surviving candidate."""
        with self._lock:
            dq = self._exemplars.get(key, {}).get(bucket)
            cands = list(dq) if dq else ()
        for trace_id, value, ts in cands:
            if accept is None or accept(trace_id):
                return (trace_id, value, ts)
        return None

    def exemplar_buckets(self, key: str) -> list[int]:
        """Buckets holding at least one exemplar candidate."""
        with self._lock:
            return sorted(self._exemplars.get(key, {}))

    def time(self, key: str):
        """Context manager recording elapsed seconds into a time_avg."""
        counters = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                counters.tinc(key, time.perf_counter() - self.t0)
                return False
        return _Timer()

    def get(self, key: str):
        with self._lock:
            val = self._values[key]
            if self._types[key] == CounterType.TIME_AVG:
                s, c = val
                return {"sum": s, "avgcount": c,
                        "avg": (s / c) if c else 0.0}
            if self._types[key] == CounterType.HISTOGRAM:
                return list(val)
            return val

    def dump(self) -> dict:
        with self._lock:
            keys = list(self._types)
        return {key: self.get(key) for key in keys}


class PerfCountersCollection:
    """All counters in the process (PerfCountersCollection), the source for
    ``perf dump`` and the prometheus exporter."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._loggers: dict[str, PerfCounters] = {}

    def create(self, name: str) -> PerfCounters:
        with self._lock:
            if name in self._loggers:
                raise ValueError(f"duplicate perf counters {name}")
            pc = PerfCounters(name)
            self._loggers[name] = pc
            return pc

    def get(self, name: str) -> PerfCounters | None:
        with self._lock:
            return self._loggers.get(name)

    def remove(self, name: str) -> None:
        with self._lock:
            self._loggers.pop(name, None)

    def items(self) -> list[tuple[str, PerfCounters]]:
        """(name, logger) pairs — the exposition layer needs the live
        objects (exemplar queries), not just the value dump."""
        with self._lock:
            return sorted(self._loggers.items())

    def dump(self) -> dict:
        with self._lock:
            loggers = dict(self._loggers)
        return {name: pc.dump() for name, pc in loggers.items()}


_collection = PerfCountersCollection()


def collection() -> PerfCountersCollection:
    return _collection
