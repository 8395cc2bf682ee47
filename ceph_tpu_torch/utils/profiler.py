"""Whole-stack continuous profiler — sampled Python flamegraphs with
stage attribution.

PR 6's gap report attributes the ~1000x daemon->engine gap to STAGES
(``commit_wait`` 38%, ``engine_stage_wait`` 28%, device compute 0.1%)
but cannot say which CODE inside a stage burns the time: the stage
timeline names intervals, not functions. This module is the missing
half — an in-process, low-overhead stack-sampling profiler that runs
continuously across every daemon thread (they share one process here,
the vstart model), so ROADMAP item 1's fan-out rewrite is aimed by
measurement instead of guesswork. "Understanding System
Characteristics of Online Erasure Coding" (PAPERS.md) is the prior:
EC hot-path pathologies are CPU-side and emergent under load —
exactly what an always-on sampler catches and a microbenchmark
misses.

Design:

- A sampler thread walks ``sys._current_frames()`` at a configurable
  rate (``profiler_hz``, default 50) and folds each thread's stack
  into flamegraph "folded" form (``frame;frame;frame``). Aggregation
  is FIXED MEMORY: at most ``profiler_max_stacks`` distinct folded
  stacks are kept; overflow samples still count (under a sentinel
  key) and are reported as ``dropped_stacks``.
- Wall vs CPU split per thread: each sweep reads every thread's
  CPU clock (``pthread_getcpuclockid``); a sample whose thread
  advanced its CPU time since the previous sweep is an on-CPU
  sample. Where the platform lacks the clock the split degrades to
  wall-only (never an error).
- **The stage join** (the key move): daemon hot loops mark the stage
  that owns the thread via :func:`push_stage`/:func:`pop_stage`
  (plain dict writes — allocation-free, always on, nanoseconds), so
  a sample lands attributed to the PR-6 stage vocabulary: the
  messenger loop is ``wire``, an op-wq worker is ``pg_process`` (or
  ``commit_wait`` for engine continuations), the engine thread is
  ``engine_stage_wait``/``device_finalize``, the mgr tick is
  ``mgr_tick``. Threads with no explicit region fall back to a
  module classifier (leaf-to-root walk for the first frame whose
  file maps to a known subsystem), so attribution stays high even
  for threads nobody instrumented.

OFF is the default and costs NOTHING: no sampler thread exists, no
sample objects are allocated (mirrors the tracing layer's zero-Spans
contract); the region marks daemons always perform are single dict
stores. ON at 50 Hz measures < 5% overhead on the cluster bench
quick run (BASELINE.md "Profiling the data plane" records the
number).

Export: ``profile start/stop/dump/flame/status`` on every daemon's
admin socket (the profiler is process-wide, like the device
registry), ``/api/profile`` + a dashboard panel, ``profiler_*``
PerfCounters (prometheus + flight recorder for free), and
``tools/gap_report.py --profile`` joining hot frames under the
stage-attribution table. ``tools/flame.py`` renders folded output.
"""

from __future__ import annotations

import sys
import threading
import time

from ceph_tpu_torch.utils.perf_counters import PerfCounters, collection

#: thread ident -> the stage that owns the thread right now (the
#: sampler joins on this; writers use push_stage/pop_stage)
_thread_stage: dict[int, str] = {}

#: sample of a thread in no marked region and no classifiable frame
UNATTRIBUTED = "(unattributed)"

#: sentinel folded-stack key once the fixed-memory table is full
OVERFLOW_KEY = "[stack-table-full]"

#: frames deeper than this truncate (bounds the folded-key size)
_MAX_DEPTH = 48


def push_stage(stage: str) -> str | None:
    """Mark the calling thread as owned by ``stage``; returns the
    previous owner for :func:`pop_stage`. One dict store — safe to
    leave in hot paths with the profiler off."""
    ident = threading.get_ident()
    prev = _thread_stage.get(ident)
    _thread_stage[ident] = stage
    return prev


def pop_stage(prev: str | None) -> None:
    """Restore the previous owner saved by :func:`push_stage`."""
    ident = threading.get_ident()
    if prev is None:
        _thread_stage.pop(ident, None)
    else:
        _thread_stage[ident] = prev


#: file-substring -> stage bucket, tried leaf-to-root when no region
#: is marked. Canonical EC-write stage names where a subsystem maps
#: onto one; own labels otherwise (they group their own rows).
_CLASSIFY = (
    ("parallel/messenger", "wire"),
    ("parallel/messages", "wire"),
    ("utils/msgr_telemetry", "wire"),
    ("osd/device_engine", "engine_stage_wait"),
    ("osd/scrub_engine", "scrub"),
    ("osd/", "pg_process"),
    ("client/", "objecter_encode"),
    ("tools/rados_cli", "objecter_encode"),
    ("parallel/mon", "mon_tick"),
    ("parallel/auth", "mon_tick"),
    ("parallel/osdmap", "mon_tick"),
    ("parallel/crush", "pg_process"),
    ("mgr/", "mgr_tick"),
    ("store/", "store_commit"),
    ("ops/", "device_compute"),
    ("models/", "device_compute"),
    ("parallel/", "device_compute"),
    ("bench/", "bench_driver"),
    ("qa/", "bench_driver"),
    ("tests/", "bench_driver"),
    ("services/", "services"),
    ("ceph_tpu", "other"),
)


def _classify(files: list[str]) -> str:
    """Leaf-to-root: the first frame whose file maps to a known
    subsystem names the stage; stacks entirely outside the repo
    (pure stdlib threads) stay unattributed."""
    for fname in files:
        if "ceph_tpu" not in fname and "/repo/" not in fname:
            continue
        for needle, stage in _CLASSIFY:
            if needle in fname:
                return stage
    return UNATTRIBUTED


class StackProfiler:
    """One per process (the daemons share the process, so the sample
    tables are process-wide like the device registry). Construction
    is cheap and spawns NOTHING; only :meth:`start` creates the
    sampler thread."""

    def __init__(self, hz: float | None = None,
                 max_stacks: int | None = None) -> None:
        from ceph_tpu_torch.utils.config import g_conf
        self._lock = threading.Lock()
        self.hz = float(hz if hz is not None
                        else g_conf()["profiler_hz"])
        if hz is None:
            # tuner-managed knob (ISSUE 13): a runtime profiler_hz
            # push retunes a RUNNING sampler — the loop re-derives
            # its interval from self.hz every sweep. An explicit hz
            # argument pins the rate for this profiler's lifetime.
            try:
                g_conf().add_observer("profiler_hz", self._on_hz)
            except Exception:
                pass
        self.max_stacks = int(max_stacks if max_stacks is not None
                              else g_conf()["profiler_max_stacks"])
        perf = collection().get("profiler")
        if perf is None:
            perf = collection().create("profiler")
            self._declare(perf)
        self.perf = perf
        self._thread: threading.Thread | None = None
        self._stop_ev = threading.Event()
        #: (stage, folded) -> [wall_samples, cpu_samples]
        self._stacks: dict[tuple[str, str], list[int]] = {}
        #: ident -> {"name", "wall", "cpu", "cpu_s", "_clk", "_last"}
        self._threads: dict[int, dict] = {}
        self._samples = 0
        self._cpu_samples = 0
        self._dropped = 0
        self._t_start = 0.0
        self._elapsed = 0.0

    @staticmethod
    def _declare(perf: PerfCounters) -> None:
        perf.add_u64_counter("profile_samples",
                             "thread-stack samples taken")
        perf.add_u64_counter("profile_cpu_samples",
                             "samples whose thread was on-CPU "
                             "(thread CPU clock advanced)")
        perf.add_u64_counter("profile_dropped_stacks",
                             "samples folded into the overflow "
                             "bucket (fixed-memory cap hit)")
        perf.add_u64_counter("profile_sweeps",
                             "sampler sweeps over all threads")
        perf.add_gauge("profile_running", "1 while sampling")
        perf.add_gauge("profile_hz", "configured sampling rate")
        perf.add_gauge("profile_unique_stacks",
                       "distinct folded stacks held (bounded)")
        perf.add_time_avg("profile_sweep_time",
                          "seconds per sampler sweep (the overhead "
                          "numerator: sweep_time.sum / elapsed)")

    def _on_hz(self, _name: str, value) -> None:
        with self._lock:
            self.hz = float(value)
        if self.running:
            self.perf.set_gauge("profile_hz", self.hz)

    # -- lifecycle ----------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self, hz: float | None = None) -> bool:
        """Start sampling (idempotent); returns whether a sampler was
        newly started."""
        with self._lock:
            if self.running:
                return False
            if hz:
                self.hz = float(hz)
            self._stop_ev.clear()
            self._t_start = time.monotonic()
            self.perf.set_gauge("profile_running", 1)
            self.perf.set_gauge("profile_hz", self.hz)
            self._thread = threading.Thread(
                target=self._run, name="py-profiler", daemon=True)
            self._thread.start()
            return True

    def stop(self) -> bool:
        """Stop sampling (idempotent); aggregated tables are kept for
        dump/flame until reset()."""
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop_ev.set()
        if thread is not None:
            thread.join(timeout=2)
        self.perf.set_gauge("profile_running", 0)
        with self._lock:
            if self._t_start:
                self._elapsed += time.monotonic() - self._t_start
                self._t_start = 0.0
        return thread is not None

    def reset(self) -> None:
        """Drop the aggregated tables (counters stay cumulative —
        they are process counters like every other registry)."""
        with self._lock:
            self._stacks.clear()
            self._threads.clear()
            self._samples = 0
            self._cpu_samples = 0
            self._dropped = 0
            self._elapsed = 0.0
            self._published = (0, 0, 0)
            if self._t_start:
                self._t_start = time.monotonic()
            self.perf.set_gauge("profile_unique_stacks", 0)

    # -- the sampler thread -------------------------------------------
    def _run(self) -> None:
        my_ident = threading.get_ident()
        # interval re-derives from self.hz each sweep so a runtime
        # profiler_hz push (the tuner's observability lever) retunes
        # a live sampler without a restart
        while not self._stop_ev.wait(1.0 / max(self.hz, 0.1)):
            t0 = time.perf_counter()
            try:
                self._sweep(my_ident)
            except Exception:
                pass               # a sweep fault must not kill the loop
            self.perf.tinc("profile_sweep_time",
                           time.perf_counter() - t0)
            self.perf.inc("profile_sweeps")

    def _thread_names(self) -> dict[int, str]:
        return {t.ident: t.name for t in threading.enumerate()
                if t.ident is not None}

    def _cpu_advanced(self, ident: int, ent: dict) -> bool:
        """Did ``ident`` burn CPU since its last sweep? Uses the
        per-thread CPU clock; degrades to False (wall-only split)
        when the platform lacks it or the thread died."""
        clk = ent.get("_clk")
        if clk is False:          # probed before: clock unavailable
            return False
        try:
            if clk is None:
                clk = ent["_clk"] = time.pthread_getcpuclockid(ident)
            now = time.clock_gettime(clk)
        except (OSError, AttributeError, OverflowError):
            ent["_clk"] = False
            return False
        last = ent.get("_last")
        ent["_last"] = now
        if last is None:
            return False
        dt = now - last
        if dt > 0:
            ent["cpu_s"] += dt
        # any measurable CPU progress marks the sample on-CPU (a
        # thread parked in a lock/select advances by ~0)
        return dt > 1e-5

    def _sweep(self, my_ident: int) -> None:
        frames = sys._current_frames()
        names = self._thread_names()
        with self._lock:
            for ident, frame in frames.items():
                if ident == my_ident:
                    continue
                parts: list[str] = []
                files: list[str] = []
                depth = 0
                f = frame
                while f is not None and depth < _MAX_DEPTH:
                    code = f.f_code
                    parts.append(f"{_short(code.co_filename)}:"
                                 f"{code.co_name}")
                    files.append(code.co_filename)
                    f = f.f_back
                    depth += 1
                folded = ";".join(reversed(parts))
                stage = _thread_stage.get(ident) or _classify(files)
                ent = self._threads.get(ident)
                if ent is None:
                    ent = self._threads[ident] = {
                        "name": names.get(ident, f"tid-{ident}"),
                        "wall": 0, "cpu": 0, "cpu_s": 0.0}
                on_cpu = self._cpu_advanced(ident, ent)
                ent["wall"] += 1
                self._samples += 1
                key = (stage, folded)
                rec = self._stacks.get(key)
                if rec is None:
                    if len(self._stacks) >= self.max_stacks:
                        self._dropped += 1
                        key = (stage, OVERFLOW_KEY)
                        rec = self._stacks.get(key)
                        if rec is None:
                            rec = self._stacks[key] = [0, 0]
                    else:
                        rec = self._stacks[key] = [0, 0]
                rec[0] += 1
                if on_cpu:
                    rec[1] += 1
                    ent["cpu"] += 1
                    self._cpu_samples += 1
            n_unique = len(self._stacks)
            n_new = self._samples
            n_cpu = self._cpu_samples
            n_drop = self._dropped
        # prune stage marks left by dead threads (a worker that
        # exited inside a marked region): only idents we previously
        # sampled AND that no longer run are pruned, so a freshly
        # pushed mark from a thread born mid-sweep survives
        for ident in [i for i in list(_thread_stage)
                      if i not in frames and i in self._threads]:
            _thread_stage.pop(ident, None)
        # counters outside the table lock (they have their own)
        self.perf.set_gauge("profile_unique_stacks", n_unique)
        # set-to-absolute via inc deltas is racy across sweeps; the
        # sampler is the only writer, so plain incs per sweep are
        # exact — track deltas
        self._publish(n_new, n_cpu, n_drop)

    _published = (0, 0, 0)

    def _publish(self, samples: int, cpu: int, dropped: int) -> None:
        with self._lock:
            ps, pc, pd = self._published
            self._published = (samples, cpu, dropped)
        if samples > ps:
            self.perf.inc("profile_samples", samples - ps)
        if cpu > pc:
            self.perf.inc("profile_cpu_samples", cpu - pc)
        if dropped > pd:
            self.perf.inc("profile_dropped_stacks", dropped - pd)

    # -- views --------------------------------------------------------
    def elapsed(self) -> float:
        dt = self._elapsed
        if self._t_start:
            dt += time.monotonic() - self._t_start
        return dt

    def dump(self) -> dict:
        """JSON-able aggregate: totals, per-thread wall/CPU split,
        per-stage sample shares, attribution quality."""
        with self._lock:
            stacks = {k: list(v) for k, v in self._stacks.items()}
            threads = {i: {k: v for k, v in ent.items()
                           if not k.startswith("_")}
                       for i, ent in self._threads.items()}
            samples, cpu = self._samples, self._cpu_samples
            dropped = self._dropped
        by_stage: dict[str, dict] = {}
        for (stage, _folded), (w, c) in stacks.items():
            ent = by_stage.setdefault(stage,
                                      {"samples": 0, "cpu_samples": 0})
            ent["samples"] += w
            ent["cpu_samples"] += c
        hz = max(self.hz, 0.1)
        for ent in by_stage.values():
            ent["est_s"] = round(ent["samples"] / hz, 3)
        attributed = sum(ent["samples"]
                         for stage, ent in by_stage.items()
                         if stage != UNATTRIBUTED)
        return {
            "running": self.running,
            "hz": self.hz,
            "elapsed_s": round(self.elapsed(), 3),
            "samples": samples,
            "cpu_samples": cpu,
            "unique_stacks": len(stacks),
            "max_stacks": self.max_stacks,
            "dropped_stacks": dropped,
            "attributed_pct": round(100.0 * attributed / samples, 1)
            if samples else 0.0,
            "by_stage": dict(sorted(
                by_stage.items(),
                key=lambda kv: -kv[1]["samples"])),
            "threads": {ent["name"]: {
                "wall_samples": ent["wall"],
                "cpu_samples": ent["cpu"],
                "cpu_s": round(ent["cpu_s"], 4)}
                for ent in threads.values()},
        }

    def folded(self, cpu_only: bool = False) -> str:
        """Flamegraph folded format, one line per distinct stack:
        ``stage;frame;frame;frame count``. The stage is the root
        frame, so any flamegraph renderer groups by stage for free
        (tools/flame.py reads this)."""
        with self._lock:
            stacks = {k: list(v) for k, v in self._stacks.items()}
        lines = []
        for (stage, folded), (w, c) in sorted(
                stacks.items(), key=lambda kv: -kv[1][0]):
            n = c if cpu_only else w
            if n <= 0:
                continue
            lines.append(f"{stage};{folded} {n}")
        return "\n".join(lines)

    def top_frames(self, n: int = 10, cpu_only: bool = False
                   ) -> dict[str, list[dict]]:
        """Per-stage top-N hot frames by SELF (leaf-frame) samples —
        the gap report's join payload."""
        with self._lock:
            stacks = {k: list(v) for k, v in self._stacks.items()}
        agg: dict[str, dict[str, int]] = {}
        totals: dict[str, int] = {}
        for (stage, folded), (w, c) in stacks.items():
            count = c if cpu_only else w
            if count <= 0:
                continue
            leaf = folded.rsplit(";", 1)[-1]
            per = agg.setdefault(stage, {})
            per[leaf] = per.get(leaf, 0) + count
            totals[stage] = totals.get(stage, 0) + count
        out: dict[str, list[dict]] = {}
        for stage, per in agg.items():
            total = max(totals[stage], 1)
            out[stage] = [
                {"frame": frame, "samples": count,
                 "pct": round(100.0 * count / total, 1)}
                for frame, count in sorted(per.items(),
                                           key=lambda kv: -kv[1])[:n]]
        return out

    def status(self) -> dict:
        """The brief: running/hz/samples/overhead (asok ``profile
        status``, dashboard)."""
        sweep = self.perf.get("profile_sweep_time")
        elapsed = self.elapsed()
        overhead_pct = round(100.0 * sweep["sum"] / elapsed, 2) \
            if elapsed > 0 else 0.0
        with self._lock:
            samples, cpu = self._samples, self._cpu_samples
            unique, dropped = len(self._stacks), self._dropped
        return {"running": self.running, "hz": self.hz,
                "elapsed_s": round(elapsed, 3),
                "samples": samples, "cpu_samples": cpu,
                "unique_stacks": unique,
                "dropped_stacks": dropped,
                "sampler_overhead_pct": overhead_pct}


def _short(filename: str) -> str:
    """``.../ceph_tpu/osd/osd.py`` -> ``osd/osd.py`` (folded keys
    must stay readable and small)."""
    idx = filename.rfind("ceph_tpu/")
    if idx >= 0:
        return filename[idx + len("ceph_tpu/"):]
    return filename.rsplit("/", 1)[-1]


_module_lock = threading.Lock()
_profiler: StackProfiler | None = None


def profiler() -> StackProfiler:
    """The process-wide profiler (lazy: nothing exists until first
    use, and nothing SAMPLES until start())."""
    global _profiler
    with _module_lock:
        if _profiler is None:
            _profiler = StackProfiler()
        return _profiler


def profiler_if_exists() -> StackProfiler | None:
    """Zero-allocation peek (the OFF-cost contract: asking whether a
    profiler exists must not create one)."""
    return _profiler


def reset_for_tests() -> None:
    global _profiler
    with _module_lock:
        if _profiler is not None:
            _profiler.stop()
        collection().remove("profiler")
        _profiler = None
    _thread_stage.clear()


def register_asok(asok) -> None:
    """``profile start/stop/dump/flame/status`` on every daemon. The
    profiler is process-wide (daemons share the process), so any
    daemon's socket drives the same sampler — same contract as
    ``device perf dump``."""
    asok.register_command(
        "profile start",
        lambda a: (profiler().start(hz=a.get("hz")),
                   profiler().status())[1],
        "start the stack-sampling profiler ({hz} optional)")
    asok.register_command(
        "profile stop",
        lambda a: (profiler().stop(), profiler().status())[1],
        "stop the profiler (aggregates kept for dump/flame)")
    asok.register_command(
        "profile dump", lambda a: profiler().dump(),
        "sampled-stack aggregate: per-stage shares, wall/CPU split, "
        "attribution")
    asok.register_command(
        "profile flame",
        lambda a: {"folded": profiler().folded(
            cpu_only=bool(a.get("cpu")))},
        "flamegraph folded stacks (render with tools/flame.py)")
    asok.register_command(
        "profile status", lambda a: profiler().status(),
        "profiler brief: running/hz/samples/overhead")
