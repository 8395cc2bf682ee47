"""Static tracepoints + device profiling (src/tracing/ role).

The reference compiles LTTng-UST tracepoint providers per subsystem
(src/tracing/*.tp — osd, oprequest, objectstore, ...) and enables them
at daemon start through ``TracepointProvider`` config gating
(src/ceph_osd.cc:36, e.g. ``osd_tracing = true``). Here (a port of
``ceph_tpu/utils/tracepoints.py``):

- a PROVIDER is a named group of statically declared tracepoints
  (``provider("osd").point("op_dequeue", "oid", "lat_us")``); daemons
  declare their points at import time, exactly like a compiled-in
  .tp file;
- disabled points cost one attribute load + truth test (the
  nop-function discipline of UST's static jump patching — no string
  formatting, no allocation happens unless enabled);
- enabling a provider (config ``<name>_tracing = true``, or at
  runtime through the admin socket) routes events into a bounded
  in-memory ring, dumpable via ``dump()``/asok — the lttng-consumer
  role collapsed into the daemon;
- the DEVICE side uses torch.profiler: ``device_trace(dir)`` records
  a bracketed region with CUDA activity and writes a Chrome trace of
  every kernel the engine launched under ``dir`` (the reference wraps
  ``jax.profiler.trace``).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ceph_tpu_torch.utils.config import g_conf

_lock = threading.Lock()
_providers: dict[str, "TracepointProvider"] = {}

#: events kept per enabled provider (lttng ring-buffer role)
RING_SIZE = 8192


class Tracepoint:
    """One static tracepoint. ``__call__(*args)`` is the hot-path
    emit: when the provider is disabled it returns immediately."""

    __slots__ = ("provider", "name", "fields")

    def __init__(self, provider: "TracepointProvider", name: str,
                 fields: tuple) -> None:
        self.provider = provider
        self.name = name
        self.fields = fields

    @property
    def enabled(self) -> bool:
        return self.provider.enabled

    def __call__(self, *args) -> None:
        prov = self.provider
        if not prov.enabled:
            return
        prov._ring.append(
            (time.time(), self.name,
             dict(zip(self.fields, args)) if self.fields
             else {"args": args}))


class TracepointProvider:
    """A named tracepoint group (the compiled .tp provider role)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.enabled = False
        self._points: dict[str, Tracepoint] = {}
        self._ring: deque = deque(maxlen=RING_SIZE)
        # config gating (ceph_osd.cc:36 TracepointProvider role):
        # '<name>_tracing = true' arms the provider at declare time
        # AND tracks later changes (conf.set / mon central config)
        # through a config observer — providers are created at module
        # import, long before most config sources load
        try:
            self.enabled = bool(g_conf()[f"{name}_tracing"])
            g_conf().add_observer(
                f"{name}_tracing",
                lambda _n, v, self=self: setattr(
                    self, "enabled", bool(v)))
        except KeyError:
            pass

    def point(self, name: str, *fields: str) -> Tracepoint:
        """Declare (or fetch) a static tracepoint."""
        tp = self._points.get(name)
        if tp is None:
            tp = self._points[name] = Tracepoint(self, name,
                                                 tuple(fields))
        return tp

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def dump(self, limit: int = 0) -> list[dict]:
        events = list(self._ring)
        if limit:
            events = events[-limit:]
        return [{"ts": ts, "point": f"{self.name}:{name}", **fields}
                for ts, name, fields in events]

    def clear(self) -> None:
        self._ring.clear()


def provider(name: str) -> TracepointProvider:
    with _lock:
        prov = _providers.get(name)
        if prov is None:
            prov = _providers[name] = TracepointProvider(name)
        return prov


def providers() -> dict[str, bool]:
    with _lock:
        return {n: p.enabled for n, p in _providers.items()}


def register_asok(asok) -> None:
    """Admin-socket surface: list/enable/disable/dump — the runtime
    half of the reference's 'lttng enable-event' workflow."""
    asok.register_command(
        "tracepoints",
        lambda a: providers(),
        "declared tracepoint providers and their state")
    asok.register_command(
        "tracepoint_enable",
        lambda a: (provider(a.get("provider", "")).enable(), "ok")[1],
        "enable a tracepoint provider")
    asok.register_command(
        "tracepoint_disable",
        lambda a: (provider(a.get("provider", "")).disable(), "ok")[1],
        "disable a tracepoint provider")
    asok.register_command(
        "tracepoint_dump",
        lambda a: provider(a.get("provider", "")).dump(
            int(a.get("limit", 0) or 0)),
        "dump a provider's event ring")


#: the open device_trace session of this process (torch.profiler
#: allows one at a time)
_trace_lock = threading.Lock()
_open_trace: "device_trace | None" = None


class device_trace:
    """Bracketed device profiling: records everything launched inside
    the region with ``torch.profiler`` (CPU activity, plus CUDA
    activity for a ``cuda`` device) and writes a Chrome trace to
    ``trace-<pid>-<n>.json`` under ``logdir`` on exit.

    Unlike the reference's ``jax.profiler`` wrapper, it never turns
    into a no-op: a ``cuda`` session without a card, a profiler that
    fails to start, or a session opened inside another one raises
    ``RuntimeError``. Open it as the first profiler session of its
    process: sessions after one that spanned the device engine's
    threads have come back empty on the card.

    After exit, :meth:`kernel_names` lists the device kernels the
    region ran and ``path`` names the written trace."""

    _seq = 0

    def __init__(self, logdir: str, device: str = "cuda") -> None:
        self.logdir = logdir
        self.device = device
        self.path: str | None = None
        self._prof = None

    def __enter__(self) -> "device_trace":
        global _open_trace
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device_trace: no CUDA device")
            activities.append(ProfilerActivity.CUDA)
        elif self.device != "cpu":
            raise ValueError(f"device_trace: device {self.device!r}")
        with _trace_lock:
            if _open_trace is not None:
                raise RuntimeError(
                    "device_trace: a session is already open in this "
                    "process (torch.profiler runs one at a time)")
            _open_trace = self
        try:
            if self.device == "cuda":
                torch.cuda.synchronize()
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        except Exception:
            with _trace_lock:
                _open_trace = None
            raise
        return self

    def __exit__(self, *exc) -> None:
        global _open_trace
        import os
        import torch
        try:
            if self.device == "cuda":
                torch.cuda.synchronize()
            self._prof.__exit__(*exc)
            os.makedirs(self.logdir, exist_ok=True)
            device_trace._seq += 1
            self.path = os.path.join(
                self.logdir,
                f"trace-{os.getpid()}-{device_trace._seq}.json")
            self._prof.export_chrome_trace(self.path)
        finally:
            with _trace_lock:
                _open_trace = None

    def kernel_names(self) -> dict[str, int]:
        """{device kernel name: launches} recorded in the region
        (empty for a ``cpu`` session)."""
        return {e.key: e.count for e in self._prof.key_averages()
                if e.self_device_time_total > 0}
