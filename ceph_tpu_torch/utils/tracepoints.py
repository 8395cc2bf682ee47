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
  ``jax.profiler.trace``);
- a provider also declares SPANS (``provider("ec").span("fused_step",
  device=True)``, used as ``with SPAN():``): a name, host start and end
  from ``time.time_ns()`` (the clock of a ``torch.profiler`` trace:
  ``ts`` + ``baseTimeNanoseconds``, see :func:`trace_base_ns`), the
  enclosing span of the same thread, a call id shared by every span
  under one root, and for a device span a pair of CUDA timing events
  recorded on the current stream at entry and exit (elapsed times are
  read at dump, never on the hot path). A root span records while its
  provider is enabled or while a ``torch.profiler`` session is live in
  the process (``device_trace``'s among them); its children follow it,
  and a root's sequential children can be its ``phase``s. Off, a span
  costs three flag tests and allocates nothing. Finished spans
  go to one bounded in-memory store (``spans_dropped()`` counts what
  did not fit), dumped with the provider's points by ``dump()`` /
  ``tracepoint_dump``, read by :func:`dump_spans` and emptied by
  :func:`clear_spans`; ``device_trace`` writes the spans of its session
  into its Chrome trace (category ``ceph_span``).
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from collections import deque

import torch
from torch.autograd import profiler as _autograd_profiler

from ceph_tpu_torch.utils.config import g_conf

_lock = threading.Lock()
_providers: dict[str, "TracepointProvider"] = {}

#: events kept per enabled provider (lttng ring-buffer role)
RING_SIZE = 8192

#: finished spans kept in memory, all providers together: a 0.5 s traced
#: stretch of the Clay repair cell makes about 4,000 calls of two spans
SPAN_STORE_SIZE = 16384


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
            (time.time_ns(), self.name,
             dict(zip(self.fields, args)) if self.fields
             else {"args": args}))


class TracepointProvider:
    """A named tracepoint group (the compiled .tp provider role)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.enabled = False
        self._points: dict[str, Tracepoint] = {}
        self._spans: dict[str, SpanPoint] = {}
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

    def span(self, name: str, device: bool = False) -> "SpanPoint":
        """Declare (or fetch) a span; ``device`` spans also time the
        card with CUDA events."""
        sp = self._spans.get(name)
        if sp is None:
            sp = self._spans[name] = SpanPoint(self, name, device)
        return sp

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def dump(self, limit: int = 0) -> list[dict]:
        """The ring's points, then this provider's finished spans, in
        time order (``ts`` in seconds), the last ``limit`` of them."""
        events = [{"ts": ts / 1e9, "point": f"{self.name}:{name}", **fields}
                  for ts, name, fields in list(self._ring)]
        spans = [s for s in list(_store) if s.point.provider is self]
        if spans:
            events = sorted(events + [
                {"ts": d["start_ns"] / 1e9, **d}
                for d in (s.as_dict() for s in spans)],
                key=lambda e: e["ts"])
        return events[-limit:] if limit else events

    def clear(self) -> None:
        self._ring.clear()
        with _lock:
            _discard([s for s in list(_store) if s.point.provider is self])


def provider(name: str) -> TracepointProvider:
    with _lock:
        prov = _providers.get(name)
        if prov is None:
            prov = _providers[name] = TracepointProvider(name)
        return prov


def providers() -> dict[str, bool]:
    with _lock:
        return {n: p.enabled for n, p in _providers.items()}


# -- spans -----------------------------------------------------------------

class _Local(threading.local):
    #: the innermost open span of the thread (a class default, so that
    #: reading it on a fresh thread raises nothing)
    top = None


_tls = _Local()
_ids = itertools.count(1)
#: finished spans (``_Span``), in the order they ended
_store: list = []
_dropped = [0]
#: recording root spans open now, on any thread: while there is none and
#: nothing arms the spans, a span returns at once without reading the
#: thread's state
_open = [0]


class _Off:
    """The context a span returns while nothing records: shared, so an
    off span allocates nothing. Its ``__enter__`` and ``__exit__`` are a
    C-level no-op that takes any arguments and returns None (``int``'s
    inherited ``object.__init__``), so an off span runs no Python frame
    of its own and lets every exception through."""

    __slots__ = ()
    __enter__ = __exit__ = phase = (0).__init__


_OFF = _Off()


class SpanPoint:
    """One declared span. ``with point():`` (or ``with point(attrs):``,
    a dict kept on the record) times the block when recording."""

    __slots__ = ("provider", "name", "device", "full_name")

    def __init__(self, provider: "TracepointProvider", name: str,
                 device: bool) -> None:
        self.provider = provider
        self.name = name
        self.device = device
        self.full_name = f"{provider.name}.{name}"

    def __call__(self, attrs: dict | None = None):
        armed = self.provider.enabled or \
            _autograd_profiler._is_profiler_enabled
        if not armed and not _open[0]:
            return _OFF
        parent = _tls.top
        if parent is None and not armed:
            return _OFF
        return _Span(self, parent, attrs)


class _Span:
    """A span while open, and its record once finished."""

    __slots__ = ("point", "parent", "id", "call", "attrs", "tid",
                 "start_ns", "end_ns", "start_ev", "end_ev", "current")

    def __init__(self, point: SpanPoint, parent: "_Span | None",
                 attrs: dict | None) -> None:
        self.point = point
        self.parent = parent
        self.id = next(_ids)
        self.call = self.id if parent is None else parent.call
        self.attrs = attrs
        self.tid = threading.get_ident() if parent is None else parent.tid
        self.start_ev = self.end_ev = self.current = None

    def __enter__(self) -> "_Span":
        if self.parent is None:
            with _lock:
                _open[0] += 1
        _tls.top = self
        self.start_ev = _event(self.point)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        now = time.time_ns()
        ev = _event(self.point)
        if self.current is not None:
            self.current._finish(now, ev)
        self._finish(now, ev)
        _tls.top = self.parent
        if self.parent is None:
            with _lock:
                _open[0] -= 1
        return False

    def phase(self, point: SpanPoint, attrs: dict | None = None) -> None:
        """End this span's current phase and open ``point`` as the next:
        children that tile the span, the first from the span's start,
        the last to its end, each boundary one clock reading and one CUDA
        event. (An off span's ``phase`` does nothing.)"""
        if self.current is None:
            now, ev = self.start_ns, self.start_ev
        else:
            now = time.time_ns()
            ev = _event(point)
            self.current._finish(now, ev)
        child = self.current = _Span(point, self, attrs)
        child.start_ns, child.start_ev = now, ev
        _tls.top = child

    def _finish(self, end_ns: int, end_ev) -> None:
        self.end_ns = end_ns
        self.end_ev = end_ev
        # unlocked: threads racing here can overfill the store by one
        # span each, which keeps it bounded
        if len(_store) < SPAN_STORE_SIZE:
            _store.append(self)
        else:
            with _lock:
                _dropped[0] += 1

    def as_dict(self) -> dict:
        """The record: ``device_us`` from the CUDA events (waiting for
        the end event) for a device span that ran on the card."""
        out = {"span": self.point.full_name, "id": self.id,
               "parent": None if self.parent is None else self.parent.id,
               "call": self.call, "tid": self.tid,
               "start_ns": self.start_ns, "end_ns": self.end_ns,
               "host_us": (self.end_ns - self.start_ns) / 1e3}
        if self.start_ev is not None and self.end_ev is not None:
            self.end_ev.synchronize()
            out["device_us"] = self.start_ev.elapsed_time(self.end_ev) * 1e3
        if self.attrs:
            out.update(self.attrs)
        return out


#: timing events of discarded spans, recorded again by later spans
_free_events: list = []
#: (stream id, device index, device type) -> ``torch.cuda.Stream``
_streams: dict = {}


def _event(point: SpanPoint):
    """A CUDA timing event recorded on the current stream, for a device
    span once CUDA is up; else None. Events are reused, and the stream
    object is looked up by the current stream's id (building one, as
    ``torch.cuda.current_stream()`` does each call, costs more than the
    record)."""
    if not point.device or not torch.cuda.is_initialized():
        return None
    try:
        ev = _free_events.pop()
    except IndexError:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(_current_stream())
    return ev


def _current_stream():
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


def _discard(spans) -> None:
    """Take ``spans`` out of the store; their events go back for reuse."""
    gone = {id(s) for s in spans}
    _store[:] = [s for s in list(_store) if id(s) not in gone]
    events = {id(ev): ev for s in spans for ev in (s.start_ev, s.end_ev)
              if ev is not None}
    _free_events.extend(events.values())


def dump_spans() -> list[dict]:
    """Every finished span in the store, as records."""
    return [s.as_dict() for s in list(_store)]


def clear_spans() -> None:
    """Empty the span store and zero ``spans_dropped``."""
    with _lock:
        _discard(list(_store))
        _dropped[0] = 0


def spans_dropped() -> int:
    """Spans that ended while the store was full (not kept)."""
    return _dropped[0]


_base_ns: list = []


def trace_base_ns() -> int:
    """This process's ``baseTimeNanoseconds`` of a ``torch.profiler``
    Chrome trace: an event at ``ts`` microseconds there happened at
    ``time.time_ns()`` = ``ts * 1000 + trace_base_ns()``. Read once,
    from a CPU-only profiler session of its own (so call it while no
    other session is open)."""
    if not _base_ns:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pass
        fd, path = tempfile.mkstemp(prefix="trace-base-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                _base_ns.append(int(json.load(fh)["baseTimeNanoseconds"]))
        finally:
            os.unlink(path)
    return _base_ns[0]


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

    While it is open every span records, on every thread (as under any
    live profiler session); on exit the
    spans that started inside it leave the span store and go into the
    trace as complete events of category ``ceph_span`` on the trace's
    own time axis, with their ids, call ids and device microseconds
    under ``args``.

    After exit, :meth:`kernel_names` lists the device kernels the
    region ran and ``path`` names the written trace."""

    _seq = 0

    def __init__(self, logdir: str, device: str = "cuda") -> None:
        self.logdir = logdir
        self.device = device
        self.path: str | None = None
        self._prof = None
        self._since_ns = 0

    def __enter__(self) -> "device_trace":
        global _open_trace
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
        self._since_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _open_trace
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
            self._write_spans()
        finally:
            with _trace_lock:
                _open_trace = None

    def _write_spans(self) -> None:
        """Move the session's spans from the store into the trace."""
        taken = [s for s in list(_store) if s.start_ns >= self._since_ns]
        if not taken:
            return
        recs = [s.as_dict() for s in taken]
        with _lock:
            _discard(taken)
        with open(self.path) as fh:
            doc = json.load(fh)
        base = int(doc["baseTimeNanoseconds"])
        pid = os.getpid()
        for rec in recs:
            doc["traceEvents"].append({
                "ph": "X", "cat": "ceph_span", "name": rec["span"],
                "ts": (rec["start_ns"] - base) / 1e3,
                "dur": rec["host_us"], "pid": pid, "tid": rec["tid"],
                "args": {k: v for k, v in rec.items()
                         if k not in ("span", "start_ns", "end_ns",
                                      "host_us", "tid")}})
        with open(self.path, "w") as fh:
            json.dump(doc, fh)

    def kernel_names(self) -> dict[str, int]:
        """{device kernel name: launches} recorded in the region
        (empty for a ``cpu`` session)."""
        return {e.key: e.count for e in self._prof.key_averages()
                if e.self_device_time_total > 0}
