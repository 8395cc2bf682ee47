"""Named stand-ins that do nothing, for the reference engine's host hooks.

``ceph_tpu/osd/device_engine.py:104-117`` imports ten host modules. The
port copies the ones its gates read (``perf_counters``,
``device_telemetry``, ``stage_clock``, ``dout``); each name here stands in
for one of the others until that module is ported (ROADMAP A.6), and
every one of them does nothing:

- ``make_lock`` / ``make_condition``: plain ``threading`` primitives for
  ``analysis/lock_witness``'s witnessed ones;
- ``profiler_push_stage`` / ``profiler_pop_stage``: ``utils/profiler``'s
  per-thread stage marks;
- ``dispatch_telemetry``: ``utils/dispatch_telemetry.telemetry()``, whose
  ``note_handoff`` records nothing;
- ``flows_if_active`` (always None), ``current_flow`` (always None) and
  ``flow_scope`` (an empty context): ``utils/flow_telemetry``;
- ``tracepoint``: ``utils/tracepoints.provider(...).point(...)``, never
  enabled;
- ``NOOP_SPAN``: ``utils/tracing.NOOP``, a span whose ``child``,
  ``event``, ``finish`` and ``set_error`` do nothing;
- ``engine_fault``: ``utils/faults.engine_fault``, which never raises
  (no chaos rules are loaded).
"""

from __future__ import annotations

import contextlib
import threading


def make_lock(_name: str) -> threading.Lock:
    """A plain lock in place of the lock witness's named one."""
    return threading.Lock()


def make_condition(_name: str) -> threading.Condition:
    """A plain condition in place of the lock witness's named one."""
    return threading.Condition()


def profiler_push_stage(_stage: str) -> None:
    """No profiler: nothing is marked, nothing to restore."""
    return None


def profiler_pop_stage(_prev) -> None:
    """No profiler: nothing to restore."""


class _NoopDispatchTelemetry:
    def note_handoff(self, _seam: str, _wait_s: float) -> None:
        """Cross-thread hops are not recorded."""


_DISPATCH = _NoopDispatchTelemetry()


def dispatch_telemetry() -> _NoopDispatchTelemetry:
    return _DISPATCH


def flows_if_active() -> None:
    """Per-tenant flow attribution is off: always None."""
    return None


def current_flow() -> None:
    return None


def flow_scope(_label):
    """An empty context in place of the flow label scope."""
    return contextlib.nullcontext()


class _NoopTracepoint:
    enabled = False

    def __call__(self, *_args) -> None:
        """Never enabled: records nothing."""


def tracepoint(_provider: str, _name: str, *_fields: str) -> _NoopTracepoint:
    return _NoopTracepoint()


class _NoopSpan:
    """The free sink for untraced ops (``utils/tracing.NOOP``)."""

    __slots__ = ()
    trace_id = ""

    def child(self, _name: str, _service: str | None = None) -> "_NoopSpan":
        return self

    def event(self, _name: str) -> None:
        """Not traced."""

    def set_error(self, _detail: str = "error") -> None:
        """Not traced."""

    def finish(self) -> None:
        """Not traced."""


NOOP_SPAN = _NoopSpan()


def engine_fault(_point: str) -> None:
    """No chaos rules are loaded: never raises."""
