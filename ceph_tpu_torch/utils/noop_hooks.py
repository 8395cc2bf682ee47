"""Named stand-ins that do nothing, for reference modules not ported yet.

Each name here stands in for one reference module until that module is
ported (ROADMAP A.6), and every one of them does nothing:

- ``make_lock`` / ``make_rlock`` / ``make_condition``: plain ``threading``
  primitives for ``analysis/lock_witness``'s witnessed ones (the witness
  also treats device barriers as lock-free points; the port's version of
  that waits for its own port);
- ``tracepoint`` and ``register_tracepoints_asok``:
  ``utils/tracepoints.provider(...).point(...)``, never enabled, and its
  ``tracepoints`` admin commands;
- ``autopsy_store`` and ``register_autopsy_asok``: ``utils/autopsy``'s
  store of slow- and failed-op snapshots (``store().record``), which
  keeps nothing, and its ``autopsy`` admin commands.
"""

from __future__ import annotations

import threading


def make_lock(_name: str) -> threading.Lock:
    """A plain lock in place of the lock witness's named one."""
    return threading.Lock()


def make_rlock(_name: str) -> threading.RLock:
    """A plain re-entrant lock in place of the witness's named one."""
    return threading.RLock()


def make_condition(_name: str, lock=None) -> threading.Condition:
    """A plain condition in place of the lock witness's named one; its
    own RLock when ``lock`` is None, as the witness's."""
    return threading.Condition(lock)


class _NoopTracepoint:
    enabled = False

    def __call__(self, *_args) -> None:
        """Never enabled: records nothing."""


def tracepoint(_provider: str, _name: str, *_fields: str) -> _NoopTracepoint:
    return _NoopTracepoint()


def register_tracepoints_asok(_asok) -> None:
    """No tracepoint admin commands: none is ever enabled."""


class _NoopAutopsyStore:
    def record(self, _rec: dict, _stages) -> None:
        """Nothing is kept."""


_AUTOPSY = _NoopAutopsyStore()


def autopsy_store() -> _NoopAutopsyStore:
    return _AUTOPSY


def register_autopsy_asok(_asok) -> None:
    """No autopsy admin commands: the store keeps nothing."""
