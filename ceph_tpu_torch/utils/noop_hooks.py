"""Named stand-ins that do nothing, for the lock witness not ported yet.

``make_lock`` / ``make_rlock`` / ``make_condition`` return plain
``threading`` primitives in place of ``analysis/lock_witness``'s
witnessed ones (the witness also treats device barriers as lock-free
points; the port's version of that waits for its own port, ROADMAP
A.6).
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
