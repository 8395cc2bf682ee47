"""Leveled, per-subsystem logging with an in-memory crash ring.

A copy of ``ceph_tpu/utils/dout.py``. The reference reads the default
level and the ring size from its global config (``g_conf()``
``debug_default_level``, ``log_ring_size``); until the port has that
module they are module defaults here, each with an environment override
(``CEPH_TPU_DEBUG_DEFAULT_LEVEL``, ``CEPH_TPU_LOG_RING_SIZE``), read when
the module loads. The ``log dump`` admin command (``register_asok``)
waits for the port's admin socket. The reference's description follows.

Reference: src/log/Log.cc (async log thread + in-memory ring kept for
crash dump) and the ``dout(N)`` macros of src/common/debug.h with
per-subsystem debug levels (e.g. ``dout(20)`` in ErasureCodeIsa.cc:69).

Here: ``Dout(subsys)`` instances gate on per-subsystem levels; every
record at or below ``RING_LEVEL`` lands in a bounded ring that
``dump_recent()`` returns — the crash-dump behavior of the reference's
ring buffer.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time

#: the reference config's defaults (ceph_tpu/utils/config.py:389-392)
DEFAULT_LEVEL = int(os.environ.get("CEPH_TPU_DEBUG_DEFAULT_LEVEL", "1"))
LOG_RING_SIZE = int(os.environ.get("CEPH_TPU_LOG_RING_SIZE", "10000"))

_lock = threading.Lock()
_levels: dict[str, int] = {}
_ring: collections.deque = collections.deque(maxlen=LOG_RING_SIZE)
#: records at or below this level always enter the ring even when not
#: emitted (the reference keeps high-debug entries in memory for crashes)
RING_LEVEL = 20


def set_subsys_level(subsys: str, level: int) -> None:
    with _lock:
        _levels[subsys] = level


def get_subsys_level(subsys: str) -> int:
    with _lock:
        return _levels.get(subsys, DEFAULT_LEVEL)


def dump_recent(count: int = 1000) -> list[str]:
    """The crash-dump ring (Log.cc dump_recent role): EVERYTHING the
    ring holds, formatted — the diagnostic-bundle view."""
    with _lock:
        items = list(_ring)[-count:]
    return [rec for _lvl, _sub, rec in items]


def dump_structured(count: int = 1000,
                    honor_levels: bool = True) -> list[dict]:
    """The operator-facing ring dump. With ``honor_levels`` each record
    is gated on its subsystem's CURRENT effective level;
    ``honor_levels=False`` returns the whole ring."""
    with _lock:
        items = list(_ring)
        levels = dict(_levels)
    out = []
    for lvl, sub, rec in items:
        if honor_levels and lvl > levels.get(sub, DEFAULT_LEVEL):
            continue
        out.append({"level": lvl, "subsys": sub, "record": rec})
    return out[-count:]


class Dout:
    """Per-subsystem leveled logger: ``log = Dout('osd'); log(5, 'msg')``."""

    def __init__(self, subsys: str, stream=None) -> None:
        self.subsys = subsys
        self.stream = stream or sys.stderr

    def __call__(self, level: int, *parts) -> None:
        msg = " ".join(str(p) for p in parts)
        record = (f"{time.strftime('%Y-%m-%d %H:%M:%S')} "
                  f"{level:2d} {self.subsys}: {msg}")
        if level <= RING_LEVEL:
            with _lock:
                _ring.append((level, self.subsys, record))
        if level <= get_subsys_level(self.subsys):
            try:
                print(record, file=self.stream)
            except ValueError:
                pass     # stream closed (interpreter/test teardown):
                # a daemon thread's last log line must not raise into
                # its caller; the ring above still has the record

    def error(self, *parts) -> None:
        self(-1, *parts)
