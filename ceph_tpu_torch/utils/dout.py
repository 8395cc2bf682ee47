"""Leveled, per-subsystem logging with an in-memory crash ring.

Reference: src/log/Log.cc (async log thread + in-memory ring kept for
crash dump) and the ``dout(N)`` macros of src/common/debug.h with
per-subsystem debug levels (e.g. ``dout(20)`` in ErasureCodeIsa.cc:69).

Here: ``Dout(subsys)`` instances gate on per-subsystem levels from the
global config; every record (even below the emit threshold... above the
ring threshold) lands in a bounded ring that ``dump_recent()`` returns —
the crash-dump behavior of the reference's ring buffer.
"""

from __future__ import annotations

import collections
import sys
import threading
import time

from ceph_tpu_torch.utils.config import g_conf

_lock = threading.Lock()
_levels: dict[str, int] = {}
_ring: collections.deque = collections.deque(
    maxlen=g_conf()["log_ring_size"])
#: records at or below this level always enter the ring even when not
#: emitted (the reference keeps high-debug entries in memory for crashes)
RING_LEVEL = 20


def _resize_ring(_name: str, value: int) -> None:
    """log_ring_size observer: resize off the hot path, keeping the
    newest records."""
    global _ring
    with _lock:
        _ring = collections.deque(_ring, maxlen=value)


g_conf().add_observer("log_ring_size", _resize_ring)


def set_subsys_level(subsys: str, level: int) -> None:
    with _lock:
        _levels[subsys] = level


def get_subsys_level(subsys: str) -> int:
    with _lock:
        if subsys in _levels:
            return _levels[subsys]
    return g_conf()["debug_default_level"]


def dump_recent(count: int = 1000) -> list[str]:
    """The crash-dump ring (Log.cc dump_recent role): EVERYTHING the
    ring holds, formatted — the diagnostic-bundle view."""
    with _lock:
        items = list(_ring)[-count:]
    return [rec for _lvl, _sub, rec in items]


def dump_structured(count: int = 1000,
                    honor_levels: bool = True) -> list[dict]:
    """The operator-facing ring dump (asok ``log dump``). With
    ``honor_levels`` each record is gated on its subsystem's CURRENT
    effective level — the reference workflow: raise ``debug_<subsys>``,
    reproduce, ``log dump``. ``honor_levels=False`` returns the whole
    ring (what the crash/diagnostic path wants)."""
    with _lock:
        items = list(_ring)
        levels = dict(_levels)
    default = g_conf()["debug_default_level"]
    out = []
    for lvl, sub, rec in items:
        if honor_levels and lvl > levels.get(sub, default):
            continue
        out.append({"level": lvl, "subsys": sub, "record": rec})
    return out[-count:]


def register_asok(asok) -> None:
    """The ``log dump`` admin command (Log.cc dump_recent over the
    asok), so operators and the diagnostic bundle share one path."""

    def _dump(args: dict) -> dict:
        count = int(args.get("count", 1000))
        honor = not bool(int(args.get("all", 0)))
        recs = dump_structured(count, honor_levels=honor)
        return {"num_records": len(recs), "records": recs}

    asok.register_command(
        "log dump", _dump,
        "recent in-memory log records, gated on per-subsys levels "
        "(all=1 dumps the whole ring; count=N bounds it)")


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
