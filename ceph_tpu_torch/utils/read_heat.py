"""Per-object read-heat accounting (ROADMAP 3: any-k balanced reads).

A zipfian read storm concentrates on a few hot objects; the EC
backend rotates THEIR shard read sets across the acting set while
cold objects keep the canonical (primary-preferred) set so their
decode signatures stay shared. This module is the process-wide heat
book both sides consult:

- ``note(key)`` — count one read of ``key`` ((pool, oid)) and return
  its running count; the EC backend calls it on every client read
  and starts rotating past ``osd_hot_read_threshold``.
- ``skew()`` — max/mean read concentration across tracked objects;
  the tuner's read_skew sensor (mgr/tuner.py) steps
  ``osd_read_set_spread`` on it.

Bounded memory: when the table exceeds its cap the coldest half is
dropped (a re-heating object just re-crosses the threshold — the
hysteresis is harmless, the bound is not optional). Process-wide
like the other dataplane registries: in-process MiniClusters share
one book, exactly as they share one device engine.
"""

from __future__ import annotations

import threading

_CAP = 65536

_lock = threading.Lock()
_counts: dict[tuple, int] = {}


def note(key: tuple) -> int:
    """Count one read of ``key``; returns the running count."""
    with _lock:
        count = _counts.get(key, 0) + 1
        _counts[key] = count
        if len(_counts) > _CAP:
            keep = sorted(_counts.items(), key=lambda kv: kv[1],
                          reverse=True)[:_CAP // 2]
            _counts.clear()
            _counts.update(keep)
        return count


def skew() -> float:
    """Read concentration: hottest object's count over the mean
    (1.0 = perfectly even; zipfian storms score far higher). 0.0
    when nothing was read yet."""
    with _lock:
        if not _counts:
            return 0.0
        counts = list(_counts.values())
    return max(counts) / (sum(counts) / len(counts))


def snapshot_brief(top: int = 8) -> dict:
    """The hottest objects + totals (gap_report's read arm)."""
    with _lock:
        items = sorted(_counts.items(), key=lambda kv: kv[1],
                       reverse=True)
        total = sum(_counts.values())
    return {"objects": len(items), "reads": total,
            "skew": (items[0][1] / (total / len(items)))
            if items else 0.0,
            "top": [{"key": list(k), "reads": c}
                    for k, c in items[:top]]}


def reset() -> None:
    """Test/bench isolation (the dataplane-registry convention)."""
    with _lock:
        _counts.clear()
