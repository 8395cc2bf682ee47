"""Runtime lock-order witness: a lockdep for the port's host locks.

Every lock built through :func:`make_lock` / :func:`make_rlock` /
:func:`make_condition` carries a NAME, the class of its construction
site (e.g. ``"osd.pgs"``): many PG instances share one name, as lockdep
keys by lock class, so the witness's memory stays fixed however many PGs
exist. While enabled, each thread's held-set is tracked and every nested
acquisition records a directed edge ``held -> acquired`` with a stack
fingerprint. At report time:

- a cycle in the order graph is a potential AB-BA deadlock, even if it
  never fired in this run (two daemons dispatching into each other
  under their own locks);
- a *blocking-under-lock* finding is a blocking operation executed
  while holding any witnessed lock: a device barrier
  (``torch.cuda.synchronize``, ``torch.cuda.Event.synchronize``,
  ``torch.cuda.Stream.synchronize``, and ``ops/backend.device_get``, the
  copy from the card to the host), a blocking admin-socket
  round-trip, ``os.fsync``, or ``Condition.wait`` on a different lock.

Contract when DISABLED (the default): the ``make_*`` constructors
return the bare ``threading`` primitives (no wrapper objects, no
per-acquire cost, no patched functions). Enabling is process-wide; the
witness gates in ``tests/test_torch_lock_witness.py`` arm it per test,
``CEPH_TPU_LOCK_WITNESS=1`` (:func:`env_enabled`) asks a harness (a
test session, a benchmark) to arm it for its run, and ``chip_smoke.py``
phase 5h arms it on the card. Locks built before :func:`enable`
(module-level locks built at import) stay bare.

State is fixed-memory: edges, fingerprints and findings are capped;
past the cap new observations only bump counters.

A second, independent opt-in mode, **lock timing**, rides the same
seams: while :func:`enable_timing` is on (``CEPH_TPU_LOCK_TIMING=1``
asks for it), ``make_*`` wraps the primitive in a :class:`_TimedLock` /
:class:`_TimedCondition` that measures wait and hold per named lock and
condvar notify->wake latency, reported into the ``dispatch`` telemetry
(``utils/dispatch_telemetry``). Both modes compose: the witness wraps
the timed lock as its ``_inner``, and a witnessed condition over a timed
lock times its wakeups.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback

#: caps: witness memory stays fixed no matter how long the run is
MAX_EDGES = 4096
MAX_STACKS_PER_EDGE = 4
MAX_VIOLATIONS = 512
_STACK_DEPTH = 8

_ENABLED = False
_TIMING = False
_state_lock = threading.Lock()     # guards the graphs below (bare by design)
_tls = threading.local()

#: (from_name, to_name) -> {"count", "stacks": {fingerprint: sample}}
_edges: dict[tuple[str, str], dict] = {}
#: (from_name, to_name) of self-edges where the two instances differed
_distinct_self_edges: set[tuple[str, str]] = set()
#: key -> {"kind", "lock", "site", "count", "stack"}
_violations: dict[str, dict] = {}
_edges_dropped = 0
#: (owner, attr, original, owner had attr in its own __dict__)
_saved_hooks: list = []


def env_enabled() -> bool:
    return os.environ.get("CEPH_TPU_LOCK_WITNESS") == "1"


def enabled() -> bool:
    return _ENABLED


def timing_env_enabled() -> bool:
    return os.environ.get("CEPH_TPU_LOCK_TIMING") == "1"


def timing_enabled() -> bool:
    return _TIMING


# -- construction seams (the named-lock adoption surface) ---------------

def make_lock(name: str):
    """A named mutex. Off: a bare ``threading.Lock`` (zero wrappers)."""
    inner = threading.Lock()
    if _TIMING:
        inner = _TimedLock(inner, name, reentrant=False)
    if not _ENABLED:
        return inner
    return WitnessLock(inner, name, _site(), reentrant=False)


def make_rlock(name: str):
    inner = threading.RLock()
    if _TIMING:
        inner = _TimedLock(inner, name, reentrant=True)
    if not _ENABLED:
        return inner
    return WitnessLock(inner, name, _site(), reentrant=True)


def _is_reentrant(lock) -> bool:
    if isinstance(lock, _TimedLock):
        return lock._reentrant
    return isinstance(lock, type(threading.RLock()))


def make_condition(name: str, lock=None):
    """A condition variable; ``lock`` may be a ``make_lock``/
    ``make_rlock`` result (witnessed, timed or bare) or None (own
    RLock)."""
    if not _ENABLED:
        if isinstance(lock, WitnessLock):     # enabled->disabled races
            lock = lock._inner
        if not _TIMING:
            if isinstance(lock, _TimedLock):  # timing flipped off
                lock = lock._inner
            return threading.Condition(lock)
        if lock is None:
            lock = _TimedLock(threading.RLock(), name, reentrant=True)
        elif not isinstance(lock, _TimedLock):
            lock = _TimedLock(lock, name,
                              reentrant=_is_reentrant(lock))
        return _TimedCondition(lock, name)
    if lock is None:
        inner = threading.RLock()
        if _TIMING:
            inner = _TimedLock(inner, name, reentrant=True)
        lock = WitnessLock(inner, name, _site(), reentrant=True)
    elif not isinstance(lock, WitnessLock):
        lock = WitnessLock(lock, name, _site(),
                           reentrant=_is_reentrant(lock))
    return WitnessCondition(lock, name)


def _site() -> str:
    f = sys._getframe(2)
    return "%s:%d" % (os.path.basename(f.f_code.co_filename), f.f_lineno)


# -- per-thread held-set ------------------------------------------------

def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _fingerprint() -> tuple[str, str, str]:
    """(fingerprint, sample text, call path) of the acquiring stack,
    app frames only, bounded depth. The fingerprint (dedup within one
    run) hashes file:line rows; the call path (baseline keys, stable
    across runs and line-number drift) joins function names only."""
    import zlib
    frames = traceback.extract_stack(sys._getframe(2), limit=_STACK_DEPTH)
    rows = []
    names = []
    for fr in frames:
        if "lock_witness" in fr.filename:
            continue
        rows.append("%s:%d:%s" % (os.path.basename(fr.filename),
                                  fr.lineno, fr.name))
        names.append(fr.name)
    text = " <- ".join(reversed(rows))
    path = "<-".join(reversed(names[-2:]))
    fp = "%08x" % zlib.crc32("|".join(rows).encode())
    return (fp, text, path)


def _note_acquired(lock: "WitnessLock") -> None:
    global _edges_dropped
    held = _held()
    if held:
        fp = None
        for prior in held:
            key = (prior.name, lock.name)
            if prior.name == lock.name and prior is lock:
                continue                 # RLock re-entry, not an edge
            with _state_lock:
                ent = _edges.get(key)
                if ent is None:
                    if len(_edges) >= MAX_EDGES:
                        _edges_dropped += 1
                        continue
                    ent = _edges[key] = {"count": 0, "stacks": {}}
                ent["count"] += 1
                if prior.name == lock.name:
                    _distinct_self_edges.add(key)
                if len(ent["stacks"]) < MAX_STACKS_PER_EDGE:
                    if fp is None:
                        fp = _fingerprint()
                    ent["stacks"].setdefault(fp[0], fp[1])
    held.append(lock)


def _note_released(lock: "WitnessLock") -> None:
    held = _held()
    # out-of-order releases are legal (hand-over-hand); drop by identity
    for i in range(len(held) - 1, -1, -1):
        if held[i] is lock:
            del held[i]
            return


def note_blocking(kind: str, detail: str = "") -> None:
    """Record a blocking-under-lock finding if this thread holds any
    witnessed lock. No-op (one predicate) while the witness is off."""
    if not _ENABLED:
        return
    held = _held()
    if not held:
        return
    _record_violation(kind, held[-1], detail)


def _record_violation(kind: str, lock: "WitnessLock",
                      detail: str = "") -> None:
    fp, text, path = _fingerprint()
    key = f"blocking:{kind}:{lock.name}:{path}"
    with _state_lock:
        ent = _violations.get(key)
        if ent is None:
            if len(_violations) >= MAX_VIOLATIONS:
                return
            ent = _violations[key] = {
                "kind": kind, "lock": lock.name, "site": lock.site,
                "detail": detail, "count": 0, "stack": text,
                "key": key}
        ent["count"] += 1


# -- proxies ------------------------------------------------------------

class WitnessLock:
    """Named, site-attributed lock proxy. Held-set bookkeeping happens
    only on the transition unlocked->locked (RLock re-entries bump a
    depth counter instead), so edges are per lock class and the graph
    stays small."""

    __slots__ = ("_inner", "name", "site", "_reentrant", "_depth")

    def __init__(self, inner, name: str, site: str,
                 reentrant: bool) -> None:
        self._inner = inner
        self.name = name
        self.site = site
        self._reentrant = reentrant
        self._depth = _Tls()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if self._reentrant and self._depth.value > 0:
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                self._depth.value += 1
            return ok
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if self._reentrant:
                self._depth.value = 1
            _note_acquired(self)
        return ok

    def release(self) -> None:
        if self._reentrant and self._depth.value > 1:
            self._depth.value -= 1
            self._inner.release()
            return
        if self._reentrant:
            self._depth.value = 0
        self._inner.release()
        _note_released(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<WitnessLock {self.name} @{self.site}>"


class _Tls:
    """Per-thread int riding a lock proxy (RLock depth)."""

    __slots__ = ("_tls",)

    def __init__(self) -> None:
        self._tls = threading.local()

    @property
    def value(self) -> int:
        return getattr(self._tls, "v", 0)

    @value.setter
    def value(self, v: int) -> None:
        self._tls.v = v


class WitnessCondition:
    """Condition proxy over a witnessed lock. ``wait`` checks the
    foreign-lock rule: waiting on THIS condition while holding any
    OTHER witnessed lock parks that lock for an unbounded time (the
    engine-shutdown race shape) and is recorded as a
    ``cond_wait_under_lock`` finding. Over a timed lock (both modes on)
    it also reports notify->wake latency, as :class:`_TimedCondition`
    does."""

    def __init__(self, lock: WitnessLock, name: str) -> None:
        self._lock = lock
        self.name = name
        self._cond = threading.Condition(lock._inner)
        self._timed = isinstance(lock._inner, _TimedLock)
        self._last_notify = 0.0

    # lock surface ----------------------------------------------------
    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self._lock.release()
        return False

    # condition surface -----------------------------------------------
    def wait(self, timeout: float | None = None):
        for other in _held():
            if other is not self._lock:
                _record_violation("cond_wait_under_lock", other,
                                  f"waiting on {self.name}")
        # the wait releases our lock; mirror that in the held-set
        _note_released(self._lock)
        depth, self._lock._depth.value = self._lock._depth.value, 0
        try:
            if not self._timed:
                return self._cond.wait(timeout)
            return _timed_wait(self, timeout)
        finally:
            self._lock._depth.value = depth
            _note_acquired(self._lock)

    def wait_for(self, predicate, timeout: float | None = None):
        # re-implemented over self.wait so the foreign-lock check and
        # held-set bookkeeping apply per wakeup
        return _wait_for(self.wait, predicate, timeout)

    def notify(self, n: int = 1) -> None:
        if self._timed:
            self._last_notify = time.monotonic()
        self._cond.notify(n)

    def notify_all(self) -> None:
        if self._timed:
            self._last_notify = time.monotonic()
        self._cond.notify_all()


def _wait_for(wait, predicate, timeout: float | None):
    """``threading.Condition.wait_for`` over a proxy's own ``wait``."""
    endtime = None
    result = predicate()
    while not result:
        if timeout is not None:
            if endtime is None:
                endtime = time.monotonic() + timeout
            waittime = endtime - time.monotonic()
            if waittime <= 0:
                break
            wait(waittime)
        else:
            wait(None)
        result = predicate()
    return result


# -- lock timing (the dispatch telemetry's lock-wait plane) -------------

def _report_timing(kind: str, name: str, value: float) -> None:
    """Feed one timing observation into the ``dispatch`` telemetry.
    Lazy import (the telemetry builds its own locks) and re-entry
    guarded: a timed lock inside the telemetry itself must not
    recurse. Telemetry faults never cost a lock operation."""
    if getattr(_tls, "in_report", False):
        return
    _tls.in_report = True
    try:
        from ceph_tpu_torch.utils.dispatch_telemetry import telemetry
        tel = telemetry()
        if kind == "wait":
            tel.note_lock_wait(name, value)
        elif kind == "hold":
            tel.note_lock_hold(name, value)
        else:
            tel.note_condvar_wakeup(name, value)
    except Exception:
        pass
    finally:
        _tls.in_report = False


class _TimedLock:
    """Wait-vs-hold timing proxy over a bare primitive. Measures the
    blocked time of every outermost acquire and the held time of every
    outermost release (RLock re-entries bump a depth counter like
    WitnessLock). Composes under WitnessLock as its ``_inner``."""

    __slots__ = ("_inner", "name", "_reentrant", "_depth", "_hold_t0")

    def __init__(self, inner, name: str, reentrant: bool) -> None:
        self._inner = inner
        self.name = name
        self._reentrant = reentrant
        self._depth = _Tls()
        self._hold_t0 = 0.0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if self._reentrant and self._depth.value > 0:
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                self._depth.value += 1
            return ok
        t0 = time.monotonic()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            now = time.monotonic()
            if self._reentrant:
                self._depth.value = 1
            self._hold_t0 = now
            _report_timing("wait", self.name, now - t0)
        return ok

    def release(self) -> None:
        if self._reentrant and self._depth.value > 1:
            self._depth.value -= 1
            self._inner.release()
            return
        if self._reentrant:
            self._depth.value = 0
        hold = time.monotonic() - self._hold_t0 \
            if self._hold_t0 else 0.0
        self._inner.release()
        _report_timing("hold", self.name, hold)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    # threading.Condition protocol: a condition built directly over
    # this proxy (WitnessCondition does that when both modes are on)
    # must fully unwind/restore the RLock depth across wait()
    def _release_save(self):
        depth = self._depth.value if self._reentrant else 0
        self._depth.value = 0
        hold = time.monotonic() - self._hold_t0 \
            if self._hold_t0 else 0.0
        if hasattr(self._inner, "_release_save"):
            saved = self._inner._release_save()
        else:
            saved = None
            self._inner.release()
        _report_timing("hold", self.name, hold)
        return (depth, saved)

    def _acquire_restore(self, state) -> None:
        depth, saved = state
        t0 = time.monotonic()
        if saved is not None and hasattr(self._inner,
                                         "_acquire_restore"):
            self._inner._acquire_restore(saved)
        else:
            self._inner.acquire()
        now = time.monotonic()
        self._hold_t0 = now
        self._depth.value = depth
        # post-wakeup reacquire contention is genuine lock wait
        _report_timing("wait", self.name, now - t0)

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self) -> str:
        return f"<_TimedLock {self.name}>"


class _TimedCondition:
    """Condition proxy adding notify->wake latency measurement: every
    ``notify``/``notify_all`` stamps the signal instant; a waiter that
    wakes notified reports how long after the newest signal it was
    actually running again."""

    def __init__(self, lock: _TimedLock, name: str) -> None:
        self._lock = lock
        self.name = name
        # built over the proxy: wait() unwinds via _release_save /
        # _acquire_restore above, so hold intervals close at wait
        # entry and wakeup reacquire counts as wait
        self._cond = threading.Condition(lock)
        self._last_notify = 0.0

    # lock surface ----------------------------------------------------
    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self._lock.release()
        return False

    # condition surface -----------------------------------------------
    def wait(self, timeout: float | None = None):
        return _timed_wait(self, timeout)

    def wait_for(self, predicate, timeout: float | None = None):
        return _wait_for(self.wait, predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._last_notify = time.monotonic()
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._last_notify = time.monotonic()
        self._cond.notify_all()


def _timed_wait(cv, timeout: float | None):
    """``cv._cond.wait(timeout)``; a waiter that wakes notified reports
    how long after the newest ``notify`` (``cv._last_notify``) it was
    running again."""
    t0 = time.monotonic()
    notified = cv._cond.wait(timeout)
    if notified:
        lat = time.monotonic() - cv._last_notify \
            if cv._last_notify >= t0 else 0.0
        _report_timing("condvar", cv.name, max(lat, 0.0))
    return notified


def enable_timing() -> None:
    """Turn lock timing on process-wide: locks constructed through the
    ``make_*`` seams AFTER this point are timed. Independent of the
    witness; both may be on."""
    global _TIMING
    _TIMING = True


def disable_timing() -> None:
    global _TIMING
    _TIMING = False


# -- blocking hooks (installed only while enabled) ----------------------

def _wrap_blocking(owner, attr: str, kind: str) -> None:
    """Patch ``owner.attr`` (a module function, or a class's method)
    with a wrapper that records ``kind`` before calling the original;
    :func:`_remove_hooks` restores it."""
    orig = getattr(owner, attr)
    own = not isinstance(owner, type) or attr in vars(owner)

    def wrapper(*a, **kw):
        note_blocking(kind)
        return orig(*a, **kw)

    wrapper.__wrapped__ = orig
    setattr(owner, attr, wrapper)
    _saved_hooks.append((owner, attr, orig, own))


def _install_hooks() -> None:
    import torch

    from ceph_tpu_torch.ops import backend as backend_mod
    from ceph_tpu_torch.utils import admin_socket
    _wrap_blocking(os, "fsync", "fsync")
    _wrap_blocking(admin_socket, "asok_command", "socket_send")
    # the port's waits on the card: a whole-device barrier, and the
    # event and stream waits (methods: patched on the class, so every
    # instance, made before or after, goes through the hook). A torch
    # built for the CPU has these classes too; only their use raises.
    _wrap_blocking(torch.cuda, "synchronize", "device_barrier")
    _wrap_blocking(torch.cuda.Event, "synchronize", "device_barrier")
    _wrap_blocking(torch.cuda.Stream, "synchronize", "device_barrier")
    # and the blocking copy from the card to the host (the reference's
    # ``jax.device_get`` hook): every daemon-path download goes through
    # ``backend.device_get`` (``backend.to_host`` of a card tensor)
    _wrap_blocking(backend_mod, "device_get", "device_barrier")


def _remove_hooks() -> None:
    while _saved_hooks:
        owner, attr, orig, own = _saved_hooks.pop()
        if own:
            setattr(owner, attr, orig)
        else:
            delattr(owner, attr)


# -- lifecycle ----------------------------------------------------------

def enable() -> None:
    """Turn the witness on process-wide. Locks constructed through the
    ``make_*`` seams AFTER this point are witnessed; blocking hooks
    (fsync / asok / device barriers) are patched in."""
    global _ENABLED
    if _ENABLED:
        return
    reset()
    _ENABLED = True
    _install_hooks()


def disable() -> None:
    global _ENABLED
    if not _ENABLED:
        return
    _ENABLED = False
    _remove_hooks()


def reset() -> None:
    """Drop all recorded state (test isolation)."""
    global _edges_dropped
    with _state_lock:
        _edges.clear()
        _distinct_self_edges.clear()
        _violations.clear()
        _edges_dropped = 0


# -- reporting ----------------------------------------------------------

def _find_cycles(adj: dict[str, set[str]]) -> list[list[str]]:
    """Strongly connected components of size > 1 (iterative Tarjan)."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    for root in adj:
        if root in index:
            continue
        work = [(root, iter(sorted(adj.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in adj:
                    continue
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(adj.get(nxt, ())))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1:
                    sccs.append(sorted(scc))
    return sccs


def report() -> dict:
    """The witness's findings as a JSON-ready dict. Cycle keys and
    finding keys are stable across runs (no line numbers, no counts)
    so ``analysis/baseline.json`` can acknowledge them."""
    with _state_lock:
        edges = {k: dict(v, stacks=dict(v["stacks"]))
                 for k, v in _edges.items()}
        self_edges = set(_distinct_self_edges)
        violations = [dict(v) for v in _violations.values()]
        dropped = _edges_dropped
    adj: dict[str, set[str]] = {}
    for (a, b) in edges:
        adj.setdefault(a, set())
        adj.setdefault(b, set())
        if a != b:
            adj[a].add(b)
    cycles = []
    for scc in _find_cycles(adj):
        scc_set = set(scc)
        cyc_edges = [
            {"from": a, "to": b, "count": ent["count"],
             "stacks": list(ent["stacks"].values())}
            for (a, b), ent in sorted(edges.items())
            if a in scc_set and b in scc_set and a != b]
        cycles.append({"key": "cycle:" + "|".join(scc),
                       "locks": scc, "edges": cyc_edges})
    # same-name nesting across DISTINCT instances: the two-PG-locks
    # class, a potential self-deadlock unless instance order is fixed
    for (a, b) in sorted(self_edges):
        ent = edges[(a, b)]
        cycles.append({"key": f"cycle:{a}|{a}",
                       "locks": [a, a],
                       "edges": [{"from": a, "to": b,
                                  "count": ent["count"],
                                  "stacks": list(
                                      ent["stacks"].values())}]})
    return {
        "enabled": _ENABLED,
        "edges": len(edges),
        "edges_dropped": dropped,
        "cycles": cycles,
        "blocking": sorted(violations, key=lambda v: v["key"]),
    }


def save_report(path: str) -> str:
    with open(path, "w") as f:
        json.dump(report(), f, indent=1, sort_keys=True)
    return path


def unacknowledged(rep: dict | None = None,
                   baseline: dict | None = None) -> list[dict]:
    """Findings not acknowledged by the ``witness`` section of
    analysis/baseline.json: what the witness gates assert is empty."""
    if rep is None:
        rep = report()
    if baseline is None:
        from ceph_tpu_torch.analysis import linters
        baseline = linters.load_baseline()
    acked = {e["key"] for e in baseline.get("witness", ())}
    out = [c for c in rep["cycles"] if c["key"] not in acked]
    out += [v for v in rep["blocking"] if v["key"] not in acked]
    return out
