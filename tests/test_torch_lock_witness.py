"""The port's lock-order witness (``ceph_tpu_torch/analysis/lock_witness``)
against the reference's, on the CPU.

Counterparts of the 20 tests of ``tests/test_lock_witness.py``:

- off = zero wrappers (the ``make_*`` seams return bare threading
  primitives, no hook patched);
- the scripted AB-BA shape (two daemons messaging each other under their
  own locks) is reported as a cycle without the test hanging;
- blocking-under-lock detection covers the port's device barriers
  (``torch.cuda.synchronize``, ``torch.cuda.Event.synchronize``,
  ``torch.cuda.Stream.synchronize``, the copy from the card to the host
  ``ops/backend.device_get``), fsync, the blocking asok
  round-trip, and ``Condition.wait`` under a foreign lock;
- witness-armed port MiniCluster bursts (threaded, blockstore group
  commit, crimson; ``backend=torch``) report zero unacknowledged
  findings against ``ceph_tpu_torch/analysis/baseline.json``;
- witness state is fixed-memory and the proxy overhead bounded.

Beside them: the same scenarios run under both witnesses give equal
cycle and blocking keys, the hooks are restored on ``disable()``, and the
timing mode feeds the port's ``dispatch`` telemetry, also composed with
the witness under ``Condition.wait``; the same timing scenarios run
under both packages' timing modes report waits, holds and wakeups on
the same locks.

The witness is armed per test (the ``witness`` fixture); this repo's
``tests/conftest.py`` arms only the reference's, and only from the
environment.
"""

import json
import os
import threading
import time

import pytest
import torch

from ceph_tpu.analysis import lock_witness as ref_lw
from ceph_tpu_torch.analysis import linters
from ceph_tpu_torch.analysis import lock_witness as lw
from ceph_tpu_torch.ops import backend as backend_mod
from ceph_tpu_torch.utils import admin_socket as asok_mod


@pytest.fixture
def witness():
    lw.enable()
    try:
        yield lw
    finally:
        lw.disable()
        lw.reset()


@pytest.fixture
def timing():
    lw.enable_timing()
    try:
        yield lw
    finally:
        lw.disable_timing()


def _run_bounded(fn, timeout=15.0):
    """Watchdog: run fn on a worker; fail (don't hang the suite) if it
    wedges."""
    done = []
    err = []

    def body():
        try:
            fn()
            done.append(1)
        except BaseException as exc:   # noqa: BLE001 (reraised below)
            err.append(exc)

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout)
    if err:
        raise err[0]
    assert done, f"scenario wedged (>{timeout}s): watchdog tripped"


#: the six hooked callables: (owner, attribute)
HOOKS = ((os, "fsync"), (asok_mod, "asok_command"),
         (torch.cuda, "synchronize"), (torch.cuda.Event, "synchronize"),
         (torch.cuda.Stream, "synchronize"), (backend_mod, "device_get"))


def _barrier_calls():
    """The port's four device waits, called without a card: the three
    explicit waits raise (no CUDA in this torch, or a stand-in self)
    after the hook ran; the copy to the host (the counterpart of the
    reference's hooked ``jax.device_get``) copies a CPU tensor."""
    return {"torch.cuda.synchronize": torch.cuda.synchronize,
            "Event.synchronize":
                lambda: torch.cuda.Event.synchronize(object()),
            "Stream.synchronize":
                lambda: torch.cuda.Stream.synchronize(object()),
            "backend.device_get":
                lambda: backend_mod.device_get(torch.zeros(4))}


# -- off = zero wrappers ------------------------------------------------

def test_witness_off_returns_bare_primitives():
    assert not lw.enabled() and not lw.timing_enabled()
    assert type(lw.make_lock("x")) is type(threading.Lock())
    assert type(lw.make_rlock("x")) is type(threading.RLock())
    cond = lw.make_condition("x")
    assert type(cond) is threading.Condition
    # and no blocking hooks are patched in
    for owner, attr in HOOKS:
        assert not hasattr(getattr(owner, attr), "__wrapped__"), attr


def _hooked(owner, attr):
    """The attribute as its owner holds it (a class's own __dict__)."""
    return vars(owner).get(attr) if isinstance(owner, type) \
        else getattr(owner, attr)


def test_enable_disable_roundtrip():
    originals = [_hooked(o, a) for o, a in HOOKS]
    lw.enable()
    try:
        assert lw.enabled()
        assert isinstance(lw.make_lock("a"), lw.WitnessLock)
        assert isinstance(lw.make_rlock("a"), lw.WitnessLock)
        assert isinstance(lw.make_condition("a"), lw.WitnessCondition)
        for (owner, attr), orig in zip(HOOKS, originals):
            assert _hooked(owner, attr).__wrapped__ is orig, attr
    finally:
        lw.disable()
        lw.reset()
    assert type(lw.make_lock("x")) is type(threading.Lock())
    # the originals themselves are back (the methods on their classes)
    for (owner, attr), orig in zip(HOOKS, originals):
        assert _hooked(owner, attr) is orig, attr


def test_env_switches():
    old = {k: os.environ.pop(k, None)
           for k in ("CEPH_TPU_LOCK_WITNESS", "CEPH_TPU_LOCK_TIMING")}
    try:
        assert not lw.env_enabled() and not lw.timing_env_enabled()
        os.environ["CEPH_TPU_LOCK_WITNESS"] = "1"
        os.environ["CEPH_TPU_LOCK_TIMING"] = "1"
        assert lw.env_enabled() and lw.timing_env_enabled()
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


# -- AB-BA ---------------------------------------------------------------

class _Daemon:
    """Minimal reconstruction of the loopback deadlock shape: a daemon
    whose handler runs under its own lock and SYNCHRONOUSLY calls into
    its peer (dispatch on the sending thread)."""

    def __init__(self, name: str, mod=lw) -> None:
        self.lock = mod.make_lock(f"daemon.{name}")
        self.peer: "_Daemon | None" = None

    def tick(self) -> None:
        """Heartbeat: under MY lock, message the peer."""
        with self.lock:
            self.peer.handle()

    def handle(self) -> None:
        with self.lock:
            pass


def test_scripted_abba_reported_without_hanging(witness):
    """Both daemons tick (one after the other: the deadlock never FIRES
    in this run) and the witness still reports the A->B / B->A cycle
    from the order graph alone."""
    a, b = _Daemon("alpha"), _Daemon("beta")
    a.peer, b.peer = b, a

    def scenario():
        a.tick()     # daemon.alpha -> daemon.beta
        b.tick()     # daemon.beta -> daemon.alpha

    _run_bounded(scenario)
    rep = lw.report()
    keys = [c["key"] for c in rep["cycles"]]
    assert "cycle:daemon.alpha|daemon.beta" in keys, keys
    cyc = next(c for c in rep["cycles"]
               if c["key"] == "cycle:daemon.alpha|daemon.beta")
    dirs = {(e["from"], e["to"]) for e in cyc["edges"]}
    assert ("daemon.alpha", "daemon.beta") in dirs
    assert ("daemon.beta", "daemon.alpha") in dirs
    assert all(e["stacks"] for e in cyc["edges"])
    # and it is NOT acknowledged by the checked-in baseline
    assert any(u.get("key") == cyc["key"]
               for u in lw.unacknowledged(rep))


def test_consistent_order_is_not_a_cycle(witness):
    a = lw.make_lock("ord.a")
    b = lw.make_lock("ord.b")
    for _ in range(3):
        with a:
            with b:
                pass
    rep = lw.report()
    assert rep["cycles"] == [] and rep["edges"] == 1


def test_rlock_reentry_is_not_an_edge(witness):
    r = lw.make_rlock("re.lock")
    with r:
        with r:
            pass
    rep = lw.report()
    assert rep["cycles"] == [] and rep["edges"] == 0


def test_distinct_instances_same_class_nesting_flagged(witness):
    """Two PG locks share the name 'pg.lock' (lockdep keys by class);
    nesting two DIFFERENT instances is the two-PG-deadlock shape and
    must surface as a self-cycle."""
    p1, p2 = lw.make_lock("same.class"), lw.make_lock("same.class")
    with p1:
        with p2:
            pass
    keys = [c["key"] for c in lw.report()["cycles"]]
    assert "cycle:same.class|same.class" in keys


# -- blocking-under-lock -------------------------------------------------

def test_fsync_under_lock_flagged(witness, tmp_path):
    fd = os.open(str(tmp_path / "f"), os.O_CREAT | os.O_WRONLY)
    try:
        lock = lw.make_lock("store.meta")
        with lock:
            os.fsync(fd)
    finally:
        os.close(fd)
    rep = lw.report()
    assert any(v["kind"] == "fsync" and v["lock"] == "store.meta"
               for v in rep["blocking"])


def test_fsync_outside_lock_clean(witness, tmp_path):
    fd = os.open(str(tmp_path / "f"), os.O_CREAT | os.O_WRONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    assert lw.report()["blocking"] == []


@pytest.mark.parametrize("barrier", sorted(_barrier_calls()))
def test_device_barrier_under_lock_flagged(witness, barrier):
    """Each of the port's device waits under a lock is a
    ``device_barrier`` finding. Without a card the call raises after the
    hook recorded it (torch for the CPU has the classes, not the
    device)."""
    call = _barrier_calls()[barrier]
    with lw.make_lock("engine.window"):
        try:
            call()
        except (AssertionError, RuntimeError, TypeError):
            pass
    rep = lw.report()
    assert any(v["kind"] == "device_barrier"
               and v["lock"] == "engine.window"
               for v in rep["blocking"]), rep["blocking"]


def test_device_barrier_outside_lock_clean(witness):
    for call in _barrier_calls().values():
        try:
            call()
        except (AssertionError, RuntimeError, TypeError):
            pass
    assert lw.report()["blocking"] == []


def test_host_view_of_a_cpu_tensor_is_no_barrier(witness):
    """``backend.to_host`` of a CPU tensor is its own memory, no copy
    from the card: clean under a lock (the host twin's codecs take it
    under ``pg.lock``), while the same tensor through ``device_get`` is a
    finding, as the reference's hooked ``jax.device_get`` is on its CPU
    backend."""
    with lw.make_lock("pg.lock"):
        view = backend_mod.to_host(torch.arange(4))
    assert view.tolist() == [0, 1, 2, 3]
    assert lw.report()["blocking"] == []
    with lw.make_lock("pg.lock"):
        backend_mod.device_get(torch.arange(4))
    assert [(v["kind"], v["lock"]) for v in lw.report()["blocking"]] == \
        [("device_barrier", "pg.lock")]


def test_asok_roundtrip_under_lock_flagged(witness):
    from ceph_tpu_torch.utils.admin_socket import AdminSocket, asok_command
    asok = AdminSocket("witness-test")
    asok.start()
    try:
        with lw.make_lock("mgr.tick"):
            out = asok_command(asok.path, "help")
        assert isinstance(out, dict)
    finally:
        asok.stop()
    rep = lw.report()
    assert any(v["kind"] == "socket_send" and v["lock"] == "mgr.tick"
               for v in rep["blocking"])


def test_cond_wait_under_foreign_lock_flagged(witness):
    other = lw.make_lock("shutdown.gate")
    cv = lw.make_condition("engine.inflight")

    def scenario():
        with other:               # holding the shutdown lock while
            with cv:              # waiting on the engine's condition
                cv.wait(0.05)
    _run_bounded(scenario)
    rep = lw.report()
    assert any(v["kind"] == "cond_wait_under_lock"
               and v["lock"] == "shutdown.gate"
               for v in rep["blocking"])


def test_cond_wait_on_own_lock_only_is_clean(witness):
    cv = lw.make_condition("solo.cv")

    def scenario():
        with cv:
            cv.wait(0.05)
    _run_bounded(scenario)
    assert lw.report()["blocking"] == []


def test_cond_wait_for_wakes_and_checks(witness):
    cv = lw.make_condition("wf.cv")
    state = {"ready": False}

    def producer():
        time.sleep(0.05)
        with cv:
            state["ready"] = True
            cv.notify_all()

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    def scenario():
        with cv:
            assert cv.wait_for(lambda: state["ready"], timeout=5)
    _run_bounded(scenario)
    t.join(2)
    assert not t.is_alive()


# -- the same scenarios under both witnesses -----------------------------

def _abba(mod):
    a, b = _Daemon("alpha", mod), _Daemon("beta", mod)
    a.peer, b.peer = b, a
    a.tick()
    b.tick()


def _self_nest(mod):
    p1, p2 = mod.make_lock("same.class"), mod.make_lock("same.class")
    with p1:
        with p2:
            pass


def _fsync(mod, path):
    fd = os.open(path, os.O_CREAT | os.O_WRONLY)
    try:
        with mod.make_lock("store.meta"):
            os.fsync(fd)
    finally:
        os.close(fd)


def _foreign_wait(mod):
    other = mod.make_lock("shutdown.gate")
    cv = mod.make_condition("engine.inflight")
    with other:
        with cv:
            cv.wait(0.01)


def _host_copy(mod):
    """A copy from the device to the host under a lock: the reference's
    ``jax.device_get``, the port's ``backend.device_get``."""
    if mod is ref_lw:
        import jax
        import jax.numpy as jnp
        get, x = jax.device_get, jnp.arange(4)
    else:
        get, x = backend_mod.device_get, torch.arange(4)
    with mod.make_lock("engine.retire"):
        get(x)


SCENARIOS = {"abba": _abba, "self_nest": _self_nest, "fsync": _fsync,
             "foreign_wait": _foreign_wait, "host_copy": _host_copy}


def _keys(mod, scenario, tmp_path) -> tuple[list, list]:
    mod.enable()
    try:
        if scenario is _fsync:
            scenario(mod, str(tmp_path / f"f-{mod.__name__}"))
        else:
            scenario(mod)
        rep = mod.report()
    finally:
        mod.disable()
        mod.reset()
    return (sorted(c["key"] for c in rep["cycles"]),
            sorted(v["key"] for v in rep["blocking"]))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reports_equal_reference(name, tmp_path):
    """One scenario under the reference's witness, then under the
    port's: the same cycle keys and the same blocking keys."""
    if ref_lw.enabled():
        pytest.skip("the reference's witness is armed session-wide "
                    "by CEPH_TPU_LOCK_WITNESS")
    ref = _keys(ref_lw, SCENARIOS[name], tmp_path)
    port = _keys(lw, SCENARIOS[name], tmp_path)
    assert ref == port
    assert ref[0] or ref[1]


# -- timing mode ----------------------------------------------------------

@pytest.fixture
def tel():
    from ceph_tpu_torch.utils.dispatch_telemetry import telemetry
    telemetry().reset()
    yield telemetry()
    telemetry().reset()


def test_timed_lock_reports_wait_and_hold(timing, tel):
    lk = lw.make_lock("Timed::lock")
    assert isinstance(lk, lw._TimedLock)
    held = threading.Event()
    release = threading.Event()

    def holder():
        with lk:
            held.set()
            release.wait(5.0)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(5.0)
    acquired = threading.Event()

    def waiter():
        with lk:
            acquired.set()

    w = threading.Thread(target=waiter)
    w.start()
    time.sleep(0.02)
    release.set()
    t.join(5.0)
    w.join(5.0)
    assert acquired.is_set() and not t.is_alive() and not w.is_alive()
    row = tel.lock_table()["locks"]["Timed::lock"]
    assert row["waits"] >= 2          # both acquisitions counted
    assert row["hold_ms"] > 0.0 and row["wait_ms"] > 0.0


def test_timed_condition_reports_signal_to_wake(timing, tel):
    cv = lw.make_condition("Timed::cv")
    ready = threading.Event()
    woke = threading.Event()

    def waiter():
        with cv:
            ready.set()
            if cv.wait(5.0):
                woke.set()

    t = threading.Thread(target=waiter)
    t.start()
    assert ready.wait(5.0)
    with cv:
        cv.notify_all()
    t.join(5.0)
    assert woke.is_set()
    assert tel.perf.dump()["condvar_wakeups"] >= 1
    assert tel.lock_table()["locks"]["Timed::cv"]["cv_wakeups"] >= 1


@pytest.mark.parametrize("ctor", ["make_lock", "make_rlock"])
def test_witness_and_timing_compose_under_wait(witness, timing, tel, ctor):
    """A condition built over an already witnessed, timed lock (the
    engine's shape: ``make_condition(name, make_lock(...))``) keeps
    ``Condition.wait`` working: the timed proxy's ``_release_save`` /
    ``_acquire_restore`` unwind and restore the lock (an RLock's depth
    too), the held-set follows the wait, and the wait is timed."""
    lk = getattr(lw, ctor)("Both::lock")
    assert isinstance(lk, lw.WitnessLock)
    assert isinstance(lk._inner, lw._TimedLock)
    cv = lw.make_condition("Both::cv", lk)
    state = {"go": False}

    def producer():
        time.sleep(0.02)
        with lk:
            state["go"] = True
            cv.notify_all()

    def scenario():
        with lk:
            if ctor == "make_rlock":
                lk.acquire()           # depth 2 across the wait
            assert cv.wait_for(lambda: state["go"], timeout=5)
            assert lw._held() == [lk]
            if ctor == "make_rlock":
                lk.release()
        assert lw._held() == []

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    _run_bounded(scenario)
    t.join(2)
    assert not t.is_alive()
    assert lw.report()["blocking"] == []
    table = tel.lock_table()["locks"]
    assert table["Both::lock"]["waits"] >= 2
    # the witnessed condition over a timed lock times its wakeups too
    assert table["Both::cv"]["cv_wakeups"] >= 1


# -- timing mode under both witnesses ------------------------------------

def _t_contended(mod):
    lk = mod.make_lock("Timed::lock")
    held, release = threading.Event(), threading.Event()

    def holder():
        with lk:
            held.set()
            release.wait(5.0)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(5.0)
    w = threading.Thread(target=lambda: lk.acquire() and lk.release())
    w.start()
    time.sleep(0.02)
    release.set()
    t.join(5.0)
    w.join(5.0)


def _t_condvar(mod):
    cv = mod.make_condition("Timed::cv")
    ready = threading.Event()

    def waiter():
        with cv:
            ready.set()
            cv.wait(5.0)

    t = threading.Thread(target=waiter)
    t.start()
    assert ready.wait(5.0)
    with cv:
        cv.notify_all()
    t.join(5.0)


def _t_cv_over(ctor):
    def scenario(mod):
        lk = getattr(mod, ctor)("Both::lock")
        cv = mod.make_condition("Both::cv", lk)
        state = {"go": False}

        def producer():
            time.sleep(0.02)
            with lk:
                state["go"] = True
                cv.notify_all()

        t = threading.Thread(target=producer)
        t.start()
        with lk:
            cv.wait_for(lambda: state["go"], timeout=5)
        t.join(5.0)
    return scenario


TIMING = {"contended": (_t_contended, False),
          "condvar": (_t_condvar, False),
          "cv_over_lock": (_t_cv_over("make_lock"), True),
          "cv_over_rlock": (_t_cv_over("make_rlock"), True)}


def _timing_reports(mod, tel_mod, name, monkeypatch) -> dict:
    """Run one timing scenario under ``mod``'s timing mode (and its
    witness, where the scenario composes both) and return the lock
    names its telemetry was told a wait, a hold or a wakeup of."""
    scenario, witness = TIMING[name]
    seen = {"wait": set(), "hold": set(), "wakeup": set()}
    cls = tel_mod.DispatchTelemetry
    for kind, meth in (("wait", "note_lock_wait"),
                       ("hold", "note_lock_hold"),
                       ("wakeup", "note_condvar_wakeup")):
        def record(self, lock, value, _orig=getattr(cls, meth),
                   _kind=kind):
            seen[_kind].add(lock)
            return _orig(self, lock, value)
        monkeypatch.setattr(cls, meth, record)
    tel_mod.telemetry().reset()
    tel = tel_mod.telemetry()
    if witness:
        mod.enable()
    mod.enable_timing()
    try:
        _run_bounded(lambda: scenario(mod))
        table = tel.lock_table(top=64)["locks"]
        blocking = mod.report()["blocking"] if witness else []
    finally:
        mod.disable_timing()
        if witness:
            mod.disable()
            mod.reset()
        tel.reset()
    assert set(table) == set().union(*seen.values())
    assert blocking == []
    return seen


@pytest.mark.parametrize("name", sorted(TIMING))
def test_timing_reports_equal_reference(name, monkeypatch):
    """One timing scenario under the reference's timing mode and its
    ``dispatch`` telemetry, then under the port's: the same locks
    report waits and holds, and the same conditions report wakeups.

    One difference is deliberate: with both modes on, the port's
    witnessed condition over a timed lock times its wakeups, where the
    reference's reports none (its ``WitnessCondition`` waits on the bare
    condition). Phase 5h runs both modes, and reads those wakeups."""
    if ref_lw.enabled() or ref_lw.timing_enabled():
        pytest.skip("the reference's witness or timing is armed "
                    "session-wide from the environment")
    from ceph_tpu.utils import dispatch_telemetry as ref_tel
    from ceph_tpu_torch.utils import dispatch_telemetry as port_tel
    ref = _timing_reports(ref_lw, ref_tel, name, monkeypatch)
    port = _timing_reports(lw, port_tel, name, monkeypatch)
    assert ref["wait"] and ref["hold"]
    assert (ref["wait"], ref["hold"]) == (port["wait"], port["hold"])
    if TIMING[name][1]:
        assert ref["wakeup"] == set()
        assert port["wakeup"] == {"Both::cv"}
    else:
        assert ref["wakeup"] == port["wakeup"]
    if name == "condvar":
        assert ref["wakeup"] == {"Timed::cv"}


# -- fixed memory / report ----------------------------------------------

def test_edge_memory_is_capped(witness, monkeypatch):
    monkeypatch.setattr(lw, "MAX_EDGES", 4)
    anchor = lw.make_lock("cap.anchor")
    for i in range(10):
        child = lw.make_lock(f"cap.child{i}")
        with anchor:
            with child:
                pass
    rep = lw.report()
    assert rep["edges"] <= 4
    assert rep["edges_dropped"] > 0


def test_report_serializes_and_acks_filter(witness, tmp_path):
    a, b = _Daemon("ser.a"), _Daemon("ser.b")
    a.peer, b.peer = b, a
    a.tick()
    b.tick()
    path = str(tmp_path / "report.json")
    lw.save_report(path)
    with open(path) as f:
        rep = json.load(f)
    assert rep["cycles"] and rep["enabled"]
    key = rep["cycles"][0]["key"]
    acked = lw.unacknowledged(
        rep, {"witness": [{"key": key, "justification": "t"}]})
    assert key not in [u.get("key") for u in acked]


def test_witness_overhead_bounded(witness):
    """Proxy cost stays linear and small, as a paired ratio against a
    bare threading.Lock driven through the identical loop in the same
    scheduling weather, with a wide absolute ceiling as the runaway
    backstop."""
    def drive(lock) -> float:
        t0 = time.perf_counter()
        for _ in range(100_000):
            with lock:
                pass
        return time.perf_counter() - t0

    bare_s = drive(threading.Lock())
    witnessed_s = drive(lw.make_lock("bench.lock"))
    assert witnessed_s < 60.0 * max(bare_s, 1e-4), \
        f"witness overhead ratio blown: {witnessed_s:.3f}s vs " \
        f"bare {bare_s:.3f}s"
    assert witnessed_s < 20.0, \
        f"witnessed acquire runaway: {witnessed_s:.2f}s"


# -- the cluster gates ----------------------------------------------------

def _assert_clean(rep, what):
    assert rep["edges"] > 0, rep       # the gate isn't vacuous
    bad = lw.unacknowledged(rep)
    assert not bad, (
        f"unacknowledged witness findings on {what} (fix them or add a "
        "JUSTIFIED entry to ceph_tpu_torch/analysis/baseline.json "
        "'witness'): " + json.dumps(bad, indent=1)[:2000])


def _burst(cluster_cls, backend, **kw):
    def scenario():
        with cluster_cls(n_osds=3, **kw) as c:
            c.create_ec_pool("wit", k=2, m=1, backend=backend)
            ioctx = c.client().open_ioctx("wit")
            payload = bytes(range(256)) * 16
            for i in range(32):
                ioctx.write_full(f"obj-{i}", payload)
            for i in range(32):
                assert ioctx.read(f"obj-{i}") == payload
            c.wait_for_clean(timeout=30)
    return scenario


def test_minicluster_write_burst_clean(witness):
    """A full witness-enabled port MiniCluster scenario (boot, EC pool,
    write burst, reads, wait_for_clean, teardown) reports zero
    unacknowledged cycles and blocking findings; the reference's witness
    over the reference's cluster on the same scenario reports the same
    keys."""
    from ceph_tpu_torch.qa.cluster import MiniCluster

    _run_bounded(_burst(MiniCluster, "torch"), timeout=120.0)
    rep = lw.report()
    _assert_clean(rep, "the threaded burst")
    if ref_lw.enabled():
        return           # armed session-wide: not the port's to reset
    from ceph_tpu.qa.cluster import MiniCluster as RefCluster
    ref_lw.enable()
    try:
        _run_bounded(_burst(RefCluster, "jax"), timeout=120.0)
        ref = ref_lw.report()
    finally:
        ref_lw.disable()
        ref_lw.reset()
    assert sorted(c["key"] for c in rep["cycles"]) == \
        sorted(c["key"] for c in ref["cycles"])
    assert sorted(v["key"] for v in rep["blocking"]) == \
        sorted(v["key"] for v in ref["blocking"])


def test_minicluster_durable_group_commit_burst_clean(witness, tmp_path):
    """The witness-armed burst over the commit-path seams: a durable
    (blockstore) port cluster under a concurrent write burst drives the
    transaction groups, the deferred cross-PG barrier and the shared
    fsync rounds. Group commit must not fsync under a per-PG or store
    lock the op path also takes."""
    import concurrent.futures

    from ceph_tpu_torch.qa.cluster import MiniCluster

    def scenario():
        with MiniCluster(n_osds=3, store="blockstore",
                         data_dir=str(tmp_path / "wit")) as c:
            c.create_ec_pool("gwit", k=2, m=1, pg_num=4, backend="torch")
            ioctx = c.client().open_ioctx("gwit")
            payload = bytes(range(256)) * 8
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                list(pool.map(
                    lambda i: ioctx.write_full(f"g-{i}", payload),
                    range(32)))
            for i in range(32):
                assert ioctx.read(f"g-{i}") == payload
            c.wait_for_clean(timeout=30)

    _run_bounded(scenario, timeout=120.0)
    _assert_clean(lw.report(), "the group-commit paths")


def test_crimson_write_burst_clean(witness):
    """The witness armed over the crimson shard-per-core data path: the
    few cross-shard edges (map waiters, tid counter, sub-write batch
    fan-in) are witnessed ``make_lock`` sites and stay cycle-free, and
    nothing blocks under a lock the op path also takes."""
    import concurrent.futures

    from ceph_tpu_torch.qa.cluster import MiniCluster

    def scenario():
        with MiniCluster(n_osds=3, osd_flavor="crimson") as c:
            c.create_ec_pool("cwit", k=2, m=1, pg_num=4, backend="torch")
            ioctx = c.client().open_ioctx("cwit")
            payload = bytes(range(256)) * 8
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                list(pool.map(
                    lambda i: ioctx.write_full(f"c-{i}", payload),
                    range(32)))
            for i in range(32):
                assert ioctx.read(f"c-{i}") == payload
            c.wait_for_clean(timeout=30)

    _run_bounded(scenario, timeout=120.0)
    _assert_clean(lw.report(), "the crimson data path")


def test_witness_baseline_entries_are_justified():
    """No silent allowlisting: every acknowledged witness finding
    carries a written justification."""
    baseline = linters.load_baseline()
    assert baseline.get("witness")
    for ent in baseline["witness"]:
        assert ent.get("justification", "").strip(), ent
        assert not ent["justification"].startswith("TODO"), ent
