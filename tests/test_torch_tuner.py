"""The port's closed-loop tuner (``mgr/tuner.py``), its knobs
(``utils/knobs.py``), the engine's runtime observers and the deterministic
plant (``bench/tuner_sim.py``) against the reference's, on the CPU.

- The counterparts of ``tests/test_tuner.py`` (21 cases) and
  ``tests/test_tuner_scenario.py`` (5) on the port: scripted sensors, a
  scripted clock and a private ConfigProxy; the engine tests on the
  port's ``DeviceEncodeEngine``; the live-tuner MiniCluster with a
  ``backend="torch"`` pool.
- Across the packages (tolerance: equal): ``TUNER_KNOBS`` field for
  field; one scripted trace through both ``TunerEngine``s gives the same
  decision history; ``tuner_sim.comparison(seed=7, ticks_per_phase=80)``
  gives the same report; a 4-thread engine burst with ``engine_window``
  pushed 3 -> 1 -> 5 and ``engine_flush_bytes`` 64 MiB -> 1 MiB mid-burst
  stores the reference engine's shards and crcs, byte for byte.
- ``LiveSensors`` after a real write through a port cluster reports
  every sensor key, so a sensor whose source is missing fails here.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest

from ceph_tpu.bench import tuner_sim as ref_sim
from ceph_tpu.mgr import tuner as ref_tuner
from ceph_tpu.models import registry as ref_registry
from ceph_tpu.osd import device_engine as ref_de
from ceph_tpu.osd import ec_util as ref_ec
from ceph_tpu.utils import knobs as ref_knobs
from ceph_tpu.utils.config import SCHEMA as REF_SCHEMA
from ceph_tpu.utils.config import ConfigProxy as RefConfigProxy
from ceph_tpu.utils.config import g_conf as ref_conf
from ceph_tpu_torch.bench import tuner_sim
from ceph_tpu_torch.mgr.tuner import (
    DEFAULT_RULES,
    SENSOR_KEYS,
    LiveSensors,
    Module as TunerModule,
    ScriptedSensors,
    TunerEngine,
    _set_active,
    status_if_active,
)
from ceph_tpu_torch.models import from_reference_profile
from ceph_tpu_torch.osd.device_engine import DeviceEncodeEngine
from ceph_tpu_torch.osd.ec_util import StripeInfo
from ceph_tpu_torch.utils.config import SCHEMA, ConfigProxy, g_conf
from ceph_tpu_torch.utils.knobs import TUNER_KNOBS, Knob, KnobRegistry

BASE = {"p99_ms": 10.0, "mbps": 100.0, "hbm_live": 0,
        "hbm_limit": 1 << 30, "inflight": 3, "window": 3,
        "occupancy": 1, "flush_bytes_mean": 0, "health_rank": 0,
        "fault_events": 0, "mesh_slots": 0, "slot_staged": {}}

SATURATED = dict(BASE, inflight=3, window=3)          # window_grow
QUIET = dict(BASE, inflight=1)                        # nothing fires


def _engine(trace, conf=None, engine_cls=TunerEngine, schema=SCHEMA,
            proxy=ConfigProxy, **kw):
    conf = conf or proxy(schema)
    clock = [0.0]
    eng = engine_cls(ScriptedSensors(trace) if engine_cls is TunerEngine
                     else ref_tuner.ScriptedSensors(trace), conf=conf,
                     clock=lambda: clock[0], wall=lambda: clock[0],
                     publish_perf=False, **kw)
    return eng, conf, clock


def _run(eng, clock, ticks):
    out = []
    for _ in range(ticks):
        clock[0] += 1.0
        out.extend(eng.tick())
    return out


def _strip(hist):
    return [{k: v for k, v in d.items() if k != "trace_id"}
            for d in hist]


# -- knob mechanics ----------------------------------------------------

def test_knob_steps_clamp_and_quantize():
    conf = ConfigProxy(SCHEMA)
    w = TUNER_KNOBS.get("engine_window")
    assert w.up(3, conf) == 4 and w.down(3, conf) == 2
    assert w.down(1, conf) == 1 and w.up(16, conf) == 16   # clamped
    fb = TUNER_KNOBS.get("engine_flush_bytes")
    assert fb.up(1 << 20, conf) == 2 << 20
    assert fb.down(1 << 20, conf) == 1 << 20               # at lo
    assert isinstance(fb.up(1 << 20, conf), int)           # quantized
    hz = TUNER_KNOBS.get("profiler_hz")
    assert hz.up(50.0, conf) == 100.0                      # float knob


def test_knob_envelope_within_option_bounds():
    """Every declared knob's envelope sits inside its Option's hard
    min/max."""
    for knob in TUNER_KNOBS:
        opt = SCHEMA.get(knob.name)
        opt.coerce(knob.lo if opt.type is not int else int(knob.lo))
        opt.coerce(knob.hi if opt.type is not int else int(knob.hi))


def test_knobs_equal_field_for_field_across_packages():
    """The 11 knobs: same names, bounds, steps, step laws, cool-downs,
    subsystems and descriptions as the reference's, in the same order."""
    port = [dataclasses.asdict(k) for k in TUNER_KNOBS]
    ref = [dataclasses.asdict(k) for k in ref_knobs.TUNER_KNOBS]
    assert len(port) == 11
    assert port == ref


def test_push_lands_on_mon_layer_and_pins_win():
    conf = ConfigProxy(SCHEMA)
    val, landed = TUNER_KNOBS.push("engine_window", 7, conf)
    assert (val, landed) == (7, True)
    assert conf.source_of("engine_window") == "mon"
    conf.set("engine_window", 2, source="env")
    val, landed = TUNER_KNOBS.push("engine_window", 9, conf)
    assert not landed and conf["engine_window"] == 2
    detail = TUNER_KNOBS.vector_detail(conf)
    assert detail["engine_window"]["pinned"]
    assert detail["engine_flush_bytes"]["pinned"] is False


def test_duplicate_knob_rejected():
    reg = KnobRegistry([Knob("engine_window", 1, 8, 1, kind="add")])
    with pytest.raises(ValueError):
        reg.add(Knob("engine_window", 1, 8, 1, kind="add"))


# -- control discipline ------------------------------------------------

def test_hysteresis_one_tick_blip_moves_nothing():
    trace = [QUIET, SATURATED, QUIET, QUIET, QUIET, QUIET]
    eng, conf, clock = _engine(trace)
    _run(eng, clock, 6)
    assert conf["engine_window"] == SCHEMA.get(
        "engine_window").default
    assert eng.history_dump() == []


def test_step_then_cooldown_then_judgment():
    eng, conf, clock = _engine([SATURATED] * 20)
    decisions = _run(eng, clock, 8)
    kinds = [(d["kind"], d["t"]) for d in decisions]
    assert kinds[0] == ("step", 2.0)
    assert kinds[1] == ("confirm", 5.0)
    steps = [d for d in decisions if d["kind"] == "step"]
    assert all(b["t"] - a["t"] >= eng.cooldown_s
               for a, b in zip(steps, steps[1:]))
    for a, b in zip(decisions, decisions[1:]):
        if a["kind"] == "step":
            assert b["knob"] == a["knob"]


def test_revert_on_regression_within_one_cooldown():
    bad = dict(SATURATED, p99_ms=40.0)     # 4x p99, flat throughput
    eng, conf, clock = _engine([SATURATED] * 2 + [bad] * 20)
    decisions = _run(eng, clock, 12)
    step = next(d for d in decisions if d["kind"] == "step")
    revert = next(d for d in decisions if d["kind"] == "revert")
    assert revert["t"] - step["t"] <= eng.cooldown_s
    assert revert["knob"] == "engine_window"
    assert revert["from"] == step["to"]
    assert revert["to"] == step["from"]
    assert conf["engine_window"] == step["from"]
    assert revert["judge"]["d_p99_pct"] < -eng.threshold_pct
    later_steps = [d for d in decisions
                   if d["kind"] == "step" and d["t"] > revert["t"]
                   and d["knob"] == "engine_window"]
    assert all(d["t"] >= revert["t"] + 4 * eng.cooldown_s
               for d in later_steps)


def test_escalating_backoff_on_repeated_reverts():
    """Every consecutive revert of the same probe doubles the
    quarantine, against a plant whose p99 follows the knob."""
    conf = ConfigProxy(SCHEMA)

    class Responsive:
        def sample(self):
            w = conf["engine_window"]
            return dict(SATURATED,
                        p99_ms=10.0 if w <= 3 else 40.0)

    clock = [0.0]
    eng = TunerEngine(Responsive(), conf=conf,
                      clock=lambda: clock[0], wall=lambda: clock[0],
                      publish_perf=False)
    decisions = _run(eng, clock, 150)
    reverts = [d["t"] for d in decisions
               if d["kind"] == "revert"
               and d["knob"] == "engine_window"]
    assert len(reverts) >= 3
    assert conf["engine_window"] == 3
    gaps = [b - a for a, b in zip(reverts, reverts[1:])]
    assert all(b > a for a, b in zip(gaps, gaps[1:])), gaps


def test_pinned_knob_never_stepped():
    conf = ConfigProxy(SCHEMA)
    conf.set("engine_window", 3, source="env")     # operator pin
    eng, conf, clock = _engine([SATURATED] * 10, conf=conf)
    _run(eng, clock, 10)
    assert conf.source_of("engine_window") == "env"
    assert conf["engine_window"] == 3
    assert not any(d["kind"] == "step"
                   and d["knob"] == "engine_window"
                   for d in eng.history_dump())


def test_clamped_at_bound_counts_not_steps():
    conf = ConfigProxy(SCHEMA)
    conf.set("engine_window", 16)                  # knob hi
    eng, conf2, clock = _engine([SATURATED] * 8, conf=conf)
    _run(eng, clock, 8)
    assert conf["engine_window"] == 16 or \
        conf.source_of("engine_window") == "override"
    assert all(d["to"] != d["from"] for d in eng.history_dump()
               if d["kind"] == "step")


def test_determinism_same_trace_same_history():
    bad = dict(SATURATED, p99_ms=40.0, mbps=60.0)
    trace = [SATURATED] * 3 + [bad] * 10 + [QUIET] * 10
    eng1, _, c1 = _engine(trace)
    eng2, _, c2 = _engine(trace)
    _run(eng1, c1, 23)
    _run(eng2, c2, 23)
    assert _strip(eng1.history_dump()) == _strip(eng2.history_dump())
    assert eng1.history_dump() != []


#: scripted traces run through both packages' controllers
CROSS_TRACES = {
    "regression": [SATURATED] * 3 + [dict(SATURATED, p99_ms=40.0,
                                          mbps=60.0)] * 10 + [QUIET] * 10,
    "chaos": [dict(SATURATED, p99_ms=10.0 * (1 + (i * 7) % 5),
                   hbm_live=(i % 3) * (1 << 29), occupancy=(i * 3) % 8,
                   flush_bytes_mean=(i % 4) << 20, health_rank=i % 2,
                   fault_events=i // 5, read_skew=(i % 6) * 1.0,
                   cache_lookups=i, cache_hit_rate=(i % 10) / 10,
                   stream_batch_mean=(i % 5) * 8.0, mesh_slots=4,
                   slot_staged={0: 100 * (i % 7), 1: 30, 2: 40, 3: 30})
              for i in range(60)],
}


@pytest.mark.parametrize("name", sorted(CROSS_TRACES))
def test_scripted_trace_same_history_across_packages(name):
    """One scripted trace on the same scripted clock through the port's
    and the reference's TunerEngine: equal decision histories (all but
    each decision's trace id) and equal final knob vectors."""
    from ceph_tpu.parallel import placement as ref_placement
    from ceph_tpu_torch.parallel import placement
    trace = CROSS_TRACES[name]
    port, pconf, pclock = _engine(trace)
    ref, rconf, rclock = _engine(trace, engine_cls=ref_tuner.TunerEngine,
                                 schema=REF_SCHEMA, proxy=RefConfigProxy)
    try:
        _run(port, pclock, len(trace))
        _run(ref, rclock, len(trace))
        assert _strip(port.history_dump()) == _strip(ref.history_dump())
        assert port.history_dump() != []
        assert TUNER_KNOBS.vector(pconf) == \
            ref_knobs.TUNER_KNOBS.vector(rconf)
        assert placement.slot_weights() == ref_placement.slot_weights()
    finally:
        port.shutdown()
        ref.shutdown()


def test_mid_adjustment_kill_leaves_knobs_in_bounds():
    chaos = []
    for i in range(40):
        chaos.append(dict(SATURATED,
                          p99_ms=10.0 * (1 + (i * 7) % 5),
                          hbm_live=(i % 3) * (1 << 29),
                          occupancy=(i * 3) % 8,
                          health_rank=i % 2))
    eng, conf, clock = _engine(chaos)
    _run(eng, clock, 17)
    del eng
    for knob in TUNER_KNOBS:
        val = conf[knob.name]
        assert knob.lo <= val <= knob.hi, (knob.name, val)
        SCHEMA.get(knob.name).coerce(val)


# -- off = literal NOOP ------------------------------------------------

class _StubMgr:
    def __init__(self):
        self.modules = {}


def test_tuner_off_is_literal_noop(monkeypatch):
    from ceph_tpu_torch.utils.perf_counters import collection
    monkeypatch.delenv("CEPH_TPU_TUNER", raising=False)
    assert g_conf()["tuner_enabled"] is False      # default OFF
    collection().remove("tuner")                   # fresh view
    before_threads = {t.name for t in threading.enumerate()}
    before_diff = dict(g_conf().diff())
    mod = TunerModule(_StubMgr())
    mod.tick()
    assert mod.engine is None
    assert mod.TICK_PERIOD == 0.0                  # never ticked
    assert collection().get("tuner") is None       # zero counters
    assert dict(g_conf().diff()) == before_diff    # zero knob writes
    assert {t.name for t in threading.enumerate()} == before_threads
    code, msg, data = mod.handle_command({"prefix": "status"})
    assert code == 0 and b'"enabled": false' in data
    mod.shutdown()


def test_env_switch_enables(monkeypatch):
    from ceph_tpu_torch.mgr.tuner import tuner_on
    monkeypatch.delenv("CEPH_TPU_TUNER", raising=False)
    assert tuner_on() is False
    monkeypatch.setenv("CEPH_TPU_TUNER", "1")
    assert tuner_on() is True
    monkeypatch.setenv("CEPH_TPU_TUNER", "0")
    assert tuner_on() is False


# -- sensors -----------------------------------------------------------

def test_live_sensors_sample_shape():
    """A cold stack: every value numeric, nothing raises."""
    snap = LiveSensors().sample()
    assert isinstance(snap, dict)
    for key in ("p99_ms", "hbm_limit"):
        assert isinstance(snap.get(key, 0), (int, float))


def test_live_sensors_report_every_key_after_a_real_write():
    """After real writes and reads through a port cluster (client cache
    on, the flight recorder sampled around them), ``LiveSensors`` with a
    health source reports every key of ``SENSOR_KEYS``: a sensor whose
    source module went missing or was renamed would leave its key out
    (or raise) and fail here, not leave the tuner silently inert."""
    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.utils.flight_recorder import recorder
    conf = g_conf()
    saved = conf["client_cache"]
    conf.set("client_cache", True)
    try:
        with MiniCluster(n_osds=3) as cluster:
            cluster.create_ec_pool("ls", k=2, m=1, pg_num=4,
                                   backend="torch")
            io = cluster.client().open_ioctx("ls")
            recorder().sample(force=True)
            payload = bytes(range(256)) * 64
            for i in range(8):
                io.write_full(f"ls-{i}", payload)
            for i in range(8):
                assert io.read(f"ls-{i}") == payload
                assert io.read(f"ls-{i}") == payload
            recorder().sample(force=True)
            snap = LiveSensors(lambda: "HEALTH_OK").sample()
    finally:
        conf.set("client_cache", saved)
    missing = [k for k in SENSOR_KEYS if k not in snap]
    assert missing == [], (missing, snap)
    assert snap["mbps"] > 0 and snap["occupancy"] > 0
    assert snap["flush_bytes_mean"] > 0 and snap["cache_lookups"] > 0
    assert snap["health_rank"] == 0 and snap["read_skew"] >= 1.0


def test_rules_cover_every_knob_family():
    ruled = {r.knob for r in DEFAULT_RULES}
    for name in TUNER_KNOBS.names():
        assert name in ruled or name == "host_flush_bytes", name


# -- the actuator seam (runtime observers) -----------------------------

def test_engine_window_push_lands_via_observer(monkeypatch):
    monkeypatch.delenv("CEPH_TPU_ENGINE_WINDOW", raising=False)
    monkeypatch.delenv("CEPH_TPU_ENGINE_FLUSH_BYTES", raising=False)
    eng = DeviceEncodeEngine(lambda k, f: f())
    try:
        assert eng._window == g_conf()["engine_window"]
        g_conf().set("engine_window", 5, source="mon")
        assert eng._window == 5
        g_conf().set("engine_flush_bytes", 128 << 20, source="mon")
        assert eng._flush_bytes == 128 << 20
        assert eng._stager.seg_bytes == 128 << 20
        g_conf().set("mesh_flush_bytes", 2 << 20, source="mon")
        assert eng._mesh_flush_bytes == 2 << 20
        g_conf().set("host_flush_bytes", 256 << 10, source="mon")
        assert eng._host_flush_bytes == 256 << 10
    finally:
        eng.stop()
        g_conf().set_mon_layer({})
    # after stop the observers are detached: pushes no longer land
    g_conf().set("engine_window", 9, source="mon")
    try:
        assert eng._window == 5
    finally:
        g_conf().set_mon_layer({})


def test_engine_env_pin_freezes_knob(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_ENGINE_WINDOW", "2")
    eng = DeviceEncodeEngine(lambda k, f: f())
    try:
        assert eng._window == 2
        g_conf().set("engine_window", 8, source="mon")
        assert eng._window == 2                    # pinned
    finally:
        eng.stop()
        g_conf().set_mon_layer({})


def test_engine_argument_pins_and_conf_resolves(monkeypatch):
    """Resolution order argument > env > g_conf > default: an argument
    pins (no observer), an unpinned knob starts at the g_conf value."""
    for env in ("CEPH_TPU_ENGINE_WINDOW", "CEPH_TPU_ENGINE_FLUSH_BYTES",
                "CEPH_TPU_HOST_FLUSH_BYTES", "CEPH_TPU_MESH_FLUSH_BYTES"):
        monkeypatch.delenv(env, raising=False)
    g_conf().set("engine_flush_bytes", 8 << 20, source="mon")
    monkeypatch.setenv("CEPH_TPU_ENGINE_WINDOW", "4")
    eng = DeviceEncodeEngine(lambda k, f: f(), host_flush_bytes=1 << 10)
    try:
        assert eng._flush_bytes == 8 << 20         # g_conf
        assert eng._window == 4                    # env
        assert eng._host_flush_bytes == 1 << 10    # argument
        assert eng._knob_unpinned == {
            "engine_flush_bytes": True, "engine_window": False,
            "mesh_flush_bytes": True, "host_flush_bytes": False}
        g_conf().set("host_flush_bytes", 64 << 10, source="mon")
        assert eng._host_flush_bytes == 1 << 10
        assert [o for o, _ in eng._cfg_observers] == [
            "engine_flush_bytes", "mesh_flush_bytes"]
    finally:
        eng.stop()
        g_conf().set_mon_layer({})
    assert eng._cfg_observers == []


CHUNK = 1024
N_OPS = 64
PRODUCERS = 4
#: engine_window 3 -> 1 -> 5 and engine_flush_bytes 64 MiB -> 1 MiB,
#: pushed through the mon layer between staging rounds
KNOB_PUSHES = ((), (("engine_window", 1),),
               (("engine_flush_bytes", 1 << 20),), (("engine_window", 5),))


def _pushed_burst(engine_cls, conf, codec, sinfo, ops):
    """Stage ``ops`` in one round per ``KNOB_PUSHES`` entry from
    PRODUCERS threads (thread t: the round's ops t, t+4, ... under key
    pg<t>), applying the round's pushes to ``conf``'s mon layer first,
    while the earlier rounds' flushes are in flight. Returns
    ({op: (shards, crcs, err)}, {key: order}, stats, final knobs)."""
    eng = engine_cls(lambda key, fn: fn())
    out: dict = {}
    order = {t: [] for t in range(PRODUCERS)}
    lock, done = threading.Lock(), threading.Event()
    per_round = len(ops) // len(KNOB_PUSHES)
    try:
        for r, push in enumerate(KNOB_PUSHES):
            for option, value in push:
                conf.set(option, value, source="mon")
            idx = range(r * per_round, (r + 1) * per_round)

            def producer(t, idx=idx):
                for i in idx[t::PRODUCERS]:
                    def cont(s, c, e, i=i):
                        with lock:
                            out[i] = (s, c, e)
                            order[t].append(i)
                            if len(out) == len(ops):
                                done.set()
                    eng.stage_encode(f"pg{t}", codec, sinfo, ops[i], cont)
            threads = [threading.Thread(target=producer, args=(t,))
                       for t in range(PRODUCERS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        assert done.wait(300), len(out)
        knobs = (eng._window, eng._flush_bytes)
    finally:
        eng.stop()
        conf.set_mon_layer({})
    return out, order, dict(eng.stats), knobs


def test_pushed_burst_matches_reference_engine(monkeypatch):
    """4 producer threads, 64 ops of 1-8 stripes of 8 x 1 KiB, with
    ``engine_window`` pushed 3 -> 1 -> 5 and ``engine_flush_bytes``
    64 MiB -> 1 MiB between rounds through each package's mon layer:
    every op's shards and linear crcs from the port's engine equal the
    reference engine's (tolerance 0), each key's continuations come in
    staging order, and both engines end at the pushed values."""
    for env in ("CEPH_TPU_ENGINE_WINDOW", "CEPH_TPU_ENGINE_FLUSH_BYTES",
                "CEPH_TPU_HOST_FLUSH_BYTES"):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setenv("CEPH_TPU_FUSE_CRC", "1")
    # flushes stay on the device route, not the small-flush host one;
    # set on the mon layer, which the burst and the finally below clear,
    # so no override outlives the test in either process-wide config
    for conf in (g_conf(), ref_conf()):
        conf.set("host_flush_bytes", 0, source="mon")
    try:
        ref = ref_registry.instance().factory(
            "isa", {"plugin": "isa", "k": "8", "m": "3",
                    "backend": "jax"})
        port = from_reference_profile(ref.get_profile(), ref.coding_matrix,
                                      device="cpu")
        sinfo = StripeInfo(stripe_width=8 * CHUNK, chunk_size=CHUNK)
        ref_sinfo = ref_ec.StripeInfo(stripe_width=8 * CHUNK,
                                      chunk_size=CHUNK)
        rng = np.random.default_rng(15)
        ops = [rng.integers(0, 256, int(s) * 8 * CHUNK, dtype=np.uint8)
               for s in rng.integers(1, 9, N_OPS)]
        got, order, stats, knobs = _pushed_burst(
            DeviceEncodeEngine, g_conf(), port, sinfo, ops)
        want, ref_order, ref_stats, ref_knobs_ = _pushed_burst(
            ref_de.DeviceEncodeEngine, ref_conf(), ref, ref_sinfo, ops)
    finally:
        for conf in (g_conf(), ref_conf()):
            conf.set_mon_layer({})
    assert knobs == ref_knobs_ == (5, 1 << 20)
    for t in range(PRODUCERS):
        assert order[t] == ref_order[t]
    for i in range(N_OPS):
        shards, crcs, err = got[i]
        rshards, rcrcs, rerr = want[i]
        assert err is None and rerr is None, (i, err, rerr)
        assert crcs is not None and crcs == rcrcs, i
        for pos in range(11):
            assert np.array_equal(np.asarray(shards[pos]),
                                  np.asarray(rshards[pos])), (i, pos)
    assert stats["errors"] == ref_stats["errors"] == 0
    assert stats["ops"] == ref_stats["ops"] == N_OPS
    assert stats["host_flushes"] == 0
    assert stats["window_slot_flushes"]


# -- placement weighting ----------------------------------------------

def test_weights_rule_publishes_and_clears():
    from ceph_tpu_torch.parallel import placement
    placement.set_slot_weights(None)
    hot = dict(BASE, mesh_slots=4,
               slot_staged={0: 900, 1: 30, 2: 40, 3: 30})
    balanced = dict(BASE, mesh_slots=4,
                    slot_staged={0: 25, 1: 25, 2: 25, 3: 25})
    eng, conf, clock = _engine([hot] * 4 + [balanced] * 4)
    try:
        _run(eng, clock, 4)
        weights = placement.slot_weights()
        assert weights is not None
        assert weights[0] < min(weights[s] for s in (1, 2, 3))
        kinds = [d["kind"] for d in eng.history_dump()]
        assert "weights" in kinds
        _run(eng, clock, 4)
        assert placement.slot_weights() is None    # back to uniform
    finally:
        eng.shutdown()
        placement.set_slot_weights(None)


def test_shutdown_clears_weights():
    from ceph_tpu_torch.parallel import placement
    hot = dict(BASE, mesh_slots=2, slot_staged={0: 1000, 1: 10})
    eng, conf, clock = _engine([hot] * 4)
    _run(eng, clock, 3)
    assert placement.slot_weights() is not None
    eng.shutdown()
    assert placement.slot_weights() is None


# -- the bundle / status surface ---------------------------------------

def test_status_and_bundle_surface():
    bad = dict(SATURATED, p99_ms=40.0)
    eng, conf, clock = _engine([SATURATED] * 2 + [bad] * 10)
    _run(eng, clock, 8)
    st = eng.status()
    assert st["enabled"] and st["decisions"] >= 2
    assert set(st["knobs"]) == set(TUNER_KNOBS.names())
    _set_active(eng)
    try:
        brief = status_if_active()
        assert brief is not None
        assert any(d["kind"] == "revert" for d in brief["history"])
    finally:
        _set_active(None)
    assert status_if_active() is None


# -- the scenario (tests/test_tuner_scenario.py) ------------------------

def test_tuned_beats_every_fixed_config():
    report = tuner_sim.comparison(seed=7, ticks_per_phase=80)
    assert report["tuned_beats_all"], report["verdicts"]
    for name, v in report["verdicts"].items():
        assert v["tuned_worst_p99_ms"] < v["fixed_worst_p99_ms"], \
            (name, v)
        assert v["tuned_served_frac"] >= 0.98 * \
            v["fixed_served_frac"], (name, v)
    tuned = report["runs"]["tuned"]
    assert tuned["decisions"] > 0
    assert "step" in tuned["decision_kinds"]


def test_tuner_sim_comparison_equals_reference():
    """The whole tuned-vs-fixed report (every run's phases, knobs and
    decision kinds, every verdict) equals the reference's."""
    port = tuner_sim.comparison(seed=7, ticks_per_phase=80)
    ref = ref_sim.comparison(seed=7, ticks_per_phase=80)
    assert json.dumps(port, sort_keys=True, default=str) == \
        json.dumps(ref, sort_keys=True, default=str)


def test_sim_is_deterministic():
    a = tuner_sim.run_sim(7, 40)
    b = tuner_sim.run_sim(7, 40)

    def strip(run):
        return {"phases": run["phases"],
                "knobs_final": run["knobs_final"],
                "kinds": [(d["t"], d["kind"], d.get("knob"),
                           d.get("from"), d.get("to"))
                          for d in run.get("history", ())]}

    assert strip(a) == strip(b)
    c = tuner_sim.run_sim(11, 40)
    assert c["phases"].keys() == a["phases"].keys()


def test_fixed_configs_cover_each_phase_optimum():
    opts = {(p["opt_window"], p["opt_fb"])
            for p in tuner_sim.PHASE_PARAMS.values()}
    fixed = {(v["engine_window"], v["engine_flush_bytes"])
             for v in tuner_sim.FIXED_CONFIGS.values()}
    assert opts <= fixed


def test_revert_acceptance_chain():
    """Scripted regression -> revert within one cool-down -> the
    decision is in tuner history, the trace archive, the health bundle
    and the autopsy tail."""
    from ceph_tpu_torch.mgr import trace as trace_mod
    from ceph_tpu_torch.mgr.health import HealthEngine
    from ceph_tpu_torch.utils import autopsy
    from ceph_tpu_torch.utils.tracing import tracer

    bad = dict(BASE, p99_ms=45.0)
    conf = ConfigProxy(SCHEMA)
    clock = [0.0]
    eng = TunerEngine(ScriptedSensors([BASE] * 2 + [bad] * 20),
                      conf=conf, clock=lambda: clock[0],
                      publish_perf=False)
    step_t = revert_rec = None
    for _ in range(10):
        clock[0] += 1.0
        for d in eng.tick():
            if d["kind"] == "step" and step_t is None:
                step_t = d["t"]
            if d["kind"] == "revert" and revert_rec is None:
                revert_rec = d
    assert revert_rec is not None
    assert revert_rec["t"] - step_t <= eng.cooldown_s
    assert any(d["kind"] == "revert" and d["seq"] == revert_rec["seq"]
               for d in eng.history_dump())
    tid = revert_rec["trace_id"]
    assert tid and tracer().is_kept(tid)
    assert tracer().keep_reason(tid) == "forced"

    class _TraceStubMgr:
        modules: dict = {}

    tmod = trace_mod.Module(_TraceStubMgr())
    tmod.pull_now()
    archived = tmod.archive.get(tid)
    assert archived is not None
    assert archived["root"] == "tuner_revert"
    _set_active(eng)
    try:
        bundle = HealthEngine(rec=None, publish_perf=False,
                              bundle_on_err=False).dump_diagnostics()
        assert "tuner" in bundle
        assert any(d["kind"] == "revert"
                   for d in bundle["tuner"]["history"])
        store = autopsy.store()
        entry = store.record({"trace_id": "t-x", "reason": "slow",
                              "root": "write(x)", "spans": []})
        assert any(d["kind"] == "revert"
                   for d in entry["tuner_decisions"])
    finally:
        _set_active(None)


def test_minicluster_mgr_runs_live_tuner(monkeypatch):
    """A port mgr with the tuner module enabled drives LiveSensors
    against the real stack over a ``backend=torch`` pool: knobs stay in
    bounds, the asok surface answers, and stopping the mgr releases the
    actuators."""
    from ceph_tpu_torch.mgr.tuner import active_tuner
    from ceph_tpu_torch.parallel import placement
    from ceph_tpu_torch.qa.cluster import MiniCluster

    monkeypatch.setenv("CEPH_TPU_TUNER", "1")
    try:
        with MiniCluster(n_osds=3) as cluster:
            cluster.create_ec_pool("tn", k=2, m=1, pg_num=8,
                                   backend="torch")
            io = cluster.client().open_ioctx("tn")
            mgr = cluster.start_mgr(modules=("health", "tuner"))
            payload = bytes(range(256)) * 64
            for i in range(12):
                io.write_full(f"tn-{i}", payload)
            for i in range(12):
                assert io.read(f"tn-{i}") == payload
            tuner_mod = mgr.modules["tuner"]
            assert tuner_mod.engine is not None
            for _ in range(4):
                tuner_mod.tick()
            code, _msg, data = tuner_mod.handle_command(
                {"prefix": "status"})
            st = json.loads(data)
            assert code == 0 and st["enabled"]
            for name, ent in st["knobs"].items():
                knob = TUNER_KNOBS.get(name)
                assert knob.lo <= ent["value"] <= knob.hi, ent
            code, _msg, data = tuner_mod.handle_command(
                {"prefix": "history"})
            assert code == 0
    finally:
        g_conf().set_mon_layer({})
    assert active_tuner() is None
    assert placement.slot_weights() is None
