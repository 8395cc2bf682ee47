"""The port's own spans and counters (``utils/tracepoints.py`` spans, the
``BoundedLRU`` counters, the device telemetry's set-up table and
calibrations) and the benchmark's readers of them
(``ecbench/program_trace.py``, ``ecbench/metrics/``).

On the CPU:

- spans off record nothing and make no CUDA event; on while the provider
  is enabled, while a ``device_trace`` session is open, or under a live
  ``torch.profiler`` session; parents, call ids and phases; the bounded
  store and ``spans_dropped``; span times on a profiler trace's axis;
  ``device_trace`` writing ``ceph_span`` events; the spans of the fused
  flush step, the flush's upload and transpose, Clay's encoder and repair
  product and the block-sparse plan lookup;
- ``BoundedLRU``'s hits, misses and evictions by cache in ``device perf
  dump``; the set-up table; Clay's linearized-transform counters and the
  calibration records against the reference's, on the same scenario;
- each new reader on a made-up trace with made-up spans, and None where
  the program keeps no spans or dropped one.

Marked ``cuda`` (skip without a card; this file imports no JAX, so it runs
on the card's machine with ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_program_trace.py -m cuda``): spans
recorded under a session of CUDA activity alone, every B1 and B2 launch
inside its ``ec.b1`` / ``ec.b2`` span once aligned, the step's phases
summing to its device time within 5%, and the repair calibrations in
``device perf dump`` and the dashboard.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu_torch.models import instance
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.utils import lru, tracepoints
from ceph_tpu_torch.utils.device_telemetry import telemetry

ROOT = Path(__file__).resolve().parents[1]
METRICS = ROOT / "ecbench" / "metrics"


@pytest.fixture(autouse=True)
def _empty_store():
    tracepoints.clear_spans()
    yield
    tracepoints.clear_spans()


@pytest.fixture
def armed():
    """Enable providers for a test, disabled again after it."""
    provs = []

    def arm(*names):
        for name in names:
            prov = tracepoints.provider(name)
            prov.enable()
            provs.append(prov)
    yield arm
    for prov in provs:
        prov.disable()


def _names(recs):
    return [r["span"] for r in recs]


# -- recording -------------------------------------------------------------

class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        _FakeEvent.made += 1

    def record(self, stream=None):
        return None

    def synchronize(self):
        return None

    def elapsed_time(self, other):
        return 0.25


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA up as far as a span can tell, with events that count."""
    _FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(tracepoints, "_current_stream", lambda: None)
    monkeypatch.setattr(tracepoints, "_free_events", [])
    return _FakeEvent


def test_spans_off_record_nothing_and_make_no_event(fake_cuda):
    prov = tracepoints.provider("test_pt_off")
    root, kid = prov.span("root", device=True), prov.span("kid", device=True)
    step = root()
    assert step is root() and not prov.enabled
    with step:
        step.phase(kid)
        with kid():
            pass
    with pytest.raises(KeyError):
        with root():
            raise KeyError("through")
    assert tracepoints.dump_spans() == [] and fake_cuda.made == 0
    assert tracepoints.spans_dropped() == 0


def test_enabled_provider_records_parents_calls_and_events(fake_cuda,
                                                           armed):
    armed("test_pt_on")
    prov = tracepoints.provider("test_pt_on")
    root = prov.span("root", device=True)
    host = prov.span("host")
    other = tracepoints.provider("test_pt_other").span("leaf")
    for _ in range(2):
        with root({"route": "x"}):
            with host():
                with other():       # a provider not enabled: follows its root
                    pass
    recs = tracepoints.dump_spans()
    assert sorted(_names(recs)) == sorted(
        ["test_pt_on.root", "test_pt_on.host", "test_pt_other.leaf"] * 2)
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    assert len(roots) == 2 and roots[0]["call"] != roots[1]["call"]
    for r in recs:
        top = r
        while top["parent"] is not None:
            top = by_id[top["parent"]]
        assert r["call"] == top["call"] == top["id"]
        assert r["start_ns"] <= r["end_ns"]
        assert r["host_us"] == (r["end_ns"] - r["start_ns"]) / 1e3
    leaf = next(r for r in recs if r["span"] == "test_pt_other.leaf")
    assert by_id[leaf["parent"]]["span"] == "test_pt_on.host"
    assert roots[0]["route"] == "x" and roots[0]["device_us"] == 250.0
    assert "device_us" not in leaf
    # two events a device span, none for the host-only ones; cleared
    # spans give theirs back for the next ones
    assert fake_cuda.made == 4
    tracepoints.clear_spans()
    with root():
        pass
    assert fake_cuda.made == 4 and len(tracepoints._free_events) == 2


def test_phases_tile_their_span(armed):
    armed("test_pt_phase")
    prov = tracepoints.provider("test_pt_phase")
    root, a, b = prov.span("root"), prov.span("a"), prov.span("b")
    inner = prov.span("inner")
    step = root()
    with step:
        step.phase(a)
        with inner():
            pass
        step.phase(b, {"n": 3})
    recs = {r["span"]: r for r in tracepoints.dump_spans()}
    r, pa, pb = (recs[f"test_pt_phase.{n}"] for n in ("root", "a", "b"))
    assert pa["parent"] == pb["parent"] == r["id"]
    assert recs["test_pt_phase.inner"]["parent"] == pa["id"]
    assert r["start_ns"] == pa["start_ns"] and pa["end_ns"] == pb["start_ns"]
    assert pb["end_ns"] == r["end_ns"] and pb["n"] == 3


def test_profiler_session_and_device_trace_arm_the_spans(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    point = tracepoints.provider("test_pt_prof").span("s")
    with profile(activities=[ProfilerActivity.CPU]):
        with point():
            pass
    with point():
        pass                                  # session over: off again
    assert _names(tracepoints.dump_spans()) == ["test_pt_prof.s"]
    tracepoints.clear_spans()
    with tracepoints.device_trace(str(tmp_path), device="cpu") as trace:
        with point():
            torch.ones(8).sum()
    with point():
        pass
    assert tracepoints.dump_spans() == []     # moved into the trace
    doc = json.loads(Path(trace.path).read_text())
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "ceph_span"]
    assert [e["name"] for e in spans] == ["test_pt_prof.s"]
    ops = [e for e in doc["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    span = spans[0]
    assert span["args"]["parent"] is None and span["args"]["call"]
    assert any(span["ts"] - 5 <= e["ts"] and
               e["ts"] + e["dur"] <= span["ts"] + span["dur"] + 5
               for e in ops)


def test_span_times_land_on_the_trace_axis(tmp_path):
    """Each span holds, within 5 us, the ``record_function`` it wraps in
    a CPU profiler trace, once moved by :func:`trace_base_ns`."""
    from torch.profiler import ProfilerActivity, profile, record_function
    point = tracepoints.provider("test_pt_axis").span("s")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with point({"i": i}):
                with record_function(f"axis{i}"):
                    torch.ones(16).sum()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = tracepoints.trace_base_ns()
    assert base == int(doc["baseTimeNanoseconds"])
    marks = {e["name"]: e for e in doc["traceEvents"]
             if str(e.get("name", "")).startswith("axis")}
    for rec in tracepoints.dump_spans():
        ev = marks[f"axis{rec['i']}"]
        lo = (rec["start_ns"] - base) / 1e3
        hi = (rec["end_ns"] - base) / 1e3
        assert lo - 5 <= ev["ts"] and ev["ts"] + ev["dur"] <= hi + 5, rec


def test_the_store_is_bounded_and_counts_drops(armed, monkeypatch):
    armed("test_pt_bound")
    monkeypatch.setattr(tracepoints, "SPAN_STORE_SIZE", 5)
    point = tracepoints.provider("test_pt_bound").span("s")
    for _ in range(8):
        with point():
            pass
    assert len(tracepoints.dump_spans()) == 5
    assert tracepoints.spans_dropped() == 3
    tracepoints.clear_spans()
    assert tracepoints.dump_spans() == [] and tracepoints.spans_dropped() == 0


def test_dump_holds_points_then_spans_in_time_order(armed):
    armed("test_pt_dump")
    prov = tracepoints.provider("test_pt_dump")
    pt, sp = prov.point("p", "x"), prov.span("s")
    pt(1)
    with sp():
        pass
    pt(2)
    dump = prov.dump()
    assert [e.get("point", e.get("span")) for e in dump] == [
        "test_pt_dump:p", "test_pt_dump.s", "test_pt_dump:p"]
    assert all(isinstance(e["ts"], float) for e in dump)
    assert dump[0]["ts"] <= dump[1]["ts"] <= dump[2]["ts"] < time.time() + 1
    assert prov.dump(limit=1)[0]["x"] == 2
    prov.clear()
    assert prov.dump() == [] and tracepoints.dump_spans() == []


# -- the spans where the work happens ---------------------------------------

def _rs(device="cpu"):
    return instance().factory("isa", {"k": "8", "m": "3",
                                      "technique": "reed_sol_van"},
                              device=device)


def test_fused_flush_spans(armed):
    """The flush's upload and transpose, then the step and its four
    phases in order; the step's result is unchanged by the spans."""
    armed("ec")
    codec = _rs()
    sinfo = ec_util.StripeInfo(8 * 4096, 4096)
    rng = np.random.default_rng(5)
    bufs = [rng.integers(0, 256, 2 * sinfo.stripe_width, dtype=np.uint8)
            for _ in range(3)]
    fin = ec_util._flush_device_fused_async(sinfo, codec, [0, 1, 2], bufs)
    traced = fin()
    tracepoints.provider("ec").disable()
    plain = ec_util._flush_device_fused_async(sinfo, codec, [0, 1, 2],
                                              bufs)()
    for (_, s1, c1), (_, s2, c2) in zip(traced, plain):
        assert c1 == c2 and all(np.array_equal(s1[i], s2[i]) for i in s1)
    recs = tracepoints.dump_spans()
    assert sorted(_names(recs)) == sorted(
        ["ec.upload", "ec.transpose", "ec.fused_step", "ec.b1",
         "ec.segments", "ec.b2", "ec.crc_combine"])
    step = next(r for r in recs if r["span"] == "ec.fused_step")
    phases = sorted((r for r in recs if r["parent"] == step["id"]),
                    key=lambda r: r["start_ns"])
    assert _names(phases) == ["ec.b1", "ec.segments", "ec.b2",
                              "ec.crc_combine"]
    assert all(a["end_ns"] == b["start_ns"]
               for a, b in zip(phases, phases[1:]))


def test_clay_spans_route_and_plan_lookup(armed, monkeypatch):
    from ceph_tpu_torch.models import clay_device
    armed("clay")
    codec = instance().factory("clay", {"k": "4", "m": "2", "d": "5"},
                               device="cpu")
    enc = codec._encode_fn()
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, codec.sub_chunk_no, 64), dtype=np.uint8))
    enc(x)
    monkeypatch.setenv("CEPH_TPU_CLAY_SPARSE", "always")
    helpers = tuple(sorted(codec.minimum_to_decode(
        [1], [c for c in range(6) if c != 1])))
    mat = codec._repair_matrix(1, helpers)
    fn = clay_device.build_decode_matvec(codec, mat, label="repair")
    fn(torch.zeros((mat.shape[1], 64), dtype=torch.uint8))
    recs = tracepoints.dump_spans()
    assert sorted(_names(recs)) == ["bsparse.plan_lookup", "clay.encode",
                                    "clay.repair_product"]
    prod = next(r for r in recs if r["span"] == "clay.repair_product")
    look = next(r for r in recs if r["span"] == "bsparse.plan_lookup")
    assert prod["route"] == "sparse" == fn.path
    assert look["parent"] == prod["id"] and look["call"] == prod["call"]


# -- counters ----------------------------------------------------------------

def test_bounded_lru_counts_by_cache_name():
    a = lru.BoundedLRU(2, "test_pt.cache")
    b = lru.BoundedLRU(4, "test_pt.cache")
    for key in (1, 2, 1, 3, 4):
        a.get_or_build(key, lambda key=key: key * 10)
    b.put("x", 1)
    b.get_or_build("x", lambda: 2)
    assert (a.hits, a.misses, a.evictions) == (1, 4, 2)
    row = telemetry().snapshot()["caches"]["test_pt.cache"]
    assert row == {"caches": 2, "size": 3, "hits": 2, "misses": 4,
                   "evictions": 2}
    del a, b
    import gc
    gc.collect()
    assert "test_pt.cache" not in lru.cache_stats()


def test_setup_table_and_encode_tables():
    from ceph_tpu_torch.models import clay_device
    before = telemetry().setup_seconds().get("b3_tables", {"count": 0})
    codec = instance().factory("clay", {"k": "4", "m": "2", "d": "5"},
                               device="cpu")
    clay_device.build_encode_kernel(codec)
    after = telemetry().snapshot()["setup_seconds"]["b3_tables"]
    assert after["count"] == before["count"] + 1 and after["seconds"] > 0
    telemetry().note_setup("test_pt_phase", 0.5)
    telemetry().note_setup("test_pt_phase", 0.25)
    assert telemetry().setup_seconds()["test_pt_phase"] == {
        "seconds": 0.75, "count": 2}


def _lin_scenario(factory, counters):
    codec = factory("clay", {"k": "4", "m": "2", "backend": "numpy"})
    rng = np.random.default_rng(1)
    size = codec.sub_chunk_no * 8
    chunks = {i: rng.integers(0, 256, size, dtype=np.uint8)
              for i in range(6)}
    enc = codec.encode_chunks(list(range(6)),
                              {i: chunks[i] for i in range(4)})
    got = {i: (chunks[i] if i < 4 else enc[i]) for i in range(6) if i != 1}
    steps = [counters()]
    for _ in range(2):
        codec.decode_chunks([1], got)
        steps.append(counters())
    keys = ("lin_matvec_hits", "lin_matvec_misses")
    return [{k: b[k] - a[k] for k in keys} for a, b in zip(steps, steps[1:])]


def test_lin_matvec_counters_equal_reference():
    """Clay's linearized-transform LRU counts a decode's miss and then
    its repeat's hit as the reference's does."""
    from ceph_tpu.models import registry as ref_registry
    from ceph_tpu.utils.device_telemetry import telemetry as ref_tel

    def port_factory(plugin, profile):
        return instance().factory(plugin, profile, device="cpu")

    port = _lin_scenario(port_factory,
                         lambda: telemetry().perf.dump())
    ref = _lin_scenario(ref_registry.instance().factory,
                        lambda: ref_tel().perf.dump())
    assert port == ref
    assert port[0]["lin_matvec_misses"] > 0 and port[1]["lin_matvec_hits"] > 0


def test_calibration_record_equals_reference(monkeypatch):
    """A CPU codec's skipped calibration lands in ``calibrations`` under
    the reference's signature key and winner, and the dashboard's row
    source (``snapshot()["calibrations"]``) carries it."""
    from ceph_tpu.models import registry as ref_registry
    from ceph_tpu.models.clay_device import \
        build_decode_matvec as ref_build
    from ceph_tpu.utils.device_telemetry import telemetry as ref_tel
    from ceph_tpu_torch.models.clay_device import build_decode_matvec
    monkeypatch.delenv("CEPH_TPU_CLAY_SPARSE", raising=False)
    prof = {"k": "4", "m": "2", "backend": "numpy"}
    port_c = instance().factory("clay", prof, device="cpu")
    ref_c = ref_registry.instance().factory("clay", prof)
    mat = port_c._decode_matrix((2, 3, 4, 5), (0, 1))
    assert np.array_equal(mat, ref_c._decode_matrix((2, 3, 4, 5), (0, 1)))
    fn = build_decode_matvec(port_c, mat, label="test_pt_cal")
    ref_fn = ref_build(ref_c, mat, label="test_pt_cal")
    assert fn.path == ref_fn.path == "dense"

    def rows(tel):
        return {s: v for s, v in tel.snapshot()["calibrations"].items()
                if s.startswith("test_pt_cal|")}
    assert rows(telemetry()) == rows(ref_tel())
    assert rows(telemetry()) and fn.measured["skipped"] is True


# -- the readers -------------------------------------------------------------

def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


#: trace base of the made-up spans, ns
BASE = 1_000_000_000_000


def _made_up(monkeypatch, dropped=0):
    """Two steps in a 1000-1600 us window: step 1 on the host 1000-1200
    us, step 2 1300-1500 us; the card busy 1050-1250 and 1350-1450."""
    from ecbench import trace
    events = [
        _ev("cuda_runtime", "cudaDeviceSynchronize", 900.0, 100.0),
        _ev("kernel", "gf_matvec_kernel", 1050.0, 100.0),
        _ev("kernel", "copy", 1150.0, 100.0),
        _ev("kernel", "crc32c_rows_kernel", 1350.0, 100.0),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 1560.0, 40.0),
    ]
    view = trace.view_from_events(events, calls=2, yard={}, enqueue_us=1.0)
    recs = []
    sid = 0
    for start in (1000.0, 1300.0):
        sid += 1
        root = sid
        recs.append({"span": "ec.fused_step", "id": root, "parent": None,
                     "call": root, "start": start, "end": start + 200.0,
                     "device_us": 300.0})
        for name, lo, hi, dev in (("ec.b1", 0, 50, 40.0),
                                  ("ec.segments", 50, 120, 100.0),
                                  ("ec.b2", 120, 150, 40.0),
                                  ("ec.crc_combine", 150, 200, 60.0)):
            sid += 1
            recs.append({"span": name, "id": sid, "parent": root,
                         "call": root, "start": start + lo,
                         "end": start + hi, "device_us": dev})
    recs.append({"span": "ec.fused_step", "id": 99, "parent": None,
                 "call": 99, "start": 1700.0, "end": 1800.0,
                 "device_us": 1.0})        # outside the window
    for r in recs:
        r["start_ns"] = int(BASE + r.pop("start") * 1e3)
        r["end_ns"] = int(BASE + r.pop("end") * 1e3)
        r["host_us"] = (r["end_ns"] - r["start_ns"]) / 1e3
    monkeypatch.setattr(tracepoints, "dump_spans", lambda: recs)
    monkeypatch.setattr(tracepoints, "spans_dropped", lambda: dropped)
    monkeypatch.setattr(tracepoints, "trace_base_ns", lambda: BASE)
    return view


def _read(name, view):
    from ecbench import run
    return run.load_module(METRICS / f"{name}.py", f"t_pt_{name}").read(view)


def test_span_readers_on_made_up_spans(monkeypatch):
    view = _made_up(monkeypatch)
    assert _read("segments_us.flush", view) == pytest.approx(100.0)
    assert _read("combine_us.flush", view) == pytest.approx(60.0)
    assert _read("layout_host_us.flush", view) == pytest.approx(70 + 50)
    # the card idle inside a step: 1000-1050 (step 1), 1300-1350 and
    # 1450-1500 (step 2): 150 us of the 600 us window
    assert _read("idle_in_step_pct.flush", view) == \
        pytest.approx(100 * 150 / 600)


@pytest.mark.parametrize("name", ["segments_us.flush", "combine_us.flush",
                                  "layout_host_us.flush",
                                  "idle_in_step_pct.flush"])
def test_span_readers_refuse_partial_or_missing_spans(monkeypatch, name):
    assert _read(name, _made_up(monkeypatch, dropped=1)) is None
    view = _made_up(monkeypatch)
    monkeypatch.delattr(tracepoints, "dump_spans")
    assert _read(name, view) is None        # a program without spans


@pytest.mark.parametrize("name", ["program_setup_s.flush",
                                  "program_setup_s.encode",
                                  "program_setup_s.decode"])
def test_setup_readers(monkeypatch, name):
    from ceph_tpu_torch.utils import device_telemetry
    monkeypatch.setattr(device_telemetry.DeviceTelemetry, "setup_seconds",
                        lambda self: {"kernel_load": {"seconds": 0.5,
                                                      "count": 2},
                                      "calibration": {"seconds": 1.25,
                                                      "count": 12}})
    assert _read(name, None) == pytest.approx(1.75)
    monkeypatch.setattr(device_telemetry.DeviceTelemetry, "setup_seconds",
                        lambda self: {})
    assert _read(name, None) is None
    monkeypatch.delattr(device_telemetry.DeviceTelemetry, "setup_seconds")
    assert _read(name, None) is None


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _rs_steps(device, nops=128, slots=4, seed=7):
    """The benchmark's RS step: 128 x 1 MiB objects staged shard-major."""
    codec = _rs(device)
    n = nops * (1 << 17)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ring = [torch.empty((8, n), dtype=torch.uint8, device=device)
            .random_(0, 256, generator=gen) for _ in range(slots)]
    lens = [1 << 17] * nops
    mat = codec.coding_matrix

    def step(i):
        return ec_util.fused_step(mat, ring[i % slots], lens, 1 << 17, "cuda")
    return step


def _traced_steps(step, calls, window=3):
    """``calls`` steps, at most ``window`` in flight, under a profiler
    session of CUDA activity alone; the exported trace's document."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    for i in range(6):
        step(i)
    torch.cuda.synchronize()
    inflight = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for i in range(calls):
            if len(inflight) >= window:
                inflight.pop(0).synchronize()
            step(i)
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cuda.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())


@pytest.mark.cuda
def test_cuda_spans_record_under_cuda_activity_alone(cuda):
    step = _rs_steps(cuda, nops=16, slots=2)
    doc = _traced_steps(step, 8)
    recs = tracepoints.dump_spans()
    steps = [r for r in recs if r["span"] == "ec.fused_step"]
    assert len(steps) == 8 and all(r["device_us"] > 0 for r in recs)
    assert tracepoints.trace_base_ns() == int(doc["baseTimeNanoseconds"])


@pytest.mark.cuda
def test_cuda_b1_b2_launches_lie_inside_their_spans(cuda):
    step = _rs_steps(cuda)
    doc = _traced_steps(step, 24)
    base = tracepoints.trace_base_ns()
    assert base == int(doc["baseTimeNanoseconds"])
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    kernels = {e["args"]["correlation"]: e["name"] for e in evs
               if e.get("cat") == "kernel"}
    launches = {"ec.b1": [], "ec.b2": []}
    for e in evs:
        if e.get("cat") != "cuda_runtime" or "Launch" not in e["name"]:
            continue
        name = kernels.get(e["args"].get("correlation"), "")
        key = "ec.b1" if "gf_matvec_kernel" in name else \
            "ec.b2" if "crc32c_rows_kernel" in name else None
        if key:
            launches[key].append((e["ts"], e["ts"] + e["dur"]))
    spans = {k: sorted(((r["start_ns"] - base) / 1e3,
                        (r["end_ns"] - base) / 1e3)
                       for r in tracepoints.dump_spans() if r["span"] == k)
             for k in launches}
    for key, lst in launches.items():
        assert len(lst) == len(spans[key]) == 24, key
        for (lo, hi), (s0, s1) in zip(sorted(lst), spans[key]):
            assert s0 - 5 <= lo and hi <= s1 + 5, (key, lo, hi, s0, s1)


#: the fused step's phases, in order
PHASES = ("ec.b1", "ec.segments", "ec.b2", "ec.crc_combine")


@pytest.mark.cuda
def test_cuda_step_phases_account_for_its_device_time(cuda):
    """At the benchmark's 128 x 1 MiB, every operation the stretch ran on
    the card was launched inside one of the step's four phases (launch and
    operation matched by the trace's correlation ids); each phase's event
    time covers its operations' durations; and the phases' event time
    comes within 5% of the time the steps' operations span on the card,
    first start to last end of each step (their durations and the card's
    gaps between them, which events count and durations do not). Prints
    the three a step, by phase."""
    import bisect
    step = _rs_steps(cuda)
    calls = 60
    doc = _traced_steps(step, calls)
    base = tracepoints.trace_base_ns()
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    ops = {e["args"]["correlation"]: e for e in evs
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    phases = sorted(((r["start_ns"] - base) / 1e3, (r["end_ns"] - base) / 1e3,
                     r) for r in tracepoints.dump_spans()
                    if r["span"] in PHASES)
    assert len(phases) == 4 * calls
    starts = [lo for lo, _hi, _r in phases]
    mine: dict[int, list] = {r["id"]: [] for _lo, _hi, r in phases}
    for e in evs:
        op = ops.get(e.get("args", {}).get("correlation"))
        if op is None or e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        i = bisect.bisect_right(starts, e["ts"] + 5) - 1
        assert i >= 0 and e["ts"] + e["dur"] <= phases[i][1] + 5, e["name"]
        mine[phases[i][2]["id"]].append(op)
    assert sum(len(v) for v in mine.values()) == len(ops)
    table: dict[str, list] = {}
    by_step: dict[int, list] = {}
    for _lo, _hi, r in phases:
        got = mine[r["id"]]
        row = table.setdefault(r["span"], [0.0, 0.0, 0.0])
        durations = sum(o["dur"] for o in got)
        assert r["device_us"] >= durations - 1.0, r["span"]
        row[0] += r["device_us"] / calls
        row[1] += durations / calls
        row[2] += (max(o["ts"] + o["dur"] for o in got)
                   - min(o["ts"] for o in got)) / calls
        by_step.setdefault(r["call"], []).extend(got)
    extent = sum(max(o["ts"] + o["dur"] for o in got) -
                 min(o["ts"] for o in got)
                 for got in by_step.values()) / calls
    events = sum(row[0] for row in table.values())
    print("phase: events_us, durations_us, extent_us a step",
          json.dumps({k: [round(x, 2) for x in v] for k, v in table.items()}),
          "step extent_us", round(extent, 2))
    assert events == pytest.approx(extent, rel=0.05)


@pytest.mark.cuda
def test_cuda_repair_calibrations_reach_perf_dump_and_dashboard(cuda):
    import urllib.request

    from ceph_tpu_torch.models.clay_device import build_decode_matvec
    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.utils.admin_socket import asok_command
    codec = instance().factory("clay", {"k": "8", "m": "4", "d": "11"},
                               device=cuda)
    for lost in range(12):
        helpers = tuple(sorted(codec.minimum_to_decode(
            [lost], [c for c in range(12) if c != lost])))
        mat = codec._repair_matrix(lost, helpers)
        fn = build_decode_matvec(codec, mat, label="repair")
        assert fn.measured["seconds"] > 0
    cals = {s: v for s, v in telemetry().snapshot()["calibrations"].items()
            if s.startswith("repair|")}
    assert len(cals) == 12
    assert all({"winner", "dense_s", "sparse_s", "seconds"} <= set(v)
               for v in cals.values())
    assert telemetry().setup_seconds()["calibration"]["count"] >= 12
    with MiniCluster(n_osds=3) as c:
        mgr = c.start_mgr()
        assert asok_command(mgr.asok.path, "dashboard on")["code"] == 0
        url = asok_command(mgr.asok.path, "dashboard status")["data"]["url"]
        page = urllib.request.urlopen(url, timeout=10).read().decode()
        dump = json.loads(urllib.request.urlopen(
            url + "api/device", timeout=10).read())
        asok_command(mgr.asok.path, "dashboard off")
    assert all(s in page for s in cals)
    assert {s: v["winner"] for s, v in dump["calibrations"].items()
            if s in cals} == {s: v["winner"] for s, v in cals.items()}
