"""The port's observability modules against the reference's, on the CPU:
static tracepoints (``utils/tracepoints.py``), slow-op autopsies
(``utils/autopsy.py``), the prometheus exposition
(``utils/prometheus.py``), the trace export (``tools/trace_export.py``)
and the kernel build ledger (``utils/compile_cache.py``).

- Tracepoints: a disabled provider keeps nothing; enabled, its ring holds
  the points' fields as the reference's does for the same emits (equal
  dumps but for the time stamps); the ``<name>_tracing`` config observer
  and the ``tracepoint_*`` admin commands arm and dump it; the port's
  OSD, engine and BlockStore points are declared on it.
- ``device_trace`` refuses to run as a no-op: a ``cuda`` session without
  a card raises, and so does a session inside another (the card cases in
  ``tests/test_torch_cuda.py`` list B1 and B2 in a trace).
- Autopsies: the counters of ``tests/test_counter_schema.py:237`` reach
  the prometheus text and ``dump_autopsies``; an errored op is kept and
  autopsied with its timeline, spans, counter window and fault tail
  (``tests/test_trace_sampling.py:137``); the trace export CLI and the
  mgr trace module's merged tree (``:280``, ``:331``), on the port.
- ``render_text`` over equal counters in both packages gives equal text
  (``tests/test_admin_tools.py:102``), and ``MetricsServer`` serves it.
- The build ledger on a temporary directory: hits, misses, once per
  process, persisted; ``CEPH_TPU_COMPILE_CACHE=0`` records nothing.
"""

import json

import pytest

from ceph_tpu.utils import flow_telemetry as ref_flows
from ceph_tpu.utils import perf_counters as ref_perf
from ceph_tpu.utils import prometheus as ref_prom
from ceph_tpu.utils import tracepoints as ref_tp
from ceph_tpu_torch.utils import (autopsy, compile_cache, flow_telemetry,
                                  perf_counters, prometheus, tracepoints,
                                  tracing)
from ceph_tpu_torch.utils.config import g_conf


class _StubAsok:
    def __init__(self):
        self.commands = {}

    def register_command(self, prefix, handler, desc=""):
        self.commands[prefix] = handler


# -- tracepoints ---------------------------------------------------------

def _emit(tp_mod, name):
    prov = tp_mod.provider(name)
    point = prov.point("op_dequeue", "oid", "op", "client")
    bare = prov.point("bare")
    prov.clear()
    point("dropped", 1, "c")              # disabled: kept nowhere
    prov.enable()
    try:
        point("obj", 3, "client.1")
        bare(7, "x")
        point("obj2", 4, "client.2")
        return [{k: v for k, v in ev.items() if k != "ts"}
                for ev in prov.dump()], prov.dump(limit=1)
    finally:
        prov.disable()
        prov.clear()


def test_tracepoint_ring_equals_reference():
    port, port_last = _emit(tracepoints, "test_obs_port")
    ref, ref_last = _emit(ref_tp, "test_obs_port")
    assert port == ref
    assert port == [
        {"point": "test_obs_port:op_dequeue", "oid": "obj", "op": 3,
         "client": "client.1"},
        {"point": "test_obs_port:bare", "args": (7, "x")},
        {"point": "test_obs_port:op_dequeue", "oid": "obj2", "op": 4,
         "client": "client.2"}]
    assert len(port_last) == len(ref_last) == 1


def test_tracepoint_config_observer_and_asok():
    """``osd_tracing`` arms the ``osd`` provider through its config
    observer; the admin commands list, enable, dump and disable."""
    import ceph_tpu_torch.osd.device_engine  # noqa: F401 (declares points)
    import ceph_tpu_torch.osd.osd  # noqa: F401
    import ceph_tpu_torch.store.blockstore  # noqa: F401
    prov = tracepoints.provider("osd")
    assert {"device_flush", "device_decode_flush",
            "recovery_push"} <= set(prov._points)
    assert "queue_transaction" in tracepoints.provider(
        "objectstore")._points
    assert "op_dequeue" in tracepoints.provider("oprequest")._points
    conf = g_conf()
    saved = conf["osd_tracing"]
    try:
        conf.set("osd_tracing", True)
        assert prov.enabled
        conf.set("osd_tracing", False)
        assert not prov.enabled
    finally:
        conf.set("osd_tracing", saved)
    asok = _StubAsok()
    tracepoints.register_asok(asok)
    assert set(asok.commands) == {"tracepoints", "tracepoint_enable",
                                  "tracepoint_disable", "tracepoint_dump"}
    assert asok.commands["tracepoint_enable"]({"provider": "osd"}) == "ok"
    try:
        assert asok.commands["tracepoints"]({})["osd"] is True
        prov._points["device_flush"](3, 4096)
        dump = asok.commands["tracepoint_dump"]({"provider": "osd",
                                                 "limit": 1})
        assert dump[0]["point"] == "osd:device_flush"
        assert (dump[0]["ops"], dump[0]["bytes"]) == (3, 4096)
    finally:
        asok.commands["tracepoint_disable"]({"provider": "osd"})
        prov.clear()
    assert asok.commands["tracepoints"]({})["osd"] is False


def test_device_trace_refuses_to_be_a_noop(tmp_path):
    """Without a card a ``cuda`` session raises; a ``cpu`` session
    writes its Chrome trace and lists no device kernel; a session inside
    another raises, and the outer one still closes."""
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            with tracepoints.device_trace(str(tmp_path)):
                pass
    with tracepoints.device_trace(str(tmp_path), device="cpu") as trace:
        torch.ones(64).sum()
        with pytest.raises(RuntimeError, match="already open"):
            with tracepoints.device_trace(str(tmp_path), device="cpu"):
                pass
    doc = json.loads(open(trace.path).read())
    assert doc["traceEvents"]
    assert trace.kernel_names() == {}
    with tracepoints.device_trace(str(tmp_path), device="cpu"):
        pass                              # the slot was released
    with pytest.raises(ValueError):
        tracepoints.device_trace(str(tmp_path), device="tpu").__enter__()


# -- autopsies -------------------------------------------------------------

_TRACE_KEYS = ("trace_enabled", "trace_all", "trace_sample_every",
               "trace_slow_factor", "trace_slow_min_ms",
               "trace_pending_traces", "trace_max_spans",
               "trace_keep_ring", "autopsy_ring_size")


@pytest.fixture
def trace_conf():
    conf = g_conf()
    old = {k: conf[k] for k in _TRACE_KEYS}
    tracing.tracer().clear()
    autopsy.store().clear()
    yield conf
    for k, v in old.items():
        conf.set(k, v)
    tracing.tracer().clear()
    autopsy.store().clear()


def _no_cause_keeps(conf):
    conf.set("trace_all", False)
    conf.set("trace_sample_every", 0)
    conf.set("trace_slow_min_ms", 1e12)
    conf.set("trace_slow_factor", 1e6)


def test_trace_and_autopsy_counters_covered():
    """The tail sampler's and the autopsy store's counters reach the
    prometheus text and the ``dump_autopsies`` / ``trace status``
    admin commands, with the reference's keys."""
    from ceph_tpu.utils import autopsy as ref_autopsy
    trace_keys = set(tracing.tracer().perf.dump())
    assert {"trace_kept", "trace_dropped", "trace_evicted",
            "trace_spans_truncated", "trace_pending",
            "trace_kept_error", "trace_kept_fault",
            "trace_kept_slow", "trace_kept_sample", "trace_kept_forced",
            "autopsies_recorded"} <= trace_keys
    aut_keys = set(autopsy.store().perf.dump())
    assert aut_keys == set(ref_autopsy.store().perf.dump()) == {
        "autopsy_recorded", "autopsy_evicted", "autopsy_ring"}
    text = prometheus.render_text()
    for key in ("trace_kept", "trace_dropped", "trace_evicted",
                "autopsy_recorded", "autopsy_ring"):
        assert f"ceph_tpu_{key}" in text, key
    assert 'daemon="tracing"' in text and 'daemon="autopsy"' in text
    asok = _StubAsok()
    autopsy.register_asok(asok)
    tracing.register_asok(asok)
    payload = asok.commands["dump_autopsies"]({})
    assert set(payload["counters"]) >= aut_keys
    status = asok.commands["trace status"]({})
    assert set(status["counters"]) >= trace_keys


def test_error_keep_and_autopsy_contents(trace_conf):
    """An errored op is kept and autopsied: timeline, span tree,
    counter window (a forced flight-recorder sample), fault log; the
    autopsy counters move."""
    from ceph_tpu_torch.utils.stage_clock import StageClock
    conf = trace_conf
    _no_cause_keeps(conf)
    before = autopsy.store().perf.dump()["autopsy_recorded"]
    t = tracing.tracer()
    root = t.new_trace("osd_op(op=1 oid=boom)", "client.e",
                       op_type="er")
    child = root.child("sub", "osd.1")
    child.finish()
    clock = StageClock()
    clock.mark("objecter_encode")
    clock.mark("commit_reply")
    root.attach_clock(clock)
    root.set_error("code=-5")
    assert root.finish() is True
    assert t.keep_reason(root.trace_id) == "error"
    entry = autopsy.store().get(root.trace_id)
    assert entry is not None
    assert entry["reason"] == "error" and entry["error"] == "code=-5"
    assert {s["name"] for s in entry["spans"]} == \
        {"osd_op(op=1 oid=boom)", "sub"}
    assert entry["timeline"]["stages"][1]["stage"] == "objecter_encode"
    assert entry["timeline"]["wall_epoch"] > 1e9
    assert entry["counter_window"], "forced sample missing"
    assert isinstance(entry["fault_events"], list)
    json.dumps(entry)
    perf = autopsy.store().perf.dump()
    assert perf["autopsy_recorded"] == before + 1
    assert perf["autopsy_ring"] == len(autopsy.store().dump())


def test_autopsy_ring_bound_and_evictions():
    """The ring holds ``autopsy_ring_size`` entries; the rest evict and
    are counted, as in the reference."""
    from ceph_tpu.utils import autopsy as ref_autopsy
    counts = []
    for mod in (autopsy, ref_autopsy):
        store = mod.AutopsyStore(ring_size=3)
        ev0 = store.perf.dump()["autopsy_evicted"]
        for i in range(5):
            store.record({"trace_id": f"t{i}", "reason": "slow",
                          "root": f"op{i}", "spans": []})
        counts.append(([e["trace_id"] for e in store.dump()],
                       store.perf.dump()["autopsy_evicted"] - ev0,
                       store.perf.dump()["autopsy_ring"]))
    assert counts[0] == counts[1] == (["t2", "t3", "t4"], 2, 3)


def test_trace_export_cli_round_trip(trace_conf, tmp_path):
    """The port's ``tools/trace_export.py`` on a kept-trace record gives
    the reference's Chrome trace document."""
    from ceph_tpu.tools import trace_export as ref_export
    from ceph_tpu_torch.tools import trace_export
    conf = trace_conf
    conf.set("trace_all", True)
    t = tracing.tracer()
    root = t.new_trace("osd_op(op=1 oid=x)", "client.ex")
    sub = root.child("ec_sub_write", "osd.0")
    eng = sub.child("engine_flush")
    eng.event("batch_flush ops=3")
    for s in (eng, sub, root):
        s.finish()
    rec = [r for r in t.kept() if r["trace_id"] == root.trace_id][0]
    src = tmp_path / "trace.json"
    dst = tmp_path / "out.json"
    ref_dst = tmp_path / "ref.json"
    src.write_text(json.dumps(rec))
    assert trace_export.main(["--input", str(src),
                              "--output", str(dst)]) == 0
    assert ref_export.main(["--input", str(src),
                            "--output", str(ref_dst)]) == 0
    doc = json.loads(dst.read_text())
    assert doc == json.loads(ref_dst.read_text())
    events = doc["traceEvents"]
    procs = {e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {"client.ex", "osd.0"}
    spans = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in spans} == \
        {"osd_op(op=1 oid=x)", "ec_sub_write", "engine_flush"}
    assert {e["ph"] for e in events if e.get("cat") == "engine"} == \
        {"b", "e"}
    by_name = {e["name"]: e for e in spans}
    assert by_name["engine_flush"]["tid"] == 2


def test_mgr_trace_module_merges_the_tree(trace_conf):
    """The mgr trace module archives kept traces and serves the merged
    cross-daemon tree (``trace dump``) and its Chrome export."""
    from ceph_tpu_torch.mgr import trace as trace_mod
    conf = trace_conf
    conf.set("trace_all", True)
    t = tracing.tracer()
    root = t.new_trace("root_op", "client.x")
    s1 = root.child("sub1", "osd.0")
    s1.child("engine_flush").finish()
    s1.finish()
    root.child("sub2", "osd.1").finish()
    root.finish()

    class _StubMgr:
        modules: dict = {}

    mod = trace_mod.Module(_StubMgr())
    code, _, data = mod.handle_command({"prefix": "dump",
                                        "trace_id": root.trace_id})
    assert code == 0
    tree = json.loads(data)
    assert tree["services"] == sorted({"client.x", "osd.0", "osd.1"})
    roots = tree["tree"]
    assert len(roots) == 1 and roots[0]["name"] == "root_op"
    kids = {c["name"]: c for c in roots[0]["children"]}
    assert set(kids) == {"sub1", "sub2"}
    assert kids["sub1"]["children"][0]["name"] == "engine_flush"
    code, _, data = mod.handle_command({"prefix": "export",
                                        "trace_id": root.trace_id})
    assert code == 0 and json.loads(data)["traceEvents"]
    code, _, _ = mod.handle_command({"prefix": "dump",
                                     "trace_id": "nope"})
    assert code != 0


# -- prometheus --------------------------------------------------------------

def _fill(pc_mod):
    coll = pc_mod.PerfCountersCollection()
    for name in ("osd.0", 'bad"name'):
        pc = coll.create(name)
        pc.add_u64_counter("op", "ops")
        pc.add_gauge("engine_inflight", "depth")
        pc.add_time_avg("op_latency", "latency")
        pc.add_histogram("flush_bytes", "bytes")
        pc.inc("op", 5)
        pc.set_gauge("engine_inflight", 2)
        pc.tinc("op_latency", 0.25)
        pc.tinc("op_latency", 0.5)
        for v in (1, 3, 4096, 5000):
            pc.hinc("flush_bytes", v)
    return coll


def _render_both(monkeypatch, tenants=()):
    """Both packages' exposition text over equal fresh collections. The
    process's flow registries belong to whichever cluster test ran
    before, so each is replaced: by none, or by a fresh one that saw the
    same ops of ``tenants`` ((label, bytes_in, bytes_out) each)."""
    for prom, flows, pc_mod in ((prometheus, flow_telemetry, perf_counters),
                                (ref_prom, ref_flows, ref_perf)):
        coll = _fill(pc_mod)
        monkeypatch.setattr(prom, "collection", lambda c=coll: c)
        monkeypatch.setattr(flows, "collection", lambda c=coll: c)
        tel = None
        if tenants:
            tel = flows.FlowTelemetry()
            for label, nin, nout in tenants:
                tel.note_op(label, bytes_in=nin)
                tel.note_op_done(label, bytes_out=nout)
        monkeypatch.setattr(flows, "_telemetry", tel)
    return prometheus.render_text(), ref_prom.render_text()


def test_render_text_equals_reference(monkeypatch):
    """The same counters in both packages' collections render the same
    exposition text, byte for byte."""
    text, ref_text = _render_both(monkeypatch)
    assert text == ref_text
    assert "tenant=" not in text
    assert 'ceph_tpu_op{daemon="osd.0"} 5' in text
    assert "# TYPE ceph_tpu_op counter" in text
    assert 'ceph_tpu_flush_bytes_bucket{daemon="osd.0",le="+Inf"} 4' \
        in text
    assert 'daemon="bad\\"name"' in text


def test_render_text_tenant_series_equal_reference(monkeypatch):
    """Equal per-tenant flows render the same ``tenant`` series, the
    hostile label escaped alike."""
    text, ref_text = _render_both(
        monkeypatch, [("acme", 1000, 512), ("acme", 24, 0),
                      ('bad"ten\\ant', 7, 9)])
    assert text == ref_text
    assert 'ceph_tpu_flows_ops_total{tenant="acme"} 2' in text
    assert 'ceph_tpu_flows_bytes_in_total{tenant="acme"} 1024' in text
    assert 'tenant="bad\\"ten\\\\ant"' in text


def test_metrics_server_serves_text():
    import urllib.request
    srv = prometheus.MetricsServer()
    port = srv.start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        assert 'daemon="tracing"' in body
    finally:
        srv.stop()


# -- the build ledger ---------------------------------------------------------

@pytest.fixture
def ledger_dir(tmp_path, monkeypatch):
    from ceph_tpu_torch.utils.device_telemetry import telemetry
    monkeypatch.delenv("CEPH_TPU_COMPILE_CACHE", raising=False)
    compile_cache._reset_for_tests()
    telemetry().reset()
    yield tmp_path
    compile_cache._reset_for_tests()
    telemetry().reset()


def _counts():
    from ceph_tpu_torch.utils.device_telemetry import telemetry
    c = telemetry().perf.dump()
    return c["compile_cache_hits"], c["compile_cache_misses"]


def test_build_ledger_hits_misses_once_a_process(ledger_dir):
    """A library built here is a miss with its wall, one found built a
    hit; each kernel counts once a process; a later process (reset)
    against the same directory sees the earlier entries and counts its
    own hits."""
    assert compile_cache.enable(str(ledger_dir)) == str(ledger_dir)
    assert compile_cache.note_build("gf_matvec", "libgf_matvec-1.so",
                                    1.5) is False
    assert compile_cache.note_build("crc32c_rows", "libcrc-2.so",
                                    None) is True
    assert compile_cache.note_build("gf_matvec", "libgf_matvec-1.so",
                                    None) is None     # already counted
    assert _counts() == (1, 1)
    on_disk = json.loads((ledger_dir / "builds.json").read_text())
    assert on_disk == {
        "libgf_matvec-1.so": {"kernel": "gf_matvec", "builds": 1,
                              "cold_s": 1.5},
        "libcrc-2.so": {"kernel": "crc32c_rows", "hits": 1}}
    compile_cache._reset_for_tests()                  # a new process
    compile_cache.enable(str(ledger_dir))
    assert compile_cache.ledger() == on_disk
    assert compile_cache.note_build("gf_matvec", "libgf_matvec-1.so",
                                    None) is True
    assert compile_cache.ledger()["libgf_matvec-1.so"] == {
        "kernel": "gf_matvec", "builds": 1, "cold_s": 1.5, "hits": 1}
    assert _counts() == (2, 1)


def test_build_ledger_off_records_nothing(ledger_dir, monkeypatch):
    monkeypatch.setenv("CEPH_TPU_COMPILE_CACHE", "0")
    monkeypatch.setenv("CEPH_TPU_COMPILE_CACHE_DIR", str(ledger_dir))
    assert compile_cache.enable() is None
    assert compile_cache.note_build("gf_matvec", "lib.so", 2.0) is None
    assert compile_cache.ledger() == {}
    assert _counts() == (0, 0)
    assert not (ledger_dir / "builds.json").exists()


def test_build_ledger_default_dir_and_bundle(ledger_dir, monkeypatch):
    """The ledger defaults to the kernel build directory
    (``CEPH_TPU_COMPILE_CACHE_DIR`` overrides) and turns on at the first
    library it accounts; the health bundle and telemetry carry it."""
    from ceph_tpu_torch.mgr.health import HealthEngine
    from ceph_tpu_torch.ops import cuda_build
    monkeypatch.delenv("CEPH_TPU_COMPILE_CACHE_DIR", raising=False)
    assert compile_cache.default_dir() == str(cuda_build.BUILD_DIR)
    monkeypatch.setenv("CEPH_TPU_COMPILE_CACHE_DIR", str(ledger_dir))
    assert compile_cache.enabled_dir() is None
    compile_cache.note_build("gf_xor", "libgf_xor-3.so", 0.5)
    assert compile_cache.enabled_dir() == str(ledger_dir)
    bundle = HealthEngine(rec=None, publish_perf=False,
                          bundle_on_err=False).dump_diagnostics()
    assert bundle["compile_cache"] == {
        "dir": str(ledger_dir),
        "ledger": {"libgf_xor-3.so": {"kernel": "gf_xor", "builds": 1,
                                      "cold_s": 0.5}}}
    from ceph_tpu_torch.utils.device_telemetry import telemetry
    assert telemetry().snapshot_brief()["compile_cache_misses"] == 1
