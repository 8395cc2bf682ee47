"""The port's ``tools/gap_report.py`` against the reference's, on the CPU.

Counterparts of ``tests/test_gap_report.py`` and of the gap-report pin of
``tests/test_dispatch_telemetry.py``: a quick run of each package (the
port's pool on ``--backend torch``, the kernels' plain versions, with the
engine side given as ``--engine-gbps 80``; the reference's on ``jax``)
must give the same JSON key tree and stage names, and stage and
commit-path coverage of at least 90%; the port's run must carry what the
reference's tests ask of theirs (the commit-path X-ray, the what-if
ledgers, the dispatch X-ray, ``--profile``'s hot frames, the crimson and
read-balance arms). ``print_table`` prints the same text in both
packages for the same report, ``projection_honesty`` and
``_knob_section`` give equal values. Off the card with no
``--engine-gbps`` the engine side is ``none`` (the reference falls back
to a TPU figure, which the port does not carry). The bulk-ingest
comparison is held by counts: no batch frame and no loopback message
under ``CEPH_TPU_BULK_INGEST=0``, some of both under ``=1``. A fault in a
section or an arm reaches the JSON as its ``error``.
"""

import json

import pytest

from ceph_tpu.tools import gap_report as ref_gap
from ceph_tpu.utils import profiler as ref_prof_mod
from ceph_tpu_torch.tools import gap_report
from ceph_tpu_torch.utils import profiler as prof_mod

QUICK = ["--seconds", "0.5", "--osds", "3", "--obj-kb", "32",
         "--threads", "2", "--profile"]
NO_ARMS = ["--no-crimson", "--no-read-balance"]
#: dicts keyed by data (stages, connections, locks, OSDs, frames) or
#: whose keys appear with the data (the store's brief): their keys are not
#: part of the key tree
DATA_KEYED = ("/stages", "/subops", "/connections", "/by_stage",
              "/hot_frames", "/seams", "/fsync_sites", "/per_osd_op_r",
              "/vector", "/locks/locks", "/profiler_share_pct", "/brief")


def _run(mod, argv, capsys) -> tuple[dict, str]:
    assert mod.main(argv) == 0
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines()
            if ln.startswith('{"gap_report"')][-1]
    return json.loads(line)["gap_report"], out


def _key_tree(obj, path="") -> set:
    out = set()
    if isinstance(obj, dict):
        keyed = path.endswith(DATA_KEYED)
        for key, val in obj.items():
            sub = f"{path}/{'*' if keyed else key}"
            out.add(sub)
            out |= _key_tree(val, sub)
    return out


def _table(mod, report, capsys) -> str:
    mod.print_table(report)
    return capsys.readouterr().out


def test_quick_run_matches_reference(capsys):
    """Both packages' quick runs with the arms on and ``--profile``: the
    same key tree and stage names, coverage >= 90% in both; the port's
    report carries what the reference's tests ask of theirs; each
    package's table of either report is the same text."""
    prof_mod.reset_for_tests()
    rep, out = _run(gap_report, QUICK + ["--backend", "torch",
                                         "--engine-gbps", "80"], capsys)
    assert not [t for t in __import__("threading").enumerate()
                if t.name == "py-profiler"]
    prof_mod.reset_for_tests()
    ref_prof_mod.reset_for_tests()
    ref, _ = _run(ref_gap, QUICK + ["--backend", "jax"], capsys)
    ref_prof_mod.reset_for_tests()

    assert _key_tree(rep) == _key_tree(ref)
    assert set(rep["stages"]) == set(ref["stages"])
    for stage in ("wire", "dispatch_queue_wait", "engine_stage_wait",
                  "commit_wait"):
        assert stage in rep["stages"], rep["stages"]
    for r in (rep, ref):
        assert r["coverage_pct"] >= 90.0 and r["ops"] > 0
        assert r["commit_path"]["coverage_pct"] >= 90.0
        assert r["crimson"]["lost_acked"] == r["crimson"]["wrong_bytes"] == 0
        assert "error" not in r["read_balance"]
    assert (rep["engine_GBps"], rep["engine_source"]) == (80.0, "cli")
    assert rep["gap_x"] == round(80.0 * 1e3 / rep["cluster_MBps"], 1)
    assert rep["backend"] == "torch" and rep["profile"] == "k=2,m=1"
    assert rep["cluster_p99_ms"] >= rep["cluster_p50_ms"] > 0
    # the commit-path X-ray, the what-if ledgers and the store table
    for stage in ("commit_dispatch", "commit_ship_wait", "commit_ack_wait"):
        assert rep["commit_path"]["stages"][stage]["mean_ms"] >= 0.0
    wi = rep["what_if"]
    assert wi["fsyncs_saved"] > 0, wi
    assert wi["fsync_model"] in ("measured", "durable_profile")
    assert wi["projected_MBps"] >= rep["cluster_MBps"], wi
    for row in wi["group_commit"]:
        assert row["txns"] >= row["groups"] > 0
    assert wi["objecter_stream"]["coalescable_ops"] >= 0
    framing = wi["wire_framing"]
    assert framing["batch_frames"] > 0, framing
    assert framing["mean_batch_frame_bytes"] > 0
    assert rep["store"]["txn_breakdown"]["txns"] > 0
    assert rep["store"]["brief"]["txns"] > 0
    # the dispatch X-ray and the run-to-completion projection
    dsp = rep["dispatch"]
    assert dsp["coverage_pct"] >= 90.0, dsp
    for stage in ("commit_handoff", "commit_dispatch", "commit_ship_wait",
                  "commit_ack_wait"):
        assert dsp["stages"][stage]["kind"]
    assert dsp["op_chains"] > 0 and dsp["hops_per_op"] > 0
    assert dsp["seams"].get("wq_op", {}).get("hops", 0) > 0
    assert dsp["wakeups"]["wakeups"] > 0 and dsp["locks"]["locks"]
    rtc = wi["run_to_completion"]
    assert rtc["hops_saved"] > 0 and rtc["whatif_rtc_MBps"] > 0
    assert rtc["saved_ms_per_op"] >= 0
    # --profile: hot frames under the stage rows
    prof = rep["profiler"]
    assert prof["hz"] == 50.0 and prof["samples"] > 0
    assert prof["attributed_pct"] >= 80.0, prof["by_stage"]
    for frames in prof["hot_frames"].values():
        assert 0 < len(frames) <= 10
    assert prof["sampler_overhead_pct"] < 25.0
    # the arms: the measured crimson side with its honesty row
    assert rep["crimson"]["load_gen_MBps"] > 0
    assert rep["crimson"]["projection_honesty"]["verdict"] in (
        "honest", "model-needs-fix")
    assert rep["read_balance"]["verdict"] in (
        "balanced", "balanced-no-speedup", "primary-pinned")
    for text in ("data-plane gap report", "stage sum coverage",
                 "engine staging queue", "commit path (under commit_wait",
                 "what-if @", "dispatch (under commit_wait",
                 "what-if run-to-completion:", "↳",
                 "--- crimson (run-to-completion, measured) ---",
                 "--- read balance (zipfian storm, primary vs any-k) ---"):
        assert text in out, text
    for report in (rep, ref):
        assert _table(gap_report, report, capsys) == \
            _table(ref_gap, report, capsys)


def test_plain_run_off_the_card(capsys):
    """Without ``--profile`` no sampler starts and no profiler field is
    written; off the card with no ``--engine-gbps`` the engine side and
    the gap are null, labelled ``none``."""
    prof_mod.reset_for_tests()
    rep, out = _run(gap_report, ["--seconds", "0.2", "--osds", "2",
                                 "--obj-kb", "16", "--threads", "1",
                                 "--backend", "native"] + NO_ARMS, capsys)
    assert "profiler" not in rep
    assert prof_mod.profiler_if_exists() is None
    assert (rep["engine_GBps"], rep["engine_source"], rep["gap_x"]) == \
        (None, "none", None)
    assert rep["ops"] > 0 and "crimson" not in rep
    assert "(source: none)" in out and "gap:" not in out


def test_device_backends_refuse_without_a_card():
    """The default ``auto_device`` and ``cuda`` need the card: without
    one, gap_report raises before a cluster starts."""
    for argv in ([], ["--backend", "cuda"], ["--full"]):
        with pytest.raises(Exception, match="card|cuda|CUDA"):
            gap_report.main(["--seconds", "0.1"] + argv)


def test_knob_section_matches_reference(capsys):
    from ceph_tpu_torch.utils.knobs import TUNER_KNOBS

    section = gap_report._knob_section()
    assert section == ref_gap._knob_section()
    assert set(section["vector"]) == set(TUNER_KNOBS.names())
    assert section["tuner_active"] is False
    report = {"cluster_MBps": 1.0, "cluster_p50_ms": 1,
              "cluster_p99_ms": 2, "engine_GBps": 80.0,
              "engine_source": "cli", "gap_x": 10.0,
              "backend": "torch", "profile": "k2m1",
              "stages": {}, "subops": {}, "coverage_pct": 0.0,
              "knobs": section}
    text = _table(gap_report, report, capsys)
    assert text == _table(ref_gap, report, capsys)
    assert "knobs (tuner off" in text and "engine_window=" in text


@pytest.mark.parametrize("whatif,measured", [
    (5.0, 3.66), (10.0, 30.0), (10.0, 4.0), (0.0, 3.0), (3.0, 0.0),
    (None, 2.0), (7.0, 14.0)])
def test_projection_honesty_matches_reference(whatif, measured):
    assert gap_report.projection_honesty(whatif, measured) == \
        ref_gap.projection_honesty(whatif, measured)


def _attr(ops_pct):
    return {"ops_attributed": 9, "ops_total": 10, "ops_pct": ops_pct,
            "bytes_attributed": 90, "bytes_total": 100,
            "bytes_pct": ops_pct,
            "by_flow": {"acme": {"ops": 6, "ops_share": 0.6, "bytes": 60,
                                 "bytes_share": 0.6},
                        "": {"ops": 3, "ops_share": 0.3, "bytes": 30,
                             "bytes_share": 0.3}}}


FIXED = {
    "arms_failed_and_skipped": {
        "crimson": {"skipped": "n_osds 2 < k+m 3"},
        "read_balance": {"error": "RuntimeError: EIO"},
        "tenants": {"threaded": {"attribution": _attr(96.0),
                                 "coverage_ok": True},
                    "crimson": {"error": "RuntimeError: device"},
                    "coverage_ok": False}},
    "tenants_skipped": {
        "tenants": {"threaded": {"skipped": "flows_enabled=false"},
                    "crimson": {"attribution": _attr(80.0),
                                "coverage_ok": False},
                    "coverage_ok": False},
        "crimson": {"error": "RuntimeError: x"}},
}


@pytest.mark.parametrize("name", sorted(FIXED))
def test_print_table_on_fixed_reports_matches_reference(name, capsys):
    report = {"cluster_MBps": 2.5, "cluster_p50_ms": 3.0,
              "cluster_p99_ms": 9.0, "engine_GBps": None,
              "engine_source": "none", "gap_x": None, "backend": "torch",
              "profile": "k=2,m=1", "coverage_pct": 97.5,
              "stages": {"wire": {"mean_ms": 1.5, "share_pct": 60.0},
                         "engine_stage_wait": {"mean_ms": 0.9,
                                               "share_pct": 37.5}},
              "subops": {"subop_wire": {"mean_ms": 0.2}},
              "mesh": {"encode_share": 0.5}} | FIXED[name]
    text = _table(gap_report, report, capsys)
    assert text == _table(ref_gap, report, capsys)
    assert "50%" in text


@pytest.mark.parametrize("bulk", ["0", "1"])
def test_bulk_ingest_framing_counts(bulk, monkeypatch, capsys):
    """The bulk-ingest path by counts (the reference's timed before/after
    comparison loses to noise on a loaded CPU, ROADMAP section C): with
    it off the OSDs' sub-writes go out one frame each over TCP, with it
    on in batch frames through the in-process loopback."""
    monkeypatch.setenv("CEPH_TPU_BULK_INGEST", bulk)
    rep, _ = _run(gap_report, ["--seconds", "1.0", "--osds", "3",
                               "--obj-kb", "64", "--threads", "4",
                               "--backend", "torch", "--engine-gbps", "80"]
                  + NO_ARMS, capsys)
    framing = rep["what_if"]["wire_framing"]
    assert rep["coverage_pct"] >= 90.0, rep["coverage_pct"]
    if bulk == "0":
        assert framing["batch_frames"] == framing["loopback_msgs"] == 0, \
            framing
        assert framing["tcp_msgs"] > 0
    else:
        assert framing["batch_frames"] > 0 and \
            framing["loopback_msgs"] > 0, framing


def test_faults_reach_the_json(monkeypatch, capsys):
    """A section or an arm that raises carries ``error`` (never an empty
    section), and engine errors in the cluster run set the report's."""
    from ceph_tpu_torch.bench import cluster_bench

    def run_one(backend, seconds, n_osds, obj_size, threads, k, m):
        return {"bandwidth_MBps": 1.0, "p50_ms": 1.0, "p99_ms": 2.0,
                "backend": backend, "profile": f"k={k},m={m}",
                "device_engine": {"errors": 2}, "stage_breakdown": {}}

    def boom(*a, **kw):
        raise RuntimeError("EIO from the engine")

    monkeypatch.setattr(cluster_bench, "run_one", run_one)
    monkeypatch.setattr(gap_report, "_mesh_section", boom)
    monkeypatch.setattr(gap_report, "_crimson_arm", boom)
    monkeypatch.setattr(gap_report, "_read_balance_arm", boom)
    rep, out = _run(gap_report, ["--backend", "torch", "--engine-gbps", "1",
                                 "--tenants"], capsys)
    assert rep["error"] == "device engine: 2 flush errors"
    for key in ("mesh", "crimson", "read_balance"):
        assert rep[key] == {"error": "RuntimeError: EIO from the engine"}
    assert "error: device engine: 2 flush errors" in out

    class Engine:
        stats = {"errors": 1, "decode_errors": 2}

    class OSD:
        _device_engine = Engine()

    class Cluster:
        osds = {0: OSD(), 1: OSD()}

    assert gap_report._engine_errors(Cluster()) == 3
    with pytest.raises(RuntimeError, match="3 flush/decode errors"):
        gap_report._check_engine(Cluster())


def test_help_prints(capsys):
    """``--help`` prints every flag (the reference's crashes on the
    ``%`` in ``--tenants``' help)."""
    with pytest.raises(SystemExit) as exc:
        gap_report.main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--full", "--engine-gbps", "--run-engine-loop", "--profile",
                 "--no-crimson", "--no-read-balance", "--tenants"):
        assert flag in out
    assert "(>= 95% bar)" in out
