"""The port's ``tools/bench_trend.py`` against the reference's, on the CPU.

The mgr tuner judges its steps with ``lower_is_better``; the rest of the
module (``trend``, ``render``, ``main`` and its ``--tuned-vs-fixed`` mode)
is the same cross-round comparison. Each case feeds the same files or
arguments to both packages and asks for equal reports, text and exit
codes (tolerance: equal).
"""

import json
import os

import pytest

from ceph_tpu.tools import bench_trend as ref_trend
from ceph_tpu_torch.tools import bench_trend

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAMES = ("tuner_p99_ms", "tuner_MBps", "enc_GBps", "lat_p99_ms",
         "read_p50_us", "op_latency", "multichip_encode_GBps",
         "multi_tenant_fairness", "dispatch_hops_per_op@crimson",
         "cache_hit_p99_us", "hot_object_read_GBps")


def _round_file(tmp_path, name, metrics, rc=0):
    tail = "\n".join(
        json.dumps({"metric": m, "value": v, "unit": "GB/s",
                    "telemetry": {"nested": {"ok": 1}}})
        for m, v in metrics.items())
    path = tmp_path / name
    path.write_text(json.dumps(
        {"n": 1, "cmd": "bench", "rc": rc, "tail": tail,
         "parsed": None}))
    return str(path)


# name -> rounds (a dict of metrics per round, or None for a garbled file)
SCENARIOS = {
    "direction_aware": [
        {"enc_GBps": 100.0, "lat_p99_ms": 10.0, "steady_GBps": 50.0},
        {"enc_GBps": 80.0, "lat_p99_ms": 12.0, "steady_GBps": 52.0}],
    "best_prior": [{"x_GBps": 100.0}, {"x_GBps": 60.0},
                   {"x_GBps": 61.0}],
    "missing_and_garbled": [{"a_GBps": 10.0}, None,
                            {"a_GBps": 10.5, "b_GBps": 3.0}],
    "pinned_rows": [
        {"multichip_encode_GBps": 10.0, "multi_tenant_fairness": 0.67},
        {"multichip_encode_GBps": 4.0, "multi_tenant_fairness": 0.34}],
}


def _scenario_files(tmp_path, rounds):
    files = []
    for i, metrics in enumerate(rounds, 1):
        name = f"BENCH_r{i:02d}.json"
        if metrics is None:
            (tmp_path / name).write_text("not json at all")
            files.append(str(tmp_path / name))
        else:
            files.append(_round_file(tmp_path, name, metrics))
    return files


def _main_both(capsys, argv):
    rc = bench_trend.main(list(argv))
    out = capsys.readouterr().out
    ref_rc = ref_trend.main(list(argv))
    ref_out = capsys.readouterr().out
    return (rc, out), (ref_rc, ref_out)


def test_directions_equal_across_packages():
    assert bench_trend.DIRECTIONS == ref_trend.DIRECTIONS
    for name in NAMES + tuple(ref_trend.DIRECTIONS):
        assert bench_trend.lower_is_better(name) \
            == ref_trend.lower_is_better(name), name


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_trend_equal_across_packages(tmp_path, capsys, name):
    files = _scenario_files(tmp_path, SCENARIOS[name])
    report = bench_trend.trend(files, threshold_pct=10.0)
    assert report == ref_trend.trend(files, threshold_pct=10.0)
    assert bench_trend.render(report) == ref_trend.render(report)
    port, ref = _main_both(capsys, files + ["--strict"])
    assert port == ref


def test_checked_in_rounds_equal_across_packages(capsys):
    files = bench_trend.default_files(REPO_ROOT)
    assert files == ref_trend.default_files(REPO_ROOT)
    assert len(files) >= 2, "checked-in BENCH_r*.json missing"
    port, ref = _main_both(capsys, files)
    assert port == ref
    assert port[0] == 0


def test_tuned_vs_fixed_equal_across_packages(capsys):
    port, ref = _main_both(capsys, ["--tuned-vs-fixed", "--seed", "7",
                                    "--strict"])
    assert port == ref
    rc, out = port
    assert rc == 0
    line = [ln for ln in out.splitlines()
            if ln.startswith('{"tuner_sim"')][-1]
    assert json.loads(line)["tuner_sim"]["tuned_beats_all"] is True
