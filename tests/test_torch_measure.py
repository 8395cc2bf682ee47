"""The port's ``bench/measure.py`` and ``bench/rebaseline.py`` against the
reference's, on the CPU.

``measure``: counterparts of the behaviour tests of
``tests/test_measure_guard.py`` (the contended-plateau guard, its
extension and deadline, the last-good file's ratchet). Each runs the
port's ``stable_best_slope`` on a CPU uint32 tensor and the reference's on
the same parameters (``JAX_PLATFORMS=cpu``), and their ``contended`` flags
must agree. The noise guard's ceiling is the CPU peak of
``ops/cost_model.CPU_PEAKS`` here (the card's memory rate there); no TPU
figure is in the port.

``rebaseline``: the reference's rows need its Pallas kernels, so they run
here with ``stable_best_slope`` replaced by a stand-in in both packages:
each row's dict, the matrix, the byte accounting and the traffic the
guard is given must equal the reference's. The port's rows then run for
real at a small lane count (the kernels' plain versions on the CPU), each
step's output equal to the ``gf256`` / host crc32c oracle, and B1's tiled
product over Clay's [64, 176] repair matrix equal to the plain one.
Tolerance 0 throughout.
"""

import json
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu.bench import measure as ref_measure
from ceph_tpu.bench import rebaseline as ref_rebaseline
from ceph_tpu.ops import gf256 as ref_gf256
from ceph_tpu.utils import checksum as ref_checksum
from ceph_tpu_torch.bench import measure, rebaseline
from ceph_tpu_torch.ops import cost_model, crc32c_torch, gf_cuda, gf_torch

ROOT = Path(__file__).resolve().parents[1]


def _step(x):
    return measure._plus_one(x)


def _ref_step(x):
    import jax.numpy as jnp
    return x + jnp.uint32(1)


def _both(**kw):
    """The guard on the same parameters in both packages: (port, ref)
    results, each with its wall seconds appended."""
    import jax.numpy as jnp
    out = []
    for fn, step, x0 in (
            (measure.stable_best_slope, _step,
             torch.zeros(1 << 20, dtype=torch.uint32)),
            (ref_measure.stable_best_slope, _ref_step,
             jnp.zeros((1 << 20,), jnp.uint32))):
        t0 = time.perf_counter()
        res = fn(step, x0, **kw)
        out.append((*res, time.perf_counter() - t0))
    return out


def test_clean_run_not_contended():
    port, ref = _both(min_traffic_bytes=1, counts=(2, 6), time_budget=1.0,
                      stable_n=1, sleep=0.0)
    assert port[0] > 0 and ref[0] > 0
    assert port[3] is ref[3] is False


def test_plateau_slower_than_expectation_is_flagged():
    # an impossibly fast last-good slope: every plateau looks 3x+ slower,
    # so the guard extends, then flags contended rather than accept
    port, ref = _both(min_traffic_bytes=1, counts=(2, 6), time_budget=0.2,
                      stable_n=1, sleep=0.0, expect_slope=1e-12,
                      extended_budget=0.5)
    assert port[3] is ref[3] is True


def test_expectation_met_is_clean():
    port, ref = _both(min_traffic_bytes=1, counts=(2, 6), time_budget=1.0,
                      stable_n=1, sleep=0.0, expect_slope=10.0)
    assert port[3] is ref[3] is False


def test_contended_extension_keeps_sampling(monkeypatch):
    # the extension samples past the base budget, up to its deadline
    monkeypatch.setattr(measure.time, "sleep", lambda s: None)
    port, ref = _both(min_traffic_bytes=1, counts=(2, 6), time_budget=0.05,
                      stable_n=1, sleep=0.0, expect_slope=1e-12,
                      extended_budget=1.5)
    assert port[3] is ref[3] is True
    assert port[4] > 0.3 and ref[4] > 0.3, (port[4], ref[4])


def test_deadline_caps_sampling(monkeypatch):
    """A passed-soon deadline still gives one honest round, and the
    extension never samples past it."""
    monkeypatch.setattr(measure.time, "sleep", lambda s: None)
    port, ref = _both(min_traffic_bytes=1, counts=(2, 6), time_budget=30.0,
                      stable_n=1, sleep=0.0, expect_slope=1e-12,
                      extended_budget=30.0,
                      deadline=time.perf_counter() + 0.3)
    assert port[0] > 0 and ref[0] > 0
    assert port[3] == ref[3]
    assert port[4] < 10.0 and ref[4] < 10.0, (port[4], ref[4])


def test_last_good_roundtrip(tmp_path, monkeypatch):
    """The same merges in both packages give the same file: valid json,
    ratcheting up only."""
    files = {}
    for mod in (measure, ref_measure):
        p = tmp_path / f"{mod.__name__}.json"
        monkeypatch.setattr(mod, "LAST_GOOD_PATH", str(p))
        assert mod.load_last_good() == {}
        mod.save_last_good({"m1": 100.0})
        mod.save_last_good({"m2": 7.5})
        assert mod.load_last_good() == {"m1": 100.0, "m2": 7.5}
        mod.save_last_good({"m1": 60.0})
        assert mod.load_last_good()["m1"] == 100.0
        mod.save_last_good({"m1": 140.0})
        assert mod.load_last_good()["m1"] == 140.0
        files[mod] = json.loads(p.read_text())
    assert files[measure] == files[ref_measure]


def test_last_good_lives_under_build_and_is_ignored(tmp_path, monkeypatch):
    """The port's file defaults to ``build/bench/`` (made on first save),
    which git ignores: a card run never writes into a tracked file."""
    path = Path(measure.LAST_GOOD_PATH)
    assert path.relative_to(ROOT).parts[:2] == ("build", "bench")
    assert "build/bench/" in (ROOT / ".gitignore").read_text().split()
    nested = tmp_path / "a" / "b" / "last_good.json"
    monkeypatch.setattr(measure, "LAST_GOOD_PATH", str(nested))
    measure.save_last_good({"m": 1.0})
    assert json.loads(nested.read_text()) == {"m": 1.0}


def test_chained_slope_and_probe_on_the_cpu():
    slope = measure.chained_slope(_step, torch.zeros(1 << 20,
                                                     dtype=torch.uint32),
                                  min_traffic_bytes=1, counts=(2, 6),
                                  rounds=2, sleep=0.0)
    assert slope > 0
    gbps = measure.hbm_probe_gbps(nbytes=1 << 20, budget=0.1, device="cpu")
    assert gbps > 0 and np.isfinite(gbps)
    x = torch.zeros(4, dtype=torch.uint32)
    x[0] = 0xFFFFFFFF
    assert _step(x).tolist() == [0, 1, 1, 1]


def test_label_notes_the_warm_up():
    from ceph_tpu_torch.utils.device_telemetry import telemetry
    before = telemetry()._compiles.get("bench[probe_t]",
                                       {"compiles": 0})["compiles"]
    measure.stable_best_slope(_step, torch.zeros(1 << 12,
                                                 dtype=torch.uint32),
                              min_traffic_bytes=1, counts=(2, 6),
                              time_budget=0.0, sleep=0.0, label="probe_t")
    assert telemetry()._compiles["bench[probe_t]"]["compiles"] == \
        before + 1


def test_ceiling_is_the_cost_model_rate():
    assert measure.ceiling_bytes_per_s(torch.empty(0)) == \
        cost_model.CPU_PEAKS[0] * 1e9
    for name in ("HBM_CEILING_GBPS", "HBM_BYTES_PER_S"):
        assert not hasattr(measure, name)


def test_no_tpu_figure_in_the_port():
    """No TPU number stands in the port: the reference's engine baseline
    (87.9 GB/s), its HBM ceiling (820.0) and its last-good file's
    values."""
    figures = ["87.9", "820.0"] + [
        repr(v) for v in json.loads((ROOT / "ceph_tpu/bench/last_good.json")
                                    .read_text()).values()]
    pattern = re.compile(r"(?<![\d.])(" + "|".join(
        re.escape(f) for f in figures) + r")(?![\d])")
    files = sorted((ROOT / "ceph_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert hits == []


# -- rebaseline ------------------------------------------------------------

ROWS = list(rebaseline.CASES)


@pytest.fixture
def fake_slopes(monkeypatch):
    """``stable_best_slope`` in both rebaseline modules replaced by one
    stand-in that records the keywords it was given."""
    seen = {"port": [], "ref": []}

    def fake(who):
        def run(step, x0, **kw):
            seen[who].append(kw)
            return 1e-3, 0.0, 1, False
        return run
    monkeypatch.setattr(rebaseline, "stable_best_slope", fake("port"))
    monkeypatch.setattr(ref_rebaseline, "stable_best_slope", fake("ref"))
    return seen


@pytest.mark.parametrize("row", ROWS)
def test_row_dict_matches_reference(row, fake_slopes, monkeypatch):
    """The row the reference prints, key for key and value for value (the
    timing fields from the same stand-in slope), with the port's one
    addition, ``steps``; the traffic the guard is given is the same. The
    crc32c row is 24 MiB in the reference at any lane count, so both run
    it at the reference's N_LANES."""
    lanes = rebaseline.N_LANES if row == "crc32c" else 1 << 16
    monkeypatch.setattr(ref_rebaseline, "N_LANES", lanes)
    want = ref_rebaseline.ROWS[row]()
    got = rebaseline.run_row(row, "cpu", lanes)
    assert got.pop("steps") == 1
    assert got == want
    assert fake_slopes["port"] == fake_slopes["ref"]


def _ref_matrix(row):
    if row == "rs_dec3":
        gen = ref_gf256.systematic_generator(ref_gf256.rs_matrix_isa(8, 3))
        return ref_gf256.decode_matrix(gen, list(range(3, 11)), [0, 1, 2])
    if row == "shec_enc":
        return ref_rebaseline._shec_codec().coding_matrix
    if row == "shec_rec":
        codec = ref_rebaseline._shec_codec()
        _d, rows, cols, *_ = codec._search_plan(frozenset({0}),
                                                frozenset(range(1, 12)))
        return ref_gf256.invert_matrix(codec._submatrix(rows, cols))
    from ceph_tpu.models import registry
    codec = registry.instance().factory(
        "clay", {"plugin": "clay", "k": "8", "m": "4", "d": "11",
                 "backend": "numpy"})
    return codec._repair_matrix(0, tuple(range(1, 12)))


@pytest.mark.parametrize("row", [r for r in ROWS if r != "crc32c"])
def test_row_matrix_and_step_match_the_oracle(row):
    """The matrix equals the one the reference's own gf256, SHEC and Clay
    code build; a chained step (the kernel's plain version here) gives
    the gf256 oracle's product and carries row 0 of it into the data."""
    case = rebaseline.CASES[row](1 << 16)
    assert np.array_equal(case.mat, _ref_matrix(row))
    x = torch.from_numpy(case.data.copy())
    out = rebaseline.matvec_step(case.mat, x)
    want = ref_gf256.gf_matvec_chunks(case.mat, case.data)
    assert np.array_equal(out.numpy(), want)
    assert np.array_equal(x[0].numpy(), want[0])
    assert np.array_equal(x[1:].numpy(), case.data[1:])


def test_crc_row_step_matches_the_host_crc32c():
    case = rebaseline.crc32c_case(1 << 16)
    x = torch.from_numpy(case.data.copy())
    lin = rebaseline.crc_step(x)
    got = [crc32c_torch.crc32c_from_linear(v, case.data.shape[1], 0)
           for v in lin.tolist()]
    assert got == [ref_checksum.crc32c(bytes(r), 0) for r in case.data]
    assert int(x[0, 0]) == int(lin[0]) & 0xFF
    assert torch.equal(rebaseline.plain_crc_linear(
        torch.from_numpy(case.data)), lin)


@pytest.mark.parametrize("row", ROWS)
def test_row_runs_on_the_cpu(row):
    """A real (unfaked) row at a small lane count: the first step checked
    against the plain version, one sampling round (warm-up 2 + 2 x (5 +
    25) chained steps), a positive rate."""
    out = rebaseline.run_row(row, "cpu", 1 << 14, budget=0.0)
    assert out["steps"] == 63 and out["samples"] <= 1
    assert out["GBps"] >= 0 and "error" not in out


def test_tiled_product_matches_plain():
    """B1 tiled over blocks of at most 32 x 128: on a CPU tensor each
    block is the plain version, and the XORed blocks equal one plain
    product and the oracle, for Clay's [64, 176] matrix and ragged
    shapes."""
    rng = np.random.default_rng(5)
    mats = [rebaseline.clay_rep_case(1 << 16).mat] + [
        rng.integers(0, 256, size=s, dtype=np.uint8)
        for s in ((33, 129), (32, 128), (1, 300), (70, 5))]
    for mat in mats:
        data = rng.integers(0, 256, size=(mat.shape[1], 777),
                            dtype=np.uint8)
        x = torch.from_numpy(data)
        got = gf_cuda.matvec_tiled(mat, x)
        assert torch.equal(got, gf_torch.matvec(mat, x)), mat.shape
        assert np.array_equal(got.numpy(),
                              ref_gf256.gf_matvec_chunks(mat, data))


def test_main_prints_a_row_per_name_and_error_rows(capsys):
    """One JSON line a row; an unknown row is an error row and the session
    goes on, exit 0 (the reference's CLI contract)."""
    rc = rebaseline.main(["shec_enc", "nope", "--device", "cpu",
                          "--lanes", str(1 << 14), "--budget", "0"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["row"] for x in lines] == ["shec_k8m4c3_encode", "nope"]
    assert "error" in lines[1] and "error" not in lines[0]
