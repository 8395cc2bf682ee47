"""The harness on the CPU: every cell resolves to its files, a run's last
line has the contract's keys, and nothing the benchmark runs imports JAX
or the JAX package.

    python -m pytest ecbench/tests -q
"""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from ecbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

#: tiny sizes for CPU runs of each cell (the cell's shapes, less data;
#: rings of four or more slots)
TINY = {
    "rs_k8m3": ({"object_bytes": 65536, "flush_objects": 4}, 1 << 20),
    "clay_k8m4d11": ({"object_bytes": 4096, "objects_per_call": 4}, 1 << 16),
}


def tiny(cell: dict) -> dict:
    cfg, ring = TINY[cell["config"]]
    return {"config": cfg,
            "traffic": {"ring_bytes": ring, "trace_seconds": 0.2}}


def cpu_run(name: str, seed: int = 2**31 + 7, trace: bool = False,
            wrap=None) -> dict:
    cell = next(w for w in BENCH["workloads"] if w["name"] == name)
    return run.run_cell(name, seed, 0.3, trace, time.perf_counter(),
                        device="cpu", overrides=tiny(cell), wrap=wrap)


CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["ecbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    ends = {m["name"]: m for m in BENCH["end_to_end"]}
    assert ends["setup_s"]["bound"] <= 0.25
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        list(ends) + [m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in ends and UNIT.match(m["unit"])
        for w in m["workloads"]:
            assert w in ends[m["moves"]].get("workloads", CELLS)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        reported = [m for m in BENCH["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
    checks = 2 + 14 * 24
    assert checks * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    spec = run.resolve(BENCH, name)
    cfg, cell = spec["config"], spec["cell"]
    assert cfg["name"] == cell["config"]
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert entry["reduced"] == cfg["reduced"] == []
    assert (ROOT / cfg["reference"]).is_file()
    assert spec["entry"].is_file()
    assert spec["traffic"]["op"] in spec["entry"].stem
    for m in spec["per_layer"]:
        assert (ROOT / "ecbench" / "metrics" / f"{m['name']}.py").is_file()
    assert spec["end_to_end"] and spec["per_layer"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(name, trace):
    result = cpu_run(name, trace=trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    spec = run.resolve(BENCH, name)
    if trace:
        want = {m["name"] for m in spec["per_layer"]}
        # on the CPU only the host-clock readings find something to read
        assert {n for n in result["metrics"]} <= want
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"]
                                          for m in spec["end_to_end"]}
    for metric in result["metrics"].values():
        assert set(metric) == {"value", "unit"}
    for check in result["checks"].values():
        assert check["value"] <= check["limit"]


def test_the_sample_holds_each_stratum():
    sample = run.Reservoir(2, seed=5, stratum=lambda slot: slot % 3)
    for call in range(300):
        sample.offer((call % 12, call))
    assert sorted({slot % 3 for slot, _ in sample.kept}) == [0, 1, 2]
    assert len(sample.kept) == 6
    again = run.Reservoir(2, seed=5, stratum=lambda slot: slot % 3)
    for call in range(300):
        again.offer((call % 12, call))
    assert again.kept == sample.kept


def test_repair_checks_every_signature():
    result = cpu_run("clay_k8m4d11.repair_batch")
    assert result["checked_calls"] == 2 * 12
    assert result["checks"]["signatures_unchecked"]["value"] == 0


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def _sources(sub: str = "") -> list[Path]:
    base = ROOT / "ecbench" / sub
    return [p for p in base.rglob("*.py") if "tests" not in p.parts]


def test_harness_imports_neither_jax_nor_the_jax_package():
    for path in _sources():
        found = _imports(path) & {"jax", "jaxlib", "flax", "ceph_tpu"}
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        found = _imports(path) & {"jax", "jaxlib", "flax", "ceph_tpu",
                                  "ceph_tpu_torch"}
        assert not found, f"{path} imports {found}"
        assert _imports(path) <= {"__future__", "functools", "numpy",
                                  "torch", "ecbench"}


def test_a_run_loads_no_forbidden_module():
    cpu_run(CELLS[0])
    assert run.forbidden_loaded() == []


def test_without_a_card_a_run_prints_no_result(tmp_path):
    """Here there is no card: the command exits non-zero with nothing on
    standard output. The same holds in a directory that holds only
    BENCHMARK.json and the benchmark's folder."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "ecbench", tmp_path / "ecbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    import torch

    for cwd in (tmp_path,) if torch.cuda.is_available() else (ROOT, tmp_path):
        proc = subprocess.run(
            [sys.executable, "-m", "ecbench", "--workload", CELLS[0],
             "--seed", "5", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode != 0
        assert proc.stdout.strip() == ""
        assert "no result" in proc.stderr
