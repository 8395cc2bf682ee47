"""The port imports neither JAX nor the JAX package.

Every test process imports ``jax`` already (tests/conftest.py), so this is
checked statically: an AST scan of every module under ``ceph_tpu_torch/``
and of ``chip_smoke.py`` for imports of ``jax`` or ``ceph_tpu``
(``ceph_tpu_torch`` itself is allowed). ``import_module`` / ``__import__``
calls count with a constant argument or an f-string's leading constant
(the mgr loads its modules as ``f"ceph_tpu_torch.mgr.{name}"``).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ceph_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ceph_tpu")


def _leading_constant(arg) -> str | None:
    """The module name an import call's argument starts with: the whole
    constant, or an f-string's leading constant part."""
    if isinstance(arg, ast.Constant):
        return str(arg.value)
    if isinstance(arg, ast.JoinedStr) and arg.values and \
            isinstance(arg.values[0], ast.Constant):
        return str(arg.values[0].value)
    return None


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) in \
                ("import_module", "__import__") and node.args:
            name = _leading_constant(node.args[0])
            if name is not None:
                names.append(name)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_scan_covers_the_port():
    assert (ROOT / "chip_smoke.py").is_file()
    rel = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for must in ("ceph_tpu_torch/ops/gf_cuda.py",
                 "ceph_tpu_torch/osd/ec_util.py",
                 "ceph_tpu_torch/models/registry.py",
                 "ceph_tpu_torch/models/clay.py",
                 "ceph_tpu_torch/models/clay_device.py",
                 "ceph_tpu_torch/models/shec.py",
                 "ceph_tpu_torch/ops/clay_cuda.py",
                 "ceph_tpu_torch/ops/gf_block_sparse.py",
                 "ceph_tpu_torch/ops/gf_xor.py",
                 "ceph_tpu_torch/ops/gf_xor_cuda.py",
                 "ceph_tpu_torch/ops/gf_xor_torch.py",
                 "ceph_tpu_torch/models/lrc.py",
                 "ceph_tpu_torch/models/example_xor.py",
                 "ceph_tpu_torch/tools/ec_non_regression.py",
                 "ceph_tpu_torch/osd/device_engine.py",
                 "ceph_tpu_torch/utils/perf_counters.py",
                 "ceph_tpu_torch/utils/device_telemetry.py",
                 "ceph_tpu_torch/utils/stage_clock.py",
                 "ceph_tpu_torch/utils/dout.py",
                 "ceph_tpu_torch/analysis/lock_witness.py",
                 "ceph_tpu_torch/analysis/linters.py",
                 "ceph_tpu_torch/tools/analyze.py",
                 "ceph_tpu_torch/bench/engine_loop.py",
                 "ceph_tpu_torch/bench/measure.py",
                 "ceph_tpu_torch/osd/ec_backend.py",
                 "ceph_tpu_torch/osd/osd.py",
                 "ceph_tpu_torch/parallel/mon.py",
                 "ceph_tpu_torch/parallel/messenger.py",
                 "ceph_tpu_torch/qa/cluster.py",
                 "ceph_tpu_torch/qa/thrasher.py",
                 "ceph_tpu_torch/parallel/auth.py",
                 "ceph_tpu_torch/crimson/__init__.py",
                 "ceph_tpu_torch/crimson/osd.py",
                 "ceph_tpu_torch/crimson/reactor.py",
                 "ceph_tpu_torch/crimson/readpath.py",
                 "ceph_tpu_torch/utils/flight_recorder.py",
                 "ceph_tpu_torch/mgr/__init__.py",
                 "ceph_tpu_torch/mgr/mgr.py",
                 "ceph_tpu_torch/mgr/mgr_module.py",
                 "ceph_tpu_torch/mgr/health.py",
                 "ceph_tpu_torch/tools/rados_cli.py",
                 "ceph_tpu_torch/bench/cluster_bench.py",
                 "ceph_tpu_torch/bench/load_gen.py",
                 "ceph_tpu_torch/utils/knobs.py",
                 "ceph_tpu_torch/utils/tracepoints.py",
                 "ceph_tpu_torch/utils/autopsy.py",
                 "ceph_tpu_torch/utils/prometheus.py",
                 "ceph_tpu_torch/utils/compile_cache.py",
                 "ceph_tpu_torch/parallel/placement.py",
                 "ceph_tpu_torch/tools/bench_trend.py",
                 "ceph_tpu_torch/tools/trace_export.py",
                 "ceph_tpu_torch/bench/tuner_sim.py",
                 "ceph_tpu_torch/mgr/tuner.py",
                 "ceph_tpu_torch/mgr/trace.py",
                 "ceph_tpu_torch/mgr/balancer.py",
                 "ceph_tpu_torch/mgr/progress.py",
                 "ceph_tpu_torch/mgr/telemetry.py",
                 "ceph_tpu_torch/mgr/dashboard.py",
                 "ceph_tpu_torch/ops/cost_model.py",
                 "ceph_tpu_torch/ops/native.py",
                 "ceph_tpu_torch/client/striper.py",
                 "ceph_tpu_torch/cls/__init__.py",
                 "ceph_tpu_torch/cls/classes.py",
                 "ceph_tpu_torch/services/journal.py",
                 "ceph_tpu_torch/services/rbd.py",
                 "ceph_tpu_torch/services/rbd_mirror.py",
                 "ceph_tpu_torch/tools/rbd_cli.py",
                 "ceph_tpu_torch/services/rgw.py",
                 "ceph_tpu_torch/services/rgw_lc.py",
                 "ceph_tpu_torch/services/rgw_sync.py",
                 "ceph_tpu_torch/services/cephfs.py",
                 "ceph_tpu_torch/services/mds.py",
                 "ceph_tpu_torch/services/mds_client.py",
                 "ceph_tpu_torch/parallel/mesh.py",
                 "ceph_tpu_torch/parallel/mesh_compile.py",
                 "ceph_tpu_torch/parallel/sharded_codec.py",
                 "ceph_tpu_torch/tools/flame.py",
                 "ceph_tpu_torch/tools/crushtool.py",
                 "ceph_tpu_torch/tools/osdmaptool.py",
                 "ceph_tpu_torch/tools/dencoder.py",
                 "ceph_tpu_torch/tools/ceph_cli.py",
                 "ceph_tpu_torch/tools/vstart.py"):
        assert must in rel


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[p.relative_to(ROOT).as_posix() for p in PORT_FILES])
def test_port_file_imports_no_jax_or_reference(path):
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_flags_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom ceph_tpu.ops import gf256\n"
                 "from ceph_tpu_torch.ops import gf256 as ok\n"
                 "importlib.import_module('ceph_tpu.models')\n"
                 "importlib.import_module(f'ceph_tpu.mgr.{name}')\n"
                 "importlib.import_module(f'ceph_tpu_torch.mgr.{name}')\n"
                 "importlib.import_module(f'{pkg}.mgr')\n")
    bad = [n for n in _imported_modules(f) if _forbidden(n)]
    assert bad == ["jax.numpy", "ceph_tpu.ops", "ceph_tpu.models",
                   "ceph_tpu.mgr."]
