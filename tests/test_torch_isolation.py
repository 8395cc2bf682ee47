"""The port imports neither JAX nor the JAX package.

Every test process imports ``jax`` already (tests/conftest.py), so this is
checked statically: an AST scan of every module under ``ceph_tpu_torch/``
and of ``chip_smoke.py`` for imports of ``jax`` or ``ceph_tpu``
(``ceph_tpu_torch`` itself is allowed).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ceph_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ceph_tpu")


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
                ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
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
                 "ceph_tpu_torch/utils/noop_hooks.py",
                 "ceph_tpu_torch/bench/engine_loop.py",
                 "ceph_tpu_torch/bench/measure.py"):
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
                 "importlib.import_module('ceph_tpu.models')\n")
    bad = [n for n in _imported_modules(f) if _forbidden(n)]
    assert bad == ["jax.numpy", "ceph_tpu.ops", "ceph_tpu.models"]
