"""The port's plugin registry (``ceph_tpu_torch/models/registry.py``)
against the reference's, on the CPU.

The counterparts of the 12 tests of ``tests/test_plugin_registry.py``
(the purpose-built broken plugins are written for the port's
``PLUGIN_VERSION``, and the port's ``factory`` takes the torch device);
then what the two packages share: the same ``osd_erasure_code_plugins``
preload, a directory plugin file refused by the other package's version
check, and a directory plugin that wraps a built-in codec encoding the
reference's bytes.
"""

import textwrap
import threading

import numpy as np
import pytest

from ceph_tpu.models import registry as ref_registry
from ceph_tpu.utils.config import g_conf as ref_conf
from ceph_tpu_torch.models.registry import (
    ErasureCodePluginRegistry,
    PluginLoadError,
    PLUGIN_VERSION,
)
from ceph_tpu_torch.utils.config import g_conf


@pytest.fixture()
def registry():
    return ErasureCodePluginRegistry()  # fresh, not the singleton


def _write_plugin(tmp_path, name, body):
    (tmp_path / f"ec_{name}.py").write_text(textwrap.dedent(body))
    return str(tmp_path)


def test_load_builtin(registry):
    plugin = registry.load("example")
    codec = plugin.factory({"k": "2", "m": "1"}, "cpu")
    assert codec.get_chunk_count() == 3


def test_factory_end_to_end(registry):
    codec = registry.factory("jerasure", {"k": "4", "m": "2"}, device="cpu")
    assert codec.get_chunk_count() == 6


def test_unknown_plugin(registry):
    with pytest.raises(PluginLoadError):
        registry.load("no_such_plugin")


def test_missing_version(registry, tmp_path):
    d = _write_plugin(tmp_path, "nover", """
        def __erasure_code_init__(name, registry):
            pass
    """)
    with pytest.raises(PluginLoadError, match="version"):
        registry.load("nover", d)


def test_version_mismatch(registry, tmp_path):
    d = _write_plugin(tmp_path, "badver", """
        __erasure_code_version__ = "something-else"
        def __erasure_code_init__(name, registry):
            pass
    """)
    with pytest.raises(PluginLoadError, match="version"):
        registry.load("badver", d)


def test_missing_entry_point(registry, tmp_path):
    d = _write_plugin(tmp_path, "noentry", f"""
        __erasure_code_version__ = {PLUGIN_VERSION!r}
    """)
    with pytest.raises(PluginLoadError, match="entry point"):
        registry.load("noentry", d)


def test_fail_to_initialize(registry, tmp_path):
    d = _write_plugin(tmp_path, "failinit", f"""
        __erasure_code_version__ = {PLUGIN_VERSION!r}
        def __erasure_code_init__(name, registry):
            raise RuntimeError("boom")
    """)
    with pytest.raises(PluginLoadError, match="init failed"):
        registry.load("failinit", d)


def test_fail_to_register(registry, tmp_path):
    d = _write_plugin(tmp_path, "noreg", f"""
        __erasure_code_version__ = {PLUGIN_VERSION!r}
        def __erasure_code_init__(name, registry):
            pass  # forgets to register
    """)
    with pytest.raises(PluginLoadError, match="did not register"):
        registry.load("noreg", d)


def test_missing_file(registry, tmp_path):
    with pytest.raises(PluginLoadError, match="no plugin file"):
        registry.load("ghost", str(tmp_path))


def test_double_register(registry):
    registry.load("example")
    with pytest.raises(PluginLoadError, match="already registered"):
        registry.add("example", registry.get("example"))


def test_preload(registry):
    registry.preload(["example", "jerasure", "isa"])
    for name in ("example", "jerasure", "isa"):
        assert registry.get(name) is not None


def test_concurrent_load(registry):
    errors = []

    def worker():
        try:
            registry.load("jerasure")
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert registry.get("jerasure") is not None


# -- against the reference ------------------------------------------------

def test_default_preload_matches_reference(registry):
    """``preload()`` with no names reads ``osd_erasure_code_plugins``:
    the same option value in both packages, the same plugins loaded."""
    assert g_conf()["osd_erasure_code_plugins"] == \
        ref_conf()["osd_erasure_code_plugins"]
    ref = ref_registry.ErasureCodePluginRegistry()
    ref.preload()
    registry.preload()
    names = g_conf()["osd_erasure_code_plugins"].split()
    assert names
    for name in names:
        assert registry.get(name) is not None
        assert ref.get(name) is not None


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_plugin_file_of_the_other_package_is_refused(registry, tmp_path,
                                                     writer):
    """The plugin ABI is each package's own: a plugin file stamped with
    one package's ``PLUGIN_VERSION`` loads there and is refused by the
    other's version check."""
    version = ref_registry.PLUGIN_VERSION if writer == "reference" \
        else PLUGIN_VERSION
    d = _write_plugin(tmp_path, "stamped", f"""
        __erasure_code_version__ = {version!r}
        def __erasure_code_init__(name, registry):
            registry.add(name, object())
    """)
    ref = ref_registry.ErasureCodePluginRegistry()
    if writer == "reference":
        ref.load("stamped", d)
        with pytest.raises(PluginLoadError, match="version"):
            registry.load("stamped", d)
    else:
        registry.load("stamped", d)
        with pytest.raises(ref_registry.PluginLoadError, match="version"):
            ref.load("stamped", d)


def test_directory_plugin_encodes_like_the_reference(registry, tmp_path):
    """A directory plugin (``ec_<name>.py``) that wraps the built-in
    ``isa`` codec registers, and ``factory(name, profile, directory=)``
    gives a codec whose parity equals the reference's ``isa``."""
    d = _write_plugin(tmp_path, "wrapped", f"""
        from ceph_tpu_torch.models import registry as _r
        __erasure_code_version__ = {PLUGIN_VERSION!r}

        class _Plugin(_r.ErasureCodePlugin):
            def factory(self, profile, device):
                return _r.instance().factory("isa", profile, device=device)

        def __erasure_code_init__(name, registry):
            registry.add(name, _Plugin())
    """)
    profile = {"k": "8", "m": "3", "technique": "reed_sol_van",
               "backend": "torch"}
    codec = registry.factory("wrapped", profile, device="cpu",
                             directory=d)
    ref = ref_registry.ErasureCodePluginRegistry().factory(
        "isa", {**profile, "backend": "numpy"})
    rng = np.random.default_rng(14)
    data = rng.integers(0, 256, 8 * 4096, dtype=np.uint8).tobytes()
    want = set(range(11))
    got = codec.encode(want, data)
    exp = ref.encode(want, data)
    assert sorted(got) == sorted(exp)
    for i in want:
        assert np.array_equal(np.asarray(got[i]), np.asarray(exp[i])), i
