"""The port's ``native`` host GF backend (``ceph_tpu_torch/native/gf256.cc``
through ``ops/native_loader.py`` and ``ops/native.py``) against the
reference's (``ceph_tpu/ops/native/gf256.cc``, ``ops/native_loader.py``)
and its ``gf256.gf_matvec_chunks`` oracle, on the CPU.

Counterparts of ``tests/test_native.py``'s GF cases: the matvec, region
XOR and region multiply-add bit-exact over odd lengths, k up to 32 and an
unaligned base; the backend registered; a codec round trip on ``native``
equal to the reference's. Beside them, where the port takes ``native`` as
the reference does: an EC pool's host twin, ``ec_util``'s host flush and
Clay's inner codecs; and a failed build raises. Tolerance 0.
"""

import ctypes

import numpy as np
import pytest
import torch

from ceph_tpu.models import instance as ref_instance
from ceph_tpu.ops import backend as ref_backend
from ceph_tpu.ops import gf256 as ref_gf256
from ceph_tpu.ops import native_loader as ref_loader
from ceph_tpu_torch.models import instance
from ceph_tpu_torch.ops import backend, native, native_loader
from ceph_tpu_torch.osd import ec_backend, ec_util

#: (m, k, n): odd lengths, one shorter than a SIMD step, k up to 32
SHAPES = [(1, 1, 1), (3, 8, 4097), (4, 12, 1000), (2, 2, 31), (6, 32, 333),
          (11, 32, 65537), (3, 17, 64)]


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_matvec_bit_exact_against_reference(m, k, n):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    mat = rng.integers(0, 256, (m, k), dtype=np.uint8)
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    got = native_loader.matvec(mat, data)
    assert np.array_equal(got, ref_loader.matvec(mat, data))
    assert np.array_equal(got, ref_gf256.gf_matvec_chunks(mat, data))


def test_matvec_unaligned_base():
    """Rows starting one byte past a 32-byte boundary: the SIMD loop takes
    unaligned loads."""
    rng = np.random.default_rng(7)
    mat = rng.integers(0, 256, (3, 8), dtype=np.uint8)
    raw = rng.integers(0, 256, 8 * 4099 + 1, dtype=np.uint8)
    data = raw[1:].reshape(8, 4099)
    assert data.ctypes.data % 32 != 0
    assert np.array_equal(native_loader.matvec(mat, data),
                          ref_loader.matvec(mat, data))
    assert np.array_equal(native_loader.matvec(mat, data),
                          ref_gf256.gf_matvec_chunks(mat, data))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 4097])
@pytest.mark.parametrize("offset", [0, 1])
def test_region_ops_bit_exact_against_reference(n, offset):
    rng = np.random.default_rng(n + offset)
    src = rng.integers(0, 256, n + offset, dtype=np.uint8)[offset:]
    dst0 = rng.integers(0, 256, n + offset, dtype=np.uint8)[offset:]
    got, want = dst0.copy(), dst0.copy()
    native_loader.region_xor(got, src)
    ref_loader.region_xor(want, src)
    assert np.array_equal(got, want)
    assert np.array_equal(got, dst0 ^ src)
    for c in (0, 1, 2, 0x1d, 0xff):
        got, want = dst0.copy(), dst0.copy()
        native_loader.region_mul_add(got, src, c)
        ref_loader.get_lib().gf256_region_mul_add(
            _u8p(want), _u8p(src), ctypes.c_uint8(c), want.size)
        assert np.array_equal(got, want), c
        oracle = dst0 ^ ref_gf256.gf_matvec_chunks(
            np.array([[c]], np.uint8), src[None, :])[0]
        assert np.array_equal(got, oracle), c


def test_region_ops_refuse_mismatched_buffers():
    a = np.zeros(8, np.uint8)
    with pytest.raises(ValueError):
        native_loader.region_xor(a, np.zeros(9, np.uint8))
    with pytest.raises(ValueError):
        native_loader.region_mul_add(a, np.zeros(8, np.int32), 3)


def test_native_backend_registered():
    assert "native" in ref_backend.available_backends()
    assert backend.BACKENDS["native"] is native.matvec
    assert backend.resolve_name("native", "cpu") == "native"
    rng = np.random.default_rng(3)
    mat = rng.integers(0, 256, (3, 8), dtype=np.uint8)
    data = rng.integers(0, 256, (8, 999), dtype=np.uint8)
    native_loader.reset_calls()
    got = backend.matvec(mat, torch.from_numpy(data), "native")
    assert native_loader.matvec_calls == 1
    assert np.array_equal(got.numpy(),
                          ref_backend.matvec(mat, data, "native"))


@pytest.mark.parametrize("plugin,technique", [("isa", "reed_sol_van"),
                                              ("jerasure", "cauchy_good")])
def test_codec_roundtrip_on_native_equals_reference(plugin, technique):
    profile = {"k": "8", "m": "3", "technique": technique,
               "backend": "native"}
    ref = ref_instance().factory(plugin, dict(profile))
    port = instance().factory(plugin, dict(profile), device="cpu")
    assert port.resolved_backend == "native"
    data = np.random.default_rng(5).integers(0, 256, 256 * 64 + 17,
                                             dtype=np.uint8).tobytes()
    enc = port.encode(list(range(11)), data)
    ref_enc = ref.encode(list(range(11)), data)
    for i in range(11):
        assert np.array_equal(enc[i], ref_enc[i]), i
    cs = port.get_chunk_size(len(data))
    for lost in ([0, 9], [1, 2, 3], [8]):
        avail = {i: enc[i] for i in range(11) if i not in lost}
        native_loader.reset_calls()
        dec = port.decode(lost, avail, cs)
        ref_dec = ref.decode(lost, dict(avail), cs)
        for i in lost:
            assert np.array_equal(dec[i], enc[i]), (lost, i)
            assert np.array_equal(dec[i], ref_dec[i]), (lost, i)


def _host_twins(pkg: str) -> tuple[list[str], bytes]:
    """Boot ``pkg``'s MiniCluster with a host-twin EC pool, write, splice
    a RMW into the object, and return each PG's host-twin codec backend
    and the object read back."""
    import importlib
    cluster_mod = importlib.import_module(f"{pkg}.qa.cluster")
    # the reference registers ``native`` lazily, on the first call of
    # available_backends(), and marks that done before the import ends:
    # an OSD thread asking meanwhile sees numpy only. Load it first.
    ref_backend.available_backends()
    with cluster_mod.MiniCluster(n_osds=3) as cluster:
        cluster.create_ec_pool("p", k=2, m=1, pg_num=1)
        io = cluster.client().open_ioctx("p")
        io.write_full("o", b"x" * 9000)
        io.write("o", b"y" * 100, offset=4000)      # RMW: host re-encode
        back = io.read("o")
        names = [pg.backend.codec.backend for osd in cluster.osds.values()
                 for pg in osd.pgs.values()]
    return names, back


def test_host_twin_and_host_flush_take_native():
    """An EC pool's host twin encodes on ``native``, as the reference's
    does where its native library loads, and so does ec_util's host
    flush."""
    assert ec_backend.HOST_BACKEND == "native"
    native_loader.reset_calls()
    names, back = _host_twins("ceph_tpu_torch")
    assert native_loader.matvec_calls > 0
    ref_names, ref_back = _host_twins("ceph_tpu")
    assert back == ref_back == b"x" * 4000 + b"y" * 100 + b"x" * 4900
    assert names and names == ref_names == ["native"] * len(names)
    codec = instance().factory("isa", {"k": "8", "m": "3",
                                       "backend": "native"}, device="cpu")
    sinfo = ec_util.StripeInfo(stripe_width=8 * 256, chunk_size=256)
    bufs = [np.random.default_rng(i).integers(0, 256, 8 * 256 * (i + 1),
                                              dtype=np.uint8)
            for i in range(3)]
    native_loader.reset_calls()
    results = ec_util.flush_host_async(sinfo, codec, [0, 1, 2], bufs)()
    assert native_loader.matvec_calls == 1
    for (_op, shards, crcs), buf in zip(results, bufs):
        want = ec_util.encode(sinfo, codec, buf)
        assert crcs is None
        for i in range(11):
            assert np.array_equal(shards[i], want[i]), i


def test_clay_inner_codecs_take_native():
    port = instance().factory("clay", {"k": "4", "m": "2", "d": "5",
                                       "backend": "torch"}, device="cpu")
    ref = ref_instance().factory("clay", {"k": "4", "m": "2", "d": "5",
                                          "backend": "numpy"})
    assert port.mds.resolved_backend == port.pft.resolved_backend == \
        "native"
    data = np.random.default_rng(9).integers(0, 256, 4 * 8 * 64,
                                             dtype=np.uint8).tobytes()
    enc, ref_enc = port.encode(list(range(6)), data), \
        ref.encode(list(range(6)), data)
    for i in range(6):
        assert np.array_equal(enc[i], ref_enc[i]), i
    numpy_clay = instance().factory("clay", {"k": "4", "m": "2", "d": "5",
                                             "backend": "numpy"},
                                    device="cpu")
    assert numpy_clay.mds.resolved_backend == "numpy"


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No numpy fallback: without a compiler the backend raises."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    mat = np.ones((1, 2), np.uint8)
    with pytest.raises(native_loader.NativeBuildError):
        native_loader.matvec(mat, np.zeros((2, 8), np.uint8))
    with pytest.raises(native_loader.NativeBuildError):
        backend.matvec(mat, torch.zeros((2, 8), dtype=torch.uint8),
                       "native")
