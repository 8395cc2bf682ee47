"""The port's Clay codec (ceph_tpu_torch.models.clay, .clay_device) against
the JAX package's (ceph_tpu.models.clay, .clay_device).

- the host tables (``trace_layered``, ``pft_coefficients``,
  ``build_encode_fast(tables_only)``, ``build_decode_tables``) equal the
  reference's;
- kernel B3's plain version against the reference ``build_encode_kernel``
  (Pallas, interpret mode), kernel B4's plain version against the
  reference ``build_transform_kernel`` (interpret mode) and
  ``build_transform``;
- the flat tables the CUDA kernels B3 and B4 read are replayed by numpy
  emulations of the kernels' loops and must give the plain versions'
  bytes (the kernels themselves run only on the card:
  tests/test_torch_cuda.py);
- the codec (encode, every 1- and 2-erasure decode, single-node repair)
  on every backend route, ``ec_util`` with Clay, and
  ``from_reference_profile``, against the reference codec.

Tolerance 0: every result is bytes. Inputs come from numpy generators
with fixed seeds.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.models import clay_device as ref_cd
from ceph_tpu.models import instance as ref_instance
from ceph_tpu.osd import ec_util as ref_ec
from ceph_tpu_torch.models import clay_device as cd
from ceph_tpu_torch.models import from_reference_profile, instance
from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.ops import clay_cuda, gf256, gf_block_sparse_cuda
from ceph_tpu_torch.ops import gf_cuda, gf_torch
from ceph_tpu_torch.osd import ec_util

FLAGSHIP = dict(k=8, m=4, d=11)
VIRTUAL = dict(k=4, m=3, d=6)          # nu = 2 virtual nodes
SMALL = dict(k=4, m=2, d=5)


def _prof(profile, **extra):
    out = {str(k): str(v) for k, v in profile.items()}
    out.update({k: str(v) for k, v in extra.items()})
    return out


def ref_codec(profile, **extra):
    return ref_instance().factory(
        "clay", _prof(profile, backend="numpy", **extra))


def port_codec(profile, **extra):
    return instance().factory("clay", _prof(profile, **extra), device="cpu")


def _padded_erased(c, lost):
    erased = {c._node_id(i) for i in lost}
    for i in range(c.k + c.nu, c.q * c.t):
        if len(erased) >= c.m:
            break
        erased.add(i)
    return frozenset(erased)


def _data(c, sc, seed):
    rng = np.random.default_rng(seed)
    return {i: rng.integers(0, 256, c.sub_chunk_no * sc, dtype=np.uint8)
            for i in range(c.k)}


def _full(c, data):
    full = dict(data)
    full.update(c.encode_chunks(list(range(c.k, c.k + c.m)), data))
    return full


def _node_input(c, chunks, erased, sc):
    cin = np.zeros((c.q * c.t, c.sub_chunk_no, sc), dtype=np.uint8)
    for i, buf in chunks.items():
        if c._node_id(i) not in erased:
            cin[c._node_id(i)] = np.asarray(buf).reshape(c.sub_chunk_no, sc)
    return cin


# -- host tables ---------------------------------------------------------

def _same_levels(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        for name in ("ident", "pair_a", "planes", "ident2", "type_c",
                     "pair_b"):
            assert getattr(la, name) == getattr(lb, name), name


def _same_tables(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        va, vb = a[key], b[key]
        if isinstance(va, list) and va and isinstance(va[0], tuple):
            assert [x[0] for x in va] == [x[0] for x in vb], key
            for (_, ta), (_, tb) in zip(va, vb):
                assert np.array_equal(ta, tb), key
        elif isinstance(va, list):
            assert len(va) == len(vb), key
            for xa, xb in zip(va, vb):
                assert np.array_equal(np.asarray(xa), np.asarray(xb)), key
        else:
            assert np.array_equal(np.asarray(va), np.asarray(vb)), key


@pytest.mark.parametrize("profile", [FLAGSHIP, VIRTUAL, SMALL],
                         ids=["k8m4d11", "k4m3d6", "k4m2d5"])
def test_host_tables_equal_reference(profile):
    ref, port = ref_codec(profile), port_codec(profile)
    assert (port.q, port.t, port.nu, port.sub_chunk_no) == \
        (ref.q, ref.t, ref.nu, ref.sub_chunk_no)
    coeffs = cd.pft_coefficients(port)
    ref_coeffs = ref_cd.pft_coefficients(ref)
    assert sorted(coeffs) == sorted(ref_coeffs)
    for key in coeffs:
        assert np.array_equal(coeffs[key], ref_coeffs[key]), key
    _same_tables(cd.build_encode_fast(port, tables_only=True).tables,
                 ref_cd.build_encode_fast(ref, tables_only=True).tables)
    qt = port.q * port.t
    sigs = [_padded_erased(port, lost) for lost in
            ([0], [0, 1], [port.k, port.k + port.m - 1])]
    if qt <= 9:
        sigs += [frozenset(er) for er in
                 itertools.combinations(range(qt), port.m)]
    for erased in sigs:
        _same_levels(cd.trace_layered(port, erased),
                     ref_cd.trace_layered(ref, erased))
        _same_tables(cd.build_decode_tables(port, erased),
                     ref_cd.build_decode_tables(ref, erased))
    coef = np.random.default_rng(1).integers(0, 256, (40, 1), np.uint8)
    bits, tab = cd._vartabs_of(coef)
    rbits, rtab = ref_cd._vartabs_of(coef)
    assert bits == rbits and np.array_equal(tab, rtab)


# -- kernel B3's plain version ------------------------------------------

@pytest.mark.parametrize("profile,sc", [(FLAGSHIP, 40), (VIRTUAL, 9)],
                         ids=["k8m4d11", "k4m3d6"])
def test_plain_b3_equals_reference_encode_kernel(profile, sc):
    ref, port = ref_codec(profile), port_codec(profile)
    data = _data(ref, sc, 23)
    x = np.stack([data[i].reshape(ref.sub_chunk_no, sc)
                  for i in range(ref.k)])
    want = np.asarray(ref_cd.build_encode_kernel(ref)(x))
    enc = cd.build_encode_kernel(port)
    clay_cuda.reset_launches()
    got = enc(torch.from_numpy(x))
    assert clay_cuda.encode_launches == 0          # CPU: plain version
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(cd.build_encode_fast(port)(
        torch.from_numpy(x)).numpy(), want)
    host = ref.encode_chunks(list(range(ref.k, ref.k + ref.m)), data)
    for p in range(ref.m):
        assert np.array_equal(want[p].reshape(-1), host[ref.k + p])


def _mul(c, v):
    return gf256.MUL_TABLE[int(c)][v]


def _emulate_encode(arr, x):
    """csrc/clay_encode.cu's loops over its tables, in numpy (lanes
    vectorized): u_d per plane, its MDS product into u_p, then the
    recouple reading u_p across planes."""
    kk, ssc, m = arr["kk"], arr["ssc"], arr["m"]
    L = x.shape[1]

    def term(c, row):
        if c == 0 or row < 0:
            return np.zeros(L, dtype=np.uint8)
        return _mul(c, x[row])

    up = np.zeros((m * ssc, L), dtype=np.uint8)
    for z in range(ssc):
        for j in range(kk):
            f = j * ssc + z
            ud = term(arr["a1"][f], arr["ps_row"][f]) ^ \
                term(arr["a2"][f], arr["pa_row"][f])
            for i in range(m):
                up[i * ssc + z] ^= _mul(arr["dmat"][i, j], ud)
    out = np.empty((m * ssc, L), dtype=np.uint8)
    for r in range(m * ssc):
        v = term(arr["b1"][r], arr["pc_row"][r]) ^ _mul(arr["b2"][r], up[r])
        if arr["b3"][r]:
            v ^= _mul(arr["b3"][r], up[arr["pu"][r]])
        out[r] = v
    return out


@pytest.mark.parametrize("profile", [FLAGSHIP, VIRTUAL, SMALL],
                         ids=["k8m4d11", "k4m3d6", "k4m2d5"])
def test_b3_kernel_tables_replay_to_plain(profile):
    port = port_codec(profile)
    sc = 7
    data = _data(port, sc, 5)
    x = np.stack([data[i].reshape(port.sub_chunk_no, sc)
                  for i in range(port.k)])
    fast = cd.build_encode_fast(port)
    want = fast(torch.from_numpy(x)).numpy()
    arr = cd.encode_kernel_arrays(fast.tables)
    got = _emulate_encode(arr, x.reshape(-1, sc))
    assert np.array_equal(got.reshape(want.shape), want)


# -- kernel B4's plain version ------------------------------------------

def test_plain_b4_equals_reference_transform_kernel():
    """The reference's Pallas decode kernel in interpret mode, k=4, m=2,
    L=32."""
    ref, port = ref_codec(SMALL), port_codec(SMALL)
    sc = 32
    full = _full(ref, _data(ref, sc, 37))
    for lost in ([0, 1], [2, 5]):
        erased = _padded_erased(ref, lost)
        chunks = {i: b for i, b in full.items() if i not in lost}
        cin = _node_input(ref, chunks, erased, sc)
        want = np.asarray(ref_cd.build_transform_kernel(ref, erased)(cin))
        got = cd.build_transform_kernel(port, erased)(
            torch.from_numpy(cin)).numpy()
        assert np.array_equal(got, want), lost
        er = sorted(erased)
        for ch in lost:
            assert np.array_equal(
                got[er.index(ref._node_id(ch))].reshape(-1), full[ch])


@pytest.mark.parametrize("lost", [[0, 1], [0, 9], [3], [0, 5, 8, 11]])
def test_plain_b4_equals_reference_transform_flagship(lost):
    ref, port = ref_codec(FLAGSHIP), port_codec(FLAGSHIP)
    sc = 5
    full = _full(ref, _data(ref, sc, 41))
    erased = _padded_erased(ref, lost)
    chunks = {i: b for i, b in full.items() if i not in lost}
    cin = _node_input(ref, chunks, erased, sc)
    want = np.asarray(ref_cd.ClayDeviceCodec(ref).transform(erased, cin))
    got = cd.ClayDeviceCodec(port).transform(erased, cin).numpy()
    assert np.array_equal(got, want)
    for ch in lost:
        assert np.array_equal(got[ref._node_id(ch)].reshape(-1), full[ch])


def _emulate_transform(arr, cin):
    """csrc/clay_transform.cu's phases over its tables, in numpy (lanes
    vectorized), each phase updating its array in place as the kernel's
    threads do."""
    qt, ssc, kk, e = arr["qt"], arr["ssc"], arr["kk"], arr["e"]
    flat = cin.reshape(qt * ssc, -1)
    cz = np.where(np.repeat(arr["load"], ssc)[:, None] == 1, flat, 0)
    cz = cz.astype(np.uint8)
    u = np.zeros_like(cz)
    for li in range(arr["n_levels"]):
        for r in arr["u_rows"][arr["u_off"][li]:arr["u_off"][li + 1]]:
            u[r] = _mul(arr["a1"][r], cz[r]) ^ \
                _mul(arr["a2"][r], cz[arr["pair"][r]])
        for z in arr["planes"][arr["p_off"][li]:arr["p_off"][li + 1]]:
            for j in range(e):
                acc = np.zeros(cz.shape[1], dtype=np.uint8)
                for c in range(kk):
                    acc ^= _mul(arr["dmat"][j, c],
                                u[arr["intact"][c] * ssc + z])
                u[arr["er"][j] * ssc + z] = acc
        for r in arr["c_rows"][arr["c_off"][li]:arr["c_off"][li + 1]]:
            p = arr["p2"][r]
            cz[r] = _mul(arr["b1"][r], cz[p]) ^ _mul(arr["b2"][r], u[r]) ^ \
                _mul(arr["b3"][r], u[p])
    return np.stack([cz[n * ssc:(n + 1) * ssc] for n in arr["er"]])


@pytest.mark.parametrize("profile,lost", [
    (FLAGSHIP, [0, 1]), (FLAGSHIP, [3]), (FLAGSHIP, [0, 5, 8, 11]),
    (VIRTUAL, [0, 1, 2]), (VIRTUAL, [4, 6]), (SMALL, [1, 4]), (SMALL, [5]),
])
def test_b4_kernel_tables_replay_to_plain(profile, lost):
    port = port_codec(profile)
    sc = 3
    full = _full(port, _data(port, sc, 43))
    erased = _padded_erased(port, lost)
    chunks = {i: b for i, b in full.items() if i not in lost}
    cin = _node_input(port, chunks, erased, sc)
    want = cd.build_transform_kernel(port, erased)(
        torch.from_numpy(cin)).numpy()
    arr = cd.transform_kernel_arrays(port, erased)
    assert np.array_equal(_emulate_transform(arr, cin), want)
    er = sorted(erased)
    for ch in lost:
        assert np.array_equal(want[er.index(port._node_id(ch))].reshape(-1),
                              full[ch])


# -- the codec ----------------------------------------------------------

ROUTES = {
    "torch": {},
    "numpy": {"backend": "numpy"},
    # the cuda route on CPU tensors: every wrapper runs its plain version
    "cuda-wrappers": {"backend": "cuda"},
    "decode_kernel": {"backend": "cuda", "decode_kernel": "true"},
    "sparse-always": {"backend": "cuda"},
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_codec_matches_reference_every_1_2_erasure_and_repair(
        route, monkeypatch):
    if route == "sparse-always":
        monkeypatch.setenv("CEPH_TPU_CLAY_SPARSE", "always")
    ref = ref_codec(SMALL)
    port = port_codec(SMALL, **ROUTES[route])
    n = port.get_chunk_count()
    data = np.random.default_rng(42).integers(
        0, 256, size=4 * 1000 + 3, dtype=np.uint8).tobytes()
    want = ref.encode(list(range(n)), data)
    gf_block_sparse_cuda.reset_launches()
    clay_cuda.reset_launches()
    gf_cuda.reset_launches()
    got = port.encode(list(range(n)), data)
    for i in range(n):
        assert np.array_equal(got[i], want[i]), i
    cs = len(want[0])
    assert cs == port.get_chunk_size(len(data))
    for e in (1, 2):
        for lost in itertools.combinations(range(n), e):
            avail = {i: want[i] for i in range(n) if i not in lost}
            assert port.minimum_to_decode(list(lost), list(avail)) == \
                ref.minimum_to_decode(list(lost), list(avail))
            out = port.decode(list(lost), avail, cs)
            for i in lost:
                assert np.array_equal(out[i], want[i]), (route, lost, i)
    # single-node repair from d helpers' sub-chunk ranges
    sc = cs // port.sub_chunk_no
    for lost in range(n):
        avail = [i for i in range(n) if i != lost]
        plan = port.minimum_to_decode([lost], avail)
        assert plan == ref.minimum_to_decode([lost], avail)
        assert len(plan) == port.d
        helpers = {c: np.concatenate([want[c][o * sc:(o + cnt) * sc]
                                      for o, cnt in ranges])
                   for c, ranges in plan.items()}
        assert len(next(iter(helpers.values()))) == \
            cs // port.q
        out = port.decode([lost], helpers, cs)
        assert np.array_equal(out[lost], want[lost]), (route, lost)
        assert np.array_equal(
            out[lost], ref.decode([lost], helpers, cs)[lost])
    # no kernel launches on CPU tensors, whatever the route
    assert clay_cuda.encode_launches == clay_cuda.transform_launches == 0
    assert gf_block_sparse_cuda.launches == gf_cuda.launches == 0
    if route == "sparse-always":
        assert all(fn.path == "sparse" for key, fn in port._lin_cache.items()
                   if key[0] == "sparse")
    if route == "decode_kernel":
        assert any(key[0] == "ker" for key in port._lin_cache)


def test_decode_matvec_calibration_modes(monkeypatch):
    port = port_codec(SMALL, backend="cuda")
    mat = port._decode_matrix((0, 2, 4, 5), (1, 3))
    x = np.random.default_rng(11).integers(
        0, 256, size=(mat.shape[1], 512), dtype=np.uint8)
    want = gf256.gf_matvec_chunks(mat, x)
    for mode, path in (("never", "dense"), ("always", "sparse"),
                       ("auto", "dense")):
        monkeypatch.setenv("CEPH_TPU_CLAY_SPARSE", mode)
        fn = cd.build_decode_matvec(port, mat)
        assert fn.path == path, mode
        assert np.array_equal(fn(torch.from_numpy(x)).numpy(), want)
    # a CPU codec never times anything: dense, with the plan's cost noted
    assert fn.measured["skipped"] is True


def test_backend_routes_oversized_matrices_to_the_counted_dense_product():
    from ceph_tpu_torch.ops import backend
    big = np.random.default_rng(3).integers(0, 256, (64, 176), np.uint8)
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (176, 50), dtype=np.uint8))
    gf_torch.reset_dense_calls()
    gf_cuda.reset_launches()
    got = backend.matvec(big, x, "cuda")
    assert gf_torch.dense_calls == 1 and gf_cuda.launches == 0
    assert np.array_equal(got.numpy(), gf256.gf_matvec_chunks(big, x.numpy()))
    small = big[:gf_cuda.MAX_M, :gf_cuda.MAX_K]
    backend.matvec(small, x[:gf_cuda.MAX_K], "cuda")
    assert gf_torch.dense_calls == 1


def test_profile_checks_and_geometry():
    port = port_codec(FLAGSHIP)
    assert (port.q, port.t, port.nu, port.sub_chunk_no) == (4, 3, 0, 64)
    assert port.get_profile()["scalar_mds"] == "jerasure"
    for bad in ({"k": "1"}, {"k": "4", "m": "2", "d": "7"},
                {"scalar_mds": "lrc"}, {"backend": "pallas"}):
        with pytest.raises(ErasureCodeError):
            instance().factory("clay", bad, device="cpu")
    with pytest.raises(ErasureCodeError):
        port.decode_chunks([0], {i: np.zeros(64, np.uint8)
                                 for i in range(7, 12)})


def test_scalar_mds_isa_and_shec_match_reference():
    for mds in ("isa", "shec"):
        ref = ref_codec(SMALL, scalar_mds=mds)
        port = port_codec(SMALL, scalar_mds=mds)
        data = np.random.default_rng(8).integers(
            0, 256, size=4 * 256, dtype=np.uint8).tobytes()
        want = ref.encode(list(range(6)), data)
        got = port.encode(list(range(6)), data)
        for i in range(6):
            assert np.array_equal(got[i], want[i]), (mds, i)
        avail = {i: want[i] for i in range(2, 6)}
        out = port.decode([0, 1], avail, len(want[0]))
        assert np.array_equal(out[0], want[0]) and \
            np.array_equal(out[1], want[1])


def test_ec_util_with_clay_matches_reference():
    ref = ref_codec(SMALL)
    port = from_reference_profile(ref.get_profile(), device="cpu")
    assert port.get_profile()["plugin"] == "clay"
    assert (port.k, port.m, port.d) == (ref.k, ref.m, ref.d)
    chunk = 256
    sinfo = ec_util.StripeInfo(stripe_width=4 * chunk, chunk_size=chunk)
    ref_sinfo = ref_ec.StripeInfo(stripe_width=4 * chunk, chunk_size=chunk)
    data = np.random.default_rng(13).integers(
        0, 256, size=5 * sinfo.stripe_width, dtype=np.uint8)
    shards = ec_util.encode(sinfo, port, data)
    ref_shards = ref_ec.encode(ref_sinfo, ref, data)
    for i in range(6):
        assert np.array_equal(shards[i], ref_shards[i]), i
    for lost in ((0,), (5,), (0, 1), (2, 4)):
        avail = {i: shards[i] for i in range(6) if i not in lost}
        got = ec_util.decode(sinfo, port, avail, list(lost))
        want = ref_ec.decode(ref_sinfo, ref, avail, list(lost))
        for i in lost:
            assert np.array_equal(got[i], want[i]), (lost, i)
            assert np.array_equal(got[i], shards[i]), (lost, i)


@pytest.mark.parametrize("workload", ("encode", "decode"))
def test_ec_bench_cli_runs_clay_on_cpu(workload, capsys):
    from ceph_tpu_torch.bench import ec_bench
    rc = ec_bench.main(["-p", "clay", "-P", "k=4", "-P", "m=2", "-P", "d=5",
                        "-S", "8192", "-i", "2", "-w", workload, "-e", "2",
                        "--device", "cpu"])
    assert rc == 0
    elapsed, kib = capsys.readouterr().out.strip().split("\t")
    assert float(elapsed) >= 0 and int(kib) == 2 * 8
    with pytest.raises(SystemExit):
        ec_bench.main(["-p", "clay", "--device-resident", "--device", "cpu"])
