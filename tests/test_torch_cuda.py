"""The port's CUDA kernels against their plain torch versions, on the card.

Kernel B1 (ops/gf_cuda.py) and kernel B2 (ops/crc32c_cuda.py) must equal
their plain versions byte for byte (tolerance 0), over ragged shapes,
decode matrices and the largest matrix B1 takes, and the fused flush on
CUDA must equal the fused flush on the CPU. Kernels B3 and B4
(ops/clay_cuda.py) and B5 (ops/gf_block_sparse_cuda.py) must equal their
plain versions over Clay profiles, ragged L and erasure signatures, a
matrix larger than B1 takes must take the counted dense route, and the
Clay codec on CUDA must give the CPU codec's bytes. Kernel B6
(ops/gf_xor_cuda.py) must equal its plain version over encode and decode
matrices, ragged B and the largest matrix it takes, and the host oracle,
and must refuse what it does not take. The deep-scrub verify on the card
(B1 + compare + B2) must equal its plain version, and a deep scrub of a
``backend=cuda`` pool over BlockStore must convict and repair silent
flips. A crimson cluster and a cephx cluster write and read a
``backend=cuda`` pool through B1 and B2, and the load generator's healthy
phase runs on the card with an empty durability sweep. Every test here
needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import itertools
import threading

import numpy as np
import pytest
import torch

from ceph_tpu_torch.models import clay_device, instance, jerasure
from ceph_tpu_torch.ops import (backend, clay_cuda, crc32c_cuda,
                                crc32c_torch, gf256, gf_block_sparse,
                                gf_block_sparse_cuda, gf_block_sparse_torch,
                                gf_cuda, gf_torch, gf_xor, gf_xor_cuda,
                                gf_xor_torch)
from ceph_tpu_torch.osd import ec_util

pytestmark = pytest.mark.cuda

RAGGED_N = (1, 15, 16, 100, 4097, 1 << 20)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _bytes(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("m,k", [(1, 8), (2, 8), (3, 8), (4, 8), (5, 8),
                                 (16, 8), (17, 8), (32, 8), (32, 128)])
def test_gf_kernel_matches_plain(cuda, m, k):
    """Every row-block template (2, 4, and 16 rows in one or two passes)
    over ragged N, and the byte path from a pointer one byte off
    alignment."""
    mat = _bytes(m * k, m, k)
    gf_cuda.reset_launches()
    calls = 0
    for n in RAGGED_N:
        d = torch.from_numpy(_bytes(n, k, n)).to(cuda)
        got = gf_cuda.matvec_device(mat, d)
        calls += 1
        torch.cuda.synchronize()
        assert torch.equal(got, gf_torch.matvec(mat, d)), (m, k, n)
    n = 4096
    raw = torch.from_numpy(_bytes(n + 1, k * n + 1)).to(cuda)
    d = raw[1:].view(k, n)
    assert d.data_ptr() % 16 == 1
    got = gf_cuda.matvec_device(mat, d)
    calls += 1
    torch.cuda.synchronize()
    assert torch.equal(got, gf_torch.matvec(mat, d)), (m, k, "offset")
    assert gf_cuda.launches == calls


def test_gf_kernel_decode_matrices_and_oracle(cuda):
    k, m = 8, 3
    gen = gf256.systematic_generator(gf256.rs_matrix_isa(k, m))
    d_np = _bytes(3, k, 65536 + 5)
    d = torch.from_numpy(d_np).to(cuda)
    for e in (1, 2, 3):
        for lost in itertools.combinations(range(k + m), e):
            present = [i for i in range(k + m) if i not in lost][:k]
            dmat = gf256.decode_matrix(gen, present, list(lost))
            got = gf_cuda.matvec_device(dmat, d).cpu().numpy()
            assert np.array_equal(got, gf256.gf_matvec_chunks(dmat, d_np)), \
                lost


def test_gf_kernel_rejects_what_it_does_not_take(cuda):
    d = torch.zeros((4, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        gf_cuda.matvec_device(np.ones((gf_cuda.MAX_M + 1, 4), np.uint8), d)
    with pytest.raises(ValueError):
        gf_cuda.matvec_device(np.ones((2, 4), np.uint8), d.t().contiguous().t())


def test_crc_rows_kernel_matches_plain(cuda):
    crc32c_cuda.reset_launches()
    for rows in (1, 7, 1000, 65536 + 3):
        x = torch.from_numpy(_bytes(rows, rows, 512)).to(cuda)
        got = crc32c_cuda.crc_rows(x)
        torch.cuda.synchronize()
        assert torch.equal(got, crc32c_torch.crc_rows(x)), rows
    assert crc32c_cuda.launches == 4


def test_crc_rows_kernel_tile_edges_full_size_and_unaligned(cuda):
    """B2 at its tile's edges (rows a warp reduces together, +- 1), past
    one grid-stride round of its one-block-an-SM grid, at the fused
    flush's 360,448 rows, and from a pointer one byte off alignment
    (refused before any launch)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tile = crc32c_cuda.ROWS
    wrap = sms * crc32c_cuda.THREADS // 32 * tile
    cases = (tile - 1, tile, tile + 1, wrap, wrap + 1, 2 * wrap + tile + 3,
             128 * 11 * 256)
    crc32c_cuda.reset_launches()
    for rows in cases:
        x = torch.from_numpy(_bytes(rows, rows, 512)).to(cuda)
        got = crc32c_cuda.crc_rows(x)
        torch.cuda.synchronize()
        assert got.dtype == torch.int64
        assert torch.equal(got, crc32c_torch.crc_rows(x)), rows
    assert crc32c_cuda.launches == len(cases)
    raw = torch.zeros(4 * 512 + 1, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        crc32c_cuda.crc_rows(raw[1:].view(4, 512))
    assert crc32c_cuda.launches == len(cases)


def test_linear_crc_on_cuda_matches_host(cuda):
    from ceph_tpu_torch.utils import checksum
    for length in (1, 511, 512, 513, 4096 + 7):
        x = _bytes(length, 4, length)
        lin = crc32c_torch.crc_linear_device(
            torch.from_numpy(x).to(cuda)).cpu()
        got = [crc32c_torch.crc32c_from_linear(int(v), length, 0xFFFFFFFF)
               for v in lin]
        assert got == checksum.crc32c_rows(x, 0xFFFFFFFF).tolist(), length


def test_fused_flush_on_cuda_matches_cpu(cuda):
    profile = {"k": "8", "m": "3", "technique": "reed_sol_van"}
    on_card = instance().factory("isa", profile, device=cuda)
    on_cpu = instance().factory("isa", profile, device="cpu")
    sinfo = ec_util.StripeInfo(stripe_width=8 * 256, chunk_size=256)
    bufs = [_bytes(s, s * sinfo.stripe_width) for s in (1, 3, 2, 5, 1)]

    def flush(codec):
        b = ec_util.StripeBatcher(sinfo, codec)
        for op, buf in enumerate(bufs):
            b.append(op, buf)
        return b.flush(with_crcs=True)

    gf_cuda.reset_launches()
    crc32c_cuda.reset_launches()
    got = flush(on_card)
    assert gf_cuda.launches == 1 and crc32c_cuda.launches == 1
    for (_, shards, crcs), (_, wshards, wcrcs) in zip(got, flush(on_cpu)):
        assert crcs == wcrcs
        for i in range(11):
            assert np.array_equal(shards[i], wshards[i])
    avail = {i: np.concatenate([r[1][i] for r in got]) for i in range(2, 11)}
    out = ec_util.decode(sinfo, on_card, avail, [0, 1])
    for i in (0, 1):
        assert np.array_equal(out[i], np.concatenate([r[1][i] for r in got]))


def _held_burst(eng, codec, sinfo, ops, before_release=None):
    """Stage ``ops`` from two threads (thread t: ops t, t+2, ... under key
    t) while the engine is held in a run_sync, call ``before_release``,
    release; returns ({op: (shards, crcs, err)}, {key: order})."""
    out, order = {}, {0: [], 1: []}
    lock, done = threading.Lock(), threading.Event()
    gate, held = threading.Event(), threading.Event()
    holder = threading.Thread(target=eng.run_sync, args=(
        lambda: (held.set(), gate.wait(60)), 120))
    holder.start()
    assert held.wait(30)

    def producer(t):
        for i in range(t, len(ops), 2):
            def cont(s, c, e, i=i):
                with lock:
                    out[i] = (s, c, e)
                    order[t].append(i)
                    if len(out) == len(ops):
                        done.set()
            eng.stage_encode(t, codec, sinfo, ops[i], cont)

    threads = [threading.Thread(target=producer, args=(t,)) for t in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if before_release is not None:
        before_release()
    gate.set()
    assert done.wait(120), len(out)
    holder.join()
    return out, order


def test_engine_burst_on_cuda_overlaps_and_matches_cpu(cuda):
    """Three flushes through ``DeviceEncodeEngine`` (window 3) from two
    producer threads: every op's shards and linear crcs equal the CPU
    flush's, the window holds two flushes or more, and each flush runs on
    its own slot's side stream. A first burst warms the allocators of
    the three slot streams; before the second, each slot stream gets a
    0.1 s spin kernel, so the device is still busy while later flushes
    launch. The kernel libraries (their own static CUDA runtime, handed
    the slot stream by PyTorch on the engine thread) must launch behind
    it in order with PyTorch's upload and download, or the parity would
    be read before it is computed."""
    from ceph_tpu_torch.osd.device_engine import (DeviceEncodeEngine,
                                                  slot_stream)
    profile = {"k": "8", "m": "3", "technique": "reed_sol_van"}
    on_card = instance().factory("isa", profile, device=cuda)
    on_cpu = instance().factory("isa", profile, device="cpu")
    sinfo = ec_util.StripeInfo(stripe_width=8 * 4096, chunk_size=4096)
    ops = [_bytes(100 + i, 2 * sinfo.stripe_width) for i in range(24)]
    # 8 ops close a flush: exactly 3 a burst
    eng = DeviceEncodeEngine(lambda key, fn: fn(),
                             flush_bytes=16 * sinfo.stripe_width,
                             window=3, host_flush_bytes=0)

    def spin_slots():
        for slot in range(3):
            with torch.cuda.stream(slot_stream(cuda, slot)):
                torch.cuda._sleep(int(2e8))

    try:
        _held_burst(eng, on_card, sinfo, ops)
        assert eng.stats["max_inflight_depth"] >= 1
        gf_cuda.reset_launches()
        crc32c_cuda.reset_launches()
        out, order = _held_burst(eng, on_card, sinfo, ops, spin_slots)
    finally:
        eng.stop()
    stats = eng.stats
    assert stats["max_inflight_depth"] >= 2, stats
    assert stats["flushes"] == 6, stats
    assert stats["errors"] == stats["host_flushes"] == 0, stats
    assert gf_cuda.launches == crc32c_cuda.launches == 3
    for t in (0, 1):
        assert order[t] == list(range(t, len(ops), 2))
    for i, buf in enumerate(ops):
        b = ec_util.StripeBatcher(sinfo, on_cpu)
        b.append(i, buf)
        (_, wshards, wcrcs), = b.flush(with_crcs=True)
        shards, crcs, err = out[i]
        assert err is None and crcs == wcrcs, i
        for pos in range(11):
            assert np.array_equal(shards[pos], wshards[pos]), (i, pos)


CLAY_PROFILES = [{"k": "8", "m": "4", "d": "11"}, {"k": "4", "m": "2"},
                 {"k": "4", "m": "3", "d": "6"}]
CLAY_L = (1, 63, 4097)


def _clay(profile, device):
    return instance().factory("clay", profile, device=device)


#: B3's lane counts: the short form (64 lanes a tile) at 1, 63, 64, 4097
#: and 32 Ki lanes on 132 SMs, the full form at 256 Ki
B3_L = (1, 63, 64, 4097, 1 << 15, 1 << 18)


@pytest.mark.parametrize("profile", CLAY_PROFILES,
                         ids=["k8m4d11", "k4m2", "k4m3d6"])
def test_clay_encode_kernel_matches_plain(cuda, profile):
    codec = _clay(profile, cuda)
    enc = clay_device.build_encode_kernel(codec)
    k, ssc = codec.k, codec.sub_chunk_no
    clay_cuda.reset_launches()
    calls = 0
    for L in B3_L:
        x = torch.from_numpy(_bytes(L, k, ssc, L)).to(cuda)
        got = enc(x)
        calls += 1
        torch.cuda.synchronize()
        assert torch.equal(got, enc.plain(x)), L
    # an input pointer one byte off alignment takes the byte path
    buf = torch.from_numpy(_bytes(11, k * ssc * 4096 + 1)).to(cuda)
    x = buf[1:].view(k, ssc, 4096)
    got = enc(x)
    calls += 1
    torch.cuda.synchronize()
    assert torch.equal(got, enc.plain(x))
    assert clay_cuda.encode_launches == calls


@pytest.mark.parametrize("profile", CLAY_PROFILES,
                         ids=["k8m4d11", "k4m2", "k4m3d6"])
def test_clay_transform_kernel_matches_plain(cuda, profile):
    codec = _clay(profile, cuda)
    n, qt = codec.k + codec.m, codec.q * codec.t
    for e in range(1, codec.m + 1):
        lost = list(range(0, n, max(1, n // e)))[:e]
        erased = codec._pad_erased(codec._node_id(i) for i in lost)
        fn = clay_device.build_transform_kernel(codec, erased)
        for L in CLAY_L:
            c = _bytes(L + e, qt, codec.sub_chunk_no, L)
            c[sorted(erased)] = 0
            c[codec.k:codec.k + codec.nu] = 0
            x = torch.from_numpy(c).to(cuda)
            got = fn(x)
            torch.cuda.synchronize()
            assert torch.equal(got, fn.plain(x)[sorted(erased)]), (lost, L)


@pytest.mark.parametrize("profile", CLAY_PROFILES,
                         ids=["k8m4d11", "k4m2", "k4m3d6"])
def test_clay_transform_kernel_full_size_and_unaligned_match_plain(
        cuda, profile):
    """B4 at the main path's 2^18 lanes (16-byte path) and from an input
    pointer one byte off alignment (byte path), every e, each launch
    counted."""
    codec = _clay(profile, cuda)
    n, qt, ssc = codec.k + codec.m, codec.q * codec.t, codec.sub_chunk_no
    clay_cuda.reset_launches()
    calls = 0
    for e in range(1, codec.m + 1):
        lost = list(range(0, n, max(1, n // e)))[:e]
        erased = codec._pad_erased(codec._node_id(i) for i in lost)
        er = sorted(erased)
        fn = clay_device.build_transform_kernel(codec, erased)
        buf = torch.from_numpy(_bytes(e, qt * ssc * 4096 + 1)).to(cuda)
        for x in (torch.from_numpy(_bytes(e, qt, ssc, 1 << 18)).to(cuda),
                  buf[1:].view(qt, ssc, 4096)):
            x[er] = 0
            x[codec.k:codec.k + codec.nu] = 0
            got = fn(x)
            calls += 1
            torch.cuda.synchronize()
            assert torch.equal(got, fn.plain(x)[er]), (lost, x.shape)
    assert clay_cuda.transform_launches == calls


def test_block_sparse_kernel_matches_plain(cuda):
    codec = _clay(CLAY_PROFILES[0], "cpu")
    rng = np.random.default_rng(5)
    mats = [codec._decode_matrix(tuple(range(2, 12)), (0, 1)),
            codec._repair_matrix(0, tuple(range(1, 12))),
            (rng.integers(0, 256, (128, 640)) *
             (rng.random((128, 640)) < 0.05)).astype(np.uint8),
            np.zeros((8, 16), np.uint8)]
    lanes = (1, 15, 16, 31, 33, 64, 4097, 32768)
    gf_block_sparse_cuda.reset_launches()
    for mat in mats:
        plan = gf_block_sparse.plan_for(mat)
        for n in lanes:
            d = torch.from_numpy(_bytes(n, mat.shape[1], n)).to(cuda)
            got = gf_block_sparse.matvec_device(mat, d)
            torch.cuda.synchronize()
            assert torch.equal(got, gf_block_sparse_torch.matvec(plan, d))
        # a data pointer off 16-byte alignment takes the byte path
        k = mat.shape[1]
        buf = torch.from_numpy(_bytes(7, k * 4096 + 1)).to(cuda)
        d = buf[1:].view(k, 4096)
        got = gf_block_sparse.matvec_device(mat, d)
        torch.cuda.synchronize()
        assert torch.equal(got, gf_block_sparse_torch.matvec(plan, d))
    assert gf_block_sparse_cuda.launches == (len(lanes) + 1) * len(mats)


def test_backend_shape_route_is_counted(cuda):
    big = _bytes(1, 64, 176)
    d = torch.from_numpy(_bytes(2, 176, 4097)).to(cuda)
    gf_torch.reset_dense_calls()
    gf_cuda.reset_launches()
    got = backend.matvec(big, d, "cuda")
    assert gf_torch.dense_calls == 1 and gf_cuda.launches == 0
    assert np.array_equal(got.cpu().numpy(),
                          gf256.gf_matvec_chunks(big, d.cpu().numpy()))
    backend.matvec(big[:32, :128], d[:128].contiguous(), "cuda")
    assert gf_torch.dense_calls == 1 and gf_cuda.launches == 1


@pytest.mark.parametrize("extra,env", [({}, "auto"), ({}, "always"),
                                       ({"decode_kernel": "true"}, "auto")])
def test_clay_codec_on_cuda_matches_cpu(cuda, monkeypatch, extra, env):
    monkeypatch.setenv("CEPH_TPU_CLAY_SPARSE", env)
    profile = dict(CLAY_PROFILES[0], **extra)
    on_card, on_cpu = _clay(profile, cuda), _clay(profile, "cpu")
    data = _bytes(9, 8 * 64 * 300 - 11).tobytes()
    want = on_cpu.encode(list(range(12)), data)
    got = on_card.encode(list(range(12)), data)
    for i in range(12):
        assert np.array_equal(got[i], want[i]), i
    cs = len(want[0])
    for lost in ([0], [3, 10]):
        avail = {i: want[i] for i in range(12) if i not in lost}
        out = on_card.decode(lost, avail, cs)
        for i in lost:
            assert np.array_equal(out[i], want[i]), (lost, i)
    plan = on_card.minimum_to_decode([0], list(range(1, 12)))
    sc = cs // 64
    helpers = {c: np.concatenate([want[c][o * sc:(o + cnt) * sc]
                                  for o, cnt in r]) for c, r in plan.items()}
    assert np.array_equal(on_card.decode([0], helpers, cs)[0], want[0])


def _strip_matrices():
    k, m = 8, 3
    gen = gf256.systematic_generator(gf256.rs_matrix_isa(k, m))
    mats = {f"isa m={mm}": gf256.rs_matrix_isa(k, mm) for mm in (1, 2, 3)}
    mats["reed_sol_van"] = gf256.rs_vandermonde_matrix(k, m)
    mats["cauchy_good"] = jerasure.improve_cauchy_matrix(
        gf256.cauchy_original_matrix(k, m))
    for e in (1, 2, 3):
        mats[f"decode e={e}"] = gf256.decode_matrix(
            gen, list(range(e, e + k)), list(range(e)))
    return mats


STRIP_MATS = _strip_matrices()
STRIP_B = (1, 3, 64, 4097)


def _strips(seed, rows, b, device):
    return torch.from_numpy(_bytes(seed, rows, b * 512)).view(
        torch.int32).view(rows, b, 128).to(device)


@pytest.mark.parametrize("label", sorted(STRIP_MATS))
def test_xor_strip_kernel_matches_plain(cuda, label):
    kern = gf_xor.get_kernel(STRIP_MATS[label], cuda)
    gf_xor_cuda.reset_launches()
    for b in STRIP_B:
        x = _strips(b, 8 * kern.k_in, b, cuda)
        got = kern.encode_strips(x)
        torch.cuda.synchronize()
        assert torch.equal(got, gf_xor_torch.xor_strips(kern.schedule, x)), b
    assert gf_xor_cuda.launches == len(STRIP_B)


def test_xor_strip_kernel_largest_matrix_and_host_oracle(cuda):
    mat = _bytes(7, gf_xor_cuda.MAX_M_OUT, gf_xor_cuda.MAX_K_IN)
    kern = gf_xor.get_kernel(mat, cuda)
    for b in (1, 3):
        x = _strips(b, 8 * kern.k_in, b, cuda)
        assert torch.equal(kern.encode_strips(x),
                           gf_xor_torch.xor_strips(kern.schedule, x)), b
    isa = STRIP_MATS["isa m=3"]
    data = _bytes(8, 8, 3 * 4096)
    assert np.array_equal(gf_xor.get_kernel(isa, cuda)(data),
                          gf_xor.strip_matvec_reference(isa, data))


def test_xor_strip_kernel_rejects_what_it_does_not_take(cuda):
    kern = gf_xor.get_kernel(STRIP_MATS["isa m=3"], cuda)
    x = _strips(1, 64, 4, cuda)
    with pytest.raises(ValueError):
        kern.encode_strips(x[:, :, :127])
    with pytest.raises(ValueError):
        kern.encode_strips(torch.zeros(64 * 512 + 1, dtype=torch.int32,
                                       device=cuda)[1:].view(64, 4, 128))
    with pytest.raises(ValueError):
        kern.encode_strips(x.to(torch.int64))
    with pytest.raises(ValueError):
        kern.encode_strips(x.transpose(1, 2).contiguous().transpose(1, 2))
    big = gf_xor.get_kernel(np.ones((1, gf_xor_cuda.MAX_K_IN + 1), np.uint8),
                            cuda)
    with pytest.raises(ValueError):
        big.encode_strips(_strips(2, 8 * (gf_xor_cuda.MAX_K_IN + 1), 1, cuda))


def test_cluster_on_cuda_write_degraded_read_revive(cuda):
    """The OSD chain on the card: a k=2,m=1 ``backend=cuda`` pool on 4
    OSDs writes through the shared engine (fused flush: B1 + B2), reads
    back, reads degraded with one OSD killed, and recovers on revive."""
    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.utils.config import g_conf
    conf = g_conf()
    old = {k: conf[k] for k in ("osd_heartbeat_interval",
                                "osd_heartbeat_grace")}
    conf.set("osd_heartbeat_interval", 0.25)
    conf.set("osd_heartbeat_grace", 1.0)
    try:
        gf_cuda.reset_launches()
        crc32c_cuda.reset_launches()
        with MiniCluster(n_osds=4) as cluster:
            cluster.create_ec_pool("cu", k=2, m=1, pg_num=8, backend="cuda")
            io = cluster.client().open_ioctx("cu")
            # past the engine's small-flush host route (512 KiB), so
            # even a flush of one op launches on the card
            pays = {f"o{i}": _bytes(900 + i, (600 << 10) + i).tobytes()
                    for i in range(12)}
            for oid, pay in pays.items():
                io.write_full(oid, pay)
            for oid, pay in pays.items():
                assert io.read(oid) == pay
            stats = [o._device_engine.stats for o in cluster.osds.values()
                     if o._device_engine is not None]
            assert max(s["ops"] for s in stats) >= len(pays), stats
            assert gf_cuda.launches > 0 and crc32c_cuda.launches > 0
            cluster.kill_osd(3)
            cluster.wait_for_osd_down(3, timeout=30)
            for oid, pay in pays.items():
                assert io.read(oid) == pay
            cluster.revive_osd(3)
            cluster.wait_for_clean(timeout=60)
            for oid, pay in pays.items():
                assert io.read(oid) == pay
            stats = [o._device_engine.stats for o in cluster.osds.values()
                     if o._device_engine is not None]
            assert max(s["errors"] for s in stats) == 0, stats
            assert max(s["decode_errors"] for s in stats) == 0, stats
    finally:
        for k, v in old.items():
            conf.set(k, v)


def _flavour_write_read(**cluster_kw):
    """A k=2,m=1 ``backend=cuda`` pool on 4 OSDs of a ``MiniCluster``
    built with ``cluster_kw``: 12 objects past the engine's small-flush
    host route written and read back; B1 and B2 must launch."""
    from ceph_tpu_torch.qa.cluster import MiniCluster
    gf_cuda.reset_launches()
    crc32c_cuda.reset_launches()
    with MiniCluster(n_osds=4, **cluster_kw) as cluster:
        cluster.create_ec_pool("cu", k=2, m=1, pg_num=8, backend="cuda")
        io = cluster.client().open_ioctx("cu")
        io.op_timeout = 120.0
        pays = {f"o{i}": _bytes(950 + i, (600 << 10) + i).tobytes()
                for i in range(12)}
        for oid, pay in pays.items():
            io.write_full(oid, pay)
        for oid, pay in pays.items():
            assert io.read(oid) == pay
    assert gf_cuda.launches > 0 and crc32c_cuda.launches > 0


def test_crimson_cluster_on_cuda_write_read(cuda):
    _flavour_write_read(osd_flavor="crimson")


def test_cephx_cluster_on_cuda_write_read(cuda):
    _flavour_write_read(auth=True)


def test_load_gen_healthy_on_cuda(cuda):
    """``LoadGen.run_healthy`` for 2 s against a ``backend=cuda`` pool:
    ops served, B1 and B2 launched, the durability sweep empty."""
    from ceph_tpu_torch.bench.load_gen import LoadGen, LoadSpec
    from ceph_tpu_torch.qa.cluster import MiniCluster
    gf_cuda.reset_launches()
    crc32c_cuda.reset_launches()
    with MiniCluster(n_osds=4) as cluster:
        cluster.create_ec_pool("lg", k=2, m=1, pg_num=8, backend="cuda")
        spec = LoadSpec(n_keys=32, obj_size=600 << 10, read_frac=0.5,
                        concurrency=4, phase_seconds=2.0, seed=14)
        out = LoadGen(cluster, "lg", spec).run_healthy()
    assert out["phases"][0]["ops"] > 0, out["phases"]
    assert out["verify"]["lost_acked"] == []
    assert out["verify"]["wrong_bytes"] == []
    assert out["verify"]["corruptions"] == []
    assert gf_cuda.launches > 0 and crc32c_cuda.launches > 0


@pytest.mark.parametrize("k,m,n_obj,l_b", [(2, 1, 3, 4096), (3, 2, 5, 8192),
                                           (8, 3, 16, 128 << 10)])
def test_scrub_verify_on_cuda_matches_plain(cuda, k, m, n_obj, l_b):
    """The deep-scrub verify on the card (B1 re-encode, the compare, B2 +
    stage 2) equals its plain version on the CPU: the mismatch bitmap and
    the linear crcs, over clean objects and rot in data and parity
    shards; one B1 and one B2 launch a batch."""
    from ceph_tpu_torch.osd import scrub_engine
    mat = gf256.rs_matrix_isa(k, m)
    data = _bytes(k * 100 + n_obj, n_obj, k, l_b)
    parity = np.stack([gf256.gf_matvec_chunks(mat, d) for d in data])
    batch = np.concatenate([data, parity], axis=1)
    batch[1, 0, 7] ^= 0x20                  # data rot: every parity row
    batch[n_obj - 1, k + m - 1, l_b - 1] ^= 1   # parity rot: its row
    gf_cuda.reset_launches()
    crc32c_cuda.reset_launches()
    mism, lin = scrub_engine.verify_batch(mat, k, batch, device=cuda)
    assert (gf_cuda.launches, crc32c_cuda.launches) == (1, 1)
    want_mism, want_lin = scrub_engine.verify_batch(mat, k, batch,
                                                    device="cpu")
    assert np.array_equal(mism, want_mism)
    assert np.array_equal(lin, want_lin)
    assert mism[1].all() and mism[n_obj - 1, m - 1]
    assert not mism[0].any()


def test_deep_scrub_on_cuda_blockstore(cuda, tmp_path):
    """Deep scrub on the card over BlockStore: silent flips in a data and
    a parity shard of a ``backend=cuda`` k=2,m=1 pool are convicted at
    their positions through B1 + B2, repaired, and read back intact."""
    from ceph_tpu_torch.osd.pg import pg_cid
    from ceph_tpu_torch.qa.cluster import MiniCluster
    with MiniCluster(n_osds=3, store="blockstore",
                     data_dir=str(tmp_path)) as cluster:
        cluster.create_ec_pool("cu", k=2, m=1, pg_num=4, backend="cuda")
        io = cluster.client().open_ioctx("cu")
        pays = {f"o{i}": _bytes(700 + i, (600 << 10) + i).tobytes()
                for i in range(6)}
        for oid, pay in pays.items():
            io.write_full(oid, pay)
        osdmap = cluster.mon.osdmap
        pool_id = osdmap.pool_by_name["cu"]
        flips = {"o1": 1, "o4": 2}
        for oid, pos in flips.items():
            ps = osdmap.object_to_pg(pool_id, oid)
            _, acting, _ = osdmap.pg_to_up_acting(pool_id, ps)
            cluster._stores[acting[pos]].inject_bit_flip(
                pg_cid(pool_id, ps, pos), oid, offset=4096 + pos, length=8)
        gf_cuda.reset_launches()
        crc32c_cuda.reset_launches()
        res = cluster.scrub_pool("cu", deep=True)
        assert res["inconsistent"] == {o: [p] for o, p in flips.items()}, res
        assert sorted(res["repaired"]) == sorted(flips), res
        assert crc32c_cuda.launches >= res["batches"] > 0
        assert gf_cuda.launches >= res["batches"]
        assert cluster.scrub_pool("cu", deep=True)["inconsistent"] == {}
        for oid, pay in pays.items():
            assert io.read(oid) == pay
        stats = [o.scrub_engine().stats for o in cluster.osds.values()]
        assert sum(s["device_errors"] for s in stats) == 0, stats
