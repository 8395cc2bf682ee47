"""The port's multi-device mesh (``ceph_tpu_torch.parallel``: ``mesh``,
``mesh_compile``, ``sharded_codec``, ``placement``, and the mesh routes of
``osd/ec_util``, the device engine and the deep scrub) against the
reference's, on the CPU.

One counterpart for each test of the reference's ``tests/test_parallel.py``:
the reference runs on its 8 forced host devices (``tests/conftest.py``), the
port on a mesh of 8 CPU slots with the same factorization, and the outputs
are compared byte for byte (chunks and csum, reconstructed and gathered
rows, batcher and engine results and counters, placement maps, the verify
twin, the Clay k=4,m=2 repair). Tolerance 0. The reference's csum is a
uint32 that wraps; the port's is an int64 holding the same value.

Then ``tests/test_mesh_cluster.py``'s tests: the non-pow2 mesh (a 3 x 2
mesh, 5 stripes), the engine-on-mesh cluster scenario (writes, a deep
scrub, degraded reads, an OSD revived; slot decisions and stores equal
across the packages) and the loopback-vs-TCP fidelity run; a port and a
reference ``MiniCluster`` with a default mesh and placement on, whose
stores end equal shard for shard; the port's
deliberate deviation, a poisoned sharded step that fails the op with EIO
and falls back nowhere (the reference falls back to its single-device
route); and the fixture that resets both packages' default meshes, which
are process-global (a leaked mesh would reroute every later test of the
worker).
"""

import time

import numpy as np
import pytest
import torch

from ceph_tpu.models import registry as ref_registry
from ceph_tpu.ops import gf256 as ref_gf256
from ceph_tpu.osd import device_engine as ref_de
from ceph_tpu.osd import ec_util as ref_ec
from ceph_tpu.osd import scrub_engine as ref_se
from ceph_tpu.parallel import mesh as ref_mesh_mod
from ceph_tpu.parallel import placement as ref_placement
from ceph_tpu.parallel import sharded_codec as ref_sc
from ceph_tpu.qa.cluster import MiniCluster as RefCluster
from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.models import instance
from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.osd import ec_backend, ec_util
from ceph_tpu_torch.osd import scrub_engine as se
from ceph_tpu_torch.osd.device_engine import DeviceEncodeEngine
from ceph_tpu_torch.osd.ec_util import StripeInfo
from ceph_tpu_torch.parallel import mesh as mesh_mod
from ceph_tpu_torch.parallel import mesh_compile, placement, sharded_codec
from ceph_tpu_torch.qa.cluster import MiniCluster
from ceph_tpu_torch.utils.device_telemetry import telemetry
from test_torch_cluster import (  # noqa: F401  (no_early_resend: fixture)
    _assert_same_stores, _engine_stats, _stores, no_early_resend)

CPU8 = ["cpu"] * 8


def _reset_meshes():
    mesh_mod.set_default_mesh(None)
    ref_mesh_mod.set_default_mesh(None)
    placement.set_slot_weights(None)
    ref_placement.set_slot_weights(None)


@pytest.fixture(autouse=True)
def _default_meshes_reset():
    """Both packages' default meshes (and the tuner's slot weights) are
    process-global: every test starts and ends with none set."""
    _reset_meshes()
    yield
    _reset_meshes()


@pytest.fixture(scope="module")
def ref_mesh():
    import jax
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return ref_mesh_mod.make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return mesh_mod.make_mesh(8, devices=CPU8)


def _ref_codec(plugin="jerasure", k=4, m=2, backend="jax"):
    return ref_registry.instance().factory(
        plugin, {"plugin": plugin, "k": str(k), "m": str(m),
                 "backend": backend})


def _codec(plugin="jerasure", k=4, m=2, backend="torch"):
    return instance().factory(
        plugin, {"plugin": plugin, "k": str(k), "m": str(m),
                 "backend": backend}, device="cpu")


def _port_counters() -> dict:
    return telemetry().perf.dump()


def test_mesh_shape(mesh, ref_mesh, monkeypatch):
    assert mesh.shape == dict(ref_mesh.shape)
    assert mesh.shape["stripe"] * mesh.shape["shard"] == 8
    assert mesh.axis_names == tuple(ref_mesh.axis_names)
    # eight distinct slots on one device, each its own stream holder
    assert len({id(s) for s in mesh.devices.ravel()}) == 8
    assert [s.index for s in mesh.devices.ravel()] == list(range(8))
    # without explicit devices the mesh takes the card, and raises
    # without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_mesh()


@pytest.mark.parametrize("place", [True, False])
def test_distributed_encode_matches_reference(mesh, ref_mesh, place):
    k, m = 8, 3
    S, C = mesh.shape["stripe"] * 2, mesh.shape["shard"] * 64
    coding = ref_gf256.rs_vandermonde_matrix(k, m)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(S, k, C), dtype=np.uint8)

    ref_chunks, ref_csum = ref_sc.make_encode_step(
        ref_mesh, coding, place=place)(
            ref_sc.shard_stripe_batch(ref_mesh, data))
    step = sharded_codec.make_encode_step(mesh, coding, place=place)
    chunks, csum = step(sharded_codec.shard_stripe_batch(mesh, data))
    chunks, csum = np.asarray(chunks), np.asarray(csum)
    assert chunks.dtype == np.uint8 and chunks.shape == (S, k + m, C)
    assert np.array_equal(chunks, np.asarray(ref_chunks))
    assert csum.dtype == np.int64 and (csum >> 32 == 0).all()
    assert np.array_equal(csum.astype(np.uint32), np.asarray(ref_csum))

    # and right, not only equal: the parity, ring-shifted by one slot
    # block when placed
    n_shard, c_l = mesh.shape["shard"], C // mesh.shape["shard"]
    for s in range(S):
        want = ref_gf256.gf_matvec_chunks(coding, data[s])
        got = chunks[s, k:]
        if place:
            got = np.concatenate(
                [got[:, ((b + 1) % n_shard) * c_l:
                     ((b + 1) % n_shard + 1) * c_l]
                 for b in range(n_shard)], axis=1)
        assert np.array_equal(got, want), s
        assert np.array_equal(chunks[s, :k], data[s])
    want_csum = chunks.astype(np.uint64).sum(axis=(0, 2)) % (1 << 32)
    assert np.array_equal(csum.astype(np.uint64), want_csum)


def test_distributed_degraded_read(mesh, ref_mesh):
    k, m = 4, 2
    S, C = 2, mesh.shape["shard"] * 32
    coding = ref_gf256.rs_vandermonde_matrix(k, m)
    gen = ref_gf256.systematic_generator(coding)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=(S, k, C), dtype=np.uint8)
    all_chunks = np.stack(
        [np.concatenate([d, ref_gf256.gf_matvec_chunks(coding, d)])
         for d in data])
    lost, present = [1, 4], [0, 2, 3, 5]
    surv = all_chunks[:, present]
    ref_rec, ref_full = ref_sc.make_degraded_read_step(
        ref_mesh, gen, present, lost)(
            ref_sc.shard_stripe_batch(ref_mesh, surv))
    rec, full = sharded_codec.make_degraded_read_step(
        mesh, gen, present, lost)(
            sharded_codec.shard_stripe_batch(mesh, surv))
    assert np.array_equal(np.asarray(rec), np.asarray(ref_rec))
    assert np.array_equal(np.asarray(full), np.asarray(ref_full))
    assert np.array_equal(np.asarray(rec), all_chunks[:, lost])
    assert np.array_equal(np.asarray(full), all_chunks[:, lost])


def test_batcher_flush_routes_through_mesh(mesh, ref_mesh):
    """The daemon's StripeBatcher flushes through the distributed encode
    step when a mesh is given: per-op shards equal to the reference's
    mesh flush and to the host codec, no crcs."""
    cs = mesh.shape["shard"] * 64
    si = StripeInfo(stripe_width=4 * cs, chunk_size=cs)
    ref_si = ref_ec.StripeInfo(stripe_width=4 * cs, chunk_size=cs)
    host = _codec(backend="numpy")
    rng = np.random.default_rng(7)
    b = ec_util.StripeBatcher(si, _codec(), mesh=mesh)
    rb = ref_ec.StripeBatcher(ref_si, _ref_codec(), mesh=ref_mesh)
    bufs = {}
    for op in range(3):
        data = rng.integers(0, 256, size=(op + 1) * si.stripe_width,
                            dtype=np.uint8)
        bufs[op] = data
        b.append(op, data)
        rb.append(op, data)
    dispatches = _port_counters().get("mesh_dispatches", 0)
    results, ref_results = b.flush(), rb.flush()
    assert _port_counters().get("mesh_dispatches", 0) == dispatches + 1
    assert len(results) == len(ref_results) == 3
    for (op, shards, crcs), (rop, rshards, rcrcs) in zip(results,
                                                         ref_results):
        assert op == rop and crcs is None and rcrcs is None
        want = ec_util.encode(si, host, bufs[op])
        for i in range(6):
            assert np.array_equal(shards[i], rshards[i]), (op, i)
            assert np.array_equal(shards[i], want[i]), (op, i)


def _engine_run(eng, set_mesh, mesh, codec, si, big, small):
    got = {}
    set_mesh(mesh)
    try:
        for name, payload in (("big", big), ("small", small)):
            eng.stage_encode("pg", codec, si, payload,
                             lambda s, c, e, name=name:
                             got.setdefault(name, (s, e)))
            deadline = time.monotonic() + 15
            while name not in got and time.monotonic() < deadline:
                time.sleep(0.02)
    finally:
        set_mesh(None)
        eng.stop()
    return got


def test_engine_uses_default_mesh(mesh, ref_mesh):
    """The device engine picks up the process default mesh: a flush AT
    the dense->mesh threshold runs the sharded encode step, a smaller one
    stays on the single-device route — in both packages, with the same
    shards."""
    cs = mesh.shape["shard"] * 64
    si = StripeInfo(stripe_width=4 * cs, chunk_size=cs)
    ref_si = ref_ec.StripeInfo(stripe_width=4 * cs, chunk_size=cs)
    rng = np.random.default_rng(8)
    big = rng.integers(0, 256, size=2 * si.stripe_width, dtype=np.uint8)
    small = rng.integers(0, 256, size=si.stripe_width, dtype=np.uint8)
    eng = DeviceEncodeEngine(lambda key, fn: fn(), mesh_flush_bytes=len(big))
    ref_eng = ref_de.DeviceEncodeEngine(lambda key, fn: fn(),
                                        mesh_flush_bytes=len(big))
    got = _engine_run(eng, mesh_mod.set_default_mesh, mesh, _codec(), si,
                      big, small)
    ref_got = _engine_run(ref_eng, ref_mesh_mod.set_default_mesh, ref_mesh,
                          _ref_codec(), ref_si, big, small)
    assert eng.stats["mesh_flushes"] == ref_eng.stats["mesh_flushes"] == 1
    assert eng.stats["placement_flushes"] == \
        ref_eng.stats["placement_flushes"]
    host = _codec(backend="numpy")
    for name, payload in (("big", big), ("small", small)):
        assert got[name][1] is None and ref_got[name][1] is None
        want = ec_util.encode(si, host, payload)
        for i in range(6):
            assert np.array_equal(got[name][0][i], ref_got[name][0][i])
            assert np.array_equal(got[name][0][i], want[i]), (name, i)


def test_engine_routes_unsplittable_chunks_off_the_mesh():
    """A flush whose chunk size does not split over the default mesh's
    shard axis takes the single-device route, chosen by shape before any
    launch (the reference would try the mesh, fail and fall back: the
    same bytes); one that splits takes the mesh."""
    cs = 3 * 65                       # splits over 3 slots, not over 2
    si = StripeInfo(stripe_width=4 * cs, chunk_size=cs)
    payload = np.random.default_rng(5).integers(
        0, 256, size=2 * si.stripe_width, dtype=np.uint8)
    want = ec_util.encode(si, _codec(backend="numpy"), payload)
    for shard, mesh_flushes in ((2, 0), (3, 1)):
        eng = DeviceEncodeEngine(lambda key, fn: fn(), mesh_flush_bytes=1)
        got = _engine_run(eng, mesh_mod.set_default_mesh,
                          mesh_mod.make_mesh(shard, stripe=1, shard=shard,
                                             devices=CPU8),
                          _codec(), si, payload, payload)
        assert eng.stats["mesh_flushes"] == 2 * mesh_flushes, shard
        assert eng.stats["errors"] == 0
        for name in ("big", "small"):
            assert got[name][1] is None
            for i in range(6):
                assert np.array_equal(got[name][0][i], want[i])


@pytest.mark.parametrize("n,kw", [
    (8, {"chunk_count": 11}), (8, {}), (8, {"chunk_count": 3}),
    (8, {"stripe": 8, "shard": 1, "chunk_count": 11}),
    (6, {"chunk_count": 11}), (1, {})])
def test_make_mesh_shard_cap_from_profile(n, kw):
    """The shard-axis cap derives from the codec profile's chunk count
    when one is known, else 4; explicit factors win — the same
    factorization as the reference's."""
    port = mesh_mod.make_mesh(n, devices=CPU8, **kw)
    ref = ref_mesh_mod.make_mesh(n, **kw)
    assert port.shape == dict(ref.shape)
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(8, stripe=3, shard=2, devices=CPU8)


def test_compile_seam_prefers_pjit_and_falls_back(mesh, ref_mesh,
                                                  monkeypatch):
    """The layout/compile seam: the port's one route is the per-slot body
    with explicit collectives, so ``auto`` and ``shard_map`` both build
    it (counted as ``mesh_compile_shard_map``) and ``pjit`` raises; its
    chunks, csum, reconstructed and gathered rows and verify verdicts
    equal the reference's under both of ITS routes."""
    k, m = 4, 2
    coding = ref_gf256.rs_vandermonde_matrix(k, m)
    rng = np.random.default_rng(3)
    S, C = mesh.shape["stripe"] * 2, mesh.shape["shard"] * 32
    data = rng.integers(0, 256, size=(S, k, C), dtype=np.uint8)
    gen = ref_gf256.systematic_generator(coding)
    present, lost = [0, 2, 3, 5], [1, 4]
    full_chunks = np.stack(
        [np.concatenate([d, ref_gf256.gf_matvec_chunks(coding, d)])
         for d in data])
    surv = np.ascontiguousarray(full_chunks[:, present])
    nobj, l_b = 8 * 2, 1 << 10
    vbatch = np.zeros((nobj, k + m, l_b), dtype=np.uint8)
    for i in range(nobj):
        vd = rng.integers(0, 256, (k, l_b), dtype=np.uint8)
        vbatch[i, :k] = vd
        vbatch[i, k:] = ref_gf256.gf_matvec_chunks(coding, vd)
    vbatch[3, 0, 5] ^= 1                  # one rotten row

    def run(pkg, sc, msh):
        out = []
        chunks, csum = sc.make_encode_step(msh, coding)(
            sc.shard_stripe_batch(msh, data))
        rec, gathered = sc.make_degraded_read_step(
            msh, gen, present, lost)(sc.shard_stripe_batch(msh, surv))
        step = sc.make_verify_step(msh, coding, k)
        mism, lin = step(sc.shard_object_batch(msh, vbatch))
        out = [np.asarray(x) for x in (chunks, csum, rec, gathered, mism,
                                       lin)]
        out[1] = out[1].astype(np.uint32)
        out[5] = out[5].astype(np.uint32)
        return out, step.compile_path

    outs = {}
    for mode in ("pjit", "shard_map"):
        monkeypatch.setenv("CEPH_TPU_MESH_COMPILE_MODE", mode)
        outs[mode], path = run("ref", ref_sc, ref_mesh)
        assert path == mode
    before = _port_counters().get("mesh_compile_shard_map", 0)
    pjit_before = _port_counters().get("mesh_compile_pjit", 0)
    for mode in ("auto", "shard_map"):
        monkeypatch.setenv("CEPH_TPU_MESH_COMPILE_MODE", mode)
        outs[mode], path = run("port", sharded_codec, mesh)
        assert path == "shard_map"
    monkeypatch.setenv("CEPH_TPU_MESH_COMPILE_MODE", "pjit")
    with pytest.raises(RuntimeError, match="no SPMD partitioner"):
        sharded_codec.make_encode_step(mesh, coding)
    for mode in ("pjit", "auto", "shard_map"):
        for a, b in zip(outs["shard_map"] if mode == "pjit" else outs[mode],
                        outs["pjit"]):
            assert np.array_equal(a, b), mode
    _, _, rec, gathered, mism, _ = outs["auto"]
    assert np.array_equal(rec, full_chunks[:, lost])
    assert np.array_equal(gathered, full_chunks[:, lost])
    assert mism[3].any() and not mism[0].any()
    counters = _port_counters()
    assert counters.get("mesh_compile_shard_map", 0) == before + 6
    assert counters.get("mesh_compile_pjit", 0) == pjit_before
    # the layout table is the reference's, entry for entry
    for name in ("stage_batch", "coding_matrix", "chunks_out", "csum_out",
                 "gathered_out", "object_batch", "verdict_out"):
        assert tuple(getattr(mesh_compile.LAYOUT, name)()) == \
            tuple(getattr(ref_sc.LAYOUT, name)()), name


def test_placement_map_deterministic_and_disjoint(mesh, ref_mesh):
    """PG -> slot placement: a pure, CRUSH-stable function of (pgid,
    mesh), equal to the reference's map and across map instances, with
    slot submeshes that partition the slots; the tuner's weights bias
    both maps alike."""
    pmap = placement.PlacementMap(mesh)
    pmap2 = placement.PlacementMap(mesh_mod.make_mesh(8, devices=CPU8))
    ref_pmap = ref_placement.PlacementMap(ref_mesh)
    pgids = [(7, ps) for ps in range(32)] + [(3, ps) for ps in range(8)]
    slots = [pmap.slot(p) for p in pgids]
    assert slots == [pmap2.slot(p) for p in pgids] == \
        [ref_pmap.slot(p) for p in pgids]
    assert placement.stable_hash((7, 0)) == \
        ref_placement.stable_hash((7, 0)) == placement.stable_hash("(7, 0)")
    assert set(slots) == set(range(pmap.n_slots))
    seen = set()
    for slot in range(pmap.n_slots):
        sm = pmap.submesh(slot)
        assert sm.shape == dict(ref_pmap.submesh(slot).shape) == \
            {"stripe": 1, "shard": mesh.shape["shard"]}
        devs = {id(d) for d in sm.devices.ravel()}
        assert not (devs & seen), "slot submeshes overlap"
        seen |= devs
        assert pmap.submesh(slot) is sm
    assert seen == {id(d) for d in mesh.devices.ravel()}
    assert pmap.owners((7, 1)) == list(mesh.devices[pmap.slot((7, 1))])
    weights = {0: 0.2, 1: 5.0}
    placement.set_slot_weights(weights)
    ref_placement.set_slot_weights(weights)
    assert [pmap.slot(p) for p in pgids] == \
        [ref_pmap.slot(p) for p in pgids] != slots
    # the active map follows the default mesh and the placement switch
    mesh_mod.set_default_mesh(mesh)
    assert placement.active_map().mesh is mesh
    assert _port_counters()["placement_slots"] == 2
    assert placement.active_map() is placement.active_map()
    placement_env = "CEPH_TPU_MESH_PLACEMENT"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(placement_env, "0")
        assert placement.active_map() is None
        assert _port_counters()["placement_slots"] == 0


def test_flush_decode_mesh_bit_exact(mesh, ref_mesh):
    """The engine's multi-device decode twin reconstructs exactly as the
    reference's — present rows verbatim, missing rows through the sharded
    decode product — and refuses a chunk size the shard axis does not
    divide, as the reference does."""
    cs = mesh.shape["shard"] * 64
    si = StripeInfo(stripe_width=4 * cs, chunk_size=cs)
    ref_si = ref_ec.StripeInfo(stripe_width=4 * cs, chunk_size=cs)
    host = _codec(backend="numpy")
    rng = np.random.default_rng(17)
    payload = rng.integers(0, 256, 5 * si.stripe_width, dtype=np.uint8)
    shards = ec_util.encode(si, host, payload)
    surv = {i: v for i, v in shards.items() if i not in (1, 4)}
    want = [1, 2, 4]
    got = ec_util.flush_decode_mesh(mesh, si, _codec(), surv, want)
    ref_got = ref_ec.flush_decode_mesh(ref_mesh, ref_si, _ref_codec(),
                                       surv, want)
    for c in want:
        assert np.array_equal(got[c], ref_got[c]), c
        assert np.array_equal(got[c], shards[c]), c
    odd = StripeInfo(stripe_width=4 * 66, chunk_size=66)
    with pytest.raises(ErasureCodeError, match="does not shard"):
        ec_util.flush_decode_mesh(mesh, odd, _codec(),
                                  {i: np.zeros(66, np.uint8)
                                   for i in (0, 2, 3, 5)}, [1])


def test_verify_step_mesh_twin_bit_exact(mesh, ref_mesh):
    """The deep-scrub mesh twin returns the reference's mismatch bitmap
    and crc linear parts, and the single-device program's, including on
    zero-padded object rows."""
    k, m = 4, 2
    mat = ref_gf256.rs_vandermonde_matrix(k, m)
    rng = np.random.default_rng(23)
    nobj, l_b = 5, 1 << 12               # pads to 8 for the mesh
    batch = np.zeros((nobj, k + m, l_b), dtype=np.uint8)
    for i in range(nobj):
        data = rng.integers(0, 256, (k, l_b), dtype=np.uint8)
        batch[i, :k] = data
        batch[i, k:] = ref_gf256.gf_matvec_chunks(mat, data)
    batch[2, 1, 100] ^= 0x40             # one silent bit flip
    before = _port_counters().get("mesh_scrub_batches", 0)
    mism_host, lin_host = se.verify_batch(mat, k, batch, device="cpu")
    mism_mesh, lin_mesh = se.verify_batch(mat, k, batch, mesh=mesh,
                                          device="cpu")
    ref_mism, ref_lin = ref_se.verify_batch(mat, k, batch, mesh=ref_mesh)
    for got in ((mism_host, lin_host), (mism_mesh, lin_mesh)):
        assert np.array_equal(got[0], np.asarray(ref_mism))
        assert np.array_equal(got[1], np.asarray(ref_lin))
        assert got[1].dtype == np.uint32
    assert mism_mesh[2].any() and not mism_mesh[0].any()
    assert _port_counters()["mesh_scrub_batches"] == before + 1


def test_engine_decode_routes_through_mesh(mesh, ref_mesh, monkeypatch):
    """decode_sync on a default mesh: a signature-batched decode at or
    above the crossover rides the mesh twin (``mesh_decode_flushes``),
    equal to the reference's and to the host codec."""
    monkeypatch.setenv("CEPH_TPU_MESH_FLUSH_BYTES", "1")
    cs = mesh.shape["shard"] * 64
    si = StripeInfo(stripe_width=4 * cs, chunk_size=cs)
    ref_si = ref_ec.StripeInfo(stripe_width=4 * cs, chunk_size=cs)
    rng = np.random.default_rng(29)
    payload = rng.integers(0, 256, 3 * si.stripe_width, dtype=np.uint8)
    shards = ec_util.encode(si, _codec(backend="numpy"), payload)
    surv = {i: v for i, v in shards.items() if i != 0}
    outs, stats = [], []
    for eng, set_mesh, msh, codec, sinfo in (
            (DeviceEncodeEngine(lambda key, fn: fn()),
             mesh_mod.set_default_mesh, mesh, _codec(), si),
            (ref_de.DeviceEncodeEngine(lambda key, fn: fn()),
             ref_mesh_mod.set_default_mesh, ref_mesh, _ref_codec(),
             ref_si)):
        set_mesh(msh)
        try:
            outs.append(eng.decode_sync("pg-dec", codec, sinfo, surv, [0]))
        finally:
            set_mesh(None)
            eng.stop()
        stats.append(eng.stats)
    out, ref_out = outs
    assert out is not None and np.array_equal(out[0], shards[0])
    assert np.array_equal(out[0], ref_out[0])
    assert stats[0]["mesh_decode_flushes"] == \
        stats[1]["mesh_decode_flushes"] == 1
    assert stats[0]["placement_flushes"] == stats[1]["placement_flushes"]


def test_distributed_clay_repair(mesh, ref_mesh):
    """Clay single-node repair as a mesh collective: helper sub-chunk
    fragments split over the mesh, the linearized repair matrix
    reconstructs the lost chunk, and an all-gather reassembles it — equal
    to the reference's mesh repair and to the host repair."""
    ref_codec = _ref_codec("clay", backend="numpy")
    codec = _codec("clay", backend="numpy")
    ssc = codec.get_sub_chunk_count()
    assert ssc == ref_codec.get_sub_chunk_count()
    rss = ssc // codec.q
    sub = mesh.shape["shard"] * 16          # bytes per sub-chunk
    cs = ssc * sub
    rng = np.random.default_rng(9)
    data = {i: rng.integers(0, 256, cs, dtype=np.uint8) for i in range(4)}
    enc = ref_codec.encode_chunks(list(range(6)), data)
    chunks = {**{i: np.asarray(data[i]) for i in range(4)},
              **{i: np.asarray(v) for i, v in enc.items()}}
    lost = 2
    helpers = tuple(i for i in range(6) if i != lost)
    ranges = codec.get_repair_subchunks(lost)
    assert ranges == ref_codec.get_repair_subchunks(lost)
    frag = {h: np.concatenate([chunks[h][off * sub:(off + cnt) * sub]
                               for off, cnt in ranges]) for h in helpers}
    want = ref_codec.decode([lost], dict(frag), cs)
    mat = codec._repair_matrix(lost, helpers)
    assert np.array_equal(mat, ref_codec._repair_matrix(lost, helpers))
    x = np.stack([f.reshape(rss, sub) for _h, f in sorted(frag.items())]
                 ).reshape(1, len(helpers) * rss, sub)
    x = np.repeat(x, mesh.shape["stripe"], axis=0)
    _rec, full = sharded_codec.make_matrix_step(mesh, mat)(
        sharded_codec.shard_stripe_batch(mesh, x))
    _rrec, ref_full = ref_sc.make_matrix_step(ref_mesh, mat)(
        ref_sc.shard_stripe_batch(ref_mesh, x))
    assert np.array_equal(np.asarray(full), np.asarray(ref_full))
    assert np.array_equal(np.asarray(full)[0].reshape(-1),
                          np.asarray(want[lost])), "clay mesh repair"


def test_matrix_step_tiles_wide_matrices(mesh):
    """A flat matrix past B1's 32 x 128 limit runs tiled (row blocks of
    32, column blocks of 128, partial products XORed): equal to the host
    oracle for Clay k=8,m=4,d=11's repair matrix shape, 64 x 176."""
    rng = np.random.default_rng(31)
    mat = rng.integers(0, 256, (64, 176), dtype=np.uint8)
    x = rng.integers(0, 256, (mesh.shape["stripe"], 176,
                              mesh.shape["shard"] * 8), dtype=np.uint8)
    rec, full = sharded_codec.make_matrix_step(mesh, mat)(
        sharded_codec.shard_stripe_batch(mesh, x))
    want = np.stack([ref_gf256.gf_matvec_chunks(mat, s) for s in x])
    assert np.array_equal(np.asarray(rec), want)
    assert np.array_equal(np.asarray(full), want)


def test_non_pow2_stripe_rows_encode_decode_bit_exact():
    """The counterpart of ``tests/test_mesh_cluster.py``'s non-pow2 test:
    a 3 x 2 mesh (6 CPU slots; the reference's 6 of its forced host
    devices), 5 stripes of EC k=2,m=1 (not a multiple of 3 either). The
    batcher's mesh flush gives the host encode's parity and the
    reference's; the decode twin rebuilds chunk 1 as the reference's
    does; the placement map has 3 slots with (1, 2) submeshes, slot for
    slot the reference's."""
    msh = mesh_mod.make_mesh(6, stripe=3, shard=2, devices=["cpu"] * 6)
    ref_msh = ref_mesh_mod.make_mesh(6, stripe=3, shard=2)
    assert msh.shape == dict(ref_msh.shape) == {"stripe": 3, "shard": 2}
    sinfo = StripeInfo(stripe_width=2 * 4096, chunk_size=4096)
    ref_si = ref_ec.StripeInfo(stripe_width=2 * 4096, chunk_size=4096)
    rng = np.random.default_rng(5)
    bufs = [rng.integers(0, 256, 2 * 4096, dtype=np.uint8)
            for _ in range(5)]
    results = ec_util._flush_mesh(msh, sinfo, _codec(k=2, m=1),
                                  list(range(5)), bufs)()
    ref_results = ref_ec._flush_mesh(ref_msh, ref_si,
                                     _ref_codec(k=2, m=1), list(range(5)),
                                     bufs)()
    host = _codec(k=2, m=1, backend="numpy")
    for (op, shards, err), (rop, rshards, rerr), buf in zip(
            results, ref_results, bufs):
        assert err is None and rerr is None and op == rop
        want = ec_util.encode(sinfo, host, buf, [2])
        assert np.array_equal(np.asarray(shards[2]).ravel(),
                              np.asarray(want[2]).ravel()), op
        for i in range(3):
            assert np.array_equal(np.asarray(shards[i]).ravel(),
                                  np.asarray(rshards[i]).ravel()), (op, i)
    present = {0: np.concatenate([r[1][0] for r in results]),
               2: np.concatenate([r[1][2] for r in results])}
    out = ec_util.flush_decode_mesh(msh, sinfo, _codec(k=2, m=1), present,
                                    [1])
    ref_out = ref_ec.flush_decode_mesh(ref_msh, ref_si,
                                       _ref_codec(k=2, m=1), present, [1])
    want = np.concatenate([b[4096:] for b in bufs])
    assert np.array_equal(np.asarray(out[1]).ravel()[:len(want)], want)
    assert np.array_equal(np.asarray(out[1]), np.asarray(ref_out[1]))
    pmap = placement.PlacementMap(msh)
    ref_pmap = ref_placement.PlacementMap(ref_msh)
    assert pmap.n_slots == ref_pmap.n_slots == 3
    slots = [pmap.slot((1, i)) for i in range(32)]
    assert slots == [ref_pmap.slot((1, i)) for i in range(32)]
    assert set(slots) == {0, 1, 2}
    for s in range(3):
        assert pmap.submesh(s).shape == {"stripe": 1, "shard": 2}


def _mesh_cluster(cls, set_mesh, msh, payloads):
    """Boot ``cls`` with ``msh`` as its default mesh (placement on), write
    ``payloads`` to an EC k=2,m=1 device pool, read each back, deep-scrub
    the pool; return its stores and its engines' stats."""
    set_mesh(msh)
    try:
        with cls(n_osds=4) as cluster:
            backend = "torch" if cls is MiniCluster else "jax"
            cluster.create_ec_pool("mp", k=2, m=1, pg_num=4,
                                   backend=backend)
            io = cluster.client().open_ioctx("mp")
            for i, pay in enumerate(payloads):
                io.write_full(f"o{i}", pay)
            assert [io.read(f"o{i}") for i in range(len(payloads))] == \
                payloads
            report = cluster.scrub_pool("mp", repair=False, deep=True)
            return _stores(cluster), report, \
                [dict(s) for s in _engine_stats(cluster)]
    finally:
        set_mesh(None)


def test_cluster_with_default_mesh_matches_reference(monkeypatch,
                                                     no_early_resend):
    """A port and a reference MiniCluster, each with a (2, 4) default
    mesh and placement on, the crossover at 1 byte: every write flushes
    through a placement slot's submesh in both, and the stores end equal
    shard for shard; the deep scrub verifies on the mesh and finds
    nothing."""
    monkeypatch.setenv("CEPH_TPU_MESH_FLUSH_BYTES", "1")
    monkeypatch.setenv("CEPH_TPU_HOST_FLUSH_BYTES", "0")
    rng = np.random.default_rng(41)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for n in (8192, 8192 * 3, 5000, 1, 8192 * 8)]
    scrubs = _port_counters().get("mesh_scrub_batches", 0)
    port, report, stats = _mesh_cluster(
        MiniCluster, mesh_mod.set_default_mesh,
        mesh_mod.make_mesh(8, devices=CPU8), payloads)
    ref_port, ref_report, ref_stats = _mesh_cluster(
        RefCluster, ref_mesh_mod.set_default_mesh,
        ref_mesh_mod.make_mesh(8), payloads)
    _assert_same_stores(ref_port, port)
    for st in (stats, ref_stats):
        assert sum(s["mesh_flushes"] for s in st) >= len(payloads)
        assert sum(s["errors"] for s in st) == 0
        assert sum(s["device_fused_fallbacks"] for s in st) == 0
    slots = set()
    for s in stats:
        slots |= set(s["per_slot_flushes"])
    assert slots == {0, 1}
    assert not report.get("inconsistent") and \
        not ref_report.get("inconsistent")
    assert _port_counters()["mesh_scrub_batches"] > scrubs


#: (cluster class, set_default_mesh, a default mesh of 8 devices, the
#: placement module, the stage registry, the pool backend) of each package
def _port_side():
    from ceph_tpu_torch.utils.dataplane import dataplane
    return (MiniCluster, mesh_mod.set_default_mesh,
            lambda: mesh_mod.make_mesh(8, devices=CPU8), placement,
            dataplane, "torch")


def _ref_side():
    from ceph_tpu.utils.dataplane import dataplane
    return (RefCluster, ref_mesh_mod.set_default_mesh,
            lambda: ref_mesh_mod.make_mesh(8), ref_placement, dataplane,
            "jax")


def _slot_stats(cluster) -> dict:
    out = {"mesh_flushes": 0, "mesh_decode_flushes": 0,
           "placement_flushes": 0, "slots": set()}
    for st in {id(s): s for s in _engine_stats(cluster)}.values():
        for key in ("mesh_flushes", "mesh_decode_flushes",
                    "placement_flushes"):
            out[key] += st[key]
        out["slots"] |= set(st["per_slot_flushes"])
    return out


def _pgids(cluster, pool: str, oids) -> dict:
    osdmap = cluster.mon.osdmap
    pool_id = osdmap.pool_by_name[pool]
    return {oid: (pool_id, osdmap.object_to_pg(pool_id, oid))
            for oid in oids}


def _mesh_scenario(side, payloads) -> dict:
    """``tests/test_mesh_cluster.py``'s scenario on one package: a 4-OSD
    cluster with a k=2,m=1 pool of 16 PGs on a default mesh of 8 devices,
    the writes, a deep scrub, degraded reads with the highest OSD down,
    its revival; the reference test's checks, and what is compared."""
    cls, set_mesh, make, place, dataplane, backend = side
    set_mesh(make())
    try:
        with cls(n_osds=4) as cluster:
            cluster.create_ec_pool("pod", k=2, m=1, pg_num=16,
                                   backend=backend)
            io = cluster.client().open_ioctx("pod")
            io.op_timeout = 120.0
            for oid, data in payloads.items():
                io.write_full(oid, data)
            stats = _slot_stats(cluster)
            assert stats["mesh_flushes"] > 0, stats
            assert stats["placement_flushes"] > 0, stats
            pgids = _pgids(cluster, "pod", payloads)
            pmap = place.active_map()
            assert pmap is not None and pmap.n_slots == 2
            decisions = {str(p): pmap.slot(p) for p in pgids.values()}
            assert stats["slots"] == set(decisions.values()), \
                (stats, decisions)
            for oid, data in payloads.items():
                assert io.read(oid) == data, oid
            tel = _scrub_counter(backend)
            before = tel()
            res = cluster.scrub_pool("pod", deep=True)
            assert res.get("deep") and res["inconsistent"] == {}, res
            assert tel() > before, "deep scrub never rode the mesh"
            written = _stores(cluster)
            victim = max(cluster.osds)
            cluster.kill_osd(victim)
            for oid, data in payloads.items():
                assert io.read(oid) == data, f"degraded read {oid}"
            assert _slot_stats(cluster)["mesh_decode_flushes"] > 0
            cluster.revive_osd(victim)
            cluster.wait_for_clean(timeout=60)
            pmap2 = place.active_map()
            assert {str(p): pmap2.slot(p)
                    for p in pgids.values()} == decisions
            for oid, data in payloads.items():
                assert io.read(oid) == data, f"post-revive read {oid}"
            return {"decisions": decisions, "slots": stats["slots"],
                    "written": written, "revived": _stores(cluster)}
    finally:
        set_mesh(None)


def _scrub_counter(backend):
    if backend == "jax":
        from ceph_tpu.utils.device_telemetry import telemetry as ref_tel
        return lambda: ref_tel().perf.dump().get("mesh_scrub_batches", 0)
    return lambda: telemetry().perf.dump().get("mesh_scrub_batches", 0)


def test_engine_on_mesh_cluster_scenario(monkeypatch, no_early_resend):
    """Counterpart of ``tests/test_mesh_cluster.py:75`` on both packages:
    the writes ride the mesh through the placement slots (the slots the
    engine saw are the slots of the PGs written), the deep scrub the mesh
    verify, the reads with an OSD down the mesh decode; placement is the
    same before and after the OSD's revival, and every acked write reads
    back. The port's and the reference's slot decisions are equal, and so
    are their stores after the writes and after the revival, shard for
    shard."""
    monkeypatch.setenv("CEPH_TPU_MESH_FLUSH_BYTES", "1")
    rng = np.random.default_rng(31)
    payloads = {f"pod{i}": rng.integers(0, 256, 64 * 1024,
                                        dtype=np.uint8).tobytes()
                for i in range(16)}
    port = _mesh_scenario(_port_side(), payloads)
    ref = _mesh_scenario(_ref_side(), payloads)
    assert port["decisions"] == ref["decisions"]
    assert port["slots"] == ref["slots"]
    _assert_same_stores(ref["written"], port["written"])
    _assert_same_stores(ref["revived"], port["revived"])


def _fidelity_run(side, loopback: bool, monkeypatch):
    """One fixed 8-write burst over one wire path: (placement decisions,
    engine slots, per-op stage shapes)."""
    cls, set_mesh, make, place, dataplane, backend = side
    monkeypatch.setenv("CEPH_TPU_MSGR_LOOPBACK", "1" if loopback else "0")
    dataplane().reset()
    set_mesh(make())
    try:
        with cls(n_osds=3) as cluster:
            cluster.create_ec_pool("fid", k=2, m=1, pg_num=8,
                                   backend=backend)
            io = cluster.client().open_ioctx("fid")
            io.op_timeout = 120.0
            oids = [f"fid{i}" for i in range(8)]
            for oid in oids:
                io.write_full(oid, oid.encode() * 4096)
            pmap = place.active_map()
            decisions = {oid: pmap.slot(p) for oid, p
                         in _pgids(cluster, "fid", oids).items()}
            shapes = sorted({tuple(s["stage"] for s in tl["stages"])
                             for tl in dataplane().recent()})
            return decisions, _slot_stats(cluster)["slots"], shapes
    finally:
        set_mesh(None)
        monkeypatch.delenv("CEPH_TPU_MSGR_LOOPBACK")


def test_placement_fidelity_loopback_vs_tcp(monkeypatch):
    """Counterpart of ``tests/test_mesh_cluster.py:168``: the same burst
    over the in-process loopback and over TCP
    (``CEPH_TPU_MSGR_LOOPBACK``, ``parallel/messenger.py``) lands the same
    PG -> slot decisions, the same engine slots and the same per-op stage
    shapes; the port's loopback run equals the reference's."""
    monkeypatch.setenv("CEPH_TPU_MESH_FLUSH_BYTES", "1")
    lo = _fidelity_run(_port_side(), True, monkeypatch)
    tcp = _fidelity_run(_port_side(), False, monkeypatch)
    assert lo == tcp
    assert lo == _fidelity_run(_ref_side(), True, monkeypatch)


def test_poisoned_sharded_step_fails_op_with_eio(monkeypatch):
    """The port's deviation: a sharded step that faults fails the op with
    EIO and counts an engine error; no host encode, no single-device
    flush and no fallback count run in its place (the reference re-runs
    the batch on its single-device route). A poisoned mesh decode fails
    the read's decode group the same way."""
    monkeypatch.setenv("CEPH_TPU_MESH_FLUSH_BYTES", "1")
    monkeypatch.setenv("CEPH_TPU_HOST_FLUSH_BYTES", "0")
    calls = []
    for name in ("encode", "decode", "flush_host_async",
                 "_flush_device_fused_async"):
        real = getattr(ec_util, name)

        def spy(*a, real=real, name=name, **kw):
            calls.append(name)
            return real(*a, **kw)
        monkeypatch.setattr(ec_util, name, spy)
    real_mm = sharded_codec.matmul_local

    def boom(*a, **k):
        raise RuntimeError("poisoned sharded step")

    mesh_mod.set_default_mesh(mesh_mod.make_mesh(8, devices=CPU8))
    with MiniCluster(n_osds=4) as cluster:
        cluster.create_ec_pool("nf", k=2, m=1, pg_num=1, backend="torch")
        io = cluster.client().open_ioctx("nf")
        io.op_timeout = 60.0
        good = bytes(range(256)) * 64
        io.write_full("good", good)
        eng = next(o._device_engine for o in cluster.osds.values()
                   if o._device_engine is not None)
        assert eng.stats["mesh_flushes"] >= 1 and eng.stats["errors"] == 0
        monkeypatch.setattr(sharded_codec, "matmul_local", boom)
        with pytest.raises(RadosError) as err:
            io.write_full("bad", b"x" * 20000)
        assert err.value.code == ec_backend.EIO
        assert eng.stats["errors"] == 1
        assert eng.stats["device_fused_fallbacks"] == 0
        assert calls == []
        monkeypatch.setattr(sharded_codec, "matmul_local", real_mm)
        assert io.read("good") == good

        # the engine's decode: a group on the mesh faults, its op errs
        cs = 4 * 64
        si = StripeInfo(stripe_width=2 * cs, chunk_size=cs)
        codec = _codec(k=2, m=1)
        shards = ec_util.encode(si, codec, np.arange(4 * cs, dtype=np.uint8)
                                .astype(np.uint8))
        calls.clear()
        monkeypatch.setattr(sharded_codec, "matmul_local", boom)
        errors = eng.stats["decode_errors"]
        assert eng.decode_sync("pg", codec, si,
                               {1: shards[1], 2: shards[2]}, [0]) is None
        assert eng.stats["decode_errors"] == errors + 1
        assert calls == []


def test_leaked_default_meshes():
    """Sets both packages' default meshes and leaves them set: the
    autouse fixture must clear them before the next test."""
    mesh_mod.set_default_mesh(mesh_mod.make_mesh(1, devices=["cpu"]))
    ref_mesh_mod.set_default_mesh(ref_mesh_mod.make_mesh(1))


def test_default_meshes_reset_after_a_leak():
    assert mesh_mod.get_default_mesh() is None
    assert ref_mesh_mod.get_default_mesh() is None
