"""The port's deep scrub (``ceph_tpu_torch/osd/scrub_engine.py``) against the
reference's, on the CPU.

- ``verify_batch`` (B1's and B2's plain versions on CPU tensors) equals
  the reference's ``verify_batch`` (its XLA program on the JAX CPU
  backend) bit for bit: the [nobj, m] mismatch bitmap and the
  [nobj, k+m] linear crcs, for k=3,m=2 at L=7000 with rot in a data and a
  parity shard, and for ISA k=8,m=3 at l_b = 128 KiB; and both equal the
  host oracle.
- 100 same-shape batches build one cached program and count one
  signature in the device telemetry.
- A port and a reference MiniCluster (memstore, pools k=2,m=1 and
  k=2,m=2; the reference on ``backend=jax``, the port on
  ``backend=torch``) take the same writes and the same silent bit
  flips; their deep scrubs convict and repair the same (oid, position)
  pairs, and afterwards their stores are equal shard for shard (bytes,
  attrs, omap).
- The reference file's BlockStore end-to-end, clean-PG, replicated-pool
  and admin-socket cases, on the port.
- The port's deviation: a faulted verify reports an ``error``, counts
  ``device_errors``, judges none of the batch clean and sends no object
  to the host verdict (``_scrub_object``).

Clusters run one after the other. Tolerance 0.
"""

import numpy as np
import pytest

from ceph_tpu.models import registry as ref_registry
from ceph_tpu.osd import scrub_engine as ref_se
from ceph_tpu.qa.cluster import MiniCluster as RefCluster
from ceph_tpu_torch.models import instance
from ceph_tpu_torch.ops import crc32c_torch, gf256
from ceph_tpu_torch.osd import ec_util, scrub_engine as se
from ceph_tpu_torch.osd.osd import OSD
from ceph_tpu_torch.osd.pg import PGMETA, pg_cid
from ceph_tpu_torch.qa.cluster import MiniCluster
from ceph_tpu_torch.utils import checksum
from ceph_tpu_torch.utils.admin_socket import asok_command
from ceph_tpu_torch.utils.device_telemetry import telemetry

CHUNK = 4096


def _coding_matrix(plugin, k, m, **extra):
    profile = {"plugin": plugin, "k": str(k), "m": str(m),
               "backend": "numpy", **extra}
    mat = instance().factory(plugin, dict(profile),
                             device="cpu").coding_matrix
    ref = ref_registry.instance().factory(plugin, dict(profile)).coding_matrix
    assert np.array_equal(mat, ref)
    return np.asarray(mat, dtype=np.uint8)


def _batch(mat, k, n_obj, length, l_b, seed, rot):
    """Seeded objects (data + host-oracle parity), FRONT-padded to l_b,
    with ``rot`` = [(object, shard, byte, xor)] applied."""
    rng = np.random.default_rng(seed)
    objs = []
    for _ in range(n_obj):
        data = rng.integers(0, 256, size=(k, length), dtype=np.uint8)
        objs.append(np.concatenate([data, gf256.gf_matvec_chunks(mat,
                                                                 data)]))
    for i, shard, byte, xor in rot:
        objs[i][shard, byte] ^= xor
    batch = np.zeros((n_obj, objs[0].shape[0], l_b), dtype=np.uint8)
    for i, o in enumerate(objs):
        batch[i, :, l_b - length:] = o
    return objs, batch


CASES = {
    # k, m, plugin extra, objects, L, rot: data rot hits every parity row,
    # parity rot its own row only
    "k3m2_L7000": (3, 2, ("jerasure", {}), 4, 7000,
                   [(1, 2, 99, 0x40), (3, 4, 5, 0x01)]),
    "isa_k8m3_128KiB": (8, 3, ("isa", {"technique": "reed_sol_van"}), 3,
                        128 << 10, [(0, 5, 70000, 0x80), (2, 9, 1, 0x10),
                                    (2, 10, 131071, 0x02)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_batch_matches_reference(case):
    k, m, (plugin, extra), n_obj, length, rot = CASES[case]
    mat = _coding_matrix(plugin, k, m, **extra)
    l_b = se._pow2(length, se._MIN_LEN_BUCKET)
    assert l_b == ref_se._pow2(length, ref_se._MIN_LEN_BUCKET)
    objs, batch = _batch(mat, k, n_obj, length, l_b, seed=len(case), rot=rot)
    mism, lin = se.verify_batch(mat, k, batch, device="cpu")
    ref_mism, ref_lin = ref_se.verify_batch(mat, k, batch)
    assert mism.dtype == np.bool_ and mism.shape == (n_obj, m)
    assert lin.dtype == np.uint32 and lin.shape == (n_obj, k + m)
    assert np.array_equal(mism, np.asarray(ref_mism))
    assert np.array_equal(lin, np.asarray(ref_lin))
    # and the host oracle: parity re-encode and the full crcs
    for i, o in enumerate(objs):
        parity = gf256.gf_matvec_chunks(mat, o[:k])
        assert list(mism[i]) == [not np.array_equal(parity[j], o[k + j])
                                 for j in range(m)]
        for pos in range(k + m):
            assert crc32c_torch.crc32c_from_linear(
                int(lin[i, pos]), length, ec_util.HINFO_SEED) == \
                checksum.crc32c(o[pos], ec_util.HINFO_SEED)
    rotten = {i for i, _s, _b, _x in rot}
    assert {i for i in range(n_obj) if mism[i].any()} == rotten


def test_verify_batch_refuses_a_mesh():
    mat = _coding_matrix("jerasure", 2, 1)
    with pytest.raises(NotImplementedError):
        se.verify_batch(mat, 2, np.zeros((1, 3, 4096), np.uint8),
                        mesh=object(), device="cpu")


def test_100_same_shape_scrub_batches_one_program():
    """100 same-shape verify batches (object counts 3 and 4 share the
    pow2 bucket) build one cached program and count one signature; the
    recompile counter does not move."""
    k, m = 2, 1
    mat = gf256.rs_matrix_isa(k, m)
    rng = np.random.default_rng(11)
    l_b = se._MIN_LEN_BUCKET
    recompiles0 = telemetry().snapshot()["counters"].get("recompiles", 0)
    sig = f"scrub_verify[{m}x{k}]L{l_b}n4"
    key = (mat.tobytes(), k, l_b, 4)
    for i in range(100):
        batch = rng.integers(0, 256, size=(3 + i % 2, k + m, l_b),
                             dtype=np.uint8)
        se.verify_batch(mat, k, batch, device="cpu")
    assert telemetry().compile_count(sig) == 1
    assert sum(1 for kk in se._verify_cache if kk == key) == 1
    assert se.verify_fn(mat, k, l_b, 4) is se._verify_cache[key]
    assert telemetry().snapshot()["counters"].get("recompiles", 0) == \
        recompiles0


# -- port and reference clusters: same flips, same verdicts ----------------

def _stores(cluster) -> dict:
    """(pool, ps, position, object) -> (data, attrs, omap) from the store
    of the OSD the map puts at that position."""
    osdmap = cluster.mon.osdmap
    out = {}
    for pool_id, pool in osdmap.pools.items():
        for ps in range(pool.pg_num):
            _, acting, _ = osdmap.pg_to_up_acting(pool_id, ps)
            for pos, osd in enumerate(acting):
                store = cluster._stores.get(osd)
                cid = pg_cid(pool_id, ps, pos)
                if store is None or cid not in store.list_collections():
                    continue
                for oid in store.list_objects(cid):
                    out[(pool_id, ps, pos, oid)] = (
                        store.read(cid, oid), store.getattrs(cid, oid),
                        store.omap_get(cid, oid))
    return out


#: (pool, oid, position, offset, length) of each silent flip: data and
#: parity positions, the primary's own shard among them
FLIPS = [("ec", "d1", 1, 17, 4), ("ec", "p2", 2, 0, 8),
         ("ec", "d0", 0, 5000, 16), ("wide", "w2", 2, 100, 4),
         ("wide", "w3", 3, 9000, 2), ("wide", "w1", 1, 0, 1)]
OBJECTS = {"ec": ["d0", "d1", "p2", "clean1", "clean2"],
           "wide": ["w1", "w2", "w3", "clean3"]}


def _scrub_sequence(cls, backend) -> tuple[dict, dict]:
    rng = np.random.default_rng(281)
    pays = {oid: rng.integers(0, 256, 10_000 + 7_000 * i,
                              dtype=np.uint8).tobytes()
            for pool in sorted(OBJECTS)
            for i, oid in enumerate(OBJECTS[pool])}
    with cls(n_osds=4) as c:
        c.create_ec_pool("ec", k=2, m=1, pg_num=4, backend=backend)
        c.create_ec_pool("wide", k=2, m=2, pg_num=2, backend=backend)
        rados = c.client()
        ios = {pool: rados.open_ioctx(pool) for pool in OBJECTS}
        for pool, oids in OBJECTS.items():
            for oid in oids:
                ios[pool].write_full(oid, pays[oid])
        osdmap = c.mon.osdmap
        for pool, oid, pos, off, ln in FLIPS:
            pool_id = osdmap.pool_by_name[pool]
            ps = osdmap.object_to_pg(pool_id, oid)
            _, acting, _ = osdmap.pg_to_up_acting(pool_id, ps)
            c._stores[acting[pos]].inject_bit_flip(
                pg_cid(pool_id, ps, pos), oid, offset=off, length=ln)
        verdicts = {}
        for pool in sorted(OBJECTS):
            res = c.scrub_pool(pool, deep=True)
            assert res.get("deep") and "skipped" not in res, res
            verdicts[pool] = (res["inconsistent"], sorted(res["repaired"]),
                              res["objects"], res["batches"],
                              res["bytes_verified"])
            again = c.scrub_pool(pool, deep=True)
            assert again["inconsistent"] == {}, again
            assert c.scrub_pool(pool)["inconsistent"] == {}
        for pool, oids in OBJECTS.items():
            for oid in oids:
                assert ios[pool].read(oid) == pays[oid], oid
        return verdicts, _stores(c)


def test_deep_scrub_verdicts_and_repairs_match_reference():
    ref_verdicts, ref_stores = _scrub_sequence(RefCluster, "jax")
    verdicts, stores = _scrub_sequence(MiniCluster, "torch")
    want = {pool: {oid: [pos] for p, oid, pos, _o, _l in FLIPS if p == pool}
            for pool in OBJECTS}
    for pool in OBJECTS:
        assert verdicts[pool][0] == want[pool], verdicts[pool]
        assert verdicts[pool][1] == sorted(want[pool]), verdicts[pool]
    assert verdicts == ref_verdicts
    assert sorted(stores) == sorted(ref_stores)
    shards = [key for key in stores if key[3] != PGMETA]
    assert len(shards) == 5 * 3 + 4 * 4
    for key in sorted(ref_stores):
        (rd, ra, ro), (pd, pa, po) = ref_stores[key], stores[key]
        assert pd == rd, f"shard bytes differ at {key}"
        assert pa == ra, f"attrs differ at {key}"
        assert po == ro, f"omap differs at {key}"


# -- the reference file's single-cluster cases, on the port ----------------

@pytest.fixture(scope="module")
def cluster():
    with MiniCluster(n_osds=4) as c:
        c.create_ec_pool("ec", k=2, m=1, pg_num=4, backend="torch")
        c.create_pool("rep", pg_num=2, size=3)
        c.client()
        yield c


@pytest.fixture(scope="module")
def rados(cluster):
    return cluster._clients[0]


def _payload(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def _shard(cluster, pool_name, oid, pos):
    osdmap = cluster.mon.osdmap
    pool_id = osdmap.pool_by_name[pool_name]
    ps = osdmap.object_to_pg(pool_id, oid)
    _, acting, _ = osdmap.pg_to_up_acting(pool_id, ps)
    return cluster._stores[acting[pos]], pg_cid(pool_id, ps, pos)


def test_deep_scrub_blockstore_end_to_end(tmp_path):
    """BlockStore.inject_bit_flip rewrites the blob with a MATCHING csum:
    the store returns the rot with no EIO, deep scrub convicts and
    repairs it, and the client read is bit-exact."""
    with MiniCluster(n_osds=3, store="blockstore",
                     data_dir=str(tmp_path)) as c:
        rados = c.client()
        c.create_ec_pool("bec", k=2, m=1, pg_num=2, backend="torch")
        io = rados.open_ioctx("bec")
        payload = _payload(50, 50_000)
        io.write_full("durrot", payload)
        pos = 1
        store, cid = _shard(c, "bec", "durrot", pos)
        store.inject_bit_flip(cid, "durrot", offset=100, length=16)
        stream = np.frombuffer(payload + b"\0" * (-len(payload) % 8192),
                               np.uint8).reshape(-1, 2, CHUNK)[:, pos]
        raw = store.read(cid, "durrot")
        assert raw[100:116] == bytes(b ^ 0xFF for b in
                                     stream.reshape(-1)[100:116].tobytes())
        res = c.scrub_pool("bec", deep=True)
        assert res["inconsistent"].get("durrot") == [pos], res
        assert "durrot" in res["repaired"], res
        assert io.read("durrot") == payload
        assert c.scrub_pool("bec", deep=True)["inconsistent"] == {}


def test_clean_pg_deep_and_shallow_agree_no_host_verdicts(
        cluster, rados, monkeypatch):
    """On a corruption-free pool the deep and the shallow scrub agree, and
    the deep pass makes no per-object host verdict."""
    io = rados.open_ioctx("ec")
    for i in range(5):
        io.write_full(f"clean-{i}", _payload(i, 10_000 + i * 3000))
    calls = []
    orig = OSD._scrub_object

    def counting(self, pg, oid):
        calls.append(oid)
        return orig(self, pg, oid)

    monkeypatch.setattr(OSD, "_scrub_object", counting)
    before = telemetry().snapshot()["counters"]
    deep = cluster.scrub_pool("ec", deep=True)
    assert deep.get("deep") and deep["inconsistent"] == {}, deep
    assert calls == [], calls
    after = telemetry().snapshot()["counters"]
    assert after["scrub_batches"] > before["scrub_batches"]
    assert after["scrub_bytes_verified"] > before["scrub_bytes_verified"]
    shallow = cluster.scrub_pool("ec")
    assert shallow["inconsistent"] == {}
    assert shallow["objects"] == deep["objects"]


def test_deep_scrub_replicated_pool_falls_back_to_shallow(cluster, rados):
    io = rados.open_ioctx("rep")
    io.write_full("repobj", _payload(8, 8_000))
    res = cluster.scrub_pool("rep", deep=True)
    assert not res.get("deep")
    assert res["inconsistent"] == {}
    assert res["objects"] >= 1


def test_deep_scrub_asok_command(cluster, rados):
    rados.open_ioctx("ec").write_full("asok-obj", _payload(9, 9_000))
    osdmap = cluster.mon.osdmap
    pool_id = osdmap.pool_by_name["ec"]
    ps = osdmap.object_to_pg(pool_id, "asok-obj")
    _, _, primary = osdmap.pg_to_up_acting(pool_id, ps)
    out = asok_command(cluster.osds[primary].asok.path, "deep-scrub",
                       timeout=60.0, pool=pool_id, ps=ps)
    assert out.get("deep") and out["objects"] >= 1, out
    assert out["engine_stats"]["batches"] >= 1
    assert out["engine_stats"]["device_errors"] == 0


def test_poisoned_verify_reports_error_and_judges_nothing_clean(
        cluster, rados, monkeypatch):
    """The port's deviation from the reference (which judges the batch on
    the host): the fault is counted and named, the batch's objects are
    listed unverified, and no object goes to _scrub_object."""
    io = rados.open_ioctx("ec")
    io.write_full("poison", _payload(10, 12_000))
    osdmap = cluster.mon.osdmap
    pool_id = osdmap.pool_by_name["ec"]
    ps = osdmap.object_to_pg(pool_id, "poison")
    _, _, primary = osdmap.pg_to_up_acting(pool_id, ps)
    osd = cluster.osds[primary]

    def poisoned(*_a, **_kw):
        raise RuntimeError("injected verify fault")

    calls = []
    monkeypatch.setattr(se, "verify_batch", poisoned)
    monkeypatch.setattr(OSD, "_scrub_object",
                        lambda self, pg, oid: calls.append(oid))
    errors0 = osd.scrub_engine().stats["device_errors"]
    res = osd.scrub_pg((pool_id, ps), deep=True)
    assert "injected verify fault" in res["error"], res
    assert "poison" in res["unverified"]
    assert res["inconsistent"] == {} and res["batches"] == 0
    assert osd.scrub_engine().stats["device_errors"] > errors0
    assert calls == []
    agg = cluster.scrub_pool("ec", deep=True)
    assert agg["objects"] == 0 and agg["inconsistent"] == {}
    assert any("injected verify fault" in s for s in agg["skipped"])
