"""The port's OSD chain (``MiniCluster`` -> OSD -> ``ECBackend`` -> the
device engine) against the reference's, on the CPU.

The same seeded payloads go, one write after the other, into a reference
``MiniCluster`` (``ceph_tpu``) and a port ``MiniCluster``
(``ceph_tpu_torch``) with the same OSD ids, pool and ``pg_num``; then, for
each (pool, ps, position, oid), the store of the OSD the map puts at that
position is read and compared: the shard bytes, every attr (``v``,
``sz``, ``hinfo``) and the PG-meta object's log and info (omap). No
stored attr carries a time, so none is left out. Tolerance 0. The device route runs the reference with
``backend=jax`` and the port with ``backend=torch`` (the kernels' plain
versions on the CPU); the host route names no backend.

Then the port's counterparts of three reference cluster tests
(``tests/test_device_path.py:393``, ``tests/test_engine_pipeline.py:374``
and ``:472``), and the port's deliberate deviation: a device fault fails
the op with EIO instead of falling back to the host twin, and is counted.
Clusters run one after the other.
"""

import concurrent.futures
import contextlib
import json
import threading

import numpy as np
import pytest

from ceph_tpu.qa.cluster import MiniCluster as RefCluster
from ceph_tpu.utils.config import g_conf as ref_conf
from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.ops import gf256
from ceph_tpu_torch.osd import ec_backend, ec_util
from ceph_tpu_torch.osd.pg import PGMETA, pg_cid
from ceph_tpu_torch.qa.cluster import MiniCluster
from ceph_tpu_torch.utils import checksum, faults
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.device_telemetry import telemetry

CHUNK = 4096      # osd_pool_erasure_code_stripe_unit default


@pytest.fixture
def fast_death():
    """Tighten failure detection as the reference's ``fast_death``
    fixtures do (kill -> down in ~2 s), in both packages' configs. Only
    a test that kills an OSD asks for it, as in the reference: on a
    loaded host these knobs mark busy, live OSDs down, and a 12-OSD
    cluster then loses its PGs mid-write."""
    saved = []
    for conf in (g_conf(), ref_conf()):
        saved.append((conf, {k: conf[k] for k in ("osd_heartbeat_interval",
                                                  "osd_heartbeat_grace")}))
        conf.set("osd_heartbeat_interval", 0.25)
        conf.set("osd_heartbeat_grace", 1.0)
    yield
    for conf, old in saved:
        for k, v in old.items():
            conf.set(k, v)


@pytest.fixture
def no_early_resend():
    """Keep the client from resending a write that is slow but alive, in
    both packages' configs, for the comparisons of stored state. The
    objecter resends an unanswered op after 1-2 s
    (``objecter_resend_interval`` 2 s, jittered), and the OSD runs a
    resend of a ``write_full`` whose sub-writes are still in flight a
    second time (its dup-op cache holds completed ops only), so that
    object gets one more PG log entry and version. Under the 6-worker
    tier-1 run a 12-OSD cluster's write took that long, and the stores
    differed in the PG log (``test_shards_match_reference``); the
    in-process messenger loses no frame, so these tests need no resend.
    :func:`test_resend_of_a_slow_write_runs_it_again` shows the
    mechanism in both packages."""
    keys = ("objecter_resend_interval", "objecter_resend_max")
    saved = []
    for conf in (g_conf(), ref_conf()):
        saved.append((conf, {k: conf[k] for k in keys}))
        for k in keys:
            conf.set(k, 120.0)
    yield
    for conf, old in saved:
        for k, v in old.items():
            conf.set(k, v)


def _stores(cluster) -> dict:
    """(pool, ps, position, object) -> (data, attrs, omap), read from the
    store of the OSD that the map puts at that position (a crimson OSD
    keeps a store per reactor: the one holding the PG's collection)."""
    osdmap = cluster.mon.osdmap
    out = {}
    for pool_id, pool in osdmap.pools.items():
        for ps in range(pool.pg_num):
            _, acting, _ = osdmap.pg_to_up_acting(pool_id, ps)
            for pos, osd in enumerate(acting):
                stores = cluster._stores.get(osd)
                if not isinstance(stores, list):
                    stores = [stores]
                cid = pg_cid(pool_id, ps, pos)
                for store in stores:
                    if store is None or \
                            cid not in store.list_collections():
                        continue
                    for oid in store.list_objects(cid):
                        key = (pool_id, ps, pos, oid)
                        assert key not in out, f"{key} in two stores"
                        out[key] = (
                            store.read(cid, oid),
                            store.getattrs(cid, oid),
                            store.omap_get(cid, oid))
    return out


def _payloads(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
            for s in sizes]


def _write_sequence(cls, n_osds, pool, payloads, **cluster_kw):
    """Boot ``cls`` (with ``cluster_kw``, e.g. ``osd_flavor``), create the
    pool, write ``payloads`` one after the other, read each back, and
    return the stored objects (``_stores``)."""
    with cls(n_osds=n_osds, **cluster_kw) as cluster:
        io = cluster.client().open_ioctx(_create(cluster, pool))
        for i, pay in enumerate(payloads):
            io.write_full(f"o{i}", pay)
        back = [io.read(f"o{i}") for i in range(len(payloads))]
        assert back == payloads
        return _stores(cluster)


def _create(cluster, pool) -> str:
    cluster.create_ec_pool("p", **pool)
    return "p"


def _assert_same_stores(ref, port):
    assert sorted(port) == sorted(ref)
    for key in sorted(ref):
        (rd, ra, ro), (pd, pa, po) = ref[key], port[key]
        assert pd == rd, f"shard bytes differ at {key}"
        assert pa == ra, f"attrs differ at {key}: {sorted(ra)}"
        assert po == ro, f"omap differs at {key}"


CASES = {
    # (k, m, n_osds, profile extra); stripe width = k * CHUNK
    "k2m1": (2, 1, 4, {}),
    "isa_k8m3": (8, 3, 12, {"plugin": "isa",
                            "technique": "reed_sol_van"}),
}


@pytest.mark.parametrize("route", ["device", "host"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_shards_match_reference(case, route, no_early_resend):
    """Shard for shard against the reference cluster: one byte, stripe
    width -1/+0/+1, a multiple of 512 that is not one of the stripe
    width, a length that is not a multiple of 512, and 256 KiB."""
    k, m, n_osds, extra = CASES[case]
    sw = k * CHUNK
    payloads = _payloads([1, sw - 1, sw, sw + 1, 3 * 512, 5000, 256 << 10],
                         seed=k * 10 + m)
    pool = {"k": k, "m": m, "pg_num": 8, **extra}
    ref_pool, port_pool = dict(pool), dict(pool)
    if route == "device":
        ref_pool["backend"], port_pool["backend"] = "jax", "torch"
    ref = _write_sequence(RefCluster, n_osds, ref_pool, payloads)
    port = _write_sequence(MiniCluster, n_osds, port_pool, payloads)
    shards = [key for key in ref if key[3] != PGMETA]
    assert len(shards) == len(payloads) * (k + m)
    _assert_same_stores(ref, port)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_resend_of_a_slow_write_runs_it_again(pkg):
    """The mechanism behind the resend fixture, the same in both
    packages: a ``write_full`` whose sub-write commits are held 6 s is
    resent by the client (after 1-3 s: a 1-2 s delay checked each 1 s)
    and run a second time, so the object's shards reach version 3 where
    one write gives version 2 (pg_num 1: the first write took 1)."""
    if pkg == "reference":
        from ceph_tpu.utils import faults as pkg_faults
        cls = RefCluster
    else:
        pkg_faults, cls = faults, MiniCluster
    reg = pkg_faults.reset_for_tests(seed=0)
    versions = {}
    try:
        with cls(n_osds=3) as cluster:
            cluster.create_ec_pool("rs", k=2, m=1, pg_num=1)
            io = cluster.client().open_ioctx("rs")
            io.write_full("fast", b"f" * 5000)
            rule = reg.add("msgr_delay", entity="osd.*", msg_type=31,
                           delay_s=6.0, max_fires=2)   # MECSubWriteReply
            io.write_full("slow", b"s" * 5000)
            rule.remove()
            assert io.read("slow") == b"s" * 5000
            for (_pool, _ps, _pos, oid), (_d, attrs, _o) in \
                    _stores(cluster).items():
                if oid != PGMETA:
                    versions.setdefault(oid, set()).add(
                        int.from_bytes(attrs["v"], "little"))
    finally:
        reg.clear()
    # pg_num 1: "fast" is v1, "slow" v2 written once, v3 run twice
    assert versions == {"fast": {1}, "slow": {3}}


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_stale_missing_entries_do_not_livelock_recovery(pkg):
    """The recovery livelock (ROADMAP §C), on its smallest sequence: the
    primary's PG lists both other positions as missing the object's
    current version, which their shards hold. The recovery read avoids
    listed positions, so fewer than k remain and every round fails; the
    rollback probe then finds k shards at that version. The reference
    leaves the object to the failing path forever (its client reads,
    which avoid the listed positions too, may answer ENOENT meanwhile);
    the port drops the entries of the positions the probe finds holding
    the version, writing nothing, and the object reads back at it."""
    cls = RefCluster if pkg == "reference" else MiniCluster
    payload = bytes(range(256)) * 80
    with cls(n_osds=3) as cluster:
        cluster.create_ec_pool("sm", k=2, m=1, pg_num=1)
        io = cluster.client().open_ioctx("sm")
        io.write_full("obj", payload)
        _, acting, primary = cluster.mon.osdmap.pg_to_up_acting(1, 0)
        osd = cluster.osds[primary]
        pg = osd.pgs[(1, 0)]
        version = pg.log.last_version
        with pg.lock:
            pg.peer_missing = {p: {"obj": version} for p in range(3)
                               if acting[p] != primary}
        for _ in range(4):
            osd._recover(pg)
        left = {p: dict(m) for p, m in pg.peer_missing.items() if m}
        if pkg == "port":
            assert io.read("obj") == payload
        stored = {pos: int.from_bytes(attrs["v"], "little")
                  for (_pool, _ps, pos, oid), (_d, attrs, _o)
                  in _stores(cluster).items() if oid == "obj"}
    assert stored == {0: version, 1: version, 2: version}
    if pkg == "reference":
        assert sorted(left) == sorted(p for p in range(3)
                                      if acting[p] != primary)
    else:
        assert left == {}


def _engine_stats(cluster) -> list[dict]:
    return [o._device_engine.stats for o in cluster.osds.values()
            if o._device_engine is not None]


def test_cluster_device_backend_end_to_end(fast_death):
    """Counterpart of the reference's
    test_cluster_device_backend_end_to_end (backend=torch, the kernels'
    plain versions): concurrent writes batch through the engine, partial
    writes order behind staged full writes, a killed OSD's reads are
    degraded, and the revived OSD recovers through the engine's batched
    decode."""
    with MiniCluster(n_osds=4) as cluster:
        rados = cluster.client()
        cluster.create_ec_pool("dev", k=2, m=1, pg_num=8, backend="torch")
        io = rados.open_ioctx("dev")
        payload = b"d" * (96 << 10)
        errs = []

        def writer(w):
            try:
                for i in range(8):
                    io.write_full(f"o{w}_{i}", payload + bytes([w]))
            except Exception as exc:
                errs.append(exc)

        ts = [threading.Thread(target=writer, args=(w,)) for w in range(6)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert not errs, errs
        for w in range(6):
            for i in range(8):
                assert io.read(f"o{w}_{i}") == payload + bytes([w])
        stats = _engine_stats(cluster)
        assert stats, "no OSD ever used the device engine"
        # bulk ingest: the OSDs share one engine, so each handle's stats
        # are the whole cluster's
        assert max(s["ops"] for s in stats) >= 48, stats
        assert any(s["max_batch_ops"] > 1 for s in stats), stats

        io.write_full("ord", b"A" * 8192)
        io.append("ord", b"B" * 100)
        assert io.read("ord") == b"A" * 8192 + b"B" * 100
        io.write_full("gone", b"X" * 4096)
        io.remove("gone")
        with pytest.raises(RadosError):
            io.read("gone")

        cluster.kill_osd(3)
        cluster.wait_for_osd_down(3, timeout=30)
        assert io.read("o0_0") == payload + bytes([0])
        io.write_full("during", b"deg" * 1000)
        cluster.revive_osd(3)
        cluster.wait_for_clean(timeout=60)
        assert io.read("during") == b"deg" * 1000
        dstats = _engine_stats(cluster)
        assert max(s["decode_ops"] for s in dstats) > 0, dstats
        assert max(s["decode_errors"] for s in dstats) == 0, dstats
        assert max(s["errors"] for s in dstats) == 0, dstats


def test_hbm_gauges_zero_across_cluster_lifecycles():
    """Counterpart of the reference's
    test_hbm_gauges_zero_across_cluster_lifecycles: two full cluster
    lifecycles through the port's engine leave the live device-buffer
    gauges at zero every time."""
    telemetry().reset()
    tel = telemetry()
    for cycle in range(2):
        with MiniCluster(n_osds=3) as cluster:
            cluster.create_ec_pool("hbm", k=2, m=1, pg_num=4,
                                   backend="torch")
            io = cluster.client().open_ioctx("hbm")
            io.op_timeout = 120.0
            for i in range(4):
                io.write_full(f"o{i}", b"h" * 8192)
            assert io.read("o0") == b"h" * 8192
        assert tel.hbm_live_bytes() == 0, \
            f"live device bytes leaked in lifecycle {cycle}"
        assert tel.perf.get("hbm_staged_bytes") == 0
        assert tel.perf.get("hbm_inflight_bytes") == 0
    assert tel.perf.get("hbm_retired_bytes") > 0
    telemetry().reset()


def _interleave(cls, backend) -> tuple[dict, dict]:
    """The reference's interleaved write/remove rounds on one object
    through the shared engine, then a final write and a deep scrub of
    the pool; returns every OSD's stored objects and the scrub's
    report."""
    with cls(n_osds=3) as cluster:
        cluster.create_ec_pool("ord", k=2, m=1, pg_num=4, backend=backend)
        io = cluster.client().open_ioctx("ord")
        io.op_timeout = 120.0

        def _quiet(fn, *a):
            try:
                fn(*a)
            except Exception:
                pass        # remove of a not-yet-created oid etc.

        for r in range(6):
            pay = bytes(((r * 41 + j) & 0xFF) for j in range(8192))
            alt = bytes(((r * 43 + j) & 0xFF) for j in range(8192))
            with concurrent.futures.ThreadPoolExecutor(2) as pool:
                if r % 2:
                    fs = [pool.submit(io.write_full, "hot", pay),
                          pool.submit(_quiet, io.remove, "hot")]
                else:
                    fs = [pool.submit(io.write_full, "hot", pay),
                          pool.submit(io.write_full, "hot", alt)]
                for f in fs:
                    f.result()
        final = b"f" * 8192
        io.write_full("hot", final)
        assert io.read("hot") == final
        scrub = cluster.scrub_pool("ord", repair=False, deep=True)
        return _stores(cluster), scrub


def test_interleaved_write_remove_order_through_shared_engine():
    """Counterpart of the reference's
    test_interleaved_write_remove_order_through_shared_engine. The
    ordering oracles: (1) the port's deep scrub of the pool (its device
    verify re-encodes every object and checks every shard's crc) finds
    no inconsistency, as the reference's does on its own run; (2) the
    reference cluster's run of the same sequence: every shard of the
    final object holds the same bytes, ``sz`` and ``hinfo``; (3) the
    host re-encode of the stored data shards equals the stored parity;
    (4) the shards agree on one version. The version itself (``v``) and
    the PG log are not compared with the reference: they count the ops
    that committed, and whether a racing remove found the object depends
    on the interleaving."""
    ref, ref_scrub = _interleave(RefCluster, "jax")
    port, scrub = _interleave(MiniCluster, "torch")
    assert ref_scrub["inconsistent"] == {}, ref_scrub
    assert scrub["inconsistent"] == {}, scrub
    assert scrub.get("deep") and scrub["objects"] >= 1, scrub
    hot = {key[2]: val for key, val in port.items() if key[3] == "hot"}
    ref_hot = {key[2]: val for key, val in ref.items() if key[3] == "hot"}
    assert sorted(hot) == sorted(ref_hot) == [0, 1, 2]
    for pos, (data, attrs, _omap) in hot.items():
        rdata, rattrs, _ = ref_hot[pos]
        assert data == rdata, pos
        assert attrs["sz"] == rattrs["sz"] and \
            attrs["hinfo"] == rattrs["hinfo"], pos
    assert len({attrs["v"] for _d, attrs, _o in hot.values()}) == 1
    by_pos = {pos: np.frombuffer(d, np.uint8)
              for pos, (d, _a, _o) in hot.items()}
    codec = ec_backend.ec_registry.instance().factory(
        "jerasure", {"k": "2", "m": "1", "backend": "numpy"}, device="cpu")
    parity = gf256.gf_matvec_chunks(codec.coding_matrix,
                                    np.stack([by_pos[0], by_pos[1]]))
    assert np.array_equal(parity[0], by_pos[2])
    hinfo = json.loads(hot[next(iter(hot))][1]["hinfo"])
    for pos, shard in by_pos.items():
        assert hinfo["hashes"][pos] == \
            checksum.crc32c(shard, ec_util.HINFO_SEED)


@contextlib.contextmanager
def _host_twin_spy(monkeypatch):
    """Counts every host encode, decode and host flush of the port."""
    calls = []
    for name in ("encode", "decode", "flush_host_async"):
        real = getattr(ec_util, name)

        def spy(*a, real=real, name=name, **kw):
            calls.append(name)
            return real(*a, **kw)
        monkeypatch.setattr(ec_util, name, spy)
    yield calls


def test_device_faults_fail_ops_with_eio_not_host_fallback(monkeypatch):
    """The three sites where the reference falls back to its host twin
    after a device fault (the encode continuation, ``_decode``, and
    decode-on-read) fail the op in the port, and the engine counts it;
    no host encode or decode runs."""
    # every flush on the device route, fused (as on the card)
    monkeypatch.setenv("CEPH_TPU_HOST_FLUSH_BYTES", "0")
    monkeypatch.setenv("CEPH_TPU_FUSE_CRC", "1")
    reg = faults.reset_for_tests(seed=1)
    reg.clear()
    with MiniCluster(n_osds=4) as cluster:
        cluster.create_ec_pool("nf", k=2, m=2, pg_num=1, backend="torch")
        io = cluster.client().open_ioctx("nf")
        io.op_timeout = 60.0
        good = bytes(range(256)) * 64
        io.write_full("good", good)
        stats = _engine_stats(cluster)[0]
        assert stats["errors"] == 0 and stats["ops"] >= 1

        def boom(*a, **k):
            raise RuntimeError("poisoned fused path")

        # site 1: the encode continuation
        real_fused = ec_util._flush_device_fused_async
        with _host_twin_spy(monkeypatch) as calls:
            monkeypatch.setattr(ec_util, "_flush_device_fused_async", boom)
            with pytest.raises(RadosError) as err:
                io.write_full("bad", b"x" * 20000)
            assert err.value.code == ec_backend.EIO
            monkeypatch.setattr(ec_util, "_flush_device_fused_async",
                                real_fused)
            assert calls == []
        assert _engine_stats(cluster)[0]["errors"] == 1

        # sites 2 and 3: a degraded read that needs both parity rows
        # (data positions 0 and 1 unreadable, so not XOR-decodable)
        osd = cluster.osds[cluster.mon.osdmap.pg_to_up_acting(1, 0)[2]]
        pg = osd.pgs[(1, 0)]
        be = pg.backend
        for pos in (0, 1):
            reg.add("store_eio", cid_prefix=f"pg_1.0s{pos}")
        rule = reg.add("engine_decode")
        with _host_twin_spy(monkeypatch) as calls:
            with pytest.raises(RadosError) as err:
                io.read("good")
            assert err.value.code == ec_backend.EIO
            shards = {2: np.zeros(CHUNK, np.uint8),
                      3: np.zeros(CHUNK, np.uint8)}
            with pytest.raises(ec_backend.DeviceFault):
                be._decode(pg, shards, [0, 1])
            assert calls == []
        assert _engine_stats(cluster)[0]["decode_errors"] >= 2
        assert _engine_stats(cluster)[0]["decode_ops"] == 0
        rule.remove()
        assert io.read("good") == good
        assert _engine_stats(cluster)[0]["decode_ops"] >= 1
    reg.clear()


def test_auto_device_raises_without_a_card(monkeypatch):
    """``auto_device`` resolves to the card and raises without one: the
    mon refuses the profile, and the backend's resolution raises."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ec_backend.ErasureCodeError, match="no CUDA"):
        ec_backend.resolve_auto_device()
    with MiniCluster(n_osds=3) as cluster:
        code, outs, _ = cluster.mon_cmd(
            prefix="osd erasure-code-profile set", name="ad",
            profile=json.dumps({"plugin": "jerasure", "k": "2", "m": "1",
                                "backend": "auto_device"}))
        assert code != 0 and "no CUDA" in outs
        # host and CPU-device pools need no card
        cluster.create_ec_pool("cpu", k=2, m=1, pg_num=1, backend="torch")
        cluster.create_ec_pool("host", k=2, m=1, pg_num=1)


@pytest.mark.parametrize("forced", ["jax", "pallas"])
def test_forced_backend_refuses_reference_names(monkeypatch, forced):
    """``CEPH_TPU_EC_BACKEND`` takes the port's backend names only."""
    monkeypatch.setenv("CEPH_TPU_EC_BACKEND", forced)
    cluster = MiniCluster(n_osds=1)
    with pytest.raises(ValueError, match="port's backends"):
        cluster.create_ec_pool("x")
