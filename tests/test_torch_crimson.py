"""The port's crimson OSD (``ceph_tpu_torch/crimson``) against the
reference's, on the CPU.

First the counterparts of the 12 tests of ``tests/test_crimson.py``: the
single-OSD flat path (boot, maps, beacons, replicated objects) and the
mainline EC data path of a crimson ``MiniCluster`` (``backend=torch``
where the reference names ``jax``: the kernels' plain versions). The
multi-tenant test arms the port's lock witness, as the reference's arms its
own, and holds the burst to zero unacknowledged findings.

Then the stores: the same seeded payloads written one after the other into
a reference crimson cluster and a port crimson cluster are equal shard for
shard (bytes, every attr and the PG-meta log and info), on the device
route (``jax`` / ``torch``) and the host route; and a port crimson cluster
equals a port threaded one. Tolerance 0. Degraded reads decode on the
host twin (``ec_util.decode``), the reference's own route.
"""

import asyncio
import concurrent.futures
import time

import pytest

from ceph_tpu.qa.cluster import MiniCluster as RefCluster
from ceph_tpu_torch.client.rados import RadosClient, RadosError
from ceph_tpu_torch.crimson import CrimsonOSD
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.pg import PGMETA
from ceph_tpu_torch.parallel.mon import Monitor
from ceph_tpu_torch.qa.cluster import MiniCluster
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.dispatch_telemetry import telemetry

from test_torch_cluster import (  # noqa: F401  (no_early_resend: fixture)
    CHUNK,
    _assert_same_stores,
    _payloads,
    _write_sequence,
    no_early_resend,
)


def _wait_up(mon, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if any(i.up for i in mon.osdmap.osds.values()):
            return
        time.sleep(0.05)
    raise TimeoutError("no OSD came up")


@pytest.fixture
def setup():
    mon = Monitor("a")
    mon_addr = mon.start()
    osd = CrimsonOSD(0, mon_addr)
    osd.start()
    yield mon, osd, mon_addr
    osd.stop()
    mon.stop()


# -- flat path (single reactor-sharded OSD, replicated pools) ----------

def test_crimson_osd_serves_stock_client(setup):
    mon, osd, mon_addr = setup
    _wait_up(mon)
    client = RadosClient(mon_addr).connect()
    try:
        code, outs, _ = client.mon_command(
            {"prefix": "osd pool create", "pool": "cr", "pg_num": "4",
             "size": "1"})
        assert code == 0, outs
        io = client.open_ioctx("cr")
        io.write_full("o", b"reactor" * 100)
        assert io.read("o") == b"reactor" * 100
        io.append("o", b"!")
        assert io.read("o") == b"reactor" * 100 + b"!"
        assert io.stat("o") == 701
        io.remove("o")
        with pytest.raises(RadosError):
            io.read("o")
    finally:
        client.shutdown()


def test_shared_nothing_sharding_and_parallel_pgs(setup):
    """Every PG's data lives on exactly one reactor's store, several
    reactors carry load, and a stock client sees one coherent OSD."""
    mon, osd, mon_addr = setup
    _wait_up(mon)
    client = RadosClient(mon_addr).connect()
    try:
        code, outs, _ = client.mon_command(
            {"prefix": "osd pool create", "pool": "shards",
             "pg_num": "16", "size": "1"})
        assert code == 0, outs
        io = client.open_ioctx("shards")
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(
                lambda i: io.write_full(f"obj{i}",
                                        b"s" * 512 + bytes([i])),
                range(48)))
        for i in range(48):
            assert io.read(f"obj{i}") == b"s" * 512 + bytes([i])
        stats = osd.shard_stats()
        assert len(stats) == osd.smp and osd.smp >= 2
        assert sum(1 for s in stats if s["ops"] > 0) >= 2, stats
        seen = []
        for r in osd.reactors:
            for cid in r.store.list_collections():
                seen.append(cid)
                pool_ps = cid.split("_", 1)[1].split("s")[0]
                pgid = tuple(int(x) for x in pool_ps.split("."))
                assert osd.shard_of(pgid) is r, (cid, r.idx)
        assert len(seen) == len(set(seen)), (
            "a PG's state exists on two reactors", seen)
        total = sum(len(r.store.list_objects(cid))
                    for r in osd.reactors
                    for cid in r.store.list_collections())
        assert total == 48
    finally:
        client.shutdown()


def test_per_pg_sequencer_orders_ops(setup):
    """Concurrent appends to one PG from many client threads never lose
    bytes or interleave."""
    mon, osd, mon_addr = setup
    _wait_up(mon)
    client = RadosClient(mon_addr).connect()
    try:
        code, outs, _ = client.mon_command(
            {"prefix": "osd pool create", "pool": "seq",
             "pg_num": "1", "size": "1"})
        assert code == 0, outs
        io = client.open_ioctx("seq")
        io.write_full("log", b"")
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(
                lambda i: io.append("log", bytes([i]) * 7),
                range(40)))
        data = io.read("log")
        assert len(data) == 40 * 7
        for off in range(0, len(data), 7):
            run = data[off:off + 7]
            assert run == run[:1] * 7, (off, run)
        io.setxattr("log", "who", b"crimson")
        assert io.getxattr("log", "who") == b"crimson"
    finally:
        client.shutdown()


def test_crimson_pgls_lists_every_pg(setup):
    """OSD_OP_LIST routes by the message's ps, so every PG is listed."""
    mon, osd, mon_addr = setup
    _wait_up(mon)
    client = RadosClient(mon_addr).connect()
    try:
        code, outs, _ = client.mon_command(
            {"prefix": "osd pool create", "pool": "ls",
             "pg_num": "8", "size": "1"})
        assert code == 0, outs
        io = client.open_ioctx("ls")
        for i in range(24):
            io.write_full(f"k{i}", b"v")
        assert io.list_objects() == sorted(f"k{i}" for i in range(24))
    finally:
        client.shutdown()


def test_beacon_loop_injectable_seam():
    """The beacon loop reads its interval through the injected seam each
    lap and sleeps through the injected sleeper."""
    mon = Monitor("a")
    mon_addr = mon.start()
    laps = []

    async def fake_sleep(interval):
        laps.append(interval)
        if len(laps) >= 5:
            await asyncio.Event().wait()     # park forever
        await asyncio.sleep(0)

    osd = CrimsonOSD(0, mon_addr, beacon_interval=0.125,
                     beacon_sleep=fake_sleep)
    try:
        osd.start()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and osd.beacons_sent < 4:
            time.sleep(0.01)
        assert osd.beacons_sent >= 4
        assert laps[:4] == [0.125] * 4
        assert mon.osdmap.osds[0].up
    finally:
        osd.stop()
        mon.stop()


# -- the mainline EC data path on a crimson cluster --------------------

def test_stock_client_ec_roundtrip_on_crimson_cluster():
    with MiniCluster(n_osds=3, osd_flavor="crimson") as cluster:
        cluster.create_ec_pool("ec", k=2, m=1, pg_num=8)
        io = cluster.client().open_ioctx("ec")
        io.op_timeout = 30.0
        payload = b"crimson-ec" * 500
        io.write_full("obj", payload)
        assert io.read("obj") == payload
        io.append("obj", b"tail")
        assert io.read("obj") == payload + b"tail"
        assert io.stat("obj") == len(payload) + 4
        io.setxattr("obj", "k", b"v")
        assert io.getxattr("obj", "k") == b"v"
        for i in range(12):
            io.write_full(f"m{i}", bytes([i]) * 333)
        for i in range(12):
            assert io.read(f"m{i}") == bytes([i]) * 333
        assert set(io.list_objects()) >= {f"m{i}" for i in range(12)}
        io.remove("obj")
        with pytest.raises(RadosError):
            io.read("obj")
        cluster.wait_for_clean(timeout=15)


def _drive_readback(flavor: str) -> dict:
    out = {}
    with MiniCluster(n_osds=3, osd_flavor=flavor) as cluster:
        cluster.create_ec_pool("ab", k=2, m=1, pg_num=4)
        io = cluster.client().open_ioctx("ab")
        io.op_timeout = 30.0
        for i in range(6):
            io.write_full(f"o{i}", bytes([0x40 + i]) * (1000 + i))
        io.append("o0", b"-suffix")
        io.write_full("o1", b"overwritten")
        io.setxattr("o2", "tag", b"ab")
        for i in range(6):
            out[f"o{i}"] = io.read(f"o{i}")
        out["stat_o0"] = io.stat("o0")
        out["xattr_o2"] = io.getxattr("o2", "tag")
        out["ls"] = io.list_objects()
    return out


def test_byte_identical_readback_vs_threaded():
    """The same op sequence against a threaded and a crimson cluster
    reads back byte-identical."""
    assert _drive_readback("threaded") == _drive_readback("crimson")


def test_per_pg_ordering_under_concurrent_connections():
    """Several client connections append to one PG: every append stays
    atomic and each connection's ops keep their issue order."""
    with MiniCluster(n_osds=3, osd_flavor="crimson") as cluster:
        cluster.create_ec_pool("ord", k=2, m=1, pg_num=1)
        setup_io = cluster.client().open_ioctx("ord")
        setup_io.op_timeout = 30.0
        setup_io.write_full("log", b"")
        n_conns, per_conn = 4, 6

        def hammer(c):
            client = cluster.client()
            io = client.open_ioctx("ord")
            io.op_timeout = 30.0
            for s in range(per_conn):
                io.append("log", bytes([16 * c + s]) * 5)
            client.shutdown()

        with concurrent.futures.ThreadPoolExecutor(n_conns) as pool:
            list(pool.map(hammer, range(n_conns)))
        data = setup_io.read("log")
        assert len(data) == n_conns * per_conn * 5
        runs = []
        for off in range(0, len(data), 5):
            run = data[off:off + 5]
            assert run == run[:1] * 5, (off, run)
            runs.append(run[0])
        for c in range(n_conns):
            seq = [b % 16 for b in runs if b // 16 == c]
            assert seq == sorted(seq), (c, seq)
            assert len(seq) == per_conn


def test_dropped_frames_zero_lost_acked_writes():
    """Client op and reply frames dropped mid-burst: the resend ladder
    re-drives them, the dup-op cache answers resends of applied writes;
    every acked write reads back byte-exact."""
    from ceph_tpu_torch.parallel import messages as M
    conf = g_conf()
    old_resend = conf["objecter_resend_interval"]
    conf.set("objecter_resend_interval", 0.3)
    try:
        with MiniCluster(n_osds=3, osd_flavor="crimson") as cluster:
            reg = cluster.faults
            reg.reseed(11)
            cluster.create_ec_pool("dz", k=2, m=1, pg_num=4,
                                   backend="torch")
            io = cluster.client().open_ioctx("dz")
            io.op_timeout = 60.0
            payload_of = (lambda i: bytes(((i * 13 + j) & 0xFF)
                                          for j in range(4096)))
            io.write_full("warm", b"w")
            rules = [
                reg.add("msgr_drop", entity="client.*",
                        msg_type=M.MOSDOp.MSG_TYPE,
                        every=4, max_fires=3),
                reg.add("msgr_drop", entity="client.*",
                        msg_type=M.MOSDOpBatch.MSG_TYPE,
                        every=3, max_fires=3),
                reg.add("msgr_drop", entity="osd.*",
                        msg_type=M.MOSDOpReplyBatch.MSG_TYPE,
                        every=5, max_fires=2),
            ]
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                list(pool.map(
                    lambda i: io.write_full(f"s{i}", payload_of(i)),
                    range(24)))
            for r in rules:
                r.remove()
            assert sum(r.fires for r in rules) >= 1
            for i in range(24):
                assert io.read(f"s{i}") == payload_of(i), \
                    f"s{i} lost or wrong"
    finally:
        conf.set("objecter_resend_interval", old_resend)


def test_rtc_telemetry_no_continuation_hops_single_wakeups():
    """A crimson write burst through the engine crosses no
    ``wq_continuation`` or ``wq_op`` hop, every op crosses the
    ``reactor_submit`` seam, and a reply frame wakes ~one client
    thread."""
    with MiniCluster(n_osds=3, osd_flavor="crimson") as cluster:
        cluster.create_ec_pool("tl", k=2, m=1, pg_num=4,
                               backend="torch")
        io = cluster.client().open_ioctx("tl")
        io.op_timeout = 30.0
        io.write_full("warm", b"w" * 1024)
        telemetry().reset()
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            list(pool.map(
                lambda i: io.write_full(f"b{i}", b"x" * 8192),
                range(16)))
        for i in range(16):
            assert io.read(f"b{i}") == b"x" * 8192
        snap = telemetry().snapshot()
        c = snap["counters"]
        assert c["ophop_wq_continuation"] == 0, c
        assert c["ophop_wq_op"] == 0, c
        assert c["ophop_reactor_submit"] >= 32, c
        assert c["op_chains"] >= 32
        wf = snap["wakeups"]["wakeups_per_frame"]
        assert wf <= 1.05, snap["wakeups"]


def test_crimson_kill_revive_preserves_shard_data():
    """A revived crimson OSD gets its per-shard stores back: acked writes
    survive a kill/revive with no recovery in play."""
    with MiniCluster(n_osds=3, osd_flavor="crimson") as cluster:
        cluster.create_ec_pool("kr", k=2, m=1, pg_num=4)
        io = cluster.client().open_ioctx("kr")
        io.op_timeout = 30.0
        for i in range(8):
            io.write_full(f"d{i}", bytes([i]) * 2048)
        victim = max(cluster.osds)
        stores = cluster._stores[victim]
        cluster.kill_osd(victim)
        cluster.wait_for_osd_down(victim, timeout=30)
        cluster.revive_osd(victim)
        cluster.wait_for_osds_up(timeout=15)
        assert [r.store for r in cluster.osds[victim].reactors] == stores
        for i in range(8):
            assert io.read(f"d{i}") == bytes([i]) * 2048


def test_crimson_multi_tenant_burst_attributes_flows():
    """A multi-tenant burst on crimson attributes per-tenant ops, bytes
    and store-txn costs with >= 95% coverage, witness-armed: the
    attribution seams run inside the reactors' submit halves and must
    not add a cycle or a blocking call under a lock."""
    import json

    from ceph_tpu_torch.analysis import lock_witness as lw
    from ceph_tpu_torch.utils import flow_telemetry as ft

    lw.enable()
    try:
        with MiniCluster(n_osds=3, osd_flavor="crimson") as cluster:
            cluster.create_ec_pool("mt", k=2, m=1, pg_num=4,
                                   backend="torch")
            client = cluster.client()
            warm = client.open_ioctx("mt")
            warm.op_timeout = 30.0
            warm.set_flow("warmup")
            warm.write_full("warm", b"w" * 1024)
            tel = ft.telemetry_if_exists()
            assert tel is not None, \
                "a tagged write must materialize the flows registry"
            tel.reset()
            tenants = ("acme", "globex", "initech")
            ios = []
            for t in tenants:
                tio = client.open_ioctx("mt")
                tio.op_timeout = 30.0
                tio.set_flow(t)
                ios.append(tio)

            def burst(i):
                tio = ios[i % len(ios)]
                tio.write_full(f"{tenants[i % 3]}_{i}", b"x" * 4096)
                assert tio.read(f"{tenants[i % 3]}_{i}") \
                    == b"x" * 4096

            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                list(pool.map(burst, range(18)))

            tel = ft.telemetry()
            table = tel.flow_table()["flows"]
            for t in tenants:
                row = table.get(t)
                assert row is not None, (t, sorted(table))
                assert row["ops"] >= 12, (t, row)
                assert row["bytes_in"] >= 6 * 4096, (t, row)
                assert row["bytes_out"] >= 6 * 4096, (t, row)
                assert row["store_txn_bytes"] > 0, (t, row)
            att = tel.attribution()
            assert att["ops_pct"] >= 95.0, att
            assert att["bytes_pct"] >= 95.0, att
    finally:
        rep = lw.report()
        bad = lw.unacknowledged(rep)
        lw.disable()
        lw.reset()
    assert rep["edges"] > 0, rep
    assert not bad, (
        "unacknowledged witness findings on the multi-tenant crimson "
        "burst: " + json.dumps(bad, indent=1)[:2000])


# -- the stores against the reference and against the threaded OSD -----

CASES = {
    # (k, m, n_osds, profile extra)
    "k2m1": (2, 1, 4, {}),
    "isa_k8m3": (8, 3, 12, {"plugin": "isa",
                            "technique": "reed_sol_van"}),
}


def _case(case, route):
    k, m, n_osds, extra = CASES[case]
    sw = k * CHUNK
    payloads = _payloads([1, sw - 1, sw, sw + 1, 3 * 512, 5000, 256 << 10],
                         seed=k * 10 + m + 1)
    pool = {"k": k, "m": m, "pg_num": 8, **extra}
    ref_pool, port_pool = dict(pool), dict(pool)
    if route == "device":
        ref_pool["backend"], port_pool["backend"] = "jax", "torch"
    return k, m, n_osds, payloads, ref_pool, port_pool


@pytest.mark.parametrize("case,route", [("k2m1", "device"),
                                        ("k2m1", "host"),
                                        ("isa_k8m3", "device")])
def test_crimson_shards_match_reference_crimson(case, route,
                                                no_early_resend):
    """Shard for shard, attrs and PG-meta omap included, against the
    reference's crimson cluster written alike."""
    k, m, n_osds, payloads, ref_pool, port_pool = _case(case, route)
    ref = _write_sequence(RefCluster, n_osds, ref_pool, payloads,
                          osd_flavor="crimson")
    port = _write_sequence(MiniCluster, n_osds, port_pool, payloads,
                           osd_flavor="crimson")
    shards = [key for key in ref if key[3] != PGMETA]
    assert len(shards) == len(payloads) * (k + m)
    _assert_same_stores(ref, port)


@pytest.mark.parametrize("route", ["device", "host"])
def test_crimson_shards_match_threaded(route, no_early_resend):
    """A port crimson cluster and a port threaded cluster written alike
    hold the same shards, attrs and PG-meta omap."""
    k, m, n_osds, payloads, _ref_pool, port_pool = _case("k2m1", route)
    threaded = _write_sequence(MiniCluster, n_osds, port_pool, payloads)
    crimson = _write_sequence(MiniCluster, n_osds, port_pool, payloads,
                              osd_flavor="crimson")
    assert len([key for key in crimson if key[3] != PGMETA]) == \
        len(payloads) * (k + m)
    _assert_same_stores(threaded, crimson)


def test_crimson_degraded_read_decodes_on_the_host_twin(monkeypatch):
    """With an OSD down, a crimson read reconstructs through
    ``ec_util.decode`` on the host codec (the reference's route: a
    reactor never blocks on an engine continuation), and the engine
    decodes nothing."""
    calls = []
    real = ec_util.decode

    def spy(sinfo, codec, shards, want):
        calls.append(type(codec).__name__)
        return real(sinfo, codec, shards, want)

    monkeypatch.setattr(ec_util, "decode", spy)
    with MiniCluster(n_osds=3, osd_flavor="crimson") as cluster:
        cluster.create_ec_pool("dg", k=2, m=1, pg_num=1, backend="torch")
        io = cluster.client().open_ioctx("dg")
        io.op_timeout = 30.0
        blobs = {f"d{i}": bytes([i]) * (20000 + i) for i in range(4)}
        for oid, blob in blobs.items():
            io.write_full(oid, blob)
        osdmap = cluster.mon.osdmap
        _, acting, primary = osdmap.pg_to_up_acting(1, 0)
        victim = next(o for o in acting[:2] if o != primary)
        cluster.kill_osd(victim)
        cluster.wait_for_osd_down(victim, timeout=30)
        for oid, blob in blobs.items():
            assert io.read(oid) == blob
        assert len(calls) >= len(blobs)
        engine = cluster.osds[primary].reactors[0].services.device_engine()
        assert engine.stats["decode_ops"] == 0


@pytest.mark.parametrize("cluster_kw", [{"osd_flavor": "crimson"},
                                        {"auth": True}],
                         ids=["crimson", "cephx"])
def test_cuda_pool_raises_without_a_card(monkeypatch, cluster_kw):
    """A ``backend=cuda`` pool on a crimson or a cephx cluster is refused
    without a card: nothing runs the plain versions in its place."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with MiniCluster(n_osds=3, **cluster_kw) as cluster:
        with pytest.raises(AssertionError):
            cluster.create_ec_pool("cu", k=2, m=1, pg_num=1, backend="cuda")
        assert "cu" not in cluster.mon.osdmap.pool_by_name


def test_crimson_device_fault_fails_the_write_with_eio(monkeypatch):
    """A failed engine launch under a crimson write completes the op with
    EIO (``DeviceFault``), as on the threaded OSD: no host encode runs in
    its place, and the next write goes through."""
    from ceph_tpu_torch.osd import ec_backend
    from ceph_tpu_torch.utils import faults
    monkeypatch.setenv("CEPH_TPU_HOST_FLUSH_BYTES", "0")
    monkeypatch.setenv("CEPH_TPU_FUSE_CRC", "1")
    host_encodes = []
    real_encode = ec_util.encode

    def spy(*a, **kw):
        host_encodes.append(1)
        return real_encode(*a, **kw)

    reg = faults.reset_for_tests(seed=2)
    try:
        with MiniCluster(n_osds=3, osd_flavor="crimson") as cluster:
            cluster.create_ec_pool("ef", k=2, m=1, pg_num=1,
                                   backend="torch")
            io = cluster.client().open_ioctx("ef")
            io.op_timeout = 30.0
            io.write_full("good", b"g" * 20000)
            monkeypatch.setattr(ec_util, "encode", spy)
            rule = reg.add("engine_launch", max_fires=1)
            with pytest.raises(RadosError) as err:
                io.write_full("bad", b"x" * 20000)
            assert err.value.code == ec_backend.EIO
            assert rule.fires == 1 and host_encodes == []
            io.write_full("after", b"a" * 20000)
            assert io.read("after") == b"a" * 20000
            assert io.read("good") == b"g" * 20000
    finally:
        reg.clear()
