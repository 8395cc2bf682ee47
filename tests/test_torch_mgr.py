"""The port's mgr modules — balancer (upmap), progress, telemetry,
dashboard — and the default module set, against the reference's, on the
CPU.

- The counterparts of ``tests/test_mgr.py`` (7 cases) on the port: the
  OSDMap's ``pg_upmap_items`` mechanics, the balancer on a stand-in mgr
  whose mon applies upmaps through the map's own validator, telemetry,
  progress, the mgr daemon against a port ``MiniCluster`` (``start_mgr()``
  booting the default set), and the dashboard's HTML page and JSON API.
- Across the packages (tolerance: equal): OSDMaps built alike in both
  packages are asserted equal first (the encoded map and every PG's up
  set); then the balancer's plans are equal move for move over several
  rounds, and so are the spreads after each; the telemetry reports have
  the same keys and, but for the timestamp, the same values.
"""

import json
import os

import pytest

from ceph_tpu.mgr import balancer as ref_balancer
from ceph_tpu.mgr import telemetry as ref_telemetry
from ceph_tpu.parallel import crush as ref_crush
from ceph_tpu.parallel.osdmap import OSDMap as RefOSDMap
from ceph_tpu_torch.mgr.mgr import DEFAULT_MODULES
from ceph_tpu_torch.parallel import crush
from ceph_tpu_torch.parallel.osdmap import OSDMap
from ceph_tpu_torch.qa.cluster import MiniCluster
from ceph_tpu_torch.utils.admin_socket import asok_command


def make_map(n_osds: int = 5, pg_num: int = 32, size: int = 2,
             osdmap_cls=OSDMap, crush_mod=crush) -> OSDMap:
    m = osdmap_cls()
    m.crush.add_bucket("default", "root")
    for i in range(n_osds):
        host = f"host{i}"
        m.crush.add_bucket(host, "host", parent="default")
        m.crush.add_device(i, host)
        m.add_osd(i)
        m.mark_up(i, f"127.0.0.1:{7000 + i}")
    m.crush.add_rule(crush_mod.Rule("data", "default", "host", "firstn"))
    m.create_pool("p", pg_num, "data", size=size, min_size=1)
    m.epoch = 1
    return m


def make_map_pair(**kw):
    """The same map built alike in both packages, asserted equal."""
    port = make_map(**kw)
    ref = make_map(osdmap_cls=RefOSDMap, crush_mod=ref_crush, **kw)
    assert port.encode() == ref.encode()
    pid = port.pool_by_name["p"]
    for ps in range(port.pools[pid].pg_num):
        assert port.pg_to_up_acting(pid, ps) == ref.pg_to_up_acting(pid, ps)
    return port, ref


def test_pg_upmap_items_remaps_up_set():
    m = make_map()
    pid = m.pool_by_name["p"]
    ps = 0
    up, _, _ = m.pg_to_up_acting(pid, ps)
    target = next(o for o in m.osds if o not in up)
    m.pg_upmap_items[(pid, ps)] = [(up[0], target)]
    up2, acting2, _ = m.pg_to_up_acting(pid, ps)
    assert up2 == [target] + up[1:]
    assert acting2 == up2
    m.mark_down(target)
    up3, _, _ = m.pg_to_up_acting(pid, ps)
    assert up3 == up
    m2 = OSDMap.decode(m.encode())
    assert m2.pg_upmap_items == m.pg_upmap_items


class _FakeMgr:
    """Just enough Mgr surface for module unit tests."""

    def __init__(self, osdmap):
        self.osdmap = osdmap
        self.mon_addr = "127.0.0.1:1"
        self.commands = []

    def get_osdmap(self):
        return self.osdmap

    def get_status(self):
        return {"health": "HEALTH_OK", "pgmap": {"degraded_pgs": 0}}

    def mon_command(self, **cmd):
        self.commands.append(cmd)
        key = (int(cmd["pool"]), int(cmd["ps"]))
        pairs = [(int(f), int(t)) for f, t in json.loads(cmd["items"])]
        err = self.osdmap.validate_upmap_items(key[0], key[1], pairs)
        if err is not None:
            return err[0], err[1], b""
        self.osdmap.pg_upmap_items[key] = pairs
        return 0, "ok", b""


def test_balancer_reduces_spread():
    from ceph_tpu_torch.mgr import balancer
    m = make_map(n_osds=5, pg_num=32, size=2)
    mgr = _FakeMgr(m)
    mod = balancer.Module(mgr)
    before = mod.eval()
    assert before["osds"] == 5
    plan = mod.optimize(max_optimizations=64)
    assert plan, f"no plan though spread={before['spread']}"
    code, msg = mod.execute(plan)
    assert code == 0, msg
    after = mod.eval()
    assert after["spread"] < before["spread"], (before, after)
    pid = m.pool_by_name["p"]
    for ps in range(32):
        up, _, _ = m.pg_to_up_acting(pid, ps)
        hosts = [balancer.Module._domain_of(m, o, "host") for o in up]
        assert len(set(hosts)) == len(hosts), (ps, up)


@pytest.mark.parametrize("n_osds,pg_num,size", [(5, 32, 2), (6, 32, 2),
                                                (8, 64, 3)])
def test_balancer_moves_equal_reference(n_osds, pg_num, size):
    """On equal OSDMaps, the port's balancer plans the reference's moves,
    move for move, round after round (three rounds, then a remap target
    killed and one more), with the same spread after each."""
    from ceph_tpu_torch.mgr import balancer
    port_map, ref_map = make_map_pair(n_osds=n_osds, pg_num=pg_num,
                                      size=size)
    port = balancer.Module(_FakeMgr(port_map))
    ref = ref_balancer.Module(_FakeMgr(ref_map))
    assert port.eval() == ref.eval()
    rounds = 0
    for _ in range(3):
        plan = port.optimize(max_optimizations=16)
        assert plan == ref.optimize(max_optimizations=16)
        if not plan:
            break
        rounds += 1
        assert port.execute(plan) == ref.execute(plan)
        assert port.eval() == ref.eval()
    assert rounds >= 1
    assert port_map.pg_upmap_items == ref_map.pg_upmap_items
    targets = sorted({t for items in port_map.pg_upmap_items.values()
                      for _, t in items})
    port_map.mark_down(targets[0])
    ref_map.mark_down(targets[0])
    plan = port.optimize(max_optimizations=16)
    assert plan == ref.optimize(max_optimizations=16)
    assert port.execute(plan) == ref.execute(plan)
    assert port.eval() == ref.eval()


def test_telemetry_report_shape():
    from ceph_tpu_torch.mgr import telemetry
    mod = telemetry.Module(_FakeMgr(make_map()))
    report = mod.compile_report()
    assert report["osd"]["count"] == 5
    assert report["pools"][0]["type"] == "replicated"
    assert len(report["cluster_id"]) == 16
    code, _, data = mod.handle_command({"prefix": "show"})
    assert code == 0 and json.loads(data)["report_version"] == 1
    code, msg, _ = mod.handle_command({"prefix": "send"})
    assert code != 0


def test_telemetry_report_equals_reference():
    """Equal maps give reports with the same keys and, but for the
    timestamp, the same values."""
    from ceph_tpu_torch.mgr import telemetry
    port_map, ref_map = make_map_pair()
    port = telemetry.Module(_FakeMgr(port_map)).compile_report()
    ref = ref_telemetry.Module(_FakeMgr(ref_map)).compile_report()
    assert sorted(port) == sorted(ref)
    port.pop("report_timestamp")
    ref.pop("report_timestamp")
    assert port == ref


def test_progress_tracks_degraded_episode():
    from ceph_tpu_torch.mgr import progress
    mgr = _FakeMgr(make_map())
    mod = progress.Module(mgr)
    mgr.get_status = lambda: {"pgmap": {"degraded_pgs": 4}}
    mod.tick()
    assert mod.events["recovery"]["baseline"] == 4
    mgr.get_status = lambda: {"pgmap": {"degraded_pgs": 1}}
    mod.tick()
    assert mod.events["recovery"]["progress"] == pytest.approx(0.75)
    mgr.get_status = lambda: {"pgmap": {"degraded_pgs": 0}}
    mod.tick()
    assert "recovery" not in mod.events
    assert mod.completed and mod.completed[-1]["progress"] == 1.0


def test_mgr_daemon_in_cluster():
    """The default module set boots on a port cluster; the balancer
    moves PGs through the mon's ``osd pg-upmap-items`` and data stays
    readable after backfill."""
    with MiniCluster(n_osds=4) as c:
        rados = c.client()
        c.create_pool("bal", pg_num=16, size=2)
        io = rados.open_ioctx("bal")
        blobs = {f"o{i}": os.urandom(16_000) for i in range(12)}
        for o, b in blobs.items():
            io.write_full(o, b)
        mgr = c.start_mgr()
        assert tuple(mgr.modules) == DEFAULT_MODULES
        out = asok_command(mgr.asok.path, "telemetry show")
        assert out["code"] == 0
        assert out["data"]["osd"]["count"] == 4
        out = asok_command(mgr.asok.path, "balancer eval")
        before = out["data"]["spread"]
        out = asok_command(mgr.asok.path, "balancer optimize", max="32")
        plan = out["data"]
        if plan:
            out = asok_command(mgr.asok.path, "balancer execute")
            assert out["code"] == 0, out
            epoch = c.epoch()
            rados.wait_for_epoch(epoch, timeout=10)
            c.wait_for_clean(timeout=30)
            out = asok_command(mgr.asok.path, "balancer eval")
            assert out["data"]["spread"] <= before
            dump = json.loads(c.mon_cmd(prefix="osd dump")[2])
            assert dump["pg_upmap_items"]
            out = asok_command(mgr.asok.path, "balancer optimize",
                               max="32")
            if out["data"]:
                out = asok_command(mgr.asok.path, "balancer execute")
                assert out["code"] == 0, out
                c.wait_for_clean(timeout=30)
        pid = c.mon.osdmap.pool_by_name["bal"]
        raw = c.mon.osdmap.pg_to_raw_up(pid, 0)
        spare = next(o for o in range(4) if o not in raw)
        code, msg, _ = c.mon_cmd(
            prefix="osd pg-upmap-items", pool=str(pid), ps="0",
            items=json.dumps([[raw[0], spare], [raw[1], spare]]))
        assert code != 0 and "duplicate" in msg, (code, msg)
        for o, b in blobs.items():
            assert io.read(o) == b


def test_balancer_second_round_and_down_target():
    from ceph_tpu_torch.mgr import balancer
    m = make_map(n_osds=6, pg_num=32, size=2)
    mgr = _FakeMgr(m)
    mod = balancer.Module(mgr)
    for _ in range(3):
        plan = mod.optimize(max_optimizations=16)
        if not plan:
            break
        code, msg = mod.execute(plan)
        assert code == 0, msg
    assert mod.eval()["spread"] <= 1
    targets = {t for items in m.pg_upmap_items.values()
               for _, t in items}
    if targets:
        dead = sorted(targets)[0]
        m.mark_down(dead)
        plan = mod.optimize(max_optimizations=16)
        code, msg = mod.execute(plan)
        assert code == 0, msg


def test_dashboard_module_serves_cluster_state():
    """The HTML overview and the JSON API (health, osds, pools, tuner,
    mesh, traces) of the default set's dashboard over HTTP."""
    import urllib.request
    with MiniCluster(n_osds=3) as c:
        c.create_pool("dash", pg_num=4, size=2)
        mgr = c.start_mgr()
        out = asok_command(mgr.asok.path, "dashboard on")
        assert out["code"] == 0
        st = asok_command(mgr.asok.path, "dashboard status")
        url = st["data"]["url"]
        assert st["data"]["serving"] and url

        def get(path):
            return json.loads(urllib.request.urlopen(
                url + path, timeout=10).read())
        health = get("api/health")
        assert health["status"].startswith("HEALTH")
        osds = get("api/osds")
        assert len(osds) == 3 and all(v["up"] for v in osds.values())
        pools = get("api/pools")
        assert pools["dash"]["type"] == "replicated"
        tuner = get("api/tuner")
        assert tuner["enabled"] is False and len(tuner["knobs"]) == 11
        mesh = get("api/mesh")
        assert mesh["mesh"] is None and mesh["placement"] is None
        traces = get("api/traces")
        assert {"stats", "kept", "autopsies"} <= set(traces)
        page = urllib.request.urlopen(url, timeout=10).read().decode()
        assert "ceph_tpu cluster" in page and "osd.0" in page
        assert asok_command(mgr.asok.path, "dashboard off")["code"] == 0
