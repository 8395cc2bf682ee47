"""MiniCluster — the vstart.sh / ceph-helpers.sh role, in-process.

Boots one mon + N OSDs (each a real daemon with its own messenger and
store) in one Python process, the way qa/standalone tests boot many
ceph-osd processes on one host. Helpers mirror ceph-helpers.sh:
``create_ec_pool``, ``kill_osd``/``revive_osd``, ``wait_for_clean``.

The port boots both OSD flavours (threaded and crimson) and cephx; the
mgr boots with the modules the port has (``mgr/mgr.py``
``PORTED_MODULES``) and raises for the others (ROADMAP A.6).
"""

from __future__ import annotations

import time

from ceph_tpu_torch.client.rados import RadosClient
from ceph_tpu_torch.osd.osd import OSD
from ceph_tpu_torch.parallel.mon import Monitor
from ceph_tpu_torch.store.object_store import create_store
from ceph_tpu_torch.utils.dout import Dout

log = Dout("qa")

#: backend names ``CEPH_TPU_EC_BACKEND`` may force onto a pool: the port's
#: device backends and its host ones
FORCED_BACKENDS = ("cuda", "torch", "auto_device", "numpy", "auto")


class MiniCluster:
    def __init__(self, n_osds: int = 3, store: str = "memstore",
                 data_dir: str | None = None, auth: bool = False,
                 n_mons: int = 1,
                 osd_flavor: str = "threaded") -> None:
        assert osd_flavor in ("threaded", "crimson"), osd_flavor
        self.n_osds = n_osds
        self.n_mons = n_mons
        self.store_kind = store
        self.data_dir = data_dir
        #: "threaded" boots the mainline OSD; "crimson" boots the
        #: shard-per-core run-to-completion OSD (same wire protocol —
        #: every helper/client below works unchanged)
        self.osd_flavor = osd_flavor
        self.mons: dict[int, Monitor] = {}
        self._mon_dbs: dict[int, object] = {}
        self.mon_addr = ""
        self.osds: dict[int, OSD] = {}
        self._stores: dict[int, object] = {}
        self._clients: list[RadosClient] = []
        self.keyring = None
        if auth:
            from ceph_tpu_torch.parallel import auth as A
            self.keyring = A.Keyring()
            self.keyring.generate(A.SERVICE_ENTITY)
            self.keyring.generate("client.admin")

    MON_NAMES = "abcdefgh"

    @property
    def mon(self) -> Monitor | None:
        """A live mon to inspect — the current leader when one exists."""
        if not self.mons:
            return None
        for m in self.mons.values():
            if m.is_leader():
                return m
        return self.mons[min(self.mons)]

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "MiniCluster":
        for rank in range(self.n_mons):
            self.mons[rank] = Monitor(self.MON_NAMES[rank],
                                      keyring=self.keyring)
            self._mon_dbs[rank] = self.mons[rank].db
        monmap = {rank: m.prebind() for rank, m in self.mons.items()}
        for rank, m in self.mons.items():
            m.set_monmap(monmap, rank)
            m.start()
        self.mon_addr = ",".join(monmap[r] for r in sorted(monmap))
        for i in range(self.n_osds):
            self.start_osd(i)
        self.wait_for_osds_up(timeout=15)
        return self

    def _make_store(self, osd_id: int):
        if self.store_kind == "memstore":
            return create_store("memstore")
        path = f"{self.data_dir}/osd.{osd_id}"
        return create_store(self.store_kind, path)

    def start_osd(self, osd_id: int) -> OSD:
        if self.osd_flavor == "crimson":
            # crimson manages its own per-reactor shard stores (the
            # shared-nothing discipline: one store per reactor); a
            # revive hands the killed OSD's shard stores back so its
            # data survives, mirroring the threaded store cache
            from ceph_tpu_torch.crimson import CrimsonOSD
            cached = self._stores.get(osd_id)
            osd = CrimsonOSD(osd_id, self.mon_addr,
                             store_kind=self.store_kind,
                             data_dir=self.data_dir,
                             shard_stores=cached if
                             isinstance(cached, list) else None)
            osd.start()
            self._stores[osd_id] = [r.store for r in osd.reactors]
            self.osds[osd_id] = osd
            return osd
        store = self._stores.get(osd_id) or self._make_store(osd_id)
        self._stores[osd_id] = store
        osd = OSD(osd_id, store, self.mon_addr, keyring=self.keyring)
        osd.start()
        self.osds[osd_id] = osd
        return osd

    def start_mgr(self, name: str = "x", modules=None):
        """Boot a Mgr daemon against this cluster's mons (run_mgr role
        of qa/standalone/ceph-helpers.sh). Raises NotImplementedError
        naming the modules asked for that the port does not have (the
        default set among them)."""
        from ceph_tpu_torch.mgr import Mgr
        auth = None
        if self.keyring is not None:
            auth = ("client.admin", self.keyring.get("client.admin"))
        kw = {"auth": auth}
        if modules is not None:
            kw["modules"] = tuple(modules)
        self.mgr = Mgr(self.mon_addr, name=name, **kw).start()
        return self.mgr

    def stop(self) -> None:
        if getattr(self, "mgr", None) is not None:
            self.mgr.stop()
            self.mgr = None
        for client in self._clients:
            client.shutdown()
        self._clients.clear()
        for osd in list(self.osds.values()):
            osd.stop()
        self.osds.clear()
        for m in self.mons.values():
            m.stop()
        self.mons.clear()

    def __enter__(self) -> "MiniCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- clients ------------------------------------------------------
    def client(self) -> RadosClient:
        auth = None
        if self.keyring is not None:
            auth = ("client.admin", self.keyring.get("client.admin"))
        c = RadosClient(self.mon_addr, auth=auth).connect()
        self._clients.append(c)
        return c

    # -- helpers (ceph-helpers.sh roles) ------------------------------
    def mon_cmd(self, **cmd) -> tuple[int, str, bytes]:
        client = self._clients[0] if self._clients else self.client()
        return client.mon_command(cmd)

    def create_pool(self, name: str, pg_num: int = 8,
                    size: int = 3) -> None:
        code, outs, _ = self.mon_cmd(prefix="osd pool create", pool=name,
                                     pg_num=pg_num, size=size)
        assert code == 0, outs

    def create_ec_pool(self, name: str, k: int = 2, m: int = 1,
                       plugin: str = "jerasure", pg_num: int = 8,
                       **profile_extra) -> None:
        import json
        import os
        profile = {"plugin": plugin, "k": str(k), "m": str(m),
                   **{a: str(b) for a, b in profile_extra.items()}}
        # CEPH_TPU_EC_BACKEND=cuda|torch|auto_device runs the whole qa
        # suite with the device stripe-batch path engaged (cuda: the
        # real-card gate); the reference's jax/pallas names are refused
        forced = os.environ.get("CEPH_TPU_EC_BACKEND")
        if forced and "backend" not in profile:
            if forced not in FORCED_BACKENDS:
                raise ValueError(
                    f"CEPH_TPU_EC_BACKEND={forced!r}: the port's backends "
                    f"are {', '.join(FORCED_BACKENDS)}")
            profile["backend"] = forced
        code, outs, _ = self.mon_cmd(
            prefix="osd erasure-code-profile set", name=f"{name}_profile",
            profile=json.dumps(profile))
        assert code == 0, outs
        code, outs, _ = self.mon_cmd(
            prefix="osd pool create", pool=name, pg_num=pg_num,
            erasure_code_profile=f"{name}_profile")
        assert code == 0, outs

    @property
    def faults(self):
        """The process-wide seeded fault registry (utils/faults) —
        the ONE injection API: scoped messenger drop/delay windows,
        store EIO/latency, device-engine launch failures, and the
        kill/revive schedule the load generator executes. Cluster
        fault actions below record themselves into its event log so
        a run's whole fault sequence reads back from one place."""
        from ceph_tpu_torch.utils import faults as F
        return F.registry()

    def kill_osd(self, osd_id: int) -> None:
        """Hard-stop an OSD (Thrasher.kill_osd role): the daemon dies,
        its store survives for revive."""
        osd = self.osds.pop(osd_id)
        osd.stop()
        self.faults.note_action("kill_osd", f"osd.{osd_id}")
        log(1, f"killed osd.{osd_id}")

    def revive_osd(self, osd_id: int) -> OSD:
        assert osd_id not in self.osds
        osd = self.start_osd(osd_id)
        self.faults.note_action("revive_osd", f"osd.{osd_id}")
        log(1, f"revived osd.{osd_id}")
        return osd

    def partition_mons(self, *groups: list[int]) -> None:
        """Symmetric mon-level network partition (the qa suites'
        partition-thrashing role): mons in different groups silently
        drop each other's frames (messenger blocked_peers injection).
        OSD/client traffic is unaffected."""
        ranks = {r for g in groups for r in g}
        for g in groups:
            for r in g:
                self.mons[r].msgr.blocked_peers = {
                    self.mons[o].addr for o in ranks if o not in g}

    def heal_mons(self) -> None:
        for m in self.mons.values():
            m.msgr.blocked_peers = set()

    def kill_mon(self, rank: int) -> None:
        """Hard-stop a monitor; its commit log survives for revive."""
        m = self.mons.pop(rank)
        m.stop()
        log(1, f"killed mon rank {rank}")

    def revive_mon(self, rank: int) -> Monitor:
        assert rank not in self.mons
        m = Monitor(self.MON_NAMES[rank], db=self._mon_dbs[rank],
                    keyring=self.keyring)
        addr = m.prebind()
        monmap = {r: mm.addr for r, mm in self.mons.items()}
        monmap[rank] = addr
        m.set_monmap(monmap, rank)
        m.start()
        self.mons[rank] = m
        log(1, f"revived mon rank {rank} at {addr}")
        return m

    def scrub_pool(self, pool_name: str, repair: bool = True,
                   deep: bool = False) -> dict:
        """Scrub every PG of a pool on its primary (the 'ceph pg
        scrub' / 'ceph pg deep-scrub' roles); returns aggregated
        results. ``deep`` routes through the device deep-scrub engine
        (fused crc + parity verify, batched sparse repair)."""
        osdmap = self.mon.osdmap
        pool_id = osdmap.pool_by_name[pool_name]
        agg = {"objects": 0, "inconsistent": {}, "repaired": []}
        if deep:
            agg["batches"] = 0
            agg["bytes_verified"] = 0
        for ps in osdmap.pgs_of_pool(pool_id):
            _, _, primary = osdmap.pg_to_up_acting(pool_id, ps)
            osd = self.osds.get(primary)
            if osd is None:
                agg.setdefault("skipped", []).append(f"{pool_id}.{ps}")
                continue
            # the primary instantiates + peers the PG on demand, so a
            # PG that served no op since failover still gets scrubbed
            res = osd.scrub_pg((pool_id, ps), repair=repair,
                               deep=deep, timeout=120.0)
            if "error" in res:
                agg.setdefault("skipped", []).append(
                    f"{pool_id}.{ps}: {res['error']}")
                continue
            agg["objects"] += res["objects"]
            agg["inconsistent"].update(res["inconsistent"])
            agg["repaired"].extend(res["repaired"])
            if deep and res.get("deep"):
                agg["deep"] = True
                agg["batches"] += res.get("batches", 0)
                agg["bytes_verified"] += res.get("bytes_verified", 0)
        return agg

    # -- waiting ------------------------------------------------------
    def wait_for_osds_up(self, n: int | None = None,
                         timeout: float = 15.0) -> None:
        want = self.n_osds if n is None else n
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            up = sum(1 for o in self.mon.osdmap.osds.values() if o.up)
            if up >= want:
                return
            time.sleep(0.05)
        raise TimeoutError(f"only {up}/{want} osds up after {timeout}s")

    def wait_for_osd_down(self, osd_id: int, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            info = self.mon.osdmap.osds.get(osd_id)
            if info is not None and not info.up:
                return
            time.sleep(0.05)
        raise TimeoutError(f"osd.{osd_id} still up after {timeout}s")

    def wait_for_clean(self, timeout: float = 30.0) -> None:
        """All PGs of all pools recovered: every primary has empty
        peer_missing (wait_for_clean role)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self._dirty_pgs():
                return
            time.sleep(0.1)
        raise TimeoutError(f"cluster not clean: {self._dirty_pgs()}")

    def _dirty_pgs(self) -> list[str]:
        dirty = []
        osdmap = self.mon.osdmap
        # every mapped PG must already EXIST on its current primary —
        # a remap (e.g. a balancer upmap) can land while the new primary
        # has not yet instantiated the PG, and scanning only existing PG
        # objects would miss that window entirely
        from ceph_tpu_torch.parallel import crush as _crush
        for pid, pool in osdmap.pools.items():
            for ps in range(pool.pg_num):
                _, _, primary = osdmap.pg_to_up_acting(pid, ps)
                if primary == _crush.NONE:
                    continue
                posd = next((o for o in self.osds.values()
                             if o.whoami == primary), None)
                if posd is not None and (pid, ps) not in posd.pgs:
                    dirty.append(
                        f"pg{pid}.{ps} absent on primary osd.{primary}")
        for osd in self.osds.values():
            for pg in list(osd.pgs.values()):
                if pg.state != pg.ACTIVE:
                    dirty.append(f"osd.{osd.whoami}:{pg!r}")
                    continue
                # an ACTIVE pg whose acting set predates the current
                # map is about to re-peer: not clean yet (otherwise
                # wait_for_clean races the map-change enqueue)
                _, acting, _ = osdmap.pg_to_up_acting(pg.pool, pg.ps)
                if list(acting) != list(pg.acting):
                    dirty.append(
                        f"osd.{osd.whoami}:{pg!r} stale acting "
                        f"(map has {acting})")
                elif pg.missing_dirty():
                    with pg.lock:
                        counts = {p: len(m) for p, m in
                                  pg.peer_missing.items() if m}
                    if counts:
                        dirty.append(
                            f"osd.{osd.whoami}:pg{pg.pool}.{pg.ps} "
                            f"missing={counts}")
        return dirty

    def epoch(self) -> int:
        return self.mon.osdmap.epoch
