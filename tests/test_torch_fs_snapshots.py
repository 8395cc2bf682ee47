"""The port's CephFS snapshots (SnapRealm-lite: ``mksnap``, ``rmsnap``,
``lssnap`` and the ``.snap`` paths of ``ceph_tpu_torch/services/cephfs.py``,
through the engine and through the MDS daemon) against the reference's, on
the CPU.

Counterparts of the 8 tests of ``tests/test_fs_snapshots.py``, and the
engine's snapshot steps on an EC k=2,m=1 pool, where a snapshot's
copy-on-write clone is read from the pool's in-flight writes (the port's
``torch`` backend commits a write after its engine flush). They run
through ``fs_on_both`` of ``test_torch_cephfs.py``: the engine tests with
counted ids and clocks, held to the reference's returns, errnos, readdir
orders, stat fields and stored objects (data, attrs, omap; the EC pool's
shards by position); the daemon tests with real clocks, their outputs
held and their stores by object bytes, or by names where a live writer
races the snapshot. The MDS failover mid-``mksnap`` is marked slow, as
the reference's is (its two-package run takes ~25 s). Tolerance 0.
"""

import errno
import threading
import time

import pytest

from test_torch_cephfs import _trim_all, fs, fs_err, fs_on_both, pkg_mod
from test_torch_cluster import _stores
from test_torch_mds import VOLATILE, _daemon, _mount
from test_torch_striper import cluster_pair  # noqa: F401  (fixture)

POOL = {"snap": {"pg_num": 4, "size": 2}}
EC_POOL = {"snapec": {"k": 2, "m": 1, "pg_num": 4}}


def _engine(pkg, io):
    return fs(pkg).CephFS(io, caps=False)


# -- engine level -------------------------------------------------------

def _preserves_content(pkg, cluster, rados, io):
    f = _engine(pkg, io)
    f.mkdir("/d")
    h = f.create("/d/a")
    h.write(b"version-1")
    sid = f.mksnap("/d", "s1")
    out = {"sid": sid, "ls": f.lssnap("/d")}
    f.open("/d/a").write(b"version-2!")
    out["head"] = f.open("/d/a").read()
    snap = f.open("/d/.snap/s1/a")
    out["snap"] = snap.read()
    out["stat"] = f.stat("/d/.snap/s1/a")
    out["rofs"] = fs_err(pkg, lambda: snap.write(b"nope"))
    assert out["snap"] == b"version-1" and out["rofs"] == errno.EROFS
    return out


def test_snapshot_preserves_file_content(cluster_pair):
    fs_on_both(cluster_pair, POOL, _preserves_content)


def test_snapshot_freezes_namespace(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        f = _engine(pkg, io)
        f.mkdir("/ns")
        f.create("/ns/old").write(b"x")
        f.mksnap("/ns", "before")
        f.create("/ns/new").write(b"y")
        f.unlink("/ns/old")
        out = {"head": f.readdir("/ns"),
               "snap": f.readdir("/ns/.snap/before"),
               "old": f.open("/ns/.snap/before/old").read(),
               "new": fs_err(pkg, lambda: f.open("/ns/.snap/before/new")),
               "snaps": f.readdir("/ns/.snap")}
        assert out["head"] == ["new"] and out["snap"] == ["old"]
        return out

    fs_on_both(cluster_pair, POOL, scenario)


def test_snapshot_nested_dirs(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        f = _engine(pkg, io)
        f.mkdir("/deep")
        f.mkdir("/deep/sub")
        f.create("/deep/sub/f").write(b"nested-v1")
        f.mksnap("/deep", "d1")
        f.open("/deep/sub/f").write(b"nested-v2")
        f.create("/deep/sub/g").write(b"post")
        out = [f.open("/deep/.snap/d1/sub/f").read(),
               f.readdir("/deep/.snap/d1/sub"), f.readdir("/deep/sub")]
        assert out[:2] == [b"nested-v1", ["f"]]
        return out

    fs_on_both(cluster_pair, POOL, scenario)


def _two_layers(pkg, cluster, rados, io):
    f = _engine(pkg, io)
    f.mkdir("/layers")
    f.create("/layers/f").write(b"AAAA")
    f.mksnap("/layers", "t1")
    f.open("/layers/f").write(b"BBBB")
    f.mksnap("/layers", "t2")
    f.open("/layers/f").write(b"CCCC")
    out = [f.open(p).read() for p in ("/layers/.snap/t1/f",
                                      "/layers/.snap/t2/f", "/layers/f")]
    assert out == [b"AAAA", b"BBBB", b"CCCC"]
    return out


def test_two_snapshots_layer(cluster_pair):
    fs_on_both(cluster_pair, POOL, _two_layers)


def test_rmsnap_retires_snapid(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        f = _engine(pkg, io)
        f.mkdir("/gone")
        f.create("/gone/f").write(b"keepme")
        sid = f.mksnap("/gone", "tmp")
        f.open("/gone/f").write(b"newer!")
        out = {"snap": f.open("/gone/.snap/tmp/f").read()}
        f.rmsnap("/gone", "tmp")
        out["gone"] = fs_err(pkg, lambda: f.open("/gone/.snap/tmp/f"))
        out["ls"] = f.lssnap("/gone")
        deadline = time.time() + 10
        while time.time() < deadline:
            pool = rados.monc.osdmap.pools[io.pool_id]
            if sid in pool.removed_snaps:
                break
            time.sleep(0.2)
        out["removed"] = sid in pool.removed_snaps
        # the OSDs' trimmers start on the new map, racing the journal's
        # commit: trim here to the end, and hold the bytes, not the log
        _trim_all(cluster)
        out["objects"] = sorted(io.list_objects())
        assert out["removed"] and out["ls"] == {}
        return out

    fs_on_both(cluster_pair, POOL, scenario, compare="data")


def test_snapshot_of_deleted_file_survives(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        f = _engine(pkg, io)
        f.mkdir("/keep")
        f.create("/keep/f").write(b"precious")
        f.mksnap("/keep", "hold")
        f.unlink("/keep/f")
        out = [fs_err(pkg, lambda: f.open("/keep/f")),
               f.open("/keep/.snap/hold/f").read()]
        assert out[1] == b"precious"
        return out

    fs_on_both(cluster_pair, POOL, scenario)


def test_engine_snapshots_on_ec_pool_shard_for_shard(cluster_pair):
    """The content, layering and trim steps above on an EC k=2,m=1 pool
    (the reference's host backend, the port's ``torch``), one thread,
    held shard for shard, the trimmed clones gone in both."""
    def scenario(pkg, cluster, rados, io):
        out = [_preserves_content(pkg, cluster, rados, io),
               _two_layers(pkg, cluster, rados, io)]
        f = _engine(pkg, io)
        f.rmsnap("/layers", "t1")
        _trim_all(cluster)
        out.append([f.lssnap("/layers"), f.open("/layers/.snap/t2/f").read(),
                    sorted({key[-1] for key in _stores(cluster)
                            if key[0] == io.pool_id and "\x1e" in key[-1]})])
        return out

    fs_on_both(cluster_pair, EC_POOL, scenario)


# -- MDS daemon + mounts ------------------------------------------------

def test_mds_snapshot_under_concurrent_writes(cluster_pair):
    """A live writer races the snapshot: each package's snapshot holds
    one whole version and the head the writer's last, and the count of
    writes follows the race, so the store is held by names and only what
    the snapshot and head must be is compared."""
    def scenario(pkg, cluster, rados, io):
        mds = _daemon(pkg, cluster, io, "sa")
        try:
            with _mount(pkg, rados, io) as m1, _mount(pkg, rados, io) as m2:
                m1.mkdir("/live")
                f = m1.open("/live/data", create=True)
                f.write(b"epoch-0")
                f.release()
                stop = threading.Event()
                wrote = []

                def writer():
                    n = 0
                    while not stop.is_set():
                        h = m1.open("/live/data")
                        h.write(f"epoch-{n}".encode())
                        h.release()
                        wrote.append(n)
                        n += 1

                t = threading.Thread(target=writer, daemon=True)
                t.start()
                time.sleep(0.3)
                m2.mksnap("/live", "mid")
                time.sleep(0.3)
                stop.set()
                t.join(timeout=10)
                got = m2.open("/live/.snap/mid/data").read()
                n = int(got.decode().split("-")[1])
                head = m2.open("/live/data").read()
                out = {"wrote": bool(wrote),
                       "snap_is_a_version": 0 <= n <= wrote[-1],
                       "ls": sorted(m2.lssnap("/live")),
                       "head_is_last": head == f"epoch-{wrote[-1]}".encode()}
        finally:
            mds.stop()
        assert all(v for k, v in out.items() if k != "ls")
        return out

    fs_on_both(cluster_pair, POOL, scenario, compare="names", clocks=False)


@pytest.mark.slow
def test_mds_failover_mid_snap(cluster_pair):
    """The active MDS is wedged at the inode write of a journaled mksnap
    and killed; the standby's replay (or the retried request) completes
    the snapshot, which then serves the pre-snapshot bytes."""
    def scenario(pkg, cluster, rados, io):
        a = _daemon(pkg, cluster, io, "fa2", ttl=1.0)
        m = _mount(pkg, rados, io, op_timeout=30.0)
        try:
            m.mkdir("/fo")
            f = m.open("/fo/file", create=True)
            f.write(b"pre-snap")
            f.release()
            wedged = threading.Event()
            orig = a.fs._write_inode

            def stuck_write(ino, inode, snapc=None):
                if inode.get("snaps"):
                    wedged.set()
                    threading.Event().wait()
                return orig(ino, inode, snapc=snapc)

            a.fs._write_inode = stuck_write
            result = []
            t = threading.Thread(
                target=lambda: result.append(m.mksnap("/fo", "cut")),
                daemon=True)
            t.start()
            assert wedged.wait(timeout=10)
            a.kill()
            b = _daemon(pkg, cluster, io, "fb2", ttl=1.0, timeout=30.0)
            try:
                t.join(timeout=30)
                out = {"result": result, "ls": m.lssnap("/fo")}
                h = m.open("/fo/file")
                h.write(b"post-snap")
                h.release()
                out["snap"] = m.open("/fo/.snap/cut/file").read()
                out["head"] = m.open("/fo/file").read()
            finally:
                b.stop()
        finally:
            m.umount()
            a.kill()
        assert out["result"] and out["snap"] == b"pre-snap"
        return out

    fs_on_both(cluster_pair, POOL, scenario, compare="data", clocks=False,
               volatile=VOLATILE)


def test_pool_snap_context_of_a_realm(cluster_pair):
    """The realm's SnapContext rides the MDS open reply to the client's
    direct data writes: the handle's ``snaps`` newest first, as the
    engine's ``_realm_snapc`` gives them."""
    def scenario(pkg, cluster, rados, io):
        mds = _daemon(pkg, cluster, io, "rc")
        try:
            with _mount(pkg, rados, io) as m:
                m.mkdir("/r")
                m.mkdir("/r/s")
                m.open("/r/s/f", create=True).write(b"x")
                s1 = m.mksnap("/r", "one")
                s2 = m.mksnap("/r/s", "two")
                h = m.open("/r/s/f")
                out = {"snaps": h.snaps, "want": [s2, s1],
                       "snapc": pkg_mod(pkg, "services.cephfs").CephFS
                       ._realm_snapc([s1, s2])}
                h.release()
        finally:
            mds.stop()
        assert out["snaps"] == out["want"]
        return out

    fs_on_both(cluster_pair, POOL, scenario, compare="data", clocks=False,
               volatile=VOLATILE)
