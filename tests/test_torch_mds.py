"""The port's MDS daemon and client mount (``ceph_tpu_torch/services/mds.py``,
``mds_client.py``) against the reference's, on the CPU.

Counterparts of the 9 tests of ``tests/test_mds.py`` and of
``tests/test_blocklist.py::test_mds_takeover_blocklists_predecessor``.
Each runs the reference test's steps on a reference and a port
``MiniCluster`` (up together for the module, a fresh pool and fresh
daemons a test) through ``fs_on_both`` of ``test_torch_cephfs.py`` and
holds the port to the reference's returns, errnos, readdir orders, stat
fields, cap holders and stored objects. The daemons' leases and the
client's waits are real, so the clocks are: stamps go through
``normalize``, and the objects a daemon rewrites on its own timer (the
``mdsmap.lock`` lease, the ``mdsmap`` with the daemon's address) are held
by name, the rest by their bytes. The failover mid-rename is marked
slow, as the reference's is (its two-package run takes ~25 s).
Tolerance 0.
"""

import errno
import json
import os
import threading
import time

import pytest

from test_torch_cephfs import fs_err, fs_on_both, pkg_mod
from test_torch_striper import cluster_pair  # noqa: F401  (fixture)

POOL = {"mds": {"pg_num": 4, "size": 2}}
#: rewritten by the daemon's tick (lease) or naming its address
VOLATILE = ("mdsmap",)


def _mds(pkg):
    return pkg_mod(pkg, "services.mds")


def _mount(pkg, rados, io, **kw):
    return pkg_mod(pkg, "services.mds_client").CephFSMount(
        rados.open_ioctx(io.pool_name), **kw)


def _daemon(pkg, cluster, io, name, ttl=1.5, **kw):
    return _mds(pkg).MDSDaemon(name, cluster.mon_addr, io.pool_name,
                               active_ttl=ttl).start(wait_active=True, **kw)


def _on_both(pair, scenario, compare="data"):
    """``scenario(pkg, cluster, rados, io, mds)`` with an active MDS on
    the test's pool, stopped after."""
    def run(pkg, cluster, rados, io):
        mds = _daemon(pkg, cluster, io, "a")
        try:
            return scenario(pkg, cluster, rados, io, mds)
        finally:
            mds.stop()

    return fs_on_both(pair, POOL, run, compare=compare, clocks=False,
                      volatile=VOLATILE)


def test_namespace_over_the_wire(cluster_pair):
    def scenario(pkg, cluster, rados, io, mds):
        out = {}
        with _mount(pkg, rados, io) as m:
            m.mkdir("/a")
            m.mkdir("/a/b")
            out["root"] = m.readdir("/")
            out["a"] = m.readdir("/a")
            out["stat"] = m.stat("/a")
            out["exists"] = fs_err(pkg, lambda: m.mkdir("/a"))
            out["nope"] = fs_err(pkg, lambda: m.readdir("/nope"))
            f = m.create("/a/f.txt")
            f.write(b"hello mds")
            out["size"] = m.stat("/a/f.txt")["size"]
            out["read"] = m.open("/a/f.txt").read()
            m.rename("/a/f.txt", "/a/b/g.txt")
            out["a2"] = m.readdir("/a")
            out["moved"] = m.open("/a/b/g.txt").read()
            m.unlink("/a/b/g.txt")
            out["gone"] = fs_err(pkg, lambda: m.open("/a/b/g.txt"))
            m.rmdir("/a/b")
            out["a3"] = m.readdir("/a")
        assert out["exists"] == errno.EEXIST and out["nope"] == errno.ENOENT
        assert out["moved"] == b"hello mds" and out["a3"] == []
        return out

    _on_both(cluster_pair, scenario)


def test_second_mount_sees_first(cluster_pair):
    def scenario(pkg, cluster, rados, io, mds):
        with _mount(pkg, rados, io) as m1, _mount(pkg, rados, io) as m2:
            m1.mkdir("/shared")
            f = m1.open("/shared/x", create=True)
            f.write(b"from-m1")
            f.release()
            out = [m2.readdir("/shared"), m2.open("/shared/x").read()]
        assert out == [["x"], b"from-m1"]
        return out

    _on_both(cluster_pair, scenario)


def test_server_driven_cap_revoke(cluster_pair):
    """m2's read makes the MDS push a revoke to m1, which releases: a
    round trip, not the lease's 2 s."""
    def scenario(pkg, cluster, rados, io, mds):
        with _mount(pkg, rados, io) as m1, _mount(pkg, rados, io) as m2:
            f1 = m1.open("/capfile", create=True)
            f1.write(b"v1")
            ino = f1.ino
            out = {"before": mds.cap_holders(ino),
                   "ids": [m1.client_id, m2.client_id]}
            t0 = time.monotonic()
            out["read"] = m2.open("/capfile").read()
            elapsed = time.monotonic() - t0
            bar = 1.5 if (os.cpu_count() or 1) >= 4 else 1.9
            assert elapsed < bar, f"revoke took {elapsed:.2f}s"
            out["after"] = mds.cap_holders(ino)
        assert out["before"] == {m1.client_id: "exclusive"}
        assert out["after"] == {m2.client_id: "shared"}
        return out

    _on_both(cluster_pair, scenario)


def test_exclusive_blocks_until_release(cluster_pair):
    def scenario(pkg, cluster, rados, io, mds):
        with _mount(pkg, rados, io) as m1, _mount(pkg, rados, io) as m2:
            f1 = m1.open("/excl", create=True)
            f1.write(b"a" * 8)
            got = []

            def writer():
                f2 = m2.open("/excl")
                f2.write(b"b" * 4, offset=8)
                got.append(f2.read())
            t = threading.Thread(target=writer)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        assert got == [b"a" * 8 + b"b" * 4]
        return got

    _on_both(cluster_pair, scenario)


def test_stale_handle_sees_growth(cluster_pair):
    def scenario(pkg, cluster, rados, io, mds):
        with _mount(pkg, rados, io) as m1, _mount(pkg, rados, io) as m2:
            f1 = m1.open("/grow", create=True)
            f1.write(b"A" * 64)
            f2 = m2.open("/grow")
            out = [f2.read()]
            f1.write(b"B" * 32, offset=64)
            out += [f2.read(), f2.size()]
        assert out == [b"A" * 64, b"A" * 64 + b"B" * 32, 96]
        return out

    _on_both(cluster_pair, scenario)


def test_setattr_requires_exclusive_cap(cluster_pair):
    def scenario(pkg, cluster, rados, io, mds):
        with _mount(pkg, rados, io) as m:
            f = m.open("/gate", create=True)
            f.write(b"x")
            ino = f.ino
            f.release()
            code = fs_err(pkg, lambda: m._rpc("setattr",
                                              {"ino": ino, "size": 999}))
        assert code == errno.EPERM
        return code

    _on_both(cluster_pair, scenario)


def test_dead_client_lease_expiry(cluster_pair):
    def scenario(pkg, cluster, rados, io, mds):
        m1 = _mount(pkg, rados, io)
        with _mount(pkg, rados, io) as m2:
            f1 = m1.open("/deadcap", create=True)
            f1.write(b"before crash")
            m1._revoker.shutdown(wait=False)
            m1.msgr.shutdown()
            t0 = time.monotonic()
            f2 = m2.open("/deadcap")
            f2.write(b"after", offset=0)
            assert time.monotonic() - t0 < 8.0
            got = f2.read(5)
        assert got == b"after"
        return got

    _on_both(cluster_pair, scenario)


@pytest.mark.slow
def test_failover_replays_half_done_rename(cluster_pair):
    """The active MDS is wedged between rename's link and unlink and
    killed with its lease held; the standby replays the intent, and the
    client's retried request gets the completed reply."""
    def scenario(pkg, cluster, rados, io):
        a = _daemon(pkg, cluster, io, "fa")
        m = _mount(pkg, rados, io, op_timeout=30.0)
        try:
            m.mkdir("/d1")
            m.mkdir("/d2")
            f = m.create("/d1/victim")
            f.write(b"payload")
            f.release()
            wedged = threading.Event()

            def stuck_unlink(dir_ino, name, snapc=None):
                wedged.set()
                threading.Event().wait()

            a.fs._dir_unlink = stuck_unlink
            result = []

            def do_rename():
                m.rename("/d1/victim", "/d2/victim")
                result.append("ok")

            t = threading.Thread(target=do_rename, daemon=True)
            t.start()
            assert wedged.wait(timeout=10)
            a.kill()
            b = _daemon(pkg, cluster, io, "fb", timeout=30.0)
            try:
                t.join(timeout=30)
                out = {"result": result, "d1": m.readdir("/d1"),
                       "d2": m.readdir("/d2"),
                       "read": m.open("/d2/victim").read()}
                m.mkdir("/after-failover")
                out["root"] = m.readdir("/")
            finally:
                b.stop()
        finally:
            m.umount()
            a.kill()
        assert out["result"] == ["ok"] and out["d1"] == []
        return out

    fs_on_both(cluster_pair, POOL, scenario, compare="data", clocks=False,
               volatile=VOLATILE)


def test_deposed_mds_fences_itself(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        a = _daemon(pkg, cluster, io, "za", ttl=1.0)
        try:
            io.execute("mdsmap.lock", "lock", "break_lock",
                       json.dumps({"name": "mds_active",
                                   "cookie": "za"}).encode())
            io.execute("mdsmap.lock", "lock", "lock",
                       json.dumps({"name": "mds_active", "cookie": "thief",
                                   "type": "exclusive",
                                   "duration": 30}).encode())
            deadline = time.monotonic() + 10
            while not a._deposed:
                assert time.monotonic() < deadline, "never deposed"
                time.sleep(0.1)
            out = {"deposed": a._deposed, "active": a.is_active()}
        finally:
            a.kill()
            io.execute("mdsmap.lock", "lock", "unlock",
                       json.dumps({"name": "mds_active",
                                   "cookie": "thief"}).encode())
        assert out == {"deposed": True, "active": False}
        return out

    fs_on_both(cluster_pair, POOL, scenario, compare="data", clocks=False,
               volatile=VOLATILE)


def test_mds_takeover_blocklists_predecessor(cluster_pair):
    """The standby taking over blocklists the dead active's rados
    instance before serving; an op from that instance cannot land."""
    def scenario(pkg, cluster, rados, io):
        rados_mod = pkg_mod(pkg, "client.rados")
        a = _daemon(pkg, cluster, io, "ba", ttl=1.0)
        a_inst = a._rados.instance
        a.kill()
        b = _daemon(pkg, cluster, io, "bb", ttl=1.0, timeout=30.0)
        try:
            code, _outs, data = rados.mon_command(
                {"prefix": "osd blocklist ls"})
            out = {"code": code, "fenced": a_inst in json.loads(data)}
            imp = rados_mod.RadosClient(cluster.mon_addr,
                                        instance=a_inst).connect()
            out["late"] = fs_err(pkg, lambda: imp.open_ioctx(
                io.pool_name).write_full("late", b"stale"))
            imp.shutdown()
            with pkg_mod(pkg, "services.mds_client").CephFSMount(
                    rados.open_ioctx(io.pool_name)) as m:
                m.mkdir("/post-takeover")
                out["root"] = m.readdir("/")
        finally:
            b.stop()
        assert out["fenced"] and out["root"] == ["post-takeover"]
        assert out["late"] == pkg_mod(pkg, "osd.osd").EBLOCKLISTED
        return out

    fs_on_both(cluster_pair, POOL, scenario, compare="data", clocks=False,
               volatile=VOLATILE)
