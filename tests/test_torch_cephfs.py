"""The port's CephFS engine (``ceph_tpu_torch/services/cephfs.py``) against
the reference's (``ceph_tpu/services/cephfs.py``), on the CPU.

Counterparts of the 13 tests of ``tests/test_cephfs.py``, one test on an EC
k=2,m=1 pool, and the state carried across: a filesystem pool the
reference wrote, copied object by object into a port pool, mounted by the
port. Each counterpart runs the reference test's steps, with seeded
payloads, on a reference and a port ``MiniCluster`` (up together for the
module, a fresh pool a test) and holds the port to the reference's
returns, errnos, readdir orders, stat fields and stored objects (every
OSD's data, attrs and omap of the test's pools). Tolerance 0.

:func:`fs_deterministic` makes the two runs comparable: the mount and
client ids (``uuid.uuid4``, read inside the reference's functions, so
patched on the ``uuid`` module) count, per package, so a module's runs in
both packages name the same ids; the striper's tags and the object
classes' clock count (``deterministic`` of ``test_torch_striper.py``);
and the engine's ``time.time()`` (inode ``mtime``s, cap leases) steps 1 ms
a call, so a cap is renewed at the same call in both packages whatever
the host's load. Tests whose waits are real (two mounts contending for a
cap, leases lapsing) keep the real clocks, and their stores are held by
names, their stamps through ``normalize`` of ``test_torch_rgw.py``.
Where threads race, stores are held by object names.

The helpers here (``fs_on_both``, ``fs_deterministic``, ``fs_err``,
``copy_pool``) serve ``test_torch_mds.py`` and ``test_torch_fs_snapshots.py``
too.
"""

import concurrent.futures
import contextlib
import errno
import itertools
import time
import uuid

import pytest

from test_torch_cluster import _assert_same_stores, _stores
from test_torch_rgw import normalize
from test_torch_striper import (  # noqa: F401  (cluster_pair: fixture)
    PKGS,
    _Clock,
    _Uuid4,
    cluster_pair,
    payload,
    pkg_mod,
    store_dump,
)

REF, PORT = PKGS

#: per package, the ids ``uuid.uuid4`` hands out (never reset: a client
#: instance must stay unique within its cluster across the module)
_IDS = {pkg: itertools.count(1) for pkg in PKGS}
_POOL_SEQ = itertools.count()


class _FsClock:
    """The engine module's ``time``: ``time()`` steps 1 ms a call (a cap
    stays fresh for 1000 calls), ``sleep`` and ``monotonic`` are real."""

    sleep = staticmethod(time.sleep)
    monotonic = staticmethod(time.monotonic)

    def __init__(self) -> None:
        self._n = itertools.count(1)

    def time(self) -> float:
        return 1.7e9 + next(self._n) * 1e-3


class _RealClock:
    """``time`` with ``time()`` real but rounded down to an odd number of
    microseconds: every stamp prints with 10 digits and 6 decimals, the
    last one odd, so a json inode's length (which a snapshot's clone
    records in its snapset) does not follow the digits the clock happened
    to give, and two stamps of distinct steps (each at least one round
    trip apart) stay distinct, as their order of appearance needs."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time() -> float:
        return (2 * int(time.time() * 5e5) + 1) / 1e6


@contextlib.contextmanager
def fs_deterministic(pkg: str, clocks: bool = True):
    """Within the block: ids count (``uuid.uuid4``, per package) and so do
    the striper's tags; with ``clocks``, the object classes' clock and the
    engine's ``time.time()`` count too; without, the object classes, the
    engine, the MDS and its client read :class:`_RealClock`."""
    ids = _IDS[pkg]
    patches = [(uuid, "uuid4", lambda: uuid.UUID(int=next(ids) << 96)),
               (pkg_mod(pkg, "client.striper"), "uuid", _Uuid4())]
    if clocks:
        patches += [(pkg_mod(pkg, "cls"), "time", _Clock()),
                    (pkg_mod(pkg, "cls.classes"), "time", _Clock()),
                    (pkg_mod(pkg, "services.cephfs"), "time", _FsClock())]
    else:
        patches += [(pkg_mod(pkg, mod), "time", _RealClock())
                    for mod in ("cls", "cls.classes", "services.cephfs",
                                "services.mds", "services.mds_client")]
    saved = [(owner, attr, getattr(owner, attr))
             for owner, attr, _ in patches]
    for owner, attr, stub in patches:
        setattr(owner, attr, stub)
    try:
        yield
    finally:
        for owner, attr, orig in reversed(saved):
            setattr(owner, attr, orig)


def fs(pkg):
    return pkg_mod(pkg, "services.cephfs")


def fs_err(pkg, fn) -> int:
    """``fn()``'s errno: an ``FSError``'s, or a ``RadosError``'s code."""
    rados = pkg_mod(pkg, "client.rados")
    with pytest.raises((fs(pkg).FSError, rados.RadosError)) as ei:
        fn()
    exc = ei.value
    return exc.errno if isinstance(exc, fs(pkg).FSError) else exc.code


def _held_by_name(oid: str, volatile: tuple) -> bool:
    return any(oid.startswith(v) for v in volatile)


def fs_on_both(pair, pools: dict, scenario, compare: str = "full",
               clocks: bool = True, volatile: tuple = ()):
    """Create ``pools`` ({name: spec}; a spec with ``k`` is an EC pool,
    ``backend="torch"`` in the port) in both clusters of ``pair``, run
    ``scenario(pkg, cluster, rados, *ioctxs)`` on the reference then the
    port within :func:`fs_deterministic`, and hold the port to the
    reference's normalized output and stored objects of those pools:
    ``compare`` "full" (data, attrs, omap: ``_assert_same_stores``;
    an EC pool's shards by (pool, ps, position, object)), "data" (object
    bytes) or "names". Each call names its pools afresh (a suffix
    counting calls), so a module's tests share no pool. Objects whose
    name starts with one of ``volatile`` (a lease renewed on a timer, an
    address) are held by name. Returns the port's output."""
    seq = next(_POOL_SEQ)
    pools = {f"{name}{seq}": spec for name, spec in pools.items()}
    results = []
    for pkg in PKGS:
        cluster, rados = pair[pkg]
        ec = False
        for name, spec in pools.items():
            spec = dict(spec)
            if "k" in spec:
                ec = True
                if pkg == PORT:
                    spec["backend"] = "torch"
                cluster.create_ec_pool(name, **spec)
            else:
                cluster.create_pool(name, **spec)
        ios = [rados.open_ioctx(name) for name in pools]
        with fs_deterministic(pkg, clocks):
            out = scenario(pkg, cluster, rados, *ios)
        ids = {cluster.mon.osdmap.pool_by_name[name] for name in pools}
        if ec and compare == "full":
            dump = {key: val for key, val in _stores(cluster).items()
                    if key[0] in ids}
        else:
            dump = {}
            for pool_id in sorted(ids):
                dump.update(store_dump(cluster, compare != "full",
                                       pool_id))
        dump = {key: (None if compare == "names"
                      or _held_by_name(key[-1], volatile) else val)
                for key, val in dump.items()}
        results.append((normalize(out), normalize(dump)))
    (ref_out, ref_store), (port_out, port_store) = results
    assert port_out == ref_out
    if compare == "full":
        _assert_same_stores(
            {k: v or (None, None, None) for k, v in ref_store.items()},
            {k: v or (None, None, None) for k, v in port_store.items()})
    else:
        assert sorted(port_store) == sorted(ref_store)
        for key in sorted(ref_store):
            assert port_store[key] == ref_store[key], \
                f"stored object {key} differs"
    return port_out


def copy_pool(src, dst) -> list[str]:
    """Copy every object of ``src``'s pool into ``dst``'s, one by one in
    name order: its data, xattrs and omap (the CephFS state: inodes,
    ``.fs_super``, the ``mdslog`` journal and its class meta object, the
    striper's ``fsdata.*`` pieces and meta objects). Returns the names."""
    names = src.list_objects()
    for oid in names:
        dst.write_full(oid, src.read(oid))
        for key, val in sorted(src.getxattrs(oid).items()):
            dst.setxattr(oid, key, val)
        omap = src.omap_get(oid)
        if omap:
            dst.omap_set(oid, omap)
    return names


POOL = {"fs": {"pg_num": 4, "size": 2}}


# -- counterparts of tests/test_cephfs.py -------------------------------

def _tree(pkg, io, out):
    f = fs(pkg).CephFS(io)
    f.mkdir("/a")
    f.mkdir("/a/b")
    f.mkdir("/a/b/c")
    f.mkdir("/d")
    out["root"] = f.readdir("/")
    out["ab"] = f.readdir("/a/b")
    out["stat_a"] = f.stat("/a")
    out["mkdir_again"] = fs_err(pkg, lambda: f.mkdir("/a"))
    out["readdir_nope"] = fs_err(pkg, lambda: f.readdir("/nope"))
    return f


def test_tree_and_readdir(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        out = {}
        _tree(pkg, io, out)
        assert out["root"] == ["a", "d"] and out["ab"] == ["c"]
        assert out["mkdir_again"] == errno.EEXIST
        return out

    fs_on_both(cluster_pair, POOL, scenario)


def test_file_io_and_unlink(cluster_pair):
    blob = payload(3 << 20, 11)

    def scenario(pkg, cluster, rados, io):
        out = {}
        f = _tree(pkg, io, out)
        h = f.create("/a/hello.txt")
        h.write(b"hello fs")
        out["size"] = f.stat("/a/hello.txt")["size"]
        out["read"] = f.open("/a/hello.txt").read()
        big = f.open("/a/big.bin", create=True)
        big.write(blob)
        out["mid"] = big.read(4096, 1 << 20) == \
            blob[1 << 20:(1 << 20) + 4096]
        big.write(b"patch", offset=100)
        out["patch"] = big.read(5, 100)
        big.truncate(len(blob) + 1000)
        out["tail"] = big.read(1000, len(blob))
        out["stat_big"] = f.stat("/a/big.bin")
        f.unlink("/a/hello.txt")
        out["open_gone"] = fs_err(pkg, lambda: f.open("/a/hello.txt"))
        out["after"] = f.readdir("/a")
        assert out["mid"] and out["tail"] == b"\x00" * 1000
        return out

    fs_on_both(cluster_pair, POOL, scenario)


def test_rename(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        out = {}
        f = _tree(pkg, io, out)
        h = f.open("/d/old.txt", create=True)
        h.write(b"payload")
        f.rename("/d/old.txt", "/a/new.txt")
        out["d"] = f.readdir("/d")
        out["new"] = f.open("/a/new.txt").read()
        f.unlink("/a/new.txt")
        out["a"] = f.readdir("/a")
        assert out["new"] == b"payload"
        return out

    fs_on_both(cluster_pair, POOL, scenario)


def test_rmdir_semantics(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        out = {}
        f = _tree(pkg, io, out)
        f.mkdir("/victim")
        f.open("/victim/f", create=True).write(b"x")
        out["notempty"] = fs_err(pkg, lambda: f.rmdir("/victim"))
        f.unlink("/victim/f")
        f.rmdir("/victim")
        out["root"] = f.readdir("/")
        out["rmdir_a"] = fs_err(pkg, lambda: f.rmdir("/a"))
        out["rmdir_file"] = fs_err(pkg, lambda: f.rmdir("/nope"))
        assert out["notempty"] == errno.ENOTEMPTY
        return out

    fs_on_both(cluster_pair, POOL, scenario)


def test_remount_persistence(cluster_pair):
    data = payload(50_000, 12)

    def scenario(pkg, cluster, rados, io):
        out = {}
        f = _tree(pkg, io, out)
        h = f.open("/a/persist.bin", create=True)
        h.write(data)
        rados2 = cluster.client()
        f2 = fs(pkg).CephFS(rados2.open_ioctx(io.pool_name))
        out["ls"] = f2.readdir("/a")
        out["read"] = f2.open("/a/persist.bin").read() == data
        assert out["read"]
        return out

    fs_on_both(cluster_pair, POOL, scenario)


def test_concurrent_dirops_atomic(cluster_pair):
    """24 creates from 8 threads race ``fs.dir_link`` on one directory:
    the inode numbers go in race order, so the store is held by names."""
    def scenario(pkg, cluster, rados, io):
        f = fs(pkg).CephFS(io)
        f.mkdir("/race")

        def worker(i):
            f.open(f"/race/f{i}", create=True).write(b"x")

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(worker, range(24)))
        got = f.readdir("/race")
        assert got == sorted(f"f{i}" for i in range(24))
        return got

    fs_on_both(cluster_pair, POOL, scenario, compare="names")


def test_mds_journal_replays_half_done_rename(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        f = fs(pkg).CephFS(io)
        h = f.open("/crashy", create=True)
        h.write(b"payload")
        h.release()
        ino, _ = f._resolve("/crashy")
        f._mds_event("rename", ino=ino, new_parent=1, new_name="moved",
                     old_parent=1, old_name="crashy")
        f._dir_link(1, "moved", ino)
        torn = f.readdir("/")
        f2 = fs(pkg).CephFS(io)
        out = {"torn": torn, "after": f2.readdir("/"),
               "read": f2.open("/moved").read(),
               "committed": f2.journal.committed(f2.client_id),
               "end": f2.journal.end_position()}
        f2.unlink("/moved")
        assert out["after"] == ["moved"] and out["committed"] == out["end"]
        return out

    fs_on_both(cluster_pair, POOL, scenario)


def test_mds_journal_replays_half_done_unlink(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        f = fs(pkg).CephFS(io)
        h = f.open("/doomed2", create=True)
        h.write(b"bye")
        ino, _ = f._resolve("/doomed2")
        f._mds_event("unlink", parent=1, name="doomed2", ino=ino)
        f._dir_unlink(1, "doomed2")
        f2 = fs(pkg).CephFS(io)
        out = {"root": f2.readdir("/"),
               "inode": fs_err(pkg, lambda: io.read(f"inode.{ino}"))}
        assert "doomed2" not in out["root"]
        return out

    fs_on_both(cluster_pair, POOL, scenario)


def _trim_all(cluster) -> None:
    for osd in cluster.osds.values():
        for pg in list(osd.pgs.values()):
            osd._snap_trim(pg)


def test_mds_journal_replays_half_done_mksnap(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        f = fs(pkg).CephFS(io)
        f.mkdir("/p")
        f.mkdir("/p/d")
        f.create("/p/d/A").write(b"pre-snapshot")
        ino_d, _ = f._resolve("/p/d")
        sp = f.mksnap("/p", "sp")
        s1 = io.selfmanaged_snap_create()
        f._mds_event("mksnap", parent=ino_d, name="s1", ino=s1)
        f2 = fs(pkg).CephFS(io)
        out = {"sp": sp, "s1": s1, "ls": f2.lssnap("/p/d"),
               "via_sp": f2.readdir("/p/.snap/sp/d"),
               "via_s1": f2.readdir("/p/d/.snap/s1")}
        f2.create("/p/d/B").write(b"post")
        f2.rmsnap("/p/d", "s1")
        _trim_all(cluster)
        out["after_trim"] = f2.readdir("/p/.snap/sp/d")
        out["A"] = f2.open("/p/.snap/sp/d/A").read()
        assert out["after_trim"] == ["A"] and out["A"] == b"pre-snapshot"
        return out

    fs_on_both(cluster_pair, POOL, scenario)


def test_two_client_caps_coherence(cluster_pair):
    """Real clocks: the conflicting writer waits out its timeout."""
    def scenario(pkg, cluster, rados, io):
        CephFS = fs(pkg).CephFS
        a = CephFS(rados.open_ioctx(io.pool_name), client_id="mount-a")
        b = CephFS(rados.open_ioctx(io.pool_name), client_id="mount-b")
        out = {}
        fa = a.open("/shared-file", create=True)
        fa.write(b"from-a " * 100)
        fb = b.open("/shared-file")
        fb.cap_timeout = 0.3
        t0 = time.monotonic()
        out["clobber"] = fs_err(pkg, lambda: fb.write(b"clobber"))
        assert time.monotonic() - t0 >= 0.25
        out["holders"] = {k: v["type"] for k, v in
                          a.cap_holders("/shared-file").items()}
        fa.release()
        fb.cap_timeout = 10.0
        out["b_read"] = fb.read()
        fa2 = a.open("/shared-file")
        out["a_read"] = fa2.read()
        out["shared"] = {k: v["type"] for k, v in
                         a.cap_holders("/shared-file").items()}
        fw = b.open("/shared-file")
        fw.cap_timeout = 0.3
        out["early"] = fs_err(pkg, lambda: fw.write(b"early"))
        fa.release()
        fa2.release()
        fb.release()
        fw.cap_timeout = 10.0
        fw.write(b"now-b")
        fw.release()
        out["final"] = a.open("/shared-file").read(5)
        assert out["clobber"] == out["early"] == errno.EAGAIN
        assert out["final"] == b"now-b"
        return out

    fs_on_both(cluster_pair, POOL, scenario, compare="names", clocks=False)


def test_two_client_caps_lease_expiry(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        m = fs(pkg)
        a = m.CephFS(rados.open_ioctx(io.pool_name), client_id="mount-dead")
        b = m.CephFS(rados.open_ioctx(io.pool_name), client_id="mount-live")
        fa = a.open("/orphaned", create=True)
        fa.write(b"last words")
        fb = b.open("/orphaned")
        fb.cap_timeout = m.CAP_TTL + 5
        fb.write(b"taken over")
        got = fb.read(10)
        fb.release()
        assert got == b"taken over"
        return got

    fs_on_both(cluster_pair, POOL, scenario, compare="names", clocks=False)


def test_two_client_rename_under_contention(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        CephFS = fs(pkg).CephFS
        a = CephFS(rados.open_ioctx(io.pool_name), client_id="ren-a")
        b = CephFS(rados.open_ioctx(io.pool_name), client_id="ren-b")
        a.mkdir("/storm")
        for i in range(12):
            f = a.open(f"/storm/f{i}", create=True)
            f.write(b"payload%d" % i)
            f.release()

        def mover(args):
            m, i = args
            m.rename(f"/storm/f{i}", f"/storm/g{i}")

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(mover, [(a if i % 2 == 0 else b, i)
                                  for i in range(12)]))
        out = {"names": a.readdir("/storm"), "reads": []}
        for i in range(12):
            f = b.open(f"/storm/g{i}")
            out["reads"].append(f.read())
            f.release()
        c = CephFS(rados.open_ioctx(io.pool_name), client_id="ren-c")
        out["c"] = c.readdir("/storm")
        a.umount()
        b.umount()
        c.umount()
        assert out["names"] == sorted(f"g{i}" for i in range(12))
        return out

    fs_on_both(cluster_pair, POOL, scenario, compare="names")


def test_journal_single_to_multi_writer_upgrade(cluster_pair):
    def scenario(pkg, cluster, rados, io):
        Journaler = pkg_mod(pkg, "services.journal").Journaler
        old = Journaler(io, "upg")
        old.create()
        for i in range(5):
            old.append(b"legacy-%d" % i)
        old.commit("mds", 3)
        mw = Journaler(io, "upg", multi_writer=True)
        out = {"end": mw.end_position(), "tail": dict(mw.read_from(3))}
        p1 = mw.append(b"new-a")
        p2 = mw.append(b"new-b")
        out["p"] = (p1, p2)
        out["tail2"] = dict(mw.read_from(3))
        assert out["end"] == 5 and p1 >= 5 and p2 > p1
        return out

    fs_on_both(cluster_pair, POOL, scenario)


# -- on an EC pool, and the state carried across ------------------------

def test_cephfs_on_ec_pool_shard_for_shard(cluster_pair):
    """One mount, one thread, on an EC k=2,m=1 pool (the reference's host
    backend, the port's ``torch``): a tree, striped files over two
    objects, a snapshot and overwrites under it, a rename and an unlink,
    held shard for shard."""
    blob = payload((1 << 20) + 5000, 13)

    def scenario(pkg, cluster, rados, io):
        out = {}
        f = _tree(pkg, io, out)
        h = f.create("/a/b/big")
        h.write(blob)
        f.create("/d/small").write(b"small file")
        out["sid"] = f.mksnap("/a", "s")
        f.open("/a/b/big").write(b"Z" * 4096, offset=4096)
        f.rename("/d/small", "/a/moved")
        f.unlink("/a/moved")
        out["head"] = f.open("/a/b/big").read(8192)
        out["snap"] = f.open("/a/.snap/s/b/big").read() == blob
        out["tree"] = [f.readdir(p) for p in ("/", "/a", "/a/b", "/d")]
        out["stats"] = [f.stat(p) for p in ("/a/b/big", "/a/.snap/s/b/big")]
        assert out["snap"] and out["head"][4096:] == b"Z" * 4096
        return out

    fs_on_both(cluster_pair, {"fsec": {"k": 2, "m": 1, "pg_num": 4}},
               scenario)


def test_port_mounts_a_reference_pool(cluster_pair):
    """The reference writes a tree and journals a rename it never
    finishes (link done, unlink not); the pool is copied object by object
    into a fresh pool of each package; the reference remounts its copy,
    the port mounts its own. The port reads the same tree, stats and
    bytes, completes the rename as the reference's remount does, and the
    two copies end equal."""
    blob = payload((2 << 20) + 777, 14)
    ref_cluster, ref_rados = cluster_pair[REF]
    names = ["carry_src", "carry_copy"]
    for pkg in PKGS:
        for name in names:
            cluster_pair[pkg][0].create_pool(name, pg_num=4, size=2)
    src = ref_rados.open_ioctx("carry_src")
    # a named writer: the source run takes no id from the counter, so the
    # two packages' counters stay in step for the mounts that follow
    with fs_deterministic(REF):
        f = fs(REF).CephFS(src, client_id="writer")
        f.mkdir("/x")
        f.mkdir("/x/y")
        f.create("/x/y/big").write(blob)
        f.create("/x/small").write(b"carried")
        ino, _ = f._resolve("/x/small")
        f._mds_event("rename", ino=ino, new_parent=1, new_name="renamed",
                     old_parent=f._resolve("/x")[0], old_name="small")
        f._dir_link(1, "renamed", ino)

    results = []
    for pkg in PKGS:
        cluster, rados = cluster_pair[pkg]
        dst = rados.open_ioctx("carry_copy")
        copied = copy_pool(src, dst)
        with fs_deterministic(pkg):
            g = fs(pkg).CephFS(dst)
            out = {"copied": copied,
                   "tree": [g.readdir(p) for p in ("/", "/x", "/x/y")],
                   "stats": [g.stat(p) for p in ("/x/y/big", "/renamed")],
                   "big": g.open("/x/y/big").read() == blob,
                   "renamed": g.open("/renamed").read(),
                   "done": g.journal.committed(g.client_id) ==
                   g.journal.end_position()}
        dump = store_dump(cluster, False,
                          cluster.mon.osdmap.pool_by_name["carry_copy"])
        results.append((normalize(out), normalize(dump)))
    (ref_out, ref_store), (port_out, port_store) = results
    assert port_out == ref_out
    assert port_out["tree"][0] == ["renamed", "x"]
    assert port_out["tree"][1] == ["y"] and port_out["big"]
    assert port_out["renamed"] == b"carried" and port_out["done"]
    _assert_same_stores(ref_store, port_store)
