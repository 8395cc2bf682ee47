"""The port's client-side striper (``ceph_tpu_torch/client/striper.py``)
against the reference's (``ceph_tpu/client/striper.py``), on the CPU.

Counterparts of the 5 tests of ``tests/test_striper.py``. The extent math
runs through both packages' ``file_to_extents`` on the same layouts and
ranges; the striped-object tests run the reference test's steps on a
reference ``MiniCluster`` and on a port one, one after the other, with
the same seeded payloads, and hold the two to the same outputs and the
same stored objects (every OSD's store: data, attrs and omap). The
striper's write-generation tag (``uuid.uuid4``) is a counter in both
packages, so the stores can agree. Tolerance 0.

The helpers here (``PKGS``, ``pkg_mod``, ``deterministic``,
``store_dump``, ``run_both``) serve the port's RBD slice tests
(``test_torch_cls.py``, ``test_torch_rbd.py``) too.
"""

import contextlib
import importlib
import uuid

import numpy as np
import pytest

#: reference first, then the port
PKGS = ("ceph_tpu", "ceph_tpu_torch")


def pkg_mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class _Uuid4:
    """``uuid`` stand-in whose ``uuid4()`` counts from 1, in the high bits:
    the striper's tag is the first 16 hex digits, so each write generation
    gets its own tag, as with ``uuid.uuid4``."""

    def __init__(self) -> None:
        self.n = 0

    def uuid4(self) -> uuid.UUID:
        self.n += 1
        return uuid.UUID(int=self.n << 64)


class _Clock:
    """``time`` stand-in whose ``time()`` steps one second a call."""

    def __init__(self) -> None:
        self.t = 1.7e9

    def time(self) -> float:
        self.t += 1.0
        return self.t


@contextlib.contextmanager
def deterministic(pkg: str):
    """Within the block, ``pkg``'s striper tags and its object classes'
    stamps count instead of reading ``uuid4`` and the clock, the same in
    both packages."""
    patches = [(pkg_mod(pkg, "client.striper"), "uuid", _Uuid4()),
               (pkg_mod(pkg, "cls"), "time", _Clock()),
               (pkg_mod(pkg, "cls.classes"), "time", _Clock())]
    saved = [(owner, attr, getattr(owner, attr))
             for owner, attr, _ in patches]
    for owner, attr, stub in patches:
        setattr(owner, attr, stub)
    try:
        yield
    finally:
        for owner, attr, orig in saved:
            setattr(owner, attr, orig)


@contextlib.contextmanager
def no_resend():
    """Both packages' clients made within the block resend no slow op
    (the ``no_early_resend`` fixture of ``test_torch_cluster.py``: a
    resent write runs twice and adds a PG log entry; the in-process
    messenger loses no frame). The objecter reads the knobs when a
    client starts."""
    keys = ("objecter_resend_interval", "objecter_resend_max")
    confs = [pkg_mod(pkg, "utils.config").g_conf() for pkg in PKGS]
    saved = [(conf, {k: conf[k] for k in keys}) for conf in confs]
    for conf in confs:
        for k in keys:
            conf.set(k, 120.0)
    try:
        yield
    finally:
        for conf, old in saved:
            for k, v in old.items():
                conf.set(k, v)


def store_dump(cluster, data_only: bool = False,
               pool_id: int | None = None) -> dict:
    """Every object of every OSD's store (of pool ``pool_id`` alone when
    given): (osd, collection, oid) -> (data, attrs, omap), or the data
    alone with ``data_only`` (for runs whose ops race, where versions and
    the PG log follow the order)."""
    out = {}
    for osd_id in sorted(cluster._stores):
        stores = cluster._stores[osd_id]
        for store in stores if isinstance(stores, list) else [stores]:
            if store is None:
                continue
            for cid in store.list_collections():
                if pool_id is not None and \
                        not cid.startswith(f"pg_{pool_id}."):
                    continue
                for oid in store.list_objects(cid):
                    if data_only:
                        if oid.startswith("_pgmeta"):
                            continue
                        out[(osd_id, cid, oid)] = store.read(cid, oid)
                    else:
                        out[(osd_id, cid, oid)] = (
                            store.read(cid, oid), store.getattrs(cid, oid),
                            store.omap_get(cid, oid))
    return out


def run_both(scenario, n_osds=3, pools=(("p", {"pg_num": 2, "size": 2}),),
             data_only=False, **cluster_kw):
    """Run ``scenario(pkg, cluster, ios)`` on a reference MiniCluster, then
    on a port one, each with ``pools`` (replicated, or EC where the spec
    names ``k``) and one ioctx per pool; returns ((ref out, ref store),
    (port out, port store))."""
    results = []
    for pkg in PKGS:
        cluster_mod = pkg_mod(pkg, "qa.cluster")
        with deterministic(pkg), no_resend(), \
                cluster_mod.MiniCluster(n_osds=n_osds, **cluster_kw) as c:
            rados = c.client()
            for name, spec in pools:
                spec = dict(spec)
                if "k" in spec:
                    c.create_ec_pool(name, **spec)
                else:
                    c.create_pool(name, **spec)
            ios = {name: rados.open_ioctx(name) for name, _ in pools}
            out = scenario(pkg, c, ios)
            results.append((out, store_dump(c, data_only)))
    return results


@pytest.fixture(scope="module")
def cluster_pair():
    """A reference and a port 3-OSD MiniCluster, up together for a test
    module; :func:`on_both` gives each test its own pool in both."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(no_resend())
        pair = {}
        for pkg in PKGS:
            c = stack.enter_context(
                pkg_mod(pkg, "qa.cluster").MiniCluster(n_osds=3))
            pair[pkg] = (c, c.client())
        yield pair


def on_both(pair, pool, scenario, compare: str = "full", spec=None):
    """Create replicated pool ``pool`` (a name, or a tuple of names;
    ``spec``: pg_num 2, size 2) in both clusters of ``pair``, run
    ``scenario(pkg, io)`` (a tuple of ioctxs for a tuple of pools) on the
    reference then the port, and hold the port to the reference's output
    and stored objects of those pools: ``compare`` "full" (data, attrs,
    omap), "data" (object bytes; ops that race leave versions in their
    order) or "names" (object names; raced ops also order the keys of the
    state they build). Returns the port's output."""
    names = (pool,) if isinstance(pool, str) else tuple(pool)
    results = []
    for pkg in PKGS:
        cluster, rados = pair[pkg]
        for name in names:
            cluster.create_pool(name, **(spec or {"pg_num": 2, "size": 2}))
        ios = tuple(rados.open_ioctx(name) for name in names)
        with deterministic(pkg):
            out = scenario(pkg, ios[0] if isinstance(pool, str) else ios)
        dump = {}
        for name in names:
            dump.update(store_dump(cluster, compare != "full",
                                   cluster.mon.osdmap.pool_by_name[name]))
        if compare == "names":
            dump = dict.fromkeys(dump)
        results.append((out, dump))
    assert_same(results)
    return results[1][0]


def assert_same(results):
    (ref_out, ref_store), (out, store) = results
    assert out == ref_out
    assert sorted(store) == sorted(ref_store)
    for key in sorted(ref_store):
        assert store[key] == ref_store[key], f"stored object {key} differs"


def payload(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


# -- the extent math ----------------------------------------------------

def _extents(pkg, layout, off, ln):
    st = pkg_mod(pkg, "client.striper")
    return st.file_to_extents(st.FileLayout(*layout), off, ln)


@pytest.mark.parametrize("layout,ranges", [
    ((4096, 1, 8192), [(4096, 8192)]),
    ((100, 3, 200), [(0, 600), (600, 100)]),
    ((1 << 20, 1, 1 << 20), [(0, 8 << 20), (4095, 8194), (0, 1)]),
], ids=["single_object", "round_robin", "rbd_default"])
def test_extent_math_matches_reference(layout, ranges):
    for off, ln in ranges:
        got = _extents("ceph_tpu_torch", layout, off, ln)
        assert got == _extents("ceph_tpu", layout, off, ln)
        assert sum(n for _, _, n in got) == ln


def test_extent_math_oracle():
    """Every byte lands exactly once, where a slow per-byte oracle puts
    it, in both packages."""
    su, sc, spo = 16, 3, 4

    def oracle(b):
        stripeno, stripepos = divmod(b // su, sc)
        objectsetno, row = divmod(stripeno, spo)
        return (objectsetno * sc + stripepos, row * su + b % su)

    for off, ln in [(0, 500), (7, 123), (250, 250), (63, 2)]:
        ext = _extents("ceph_tpu_torch", (su, sc, su * spo), off, ln)
        assert ext == _extents("ceph_tpu", (su, sc, su * spo), off, ln)
        got, pos = {}, off
        for objectno, obj_off, n in ext:
            for i in range(n):
                got[pos + i] = (objectno, obj_off + i)
            pos += n
        assert pos == off + ln
        assert all(got[b] == oracle(b) for b in range(off, off + ln))


def test_layout_validation_matches_reference():
    for layout in ((0, 1, 4096), (4096, 1, 6144), (4096, -1, 4096)):
        errs = []
        for pkg in PKGS:
            st = pkg_mod(pkg, "client.striper")
            with pytest.raises(ValueError) as ei:
                st.FileLayout(*layout).validate()
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


# -- striped objects on a cluster ---------------------------------------

def test_striped_object_roundtrip_matches_reference():
    data = payload(100_000, 1)

    def scenario(pkg, cluster, ios):
        st = pkg_mod(pkg, "client.striper")
        io = ios["p"]
        lay = st.FileLayout(stripe_unit=8192, stripe_count=2,
                            object_size=16384)
        so = st.StripedObject(io, "big", lay)
        so.write(data)
        so2 = st.StripedObject(io, "big")
        assert so2.layout == lay and so2.size == len(data)
        out = [so.stat(), so2.read(), so2.read(5000, 40_000),
               sorted(o for o in io.list_objects() if o.startswith("big."))]
        assert out[1] == data and out[2] == data[40_000:45_000]
        assert len(out[3]) > 4
        so2.write(b"X" * 10_000, offset=12_345)
        expect = bytearray(data)
        expect[12_345:22_345] = b"X" * 10_000
        out.append(so2.read())
        assert out[-1] == bytes(expect)
        snapshot = store_dump(cluster)
        so2.remove()
        out.append([o for o in io.list_objects() if o.startswith("big.")])
        assert out[-1] == []
        return out, snapshot

    (ref_out, ref_store), (out, store) = run_both(scenario)
    assert out[0] == ref_out[0]
    assert_same([(None, ref_out[1]), (None, out[1])])
    assert_same([(None, ref_store), (None, store)])


def test_striped_layout_mismatch_matches_reference():
    def scenario(pkg, cluster, ios):
        st = pkg_mod(pkg, "client.striper")
        io = ios["p"]
        so = st.StripedObject(io, "conf", st.FileLayout(4096, 1, 4096))
        so.write(b"d" * 5000)
        with pytest.raises(ValueError) as ei:
            st.StripedObject(io, "conf", st.FileLayout(8192, 1, 8192))
        before = store_dump(cluster)
        so.remove()
        return str(ei.value), before

    (ref_out, ref_store), (out, store) = run_both(scenario)
    assert out[0] == ref_out[0]
    assert_same([(None, ref_out[1]), (None, out[1])])
    assert_same([(None, ref_store), (None, store)])
