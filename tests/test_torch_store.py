"""The port's durable stores and host native library against the reference.

- The contract cases of ``tests/test_store.py`` (MemStore, BlockStore,
  KStore) and its BlockStore and KStore durability cases, on the port's
  stores, as cases of parametrised tests.
- Cross-mount: a BlockStore or KStore directory written by the reference
  mounts under the port with the same bytes, attrs and omap, and the
  reverse; the same transactions leave the data file's raw bytes and the
  FileDB's entries equal in both packages, over every csum type and
  compressed blobs.
- Silent bit flips (``inject_bit_flip``) on every store: the read
  returns the rot with no EIO.
- The host native library: crc32c and xxhash32/64 equal to the
  reference's values and to the plain versions (the numpy crc, the
  table loop); the native data-file engine equal to its python twin; a
  failed build raises.
- The compressor: each codec both packages register gives the
  reference's bytes and round-trips.
- A whole-cluster restart from disk (the reference's
  ``tests/test_durability.py:16``) on the port.
- ``objectstore_tool``: the port's output equals the reference tool's on
  the same directory, op for op.

Tolerance 0 everywhere.
"""

import contextlib
import json
import os

import numpy as np
import pytest

from ceph_tpu.store.blockstore import BlockStore as RefBlockStore
from ceph_tpu.store.kstore import KStore as RefKStore
from ceph_tpu.tools import objectstore_tool as ref_tool
from ceph_tpu.utils import checksum as ref_checksum
from ceph_tpu.utils.config import g_conf as ref_conf
from ceph_tpu_torch.compressor import Compressor, registry
from ceph_tpu_torch.ops import native_loader
from ceph_tpu_torch.qa.cluster import MiniCluster
from ceph_tpu_torch.store import (
    BlockStore,
    EIOError,
    MemStore,
    Transaction,
    blockstore,
    create_store,
    native_io,
)
from ceph_tpu_torch.store.kstore import STRIPE, KStore
from ceph_tpu_torch.store.kv import FileDB
from ceph_tpu_torch.store.object_store import NoSuchCollection, NoSuchObject
from ceph_tpu_torch.tools import objectstore_tool
from ceph_tpu_torch.utils import checksum
from ceph_tpu_torch.utils.config import g_conf

CID = "pg_1.0s0"
KINDS = ("memstore", "blockstore", "kstore")


# -- the contract of tests/test_store.py, on every port store -------------

def _create_write_read(store):
    t = Transaction()
    t.create_collection(CID)
    t.write(CID, "obj", 0, b"hello world")
    committed = []
    store.queue_transaction(t, on_commit=lambda: committed.append(1))
    assert committed == [1]
    assert store.read(CID, "obj") == b"hello world"
    assert store.read(CID, "obj", 6, 5) == b"world"
    assert store.stat(CID, "obj") == 11


def _overwrite_and_extend(store):
    store.queue_transaction(
        Transaction().create_collection(CID).write(CID, "o", 0, b"AAAAAAAA"))
    store.queue_transaction(Transaction().write(CID, "o", 4, b"BBBB"))
    store.queue_transaction(Transaction().write(CID, "o", 10, b"CC"))
    assert store.read(CID, "o") == b"AAAABBBB\x00\x00CC"


def _zero_truncate_remove(store):
    store.queue_transaction(
        Transaction().create_collection(CID).write(CID, "o", 0, b"X" * 16))
    store.queue_transaction(Transaction().zero(CID, "o", 4, 8))
    assert store.read(CID, "o") == b"XXXX" + b"\x00" * 8 + b"XXXX"
    store.queue_transaction(Transaction().truncate(CID, "o", 6))
    assert store.read(CID, "o") == b"XXXX\x00\x00"
    store.queue_transaction(Transaction().remove(CID, "o"))
    with pytest.raises(NoSuchObject):
        store.read(CID, "o")


def _attrs_and_omap(store):
    t = Transaction().create_collection(CID)
    t.touch(CID, "o")
    t.setattr(CID, "o", "hinfo", b"\x01\x02")
    t.omap_set(CID, "o", {"k1": b"v1", "k2": b"v2"})
    store.queue_transaction(t)
    assert store.getattr(CID, "o", "hinfo") == b"\x01\x02"
    assert store.getattrs(CID, "o") == {"hinfo": b"\x01\x02"}
    assert store.omap_get(CID, "o") == {"k1": b"v1", "k2": b"v2"}
    store.queue_transaction(
        Transaction().rmattr(CID, "o", "hinfo").omap_rm(CID, "o", ["k1"]))
    assert store.getattrs(CID, "o") == {}
    assert store.omap_get(CID, "o") == {"k2": b"v2"}


def _listing(store):
    t = Transaction().create_collection(CID).create_collection("pg_1.1s0")
    t.touch(CID, "b").touch(CID, "a").touch("pg_1.1s0", "z")
    store.queue_transaction(t)
    assert store.list_collections() == [CID, "pg_1.1s0"]
    assert store.list_objects(CID) == ["a", "b"]
    with pytest.raises(NoSuchCollection):
        store.list_objects("nope")


def _missing_collection_rejected(store):
    with pytest.raises(NoSuchCollection):
        store.queue_transaction(Transaction().write("nope", "o", 0, b"x"))


def _remove_then_recreate_in_one_txn(store):
    store.queue_transaction(
        Transaction().create_collection(CID)
        .write(CID, "o", 0, b"old").setattr(CID, "o", "a", b"1"))
    store.queue_transaction(
        Transaction().remove(CID, "o").write(CID, "o", 0, b"new"))
    assert store.read(CID, "o") == b"new"
    assert store.getattrs(CID, "o") == {}


def _eio_injection(store):
    store.queue_transaction(
        Transaction().create_collection(CID).write(CID, "o", 0, b"data"))
    store.inject_data_error(CID, "o")
    with pytest.raises(EIOError):
        store.read(CID, "o")
    store.clear_data_error(CID, "o")
    assert store.read(CID, "o") == b"data"


def _remove_collection_same_txn_leaves_no_phantom(store):
    t = Transaction().create_collection(CID)
    t.write(CID, "ghost", 0, b"boo")
    t.remove_collection(CID)
    store.queue_transaction(t)
    assert CID not in store.list_collections()
    store.queue_transaction(Transaction().create_collection(CID))
    assert store.list_objects(CID) == []


def _failed_txn_applies_nothing(store):
    store.queue_transaction(Transaction().create_collection(CID))
    t = Transaction().write(CID, "o", 0, b"x").rmattr(CID, "missing", "a")
    with pytest.raises(NoSuchObject):
        store.queue_transaction(t)
    assert not store.exists(CID, "o")


def _bit_flip_is_silent(store):
    """inject_bit_flip returns rot WITHOUT an EIO (the class only deep
    scrub catches), and a rewrite replaces it like any data."""
    store.queue_transaction(
        Transaction().create_collection(CID).write(CID, "o", 0, b"A" * 64))
    store.inject_bit_flip(CID, "o", offset=8, length=4)
    got = store.read(CID, "o")
    assert got[8:12] == bytes(b ^ 0xFF for b in b"AAAA")
    assert got[:8] == b"A" * 8 and got[12:] == b"A" * 52
    store.queue_transaction(Transaction().write(CID, "o", 0, b"B" * 64))
    assert store.read(CID, "o") == b"B" * 64


CONTRACT = {f.__name__[1:]: f for f in (
    _create_write_read, _overwrite_and_extend, _zero_truncate_remove,
    _attrs_and_omap, _listing, _missing_collection_rejected,
    _remove_then_recreate_in_one_txn, _eio_injection,
    _remove_collection_same_txn_leaves_no_phantom,
    _failed_txn_applies_nothing, _bit_flip_is_silent)}


@pytest.mark.parametrize("case", sorted(CONTRACT))
@pytest.mark.parametrize("kind", KINDS)
def test_store_contract(kind, case, tmp_path):
    store = create_store(kind, str(tmp_path / "store"))
    store.mount()
    try:
        CONTRACT[case](store)
    finally:
        store.umount()


def test_create_store_kinds(tmp_path):
    assert isinstance(create_store("memstore"), MemStore)
    assert isinstance(create_store("blockstore", str(tmp_path / "b")),
                      BlockStore)
    assert isinstance(create_store("kstore", str(tmp_path / "k")), KStore)
    assert isinstance(create_store("kstore"), KStore)      # MemDB
    with pytest.raises(ValueError):
        create_store("blockstore")
    with pytest.raises(ValueError):
        create_store("filestore")


# -- BlockStore and KStore durability (tests/test_store.py) ---------------

def _crash(store):
    """Drop the handles without umount/compact."""
    store._data.close()
    store._db._wal.close()


def _remount_preserves_state(path):
    s = BlockStore(path)
    s.mount()
    s.queue_transaction(
        Transaction().create_collection(CID)
        .write(CID, "o", 0, b"persistent").setattr(CID, "o", "v", b"7"))
    s.umount()
    s2 = BlockStore(path)
    s2.mount()
    assert s2.read(CID, "o") == b"persistent"
    assert s2.getattr(CID, "o", "v") == b"7"
    s2.umount()


def _wal_replay_without_clean_close(path):
    s = BlockStore(path)
    s.mount()
    s.queue_transaction(
        Transaction().create_collection(CID).write(CID, "o", 0, b"walled"))
    _crash(s)
    s2 = BlockStore(path)
    s2.mount()
    assert s2.read(CID, "o") == b"walled"
    s2.umount()


def _torn_wal_tail_ignored(path):
    s = BlockStore(path)
    s.mount()
    s.queue_transaction(
        Transaction().create_collection(CID).write(CID, "o", 0, b"good"))
    _crash(s)
    with open(os.path.join(path, "db", "wal"), "ab") as f:
        f.write(b"\x40\x00\x00\x00\xde\xad\xbe\xefpartial")
    s2 = BlockStore(path)
    s2.mount()
    assert s2.read(CID, "o") == b"good"
    s2.umount()


def _bitrot_detected_on_read(path):
    s = BlockStore(path)
    s.mount()
    s.queue_transaction(
        Transaction().create_collection(CID).write(CID, "o", 0, b"S" * 4096))
    s.umount()
    with open(os.path.join(path, "data"), "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    s2 = BlockStore(path)
    s2.mount()
    with pytest.raises(EIOError):
        s2.read(CID, "o")
    s2.umount()


def _wal_commit_after_torn_tail_survives(path):
    s = BlockStore(path)
    s.mount()
    s.queue_transaction(
        Transaction().create_collection(CID).write(CID, "o1", 0, b"one"))
    _crash(s)
    with open(os.path.join(path, "db", "wal"), "ab") as f:
        f.write(b"\x40\x00\x00\x00\xde\xad\xbe\xefpartial")
    s2 = BlockStore(path)
    s2.mount()
    s2.queue_transaction(Transaction().write(CID, "o2", 0, b"two"))
    _crash(s2)
    s3 = BlockStore(path)
    s3.mount()
    assert s3.read(CID, "o1") == b"one"
    assert s3.read(CID, "o2") == b"two"
    s3.umount()


def _kstore_remount_preserves_state(path):
    s = create_store("kstore", path)
    s.mount()
    t = Transaction().create_collection(CID)
    t.touch(CID, "o")
    big = bytes(range(256)) * ((STRIPE * 2 + 999) // 256)
    t.write(CID, "o", 0, big)                 # spans 3 stripe records
    t.setattr(CID, "o", "v", b"\x07")
    t.omap_set(CID, "o", {"k": b"v"})
    done = []
    s.queue_transaction(t, on_commit=lambda: done.append(1))
    assert done
    t2 = Transaction()
    t2.write(CID, "o", STRIPE - 10, b"X" * 20)
    t2.truncate(CID, "o", STRIPE + 5)
    s.queue_transaction(t2)
    expect = bytearray(big[:STRIPE + 5])
    expect[STRIPE - 10:STRIPE + 5] = b"X" * 15
    assert s.read(CID, "o") == bytes(expect)
    s.umount()
    s2 = create_store("kstore", path)
    s2.mount()
    assert s2.read(CID, "o") == bytes(expect)
    assert s2.getattr(CID, "o", "v") == b"\x07"
    assert s2.omap_get(CID, "o") == {"k": b"v"}
    s2.umount()


def _kstore_slash_oids_do_not_cross(path):
    s = create_store("kstore", path)
    s.mount()
    t = Transaction().create_collection(CID)
    for oid in ("b/k", "b/k/s"):
        t.touch(CID, oid)
        t.write(CID, oid, 0, oid.encode())
        t.setattr(CID, oid, "tag", oid.encode())
        t.omap_set(CID, oid, {"m": oid.encode()})
    s.queue_transaction(t)
    assert sorted(s.list_objects(CID)) == ["b/k", "b/k/s"]
    s.queue_transaction(Transaction().remove(CID, "b/k"))
    assert s.list_objects(CID) == ["b/k/s"]
    assert s.read(CID, "b/k/s") == b"b/k/s"
    assert s.getattrs(CID, "b/k/s") == {"tag": b"b/k/s"}
    assert s.omap_get(CID, "b/k/s") == {"m": b"b/k/s"}
    s.umount()


DURABILITY = {f.__name__[1:]: f for f in (
    _remount_preserves_state, _wal_replay_without_clean_close,
    _torn_wal_tail_ignored, _bitrot_detected_on_read,
    _wal_commit_after_torn_tail_survives, _kstore_remount_preserves_state,
    _kstore_slash_oids_do_not_cross)}


@pytest.mark.parametrize("case", sorted(DURABILITY))
def test_store_durability(case, tmp_path):
    DURABILITY[case](str(tmp_path / "s"))


def test_kstore_bit_flip_spans_stripes(tmp_path):
    s = KStore(str(tmp_path / "ks"))
    s.mount()
    try:
        s.queue_transaction(Transaction().create_collection(CID)
                            .write(CID, "o", 0, b"C" * (STRIPE + 32)))
        s.inject_bit_flip(CID, "o", offset=STRIPE - 2, length=4)
        got = s.read(CID, "o")
        assert got[STRIPE - 2:STRIPE + 2] == bytes(b ^ 0xFF for b in b"CCCC")
        assert got[:STRIPE - 2] + got[STRIPE + 2:] == b"C" * (STRIPE + 28)
    finally:
        s.umount()


# -- cross-mount and on-disk equality with the reference ------------------

@contextlib.contextmanager
def _both_confs(**opts):
    """Set bluestore options in both packages' configs for the block."""
    saved = []
    for conf in (g_conf(), ref_conf()):
        saved.append((conf, {k: conf[k] for k in opts}))
        for key, val in opts.items():
            conf.set(key, val)
    try:
        yield
    finally:
        for conf, old in saved:
            for key, val in old.items():
                conf.set(key, val)


def _txns(seed: int) -> list:
    """Seeded transactions: compressible and random blobs, an overwrite
    that splits an extent, zero, truncate, attrs, omap, a remove and a
    second collection."""
    rng = np.random.default_rng(seed)
    rnd = rng.integers(0, 256, 20000, dtype=np.uint8).tobytes()
    text = b"deep scrub rides the same buffers " * 400
    return [
        Transaction().create_collection(CID).create_collection("pg_2.1s1")
        .write(CID, "rand", 0, rnd).write(CID, "text", 0, text)
        .setattr(CID, "text", "hinfo", b'{"x": 1}')
        .omap_set(CID, "text", {"a": b"1", "b": b"2"}),
        Transaction().write(CID, "rand", 5000, text[:9000])
        .zero(CID, "text", 100, 50).truncate(CID, "rand", 17000)
        .write("pg_2.1s1", "x/y", 0, b"q" * 5000),
        Transaction().touch(CID, "gone").setattr(CID, "gone", "v", b"\x01")
        .omap_rm(CID, "text", ["a"]),
        Transaction().remove(CID, "gone").write(CID, "tail", 0, rnd[:300]),
    ]


def _contents(store) -> dict:
    out = {}
    for cid in store.list_collections():
        for oid in store.list_objects(cid):
            out[(cid, oid)] = (store.read(cid, oid), store.getattrs(cid, oid),
                               store.omap_get(cid, oid))
    return out


def _apply_all(store, txns) -> dict:
    store.mount()
    for t in txns:
        store.queue_transaction(t)
    got = _contents(store)
    store.umount()
    return got


def _db_entries(path: str) -> dict:
    db = FileDB(path)
    try:
        return dict(db.iterate(""))
    finally:
        db.close()


STORE_PAIRS = {"blockstore": (RefBlockStore, BlockStore),
               "kstore": (RefKStore, KStore)}
#: the compressors both packages register here: the python codecs and
#: the native snappy and lz4block (the lists are fixed, not read from the
#: registries while the module is imported, so every test worker
#: collects the same cases)
CODECS = ("bz2", "lz4block", "lzma", "snappy", "zlib", "zstd")
#: (store, csum type, compression) cells of the cross-mount: BlockStore
#: under every csum type and every compressor; KStore keeps no csum or
#: compression of its own
CROSS_CELLS = [("blockstore", c, "none")
               for c in ("crc32c", "xxhash32", "xxhash64", "none")] + \
    [("blockstore", "crc32c", a) for a in CODECS] + \
    [("kstore", "crc32c", "none")]


@pytest.mark.parametrize("kind,csum,comp", CROSS_CELLS)
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_mount_same_contents(writer, kind, csum, comp, tmp_path):
    """A directory the ``writer`` package wrote mounts under the other
    with the same bytes, attrs and omap; the same transactions leave the
    data file's raw bytes and the FileDB's entries equal in both."""
    ref_cls, port_cls = STORE_PAIRS[kind]
    first, second = (ref_cls, port_cls) if writer == "reference" \
        else (port_cls, ref_cls)
    d_mine, d_twin = str(tmp_path / "a"), str(tmp_path / "b")
    with _both_confs(bluestore_csum_type=csum,
                     bluestore_compression_algorithm=comp,
                     bluestore_compression_min_blob_size=1024):
        written = _apply_all(first(d_mine), _txns(7))
        twin = _apply_all(second(d_twin), _txns(7))
        other = second(d_mine)
        other.mount()
        mounted = _contents(other)
        other.umount()
    assert len(written) == 4
    assert mounted == written
    assert twin == written
    db_sub = "db" if kind == "blockstore" else ""
    assert _db_entries(os.path.join(d_mine, db_sub)) == \
        _db_entries(os.path.join(d_twin, db_sub))
    if kind == "blockstore":
        with open(os.path.join(d_mine, "data"), "rb") as f1, \
                open(os.path.join(d_twin, "data"), "rb") as f2:
            assert f1.read() == f2.read()


def test_cross_mount_reads_reference_bit_flip(tmp_path):
    """A silent flip the reference injected (blob repointed at a matching
    csum, a compressed blob restored raw) reads back under the port as
    the same rot, with no EIO."""
    path = str(tmp_path / "bs")
    with _both_confs(bluestore_compression_algorithm="zlib",
                     bluestore_compression_min_blob_size=1024):
        ref = RefBlockStore(path)
        ref.mount()
        ref.queue_transaction(Transaction().create_collection(CID)
                              .write(CID, "o", 0, b"Z" * 8192))
        ref.inject_bit_flip(CID, "o", offset=4000, length=3)
        want = ref.read(CID, "o")
        ref.umount()
    assert want[4000:4003] == bytes(b ^ 0xFF for b in b"ZZZ")
    port = BlockStore(path)
    port.mount()
    try:
        assert port.read(CID, "o") == want
    finally:
        port.umount()


# -- the native library, the data-file engine, the compressor -------------

@pytest.mark.parametrize("length", (0, 1, 7, 8, 31, 32, 33, 4095, 4096,
                                    4097, 128 << 10, (1 << 20) + 3))
def test_native_checksums_match_reference_and_plain(length):
    x = np.random.default_rng(length).integers(0, 256, length,
                                               dtype=np.uint8)
    raw = x.tobytes()
    for seed in (0, 0xFFFFFFFF, 0x1234):
        want = ref_checksum.crc32c(raw, seed)
        assert checksum.crc32c(raw, seed) == want
        assert checksum.crc32c(x, seed) == want
        assert checksum.crc32c_plain(x, seed) == want
        if length <= 4097:
            assert checksum.crc32c_sw(x, seed) == want
        assert checksum.xxhash32(raw, seed) == \
            ref_checksum.xxhash32(raw, seed)
        assert checksum.xxhash64(raw, seed) == \
            ref_checksum.xxhash64(raw, seed)
    assert checksum.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("algorithm", sorted(checksum.ALGORITHMS))
def test_checksummer_matches_reference(algorithm):
    data = np.random.default_rng(5).integers(0, 256, 10000, dtype=np.uint8)
    mine = checksum.Checksummer(algorithm, 4096)
    ref = ref_checksum.Checksummer(algorithm, 4096)
    csums = mine.calculate(data)
    assert csums == ref.calculate(data)
    assert mine.width == ref.width
    assert mine.verify(data, csums) == -1
    bad = data.copy()
    bad[5000] ^= 1
    assert mine.verify(bad, csums) == ref.verify(bad, csums) == 4096


def test_native_data_file_matches_python_twin(tmp_path):
    """The native engine and its python twin write the same file, and
    the native engine's one-pass crc is the host crc32c of the blob."""
    blobs = [os.urandom(n) for n in (1, 4096, 100000, 3)]
    nat = native_io.NativeDataFile.open(str(tmp_path / "n"))
    py = blockstore._PyDataFile(str(tmp_path / "p"))
    try:
        for blob in blobs:
            off_n, crc = nat.append(blob)
            off_p, none = py.append(blob)
            assert off_n == off_p and none is None
            assert crc == checksum.crc32c(blob)
            assert nat.read(off_n, len(blob)) == (blob, crc)
            assert py.read(off_p, len(blob))[0] == blob
        nat.sync()
        py.sync()
        assert nat.size() == py.size() == sum(map(len, blobs))
    finally:
        nat.close()
        py.close()
    assert (tmp_path / "n").read_bytes() == (tmp_path / "p").read_bytes()


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No numpy fallback: a compiler that fails raises, and a store whose
    native engine cannot load refuses to mount."""
    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(native_loader.NativeBuildError):
        native_loader._build(tmp_path / "lib.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native_loader.NativeBuildError):
        native_loader._build(tmp_path / "lib.so")

    def broken():
        raise native_loader.NativeBuildError("g++: exit 1")

    monkeypatch.setattr(native_io, "get_lib", broken)
    with pytest.raises(native_loader.NativeBuildError):
        BlockStore(str(tmp_path / "bs")).mount()


@pytest.mark.parametrize("name", CODECS)
def test_compressor_matches_reference(name):
    from ceph_tpu.compressor import Compressor as RefCompressor
    rng = np.random.default_rng(3)
    payloads = [b"", b"x", rng.integers(0, 256, 5000,
                                        dtype=np.uint8).tobytes(),
                b"ceph " * 20000 + rng.integers(0, 4, 3000,
                                                dtype=np.uint8).tobytes()]
    for data in payloads:
        packed = Compressor.create(name).compress(data)
        assert packed == RefCompressor.create(name).compress(data)
        assert Compressor.create(name).decompress(packed) == data


def test_compressor_registers_the_codecs():
    from ceph_tpu.compressor import registry as ref_registry
    assert set(CODECS) <= set(registry().plugins())
    assert set(CODECS) <= set(ref_registry().plugins())


# -- a whole cluster restarts from disk ----------------------------------

def test_cluster_restart_from_disk(tmp_path):
    """Stop every OSD, then boot a fresh cluster over the same BlockStore
    directories: all acked data survives (the reference's
    tests/test_durability.py:16)."""
    data_dir = str(tmp_path)
    rng = np.random.default_rng(16)
    blobs = {f"o{i}": rng.integers(0, 256, 30_000 + i,
                                   dtype=np.uint8).tobytes()
             for i in range(6)}

    def pools(c):
        c.create_ec_pool("dur", k=2, m=1, pg_num=2)
        c.create_pool("durrep", pg_num=2, size=3)
        rados = c.client()
        return rados.open_ioctx("dur"), rados.open_ioctx("durrep")

    with MiniCluster(n_osds=3, store="blockstore", data_dir=data_dir) as c1:
        io_ec, io_rep = pools(c1)
        for oid, blob in blobs.items():
            io_ec.write_full(oid, blob)
            io_rep.write_full(oid, blob)
        io_ec.write("o0", b"PATCH", offset=1000)
    with MiniCluster(n_osds=3, store="blockstore", data_dir=data_dir) as c2:
        io_ec, io_rep = pools(c2)
        expect0 = bytearray(blobs["o0"])
        expect0[1000:1005] = b"PATCH"
        assert io_ec.read("o0") == bytes(expect0)
        for oid, blob in blobs.items():
            if oid != "o0":
                assert io_ec.read(oid) == blob, f"ec/{oid}"
            assert io_rep.read(oid) == blob, f"rep/{oid}"
        assert c2.scrub_pool("dur", repair=False)["inconsistent"] == {}


# -- objectstore_tool ----------------------------------------------------

def _tool(module, capsysbinary, *argv) -> tuple[int, bytes, bytes]:
    rc = module.main(list(argv))
    out = capsysbinary.readouterr()
    return rc, out.out, out.err


def test_objectstore_tool_matches_reference(tmp_path, capsysbinary):
    """Every op of the port's tool against the reference tool on the same
    (stopped) BlockStore directory: equal exit codes, output and export
    files; each package's writes read back under the other."""
    path = str(tmp_path / "osd")
    s = RefBlockStore(path)
    s.mount()
    for t in _txns(9):
        s.queue_transaction(t)
    s.umount()
    tools = {"ref": ref_tool, "port": objectstore_tool}

    def both(*argv):
        got = {name: _tool(mod, capsysbinary, "--data-path", path, *argv)
               for name, mod in tools.items()}
        assert got["port"] == got["ref"], argv
        return got["port"]

    assert json.loads(both("list")[1]) == [CID, "pg_2.1s1"]
    both("list", "--cid", CID)
    info = json.loads(both("info", "--cid", CID, "--oid", "text")[1])
    assert info["omap"] == {"b": "Mg=="}
    assert both("get-bytes", "--cid", CID, "--oid", "rand")[0] == 0
    assert both("fsck")[0] == 0
    for name, mod in tools.items():
        f = str(tmp_path / f"{name}.export")
        assert _tool(mod, capsysbinary, "--data-path", path, "export",
                     "--cid", CID, "--file", f)[0] == 0
    assert (tmp_path / "ref.export").read_bytes() == \
        (tmp_path / "port.export").read_bytes()
    # the port writes, the reference reads back (and the reverse)
    for writer, reader in (("port", "ref"), ("ref", "port")):
        blob = tmp_path / f"{writer}.bin"
        blob.write_bytes(os.urandom(3000))
        assert _tool(tools[writer], capsysbinary, "--data-path", path,
                     "set-bytes", "--cid", CID, "--oid", writer,
                     "--file", str(blob))[0] == 0
        assert _tool(tools[reader], capsysbinary, "--data-path", path,
                     "get-bytes", "--cid", CID, "--oid", writer)[1] == \
            blob.read_bytes()
        assert _tool(tools[writer], capsysbinary, "--data-path", path,
                     "rm", "--cid", CID, "--oid", writer)[0] == 0
    both("list", "--cid", CID)
    # import into a fresh directory, then a second import refuses
    fresh = str(tmp_path / "fresh")
    for name, mod in tools.items():
        d = f"{fresh}-{name}"
        assert _tool(mod, capsysbinary, "--data-path", d, "import",
                     "--file", str(tmp_path / "ref.export"))[0] == 0
        assert _tool(mod, capsysbinary, "--data-path", d, "import",
                     "--file", str(tmp_path / "ref.export"))[0] == 17
    assert _db_entries(f"{fresh}-ref/db") == _db_entries(f"{fresh}-port/db")
    # silent rot the blob csum sees: fsck reports it in both
    with open(os.path.join(path, "data"), "r+b") as f:
        f.seek(10)
        b = f.read(1)
        f.seek(10)
        f.write(bytes([b[0] ^ 0xFF]))
    rc, out, _err = both("fsck")
    assert rc == 1 and json.loads(out)["errors"]
