"""BlockStore — durable log-structured object store (BlueStore role).

Reference: src/os/bluestore/. Same commit discipline, simplified
geometry: object payloads append to a single data blob file, metadata
(attrs/omap/size/extent map) lives in the WAL-backed kv (store/kv.py —
the RocksDB seat). Commit order per transaction, as in BlueStore's txc
state machine (BlueStore.cc:9037):

  1. append write payloads to the data file, fdatasync;
  2. commit one kv batch with all metadata updates (kv WAL fsync);
  3. fire on_commit.

A crash between 1 and 2 leaks dead bytes at the data-file tail but
never exposes a partial transaction — the kv batch is the atomicity
point. Checksums are at blob granularity exactly like BlueStore's
csum_type=crc32c default (BlueStore.h:1925): each written blob carries
its crc32c; any read of any slice re-reads the whole blob and verifies
(_verify_csum role, BlueStore.cc:8061) raising EIOError on mismatch —
the trigger for EC repair upstream.

Port of ``ceph_tpu/store/blockstore.py``: the same data file, kv keys and
extent encoding, so a directory written by either package mounts under
the other with the same bytes, attrs and omap. The data file runs on the
native engine (``store/native_io.py``) or the mount raises;
:class:`_PyDataFile` stays as its plain twin for the tests.
"""

from __future__ import annotations

import os
from typing import Callable

from ceph_tpu_torch.store import object_store as osr
from ceph_tpu_torch.store.kv import FileDB, WriteBatch
from ceph_tpu_torch.store.object_store import (
    EIOError,
    NoSuchCollection,
    NoSuchObject,
    ObjectStore,
    Transaction,
)
from ceph_tpu_torch.utils import checksum
from ceph_tpu_torch.utils import tracepoints as _tracepoints
from ceph_tpu_torch.utils.encoding import Decoder, Encoder
from ceph_tpu_torch.analysis.lock_witness import make_lock

_TP_QUEUE_TXN = _tracepoints.provider("objectstore").point(
    "queue_transaction", "ops")

#: on-disk compressor ids (bluestore_compression_algorithm role); the
#: id is stored per blob so config changes never orphan old blobs
COMP_NONE = 0
_COMP_ALGS = {1: "zlib", 2: "zstd", 3: "bz2", 4: "lzma", 5: "lz4",
              6: "snappy", 7: "lz4block"}
_COMP_IDS = {v: k for k, v in _COMP_ALGS.items()}

#: blob checksum algorithms (Checksummer.h:11-19 role); id rides the
#: extent so csum_type config changes never orphan old blobs. id 0 =
#: crc32c (the pre-existing default encoding).
_CSUM_FNS = {
    0: lambda d: checksum.crc32c(d),
    1: lambda d: checksum.xxhash32(d),
    2: lambda d: checksum.xxhash64(d) & 0xFFFFFFFF,
    3: lambda d: 0,                    # "none"
}
_CSUM_IDS = {"crc32c": 0, "xxhash32": 1, "xxhash64": 2, "none": 3,
             "crc32c_16": 0, "crc32c_8": 0}


class _Extent:
    """A logical range backed by a slice of a crc-protected blob in the
    data file (BlueStore's lextent -> blob indirection). ``blob_len``
    is the blob's UNcompressed length (slice space); ``disk_len`` the
    stored bytes; ``comp`` the compressor id (0 = stored raw)."""

    __slots__ = ("logical_off", "length", "blob_off", "blob_len",
                 "blob_crc", "slice_off", "disk_len", "comp", "csum")

    def __init__(self, logical_off: int, length: int, blob_off: int,
                 blob_len: int, blob_crc: int, slice_off: int,
                 disk_len: int | None = None,
                 comp: int = COMP_NONE, csum: int = 0) -> None:
        self.logical_off = logical_off
        self.length = length
        self.blob_off = blob_off      # file offset of the whole blob
        self.blob_len = blob_len
        self.blob_crc = blob_crc      # checksum of the STORED bytes
        self.slice_off = slice_off    # this extent's start within the blob
        self.disk_len = blob_len if disk_len is None else disk_len
        self.comp = comp
        self.csum = csum              # _CSUM_FNS id used for blob_crc

    @property
    def end(self) -> int:
        return self.logical_off + self.length


class _Meta:
    __slots__ = ("size", "attrs", "omap", "extents")

    def __init__(self) -> None:
        self.size = 0
        self.attrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}
        self.extents: list[_Extent] = []   # sorted, non-overlapping

    def encode(self) -> bytes:
        e = Encoder()
        e.u64(self.size)
        e.map(self.attrs, Encoder.str, Encoder.bytes)
        e.map(self.omap, Encoder.str, Encoder.bytes)
        e.list(self.extents, lambda en, x: (
            en.u64(x.logical_off), en.u64(x.length), en.u64(x.blob_off),
            en.u64(x.blob_len), en.u32(x.blob_crc), en.u64(x.slice_off),
            en.u64(x.disk_len), en.u8(x.comp), en.u8(x.csum)))
        return e.getvalue()

    @classmethod
    def decode(cls, buf: bytes) -> "_Meta":
        d = Decoder(buf)
        m = cls()
        m.size = d.u64()
        m.attrs = d.map(Decoder.str, Decoder.bytes)
        m.omap = d.map(Decoder.str, Decoder.bytes)
        m.extents = d.list(lambda dd: _Extent(
            dd.u64(), dd.u64(), dd.u64(), dd.u64(), dd.u32(), dd.u64(),
            dd.u64(), dd.u8(), dd.u8()))
        return m


def _clip(extents: list[_Extent], a: int, b: int) -> list[_Extent]:
    """Remove logical range [a, b) from the extent list, splitting
    extents that straddle the boundary (slices keep pointing into their
    original crc'd blob)."""
    out: list[_Extent] = []
    for x in extents:
        if x.end <= a or x.logical_off >= b:
            out.append(x)
            continue
        if x.logical_off < a:
            out.append(_Extent(x.logical_off, a - x.logical_off,
                               x.blob_off, x.blob_len, x.blob_crc,
                               x.slice_off, x.disk_len, x.comp,
                               x.csum))
        if x.end > b:
            cut = b - x.logical_off
            out.append(_Extent(b, x.end - b, x.blob_off, x.blob_len,
                               x.blob_crc, x.slice_off + cut,
                               x.disk_len, x.comp, x.csum))
    return out


class _PyDataFile:
    """Pure-python twin of store/native_io.NativeDataFile (same raw
    concatenated-blob format; returns None for crc so callers hash
    via the configured csum fn). The plain version the tests hold the
    native engine against; the mount never falls back to it."""

    def __init__(self, path: str) -> None:
        # unbuffered: appends hit the fd directly, so concurrent preads
        # never observe a python-level buffer, and there is no shared
        # seek position between readers (os.pread is positionless)
        self._f = open(path, "a+b", buffering=0)

    def size(self) -> int:
        return os.fstat(self._f.fileno()).st_size

    def append(self, data: bytes):
        # O_APPEND ("a" mode) writes at EOF atomically; the returned
        # offset is only meaningful under the store's append lock,
        # which serializes the size probe with the write. Unbuffered
        # FileIO.write can return short (e.g. ENOSPC mid-blob) —
        # loop to completion or raise, mirroring ioeng_append
        off = os.fstat(self._f.fileno()).st_size
        view = memoryview(data)
        while view:
            n = self._f.write(view)
            if not n:
                raise OSError("short write appending blob")
            view = view[n:]
        return off, None

    def read(self, off: int, length: int):
        return os.pread(self._f.fileno(), length, off), None

    def sync(self) -> None:
        from ceph_tpu_torch.utils import store_telemetry
        store_telemetry.timed_fdatasync(self._f.fileno(),
                                        site="blockstore.data")

    def close(self) -> None:
        self._f.close()


class BlockStore(ObjectStore):
    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._db: FileDB | None = None
        self._data = None
        self._eio: set[tuple[str, str]] = set()
        # serializes the append stage: the data engines derive each
        # blob's offset from the current file size, so two concurrent
        # queue_transaction calls (different PGs on different op-shard
        # threads) must not interleave size-probe and write — they
        # would record the same offset for different blobs
        self._append_lock = make_lock("blockstore.append")
        self._parked = osr._ParkedCompletions("blockstore.parked")
        # leader-follower barrier coalescing (ROADMAP 1a): concurrent
        # commits share fsync rounds instead of each paying its own;
        # the hot-leader dwell window is cached at mount
        self._shared = osr._SharedBarrier("blockstore.barrier")
        self._barrier_window_s = 0.0

    # -- lifecycle ----------------------------------------------------
    def mount(self) -> None:
        from ceph_tpu_torch.utils.config import g_conf
        self._barrier_window_s = \
            g_conf()["store_barrier_window_ms"] / 1e3
        self._db = FileDB(os.path.join(self.path, "db"))
        data_path = os.path.join(self.path, "data")
        # native data-plane engine (KernelDevice/aio role: one-pass
        # append+crc32c, lock-free pread); a library that cannot be
        # built raises here, no python engine stands in
        from ceph_tpu_torch.store.native_io import NativeDataFile
        data = NativeDataFile.open(data_path)
        with self._append_lock:
            self._data = data

    def umount(self) -> None:
        if self._db:
            self._db.close()
            self._db = None
        # serialize against in-flight appends (the engine-shutdown
        # race class): an appender either finishes before the close
        # or sees _data already gone
        with self._append_lock:
            data, self._data = self._data, None
        if data:
            data.close()

    # -- metadata helpers ---------------------------------------------
    @staticmethod
    def _okey(cid: str, oid: str) -> str:
        return f"o/{cid}/{oid}"

    @staticmethod
    def _ckey(cid: str) -> str:
        return f"c/{cid}"

    def _require_coll(self, cid: str) -> None:
        if self._db.get(self._ckey(cid)) is None:
            raise NoSuchCollection(cid)

    def _meta(self, cid: str, oid: str) -> _Meta:
        raw = self._db.get(self._okey(cid, oid))
        if raw is None:
            self._require_coll(cid)
            raise NoSuchObject(f"{cid}/{oid}")
        return _Meta.decode(raw)

    # -- transactions -------------------------------------------------
    def queue_transaction(self, txn: Transaction,
                          on_commit: Callable[[], None] | None = None) -> None:
        assert self._db is not None, "not mounted"
        from ceph_tpu_torch.utils import store_telemetry
        tmr = store_telemetry.telemetry().txn_timer(
            "blockstore", id(self))
        tmr.n_ops = len(txn)
        with tmr:
            if osr.group_commit_enabled():
                # barriers ride the shared leader-follower rounds:
                # an idle store syncs immediately; concurrent commits
                # coalesce onto one fsync set (the page-cache WAL
                # write precedes the data barrier inside a round —
                # the same OS-crash-only ordering note as the
                # deferred group path)
                self._queue_transaction_timed(txn, tmr, sync=False)
                self._shared.sync(self._sync_all,
                                  self._barrier_window_s)
            else:
                self._queue_transaction_timed(txn, tmr)
            tmr.run_on_commit(on_commit)

    def queue_transaction_group(self, pairs: list,
                                defer: bool = False) -> None:
        """Group commit (ROADMAP 1a): the flush group's writes append
        in one pass under one append-lock hold, pay ONE data-file
        fdatasync, build ONE metadata kv batch = ONE WAL append + ONE
        kv.wal fsync — instead of a barrier set per txn. ``defer``
        parks both barriers and the completion sweep for
        :meth:`barrier` (the cross-thread leg: the deferred WAL
        record is page-cache-written before the data barrier, so the
        data-before-wal *barrier* order still holds at the shared
        :meth:`barrier`; the exposure window narrows the crash
        contract to OS-crash page reordering, same class as the
        reference's deferred writes)."""
        assert self._db is not None, "not mounted"
        if not pairs:
            return
        from ceph_tpu_torch.utils import store_telemetry
        tmr = store_telemetry.telemetry().txn_timer(
            "blockstore", id(self))
        merged = Transaction()
        for txn, _ in pairs:
            merged.ops.extend(txn.ops)
        tmr.n_ops = len(merged)
        tmr.n_txns = len(pairs)
        with tmr:
            data_dirty = self._queue_transaction_timed(
                merged, tmr, sync=False)
            if defer:
                self._parked.park([cb for _, cb in pairs],
                                  dirty=data_dirty)
            else:
                self._shared.sync(self._sync_all,
                                  self._barrier_window_s)
                tmr.run_on_commit_sweep([cb for _, cb in pairs])

    def _sync_all(self) -> None:
        """One barrier round: the data-file fdatasync then the WAL
        fsync — the same data-before-wal barrier order as the inline
        path, paid once per leader-follower round."""
        data = self._data
        if data is not None:
            data.sync()
        if self._db is not None:
            self._db.sync()

    def barrier(self) -> None:
        """The shared deferred barrier: one barrier round covering
        every ``defer=True`` group parked so far, then the completion
        sweep in submission order. Runs lock-free (the fsyncs must
        never sit under the append lock or a PG lock)."""
        from ceph_tpu_torch.utils import store_telemetry
        cbs, dirty = self._parked.take()
        if not cbs and not dirty:
            return
        self._shared.sync(self._sync_all, self._barrier_window_s)
        store_telemetry.sweep_completions(cbs)

    def barrier_pending(self) -> bool:
        return bool(self._parked)

    def _queue_transaction_timed(self, txn: Transaction, tmr,
                                 sync: bool = True) -> bool:
        _TP_QUEUE_TXN(len(txn))
        # stage 1: data-file appends for every WRITE op; blobs compress
        # when the configured algorithm saves enough
        # (bluestore_compression_* semantics)
        comp_alg, comp_min, comp_ratio = self._comp_config()
        from ceph_tpu_torch.utils.config import g_conf
        csum_id = _CSUM_IDS.get(g_conf()["bluestore_csum_type"], 0)
        csum_fn = _CSUM_FNS[csum_id]
        data_dirty = False
        # op idx -> (file_off, raw_len, disk_len, csum, comp_id, csum_id)
        blob_at: dict[int, tuple[int, int, int, int, int, int]] = {}
        # compress and hash outside the lock (CPU-bound), append inside
        # it: the engines derive blob offsets from file size, so
        # interleaved appends from two op-shard threads would alias
        # offsets. The native engine still computes crc32c in its own
        # single pass over the hot buffer (inside the lock, but that
        # pass IS the write path); only non-crc32c types / the python
        # engine need the explicit hash, done here.
        native = not isinstance(self._data, _PyDataFile)
        staged: list[tuple[int, bytes, bytes, int, int | None]] = []
        with tmr.stage("apply"):
            for i, op in enumerate(txn.ops):
                if op[0] == osr.OP_WRITE:
                    payload = op[4]
                    stored, comp_id = payload, COMP_NONE
                    if comp_alg is not None and \
                            len(payload) >= comp_min:
                        packed = comp_alg.compress(payload)
                        if len(packed) <= len(payload) * comp_ratio:
                            stored = packed
                            comp_id = _COMP_IDS[comp_alg.name]
                    pre = None if (csum_id == 0 and native) \
                        else csum_fn(stored)
                    staged.append((i, payload, bytes(stored), comp_id,
                                   pre))
        if staged:
            t0 = tmr.now()
            with self._append_lock:
                tmr.mark_wait("queue_wait", t0)
                with tmr.stage("apply"):
                    for i, payload, stored, comp_id, pre in staged:
                        file_off, ncrc = self._data.append(stored)
                        csum = pre if pre is not None else ncrc
                        blob_at[i] = (file_off, len(payload),
                                      len(stored), csum, comp_id,
                                      csum_id)
            data_dirty = True
        if data_dirty and sync:
            # the data-file barrier: both engines route their
            # fdatasync through the timed seam (site blockstore.data)
            self._data.sync()

        # stage 2: one kv batch for all metadata effects
        batch = WriteBatch()
        metas: dict[tuple[str, str], _Meta | None] = {}

        def load(cid: str, oid: str, create: bool) -> _Meta:
            key = (cid, oid)
            if key in metas and metas[key] is None:
                # removed earlier in this txn: recreate fresh or fail
                if not create:
                    raise NoSuchObject(f"{cid}/{oid}")
                metas[key] = _Meta()
            if key not in metas:
                raw = self._db.get(self._okey(cid, oid))
                if raw is not None:
                    metas[key] = _Meta.decode(raw)
                elif create:
                    # collection must exist (created earlier in this txn
                    # or already present)
                    if self._db.get(self._ckey(cid)) is None and \
                            not any(o[0] == osr.OP_MKCOLL and o[1] == cid
                                    for o in txn.ops):
                        raise NoSuchCollection(cid)
                    metas[key] = _Meta()
                else:
                    raise NoSuchObject(f"{cid}/{oid}")
            return metas[key]

        t_kv = tmr.now()
        for i, op in enumerate(txn.ops):
            code = op[0]
            if code == osr.OP_MKCOLL:
                batch.put(self._ckey(op[1]), b"")
            elif code == osr.OP_RMCOLL:
                batch.delete(self._ckey(op[1]))
                for k, _ in list(self._db.iterate(f"o/{op[1]}/")):
                    batch.delete(k)
                # objects staged earlier in this txn must not be re-put
                # by the final metas flush after this delete
                for key in list(metas):
                    if key[0] == op[1]:
                        metas[key] = None
            elif code == osr.OP_TOUCH:
                load(op[1], op[2], create=True)
            elif code == osr.OP_WRITE:
                m = load(op[1], op[2], create=True)
                off, payload = op[3], op[4]
                foff, raw_len, disk_len, fcrc, comp_id, cs_id = \
                    blob_at[i]
                m.extents = _clip(m.extents, off, off + raw_len)
                m.extents.append(_Extent(off, raw_len, foff, raw_len,
                                         fcrc, 0, disk_len, comp_id,
                                         cs_id))
                m.extents.sort(key=lambda x: x.logical_off)
                m.size = max(m.size, off + raw_len)
            elif code == osr.OP_ZERO:
                m = load(op[1], op[2], create=True)
                off, ln = op[3], op[4]
                m.extents = _clip(m.extents, off, off + ln)
                m.size = max(m.size, off + ln)
            elif code == osr.OP_TRUNCATE:
                m = load(op[1], op[2], create=True)
                size = op[3]
                m.extents = _clip(m.extents, size, 1 << 62)
                m.size = size
            elif code == osr.OP_REMOVE:
                metas[(op[1], op[2])] = None
                batch.delete(self._okey(op[1], op[2]))
                # a rewrite replaces the data; injected/latent read
                # errors do not survive it
                self._eio.discard((op[1], op[2]))
            elif code == osr.OP_SETATTR:
                load(op[1], op[2], create=True).attrs[op[3]] = op[4]
            elif code == osr.OP_RMATTR:
                load(op[1], op[2], create=False).attrs.pop(op[3], None)
            elif code == osr.OP_OMAP_SET:
                load(op[1], op[2], create=True).omap.update(op[3])
            elif code == osr.OP_OMAP_RM:
                m = load(op[1], op[2], create=False)
                for k in op[3]:
                    m.omap.pop(k, None)
            elif code == osr.OP_OMAP_RMRANGE:
                m = load(op[1], op[2], create=True)
                for k in [k for k in m.omap if k.startswith(op[3])]:
                    del m.omap[k]
        for (cid, oid), m in metas.items():
            if m is not None:
                batch.put(self._okey(cid, oid), m.encode())
        tmr.add("kv_build", tmr.now() - t_kv)
        # FileDB.submit lands wal_append + the kv.wal fsync on this
        # txn's timer — the atomicity point's own decomposition
        # (sync=False defers the fsync to the group's shared barrier)
        self._db.submit(batch, sync=sync)
        return data_dirty

    # -- reads --------------------------------------------------------
    @staticmethod
    def _comp_config():
        """(Compressor|None, min_blob_size, required_ratio) from config."""
        from ceph_tpu_torch.utils.config import g_conf
        name = g_conf()["bluestore_compression_algorithm"]
        if name == "none":
            return None, 0, 1.0
        from ceph_tpu_torch.compressor import CompressionError, Compressor
        try:
            comp = Compressor.create(name)
        except CompressionError:
            return None, 0, 1.0
        return (comp, g_conf()["bluestore_compression_min_blob_size"],
                g_conf()["bluestore_compression_required_ratio"])

    def _read_blob(self, x: _Extent) -> bytes:
        blob, ncrc = self._data.read(x.blob_off, x.disk_len)
        got = ncrc if (x.csum == 0 and ncrc is not None) \
            else _CSUM_FNS[x.csum](blob)
        if len(blob) != x.disk_len or got != x.blob_crc:
            raise EIOError(
                f"checksum mismatch reading blob at {x.blob_off}")
        if x.comp != COMP_NONE:
            from ceph_tpu_torch.compressor import Compressor
            try:
                blob = Compressor.create(
                    _COMP_ALGS[x.comp]).decompress(blob)
            except Exception as exc:
                # legacy id-5 blobs: before 'lz4block' got its own id,
                # environments without python-lz4 wrote the native
                # BLOCK framing under id 5. The frame format opens
                # with magic 0x184D2204, so a block blob reliably
                # fails frame decode (or 'lz4' is unregistered) —
                # retry it as lz4block instead of going EIO.
                if x.comp != _COMP_IDS.get("lz4"):
                    raise
                try:
                    blob = Compressor.create("lz4block").decompress(
                        blob)
                except Exception:
                    raise exc
            if len(blob) != x.blob_len:
                raise EIOError(
                    f"decompressed blob at {x.blob_off} has wrong size")
        return blob

    def read(self, cid: str, oid: str, off: int = 0,
             length: int | None = None) -> bytes:
        from ceph_tpu_torch.utils import faults as _faults
        if _faults.check_store_read(cid, oid):
            raise EIOError(f"injected fault EIO on {cid}/{oid}")
        if (cid, oid) in self._eio:
            raise EIOError(f"injected EIO on {cid}/{oid}")
        m = self._meta(cid, oid)
        end = m.size if length is None else min(off + length, m.size)
        if end <= off:
            return b""
        buf = bytearray(end - off)  # holes read as zeros
        for x in m.extents:
            lo, hi = max(x.logical_off, off), min(x.end, end)
            if lo >= hi:
                continue
            blob = self._read_blob(x)
            s = x.slice_off + (lo - x.logical_off)
            buf[lo - off:hi - off] = blob[s:s + (hi - lo)]
        return bytes(buf)

    def stat(self, cid: str, oid: str) -> int:
        return self._meta(cid, oid).size

    def getattr(self, cid: str, oid: str, name: str) -> bytes:
        attrs = self._meta(cid, oid).attrs
        if name not in attrs:
            raise NoSuchObject(f"attr {name} on {cid}/{oid}")
        return attrs[name]

    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]:
        return dict(self._meta(cid, oid).attrs)

    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        return dict(self._meta(cid, oid).omap)

    def list_collections(self) -> list[str]:
        return [k[2:] for k, _ in self._db.iterate("c/")]

    def list_objects(self, cid: str) -> list[str]:
        self._require_coll(cid)
        prefix = f"o/{cid}/"
        return [k[len(prefix):] for k, _ in self._db.iterate(prefix)]

    # -- fault injection ----------------------------------------------
    def inject_data_error(self, cid: str, oid: str) -> None:
        self._eio.add((cid, oid))

    def clear_data_error(self, cid: str, oid: str) -> None:
        self._eio.discard((cid, oid))

    def inject_bit_flip(self, cid: str, oid: str, offset: int = 0,
                        length: int = 4) -> None:
        """Silent corruption: flip stored bytes of the blob backing
        logical ``offset`` and repoint the extent at a blob whose
        checksum MATCHES the flipped bytes — the store's blob csum
        cannot see it (the csum-collision / below-the-checksum rot
        class), so reads return rot with no EIO. That is exactly the
        corruption only the deep-scrub parity/crc pass catches."""
        m = self._meta(cid, oid)
        changed = False
        for x in m.extents:
            lo = max(x.logical_off, offset)
            hi = min(x.end, offset + length)
            if lo >= hi:
                continue
            if x.comp != COMP_NONE:
                # flipping compressed bytes would fail decompression
                # loudly, not silently; decompress, flip, restore raw
                blob = bytearray(self._read_blob(x))
                comp = COMP_NONE
            else:
                raw, _ = self._data.read(x.blob_off, x.disk_len)
                blob = bytearray(raw)
                comp = x.comp
            s = x.slice_off + (lo - x.logical_off)
            blob[s:s + (hi - lo)] = bytes(b ^ 0xFF
                                          for b in blob[s:s + (hi - lo)])
            with self._append_lock:
                file_off, ncrc = self._data.append(bytes(blob))
            self._data.sync()
            x.blob_off = file_off
            x.blob_len = len(blob)
            x.disk_len = len(blob)
            x.comp = comp
            x.blob_crc = ncrc if (x.csum == 0 and ncrc is not None) \
                else _CSUM_FNS[x.csum](bytes(blob))
            changed = True
        if changed:
            batch = WriteBatch()
            batch.put(self._okey(cid, oid), m.encode())
            self._db.submit(batch, sync=True)
