"""KStore — object store entirely inside the key-value DB.

Role of src/os/kstore/: everything (data, attrs, omap) lives as kv
records — no separate data file or allocator. Simpler and slower than
BlueStore for big objects, but a distinct durability/layout point the
reference ships; here it exercises the same ``KeyValueDB`` the
blockstore uses for metadata (src/kv/ role), with object data chunked
into fixed-size stripe records (kstore_default_stripe_size).

Key layout (all under one namespace per collection):
    C/<cid>                      collection marker
    O/<cid>/<oid>                object meta {size}
    D/<cid>/<oid>/<n:08x>        data stripe n
    A/<cid>/<oid>/<name>         attr
    M/<cid>/<oid>/<key>          omap
cid/oid are %%-escaped ('%%' then '/'): an oid containing '/' (rgw
names objects "<bucket>/<key>") must not make one object's prefix a
prefix of a sibling's, or prefix delete/iterate would cross objects.

Port of ``ceph_tpu/store/kstore.py``, same keys and records, so a
directory written by either package mounts under the other.
"""

from __future__ import annotations

import json
from typing import Callable

from ceph_tpu_torch.store import object_store as osr
from ceph_tpu_torch.store.kv import FileDB, MemDB, WriteBatch
from ceph_tpu_torch.store.object_store import (
    EIOError,
    NoSuchCollection,
    NoSuchObject,
    ObjectStore,
    Transaction,
)
from ceph_tpu_torch.analysis.lock_witness import make_rlock

#: data stripe record size (kstore_default_stripe_size is 64K in the
#: reference; smaller here keeps partial-write RMW cheap in tests)
STRIPE = 65536


class KStore(ObjectStore):
    def __init__(self, path: str | None = None) -> None:
        self._path = path
        self._db = None
        self._lock = make_rlock("kstore.db")
        self._eio: set[tuple[str, str]] = set()
        self._parked = osr._ParkedCompletions("kstore.parked")
        self._shared = osr._SharedBarrier("kstore.barrier")
        self._barrier_window_s = 0.0

    # -- lifecycle ----------------------------------------------------
    def mount(self) -> None:
        from ceph_tpu_torch.utils.config import g_conf
        self._barrier_window_s = \
            g_conf()["store_barrier_window_ms"] / 1e3
        with self._lock:
            self._db = FileDB(self._path) if self._path else MemDB()

    def umount(self) -> None:
        with self._lock:
            if self._db is not None:
                self._db.close()
                self._db = None

    # -- key helpers --------------------------------------------------
    @staticmethod
    def _esc(part: str) -> str:
        return part.replace("%", "%25").replace("/", "%2F")

    @classmethod
    def _ckey(cls, cid: str) -> str:
        return f"C/{cls._esc(cid)}"

    @classmethod
    def _meta_key(cls, cid: str, oid: str) -> str:
        return f"O/{cls._esc(cid)}/{cls._esc(oid)}"

    @classmethod
    def _meta_prefix(cls, cid: str) -> str:
        return f"O/{cls._esc(cid)}/"

    @classmethod
    def _data_key(cls, cid: str, oid: str, n: int) -> str:
        return f"D/{cls._esc(cid)}/{cls._esc(oid)}/{n:08x}"

    @classmethod
    def _attr_prefix(cls, cid: str, oid: str) -> str:
        return f"A/{cls._esc(cid)}/{cls._esc(oid)}/"

    @classmethod
    def _omap_prefix(cls, cid: str, oid: str) -> str:
        return f"M/{cls._esc(cid)}/{cls._esc(oid)}/"

    def _meta(self, cid: str, oid: str) -> dict:
        if self._db.get(self._ckey(cid)) is None:
            raise NoSuchCollection(cid)
        raw = self._db.get(self._meta_key(cid, oid))
        if raw is None:
            raise NoSuchObject(f"{cid}/{oid}")
        return json.loads(raw)

    # -- transactions -------------------------------------------------
    def _validate(self, txn: Transaction) -> None:
        """All-or-nothing (memstore._validate semantics): reject the
        whole txn before staging anything. Point lookups only — a txn
        must not cost a scan of the whole keyspace."""
        made, gone = set(), set()            # txn-local deltas
        obj_made, obj_gone = set(), set()

        def coll_exists(cid: str) -> bool:
            if cid in made:
                return True
            if cid in gone:
                return False
            return self._db.get(self._ckey(cid)) is not None

        def obj_exists(cid: str, oid: str) -> bool:
            if (cid, oid) in obj_made:
                return True
            if (cid, oid) in obj_gone or cid in gone:
                return False
            return self._db.get(self._meta_key(cid, oid)) is not None

        for op in txn.ops:
            code = op[0]
            if code == osr.OP_MKCOLL:
                made.add(op[1])
                gone.discard(op[1])
            elif code == osr.OP_RMCOLL:
                gone.add(op[1])
                made.discard(op[1])
                obj_made = {k for k in obj_made if k[0] != op[1]}
            else:
                cid, oid = op[1], op[2]
                if not coll_exists(cid):
                    raise NoSuchCollection(cid)
                if code in (osr.OP_RMATTR, osr.OP_OMAP_RM) and \
                        not obj_exists(cid, oid):
                    raise NoSuchObject(f"{cid}/{oid}")
                if code == osr.OP_REMOVE:
                    obj_gone.add((cid, oid))
                    obj_made.discard((cid, oid))
                else:
                    obj_made.add((cid, oid))
                    obj_gone.discard((cid, oid))

    def queue_transaction(self, txn: Transaction,
                          on_commit: Callable[[], None] | None = None
                          ) -> None:
        assert self._db is not None, "not mounted"
        from ceph_tpu_torch.utils import store_telemetry
        tmr = store_telemetry.telemetry().txn_timer("kstore", id(self))
        tmr.n_ops = len(txn)
        with tmr:
            t0 = tmr.now()
            with self._lock:
                tmr.mark_wait("queue_wait", t0)
                with tmr.stage("apply"):
                    self._validate(txn)
                with tmr.stage("kv_build"):
                    batch = WriteBatch()
                    for op in txn.ops:
                        self._apply_op(batch, op)
                # FileDB.submit lands the wal_append on this txn's
                # timer (MemDB commits in RAM: free); the kv.wal
                # fsync is paid OUTSIDE the store lock below —
                # readers must not queue behind a durability barrier
                self._db.submit(batch, sync=False)
            if osr.group_commit_enabled():
                self._shared.sync(self._db.sync,
                                  self._barrier_window_s)
            else:
                self._db.sync()
            tmr.run_on_commit(on_commit)

    def queue_transaction_group(self, pairs: list,
                                defer: bool = False) -> None:
        """Group commit (ROADMAP 1a): the whole flush group builds
        ONE kv batch and pays ONE WAL append; the WAL fsync is issued
        OUTSIDE the store lock (one barrier for the group — and never
        under a lock the read path takes). ``defer`` parks barrier +
        completion sweep for :meth:`barrier`."""
        assert self._db is not None, "not mounted"
        if not pairs:
            return
        from ceph_tpu_torch.utils import store_telemetry
        tmr = store_telemetry.telemetry().txn_timer("kstore",
                                                    id(self))
        merged = Transaction()
        for txn, _ in pairs:
            merged.ops.extend(txn.ops)
        tmr.n_ops = len(merged)
        tmr.n_txns = len(pairs)
        with tmr:
            t0 = tmr.now()
            with self._lock:
                tmr.mark_wait("queue_wait", t0)
                with tmr.stage("apply"):
                    self._validate(merged)
                with tmr.stage("kv_build"):
                    batch = WriteBatch()
                    for op in merged.ops:
                        self._apply_op(batch, op)
                self._db.submit(batch, sync=False)
            if defer:
                self._parked.park([cb for _, cb in pairs],
                                  dirty=True)
            else:
                self._shared.sync(self._db.sync,
                                  self._barrier_window_s)
                tmr.run_on_commit_sweep([cb for _, cb in pairs])

    def barrier(self) -> None:
        from ceph_tpu_torch.utils import store_telemetry
        cbs, dirty = self._parked.take()
        if dirty and self._db is not None:
            self._shared.sync(self._db.sync,
                              self._barrier_window_s)
        store_telemetry.sweep_completions(cbs)

    def barrier_pending(self) -> bool:
        return bool(self._parked)

    def _apply_op(self, batch: WriteBatch, op: tuple) -> None:
        code = op[0]
        if code == osr.OP_MKCOLL:
            batch.put(self._ckey(op[1]), b"1")
        elif code == osr.OP_RMCOLL:
            cid = op[1]
            e = self._esc(cid)
            prefixes = (f"O/{e}/", f"D/{e}/", f"A/{e}/", f"M/{e}/")
            # earlier ops in THIS txn under the collection must not
            # survive (a same-txn ghost write would resurrect)
            batch.ops = [
                (kind, k, v) for kind, k, v in batch.ops
                if not (k == self._ckey(cid) or k.startswith(prefixes))]
            # per-prefix iteration: rmcoll must cost the collection's
            # keys, not the whole keyspace
            for prefix in prefixes:
                for key, _ in list(self._db.iterate(prefix)):
                    batch.delete(key)
            batch.delete(self._ckey(cid))
        elif code == osr.OP_TOUCH:
            self._ensure_obj(batch, op[1], op[2])
        elif code == osr.OP_WRITE:
            self._write(batch, op[1], op[2], op[3], op[4])
        elif code == osr.OP_ZERO:
            self._write(batch, op[1], op[2], op[3], b"\x00" * op[4])
        elif code == osr.OP_TRUNCATE:
            self._truncate(batch, op[1], op[2], op[3])
        elif code == osr.OP_REMOVE:
            cid, oid = op[1], op[2]
            meta = self._pending_get(batch, self._meta_key(cid, oid))
            if meta is not None:
                size = json.loads(meta)["size"]
                for n in range(-(-size // STRIPE)):
                    batch.delete(self._data_key(cid, oid, n))
            # drop same-txn pending records too (a ghost attr/omap put
            # earlier in this txn must not survive the remove)
            prefixes = (self._attr_prefix(cid, oid),
                        self._omap_prefix(cid, oid),
                        f"D/{self._esc(cid)}/{self._esc(oid)}/")
            batch.ops = [
                (kind, k, v) for kind, k, v in batch.ops
                if not k.startswith(prefixes)]
            for key, _ in list(self._db.iterate(
                    self._attr_prefix(cid, oid))):
                batch.delete(key)
            for key, _ in list(self._db.iterate(
                    self._omap_prefix(cid, oid))):
                batch.delete(key)
            batch.delete(self._meta_key(cid, oid))
            # a rewrite replaces the data; injected read errors do not
            # survive it (memstore/blockstore semantics)
            self._eio.discard((cid, oid))
        elif code == osr.OP_SETATTR:
            self._ensure_obj(batch, op[1], op[2])
            batch.put(self._attr_prefix(op[1], op[2]) + op[3], op[4])
        elif code == osr.OP_RMATTR:
            batch.delete(self._attr_prefix(op[1], op[2]) + op[3])
        elif code == osr.OP_OMAP_SET:
            self._ensure_obj(batch, op[1], op[2])
            for k, v in op[3].items():
                batch.put(self._omap_prefix(op[1], op[2]) + k, v)
        elif code == osr.OP_OMAP_RM:
            for k in op[3]:
                batch.delete(self._omap_prefix(op[1], op[2]) + k)
        elif code == osr.OP_OMAP_RMRANGE:
            for key, _ in list(self._db.iterate(
                    self._omap_prefix(op[1], op[2]) + op[3])):
                batch.delete(key)
        else:
            raise ValueError(f"kstore: unknown op {code}")

    def _ensure_obj(self, batch: WriteBatch, cid: str,
                    oid: str) -> None:
        """setattr/omap on a fresh oid creates the object (memstore
        _get_or_create / blockstore load(create=True) semantics)."""
        if self._pending_get(batch, self._meta_key(cid, oid)) is None:
            batch.put(self._meta_key(cid, oid),
                      json.dumps({"size": 0}).encode())

    def _pending_get(self, batch: WriteBatch, key: str) -> bytes | None:
        """Value as the batch would leave it: later ops in one
        transaction must see earlier ops' writes (txn atomicity)."""
        for kind, k, v in reversed(batch.ops):
            if k == key:
                return v if kind == 1 else None
        return self._db.get(key)

    def _stripe_get(self, batch: WriteBatch, cid: str, oid: str,
                    n: int) -> bytes:
        return self._pending_get(batch,
                                 self._data_key(cid, oid, n)) or b""

    def _write(self, batch: WriteBatch, cid: str, oid: str,
               off: int, data: bytes) -> None:
        raw = self._pending_get(batch, self._meta_key(cid, oid))
        meta = json.loads(raw) if raw is not None else {"size": 0}
        end = off + len(data)
        pos = off
        while pos < end:
            n = pos // STRIPE
            s_off = pos - n * STRIPE
            take = min(STRIPE - s_off, end - pos)
            stripe = bytearray(self._stripe_get(batch, cid, oid, n))
            if len(stripe) < s_off + take:
                stripe.extend(b"\x00" * (s_off + take - len(stripe)))
            stripe[s_off:s_off + take] = data[pos - off:pos - off + take]
            batch.put(self._data_key(cid, oid, n), bytes(stripe))
            pos += take
        meta["size"] = max(meta["size"], end)
        batch.put(self._meta_key(cid, oid), json.dumps(meta).encode())

    def _truncate(self, batch: WriteBatch, cid: str, oid: str,
                  size: int) -> None:
        raw = self._pending_get(batch, self._meta_key(cid, oid))
        meta = json.loads(raw) if raw is not None else {"size": 0}
        old = meta["size"]
        if size < old:
            first_gone = -(-size // STRIPE)
            for n in range(first_gone, -(-old // STRIPE)):
                batch.delete(self._data_key(cid, oid, n))
            if size % STRIPE:
                n = size // STRIPE
                stripe = self._stripe_get(batch, cid, oid, n)
                batch.put(self._data_key(cid, oid, n),
                          stripe[:size % STRIPE])
        meta["size"] = size
        batch.put(self._meta_key(cid, oid), json.dumps(meta).encode())

    # -- reads --------------------------------------------------------
    def read(self, cid: str, oid: str, off: int = 0,
             length: int | None = None) -> bytes:
        from ceph_tpu_torch.utils import faults as _faults
        # registry check OUTSIDE the store lock: an injected latency
        # window must stall this read, not every reader of the store
        if _faults.check_store_read(cid, oid):
            raise EIOError(f"injected fault EIO on {cid}/{oid}")
        with self._lock:
            if (cid, oid) in self._eio:
                raise EIOError(f"injected EIO on {cid}/{oid}")
            meta = self._meta(cid, oid)
            size = meta["size"]
            end = size if length is None else min(off + length, size)
            if end <= off:
                return b""
            parts = []
            pos = off
            while pos < end:
                n = pos // STRIPE
                s_off = pos - n * STRIPE
                take = min(STRIPE - s_off, end - pos)
                stripe = self._db.get(self._data_key(cid, oid, n)) \
                    or b""
                piece = stripe[s_off:s_off + take]
                parts.append(piece + b"\x00" * (take - len(piece)))
                pos += take
            return b"".join(parts)

    def stat(self, cid: str, oid: str) -> int:
        with self._lock:
            return self._meta(cid, oid)["size"]

    def getattr(self, cid: str, oid: str, name: str) -> bytes:
        with self._lock:
            self._meta(cid, oid)
            raw = self._db.get(self._attr_prefix(cid, oid) + name)
            if raw is None:
                raise NoSuchObject(f"no attr {name} on {cid}/{oid}")
            return raw

    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]:
        with self._lock:
            self._meta(cid, oid)
            prefix = self._attr_prefix(cid, oid)
            return {k[len(prefix):]: v
                    for k, v in self._db.iterate(prefix)}

    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        with self._lock:
            self._meta(cid, oid)
            prefix = self._omap_prefix(cid, oid)
            return {k[len(prefix):]: v
                    for k, v in self._db.iterate(prefix)}

    @staticmethod
    def _unesc(part: str) -> str:
        return part.replace("%2F", "/").replace("%25", "%")

    def list_collections(self) -> list[str]:
        with self._lock:
            return sorted(self._unesc(k[2:])
                          for k, _ in self._db.iterate("C/"))

    def list_objects(self, cid: str) -> list[str]:
        with self._lock:
            if self._db.get(self._ckey(cid)) is None:
                raise NoSuchCollection(cid)
            prefix = self._meta_prefix(cid)
            return sorted(self._unesc(k[len(prefix):])
                          for k, _ in self._db.iterate(prefix))

    def exists(self, cid: str, oid: str) -> bool:
        with self._lock:
            return self._db.get(self._meta_key(cid, oid)) is not None

    # -- fault injection ----------------------------------------------
    def inject_data_error(self, cid: str, oid: str) -> None:
        self._eio.add((cid, oid))

    def clear_data_error(self, cid: str, oid: str) -> None:
        self._eio.discard((cid, oid))

    def inject_bit_flip(self, cid: str, oid: str, offset: int = 0,
                        length: int = 4) -> None:
        """Silent corruption: flip stored stripe bytes in place (no
        EIO on read — the deep-scrub detection target)."""
        with self._lock:
            self._meta(cid, oid)          # ENOENT check
            batch = WriteBatch()
            pos, end = offset, offset + length
            while pos < end:
                n = pos // STRIPE
                s_off = pos - n * STRIPE
                take = min(STRIPE - s_off, end - pos)
                stripe = bytearray(
                    self._db.get(self._data_key(cid, oid, n)) or b"")
                hi = min(s_off + take, len(stripe))
                stripe[s_off:hi] = bytes(b ^ 0xFF
                                         for b in stripe[s_off:hi])
                batch.put(self._data_key(cid, oid, n), bytes(stripe))
                pos += take
            self._db.submit(batch, sync=True)
