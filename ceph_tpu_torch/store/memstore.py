"""MemStore — the in-RAM fake store for tests (src/os/memstore/).

Everything lives in dicts; commits are immediate. Fault injection works
the same as the durable store so EIO-path tests can run against either.
"""

from __future__ import annotations

from typing import Callable

from ceph_tpu_torch.store import object_store as osr
from ceph_tpu_torch.store.object_store import (
    EIOError,
    NoSuchCollection,
    NoSuchObject,
    ObjectStore,
    Transaction,
)


class _Obj:
    __slots__ = ("data", "attrs", "omap")

    def __init__(self) -> None:
        self.data = bytearray()
        self.attrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}


class MemStore(ObjectStore):
    def __init__(self) -> None:
        self._colls: dict[str, dict[str, _Obj]] = {}
        self._eio: set[tuple[str, str]] = set()

    # -- helpers ------------------------------------------------------
    def _coll(self, cid: str) -> dict[str, _Obj]:
        try:
            return self._colls[cid]
        except KeyError:
            raise NoSuchCollection(cid)

    def _obj(self, cid: str, oid: str) -> _Obj:
        coll = self._coll(cid)
        try:
            return coll[oid]
        except KeyError:
            raise NoSuchObject(f"{cid}/{oid}")

    def _get_or_create(self, cid: str, oid: str) -> _Obj:
        coll = self._coll(cid)
        if oid not in coll:
            coll[oid] = _Obj()
        return coll[oid]

    # -- transactions -------------------------------------------------
    def _validate(self, txn: Transaction) -> None:
        """All-or-nothing: reject the whole txn before applying anything
        (BlockStore gets this for free from its staged kv batch)."""
        colls = set(self._colls)
        objs = {(c, o) for c, objects in self._colls.items()
                for o in objects}
        for op in txn.ops:
            code = op[0]
            if code == osr.OP_MKCOLL:
                colls.add(op[1])
            elif code == osr.OP_RMCOLL:
                colls.discard(op[1])
                objs = {key for key in objs if key[0] != op[1]}
            else:
                cid, oid = op[1], op[2]
                if cid not in colls:
                    raise NoSuchCollection(cid)
                if code in (osr.OP_RMATTR, osr.OP_OMAP_RM) and \
                        (cid, oid) not in objs:
                    raise NoSuchObject(f"{cid}/{oid}")
                if code == osr.OP_REMOVE:
                    objs.discard((cid, oid))
                else:
                    objs.add((cid, oid))

    def queue_transaction(self, txn: Transaction,
                          on_commit: Callable[[], None] | None = None) -> None:
        from ceph_tpu_torch.utils import store_telemetry
        tmr = store_telemetry.telemetry().txn_timer(
            "memstore", id(self))
        tmr.n_ops = len(txn)
        with tmr:
            with tmr.stage("apply"):
                self._apply(txn)
            tmr.run_on_commit(on_commit)

    def queue_transaction_group(self, pairs: list,
                                defer: bool = False) -> None:
        """Group commit (ROADMAP 1a): one apply pass for the whole
        flush group, completions as one sweep in submission order.
        There is NO barrier to share in RAM — a commit here is
        already "durable" — so ``defer`` is a no-op and the sweep
        runs inline (parking acks for a barrier that will never add
        durability is pure latency; measured ~10% off the memstore
        loopback quick run)."""
        if not pairs:
            return
        from ceph_tpu_torch.utils import store_telemetry
        tmr = store_telemetry.telemetry().txn_timer(
            "memstore", id(self))
        tmr.n_ops = sum(len(txn) for txn, _ in pairs)
        tmr.n_txns = len(pairs)
        with tmr:
            with tmr.stage("apply"):
                merged = Transaction()
                for txn, _ in pairs:
                    merged.ops.extend(txn.ops)
                self._apply(merged)
            tmr.run_on_commit_sweep([cb for _, cb in pairs])

    def _apply(self, txn: Transaction) -> None:
        self._validate(txn)
        for op in txn.ops:
            code = op[0]
            if code == osr.OP_MKCOLL:
                self._colls.setdefault(op[1], {})
            elif code == osr.OP_RMCOLL:
                self._colls.pop(op[1], None)
            elif code == osr.OP_TOUCH:
                self._get_or_create(op[1], op[2])
            elif code == osr.OP_WRITE:
                o = self._get_or_create(op[1], op[2])
                off, data = op[3], op[4]
                if len(o.data) < off:
                    o.data.extend(b"\x00" * (off - len(o.data)))
                o.data[off:off + len(data)] = data
            elif code == osr.OP_ZERO:
                o = self._get_or_create(op[1], op[2])
                off, ln = op[3], op[4]
                if len(o.data) < off + ln:
                    o.data.extend(b"\x00" * (off + ln - len(o.data)))
                o.data[off:off + ln] = b"\x00" * ln
            elif code == osr.OP_TRUNCATE:
                o = self._get_or_create(op[1], op[2])
                size = op[3]
                if size < len(o.data):
                    del o.data[size:]
                else:
                    o.data.extend(b"\x00" * (size - len(o.data)))
            elif code == osr.OP_REMOVE:
                self._coll(op[1]).pop(op[2], None)
                # rewriting an object replaces its data: a previously
                # injected/latent read error does not survive it
                self._eio.discard((op[1], op[2]))
            elif code == osr.OP_SETATTR:
                self._get_or_create(op[1], op[2]).attrs[op[3]] = op[4]
            elif code == osr.OP_RMATTR:
                self._obj(op[1], op[2]).attrs.pop(op[3], None)
            elif code == osr.OP_OMAP_SET:
                self._get_or_create(op[1], op[2]).omap.update(op[3])
            elif code == osr.OP_OMAP_RM:
                o = self._obj(op[1], op[2])
                for k in op[3]:
                    o.omap.pop(k, None)
            elif code == osr.OP_OMAP_RMRANGE:
                o = self._get_or_create(op[1], op[2])
                for k in [k for k in o.omap if k.startswith(op[3])]:
                    del o.omap[k]

    # -- reads --------------------------------------------------------
    def read(self, cid: str, oid: str, off: int = 0,
             length: int | None = None) -> bytes:
        from ceph_tpu_torch.utils import faults as _faults
        if _faults.check_store_read(cid, oid):
            raise EIOError(f"injected fault EIO on {cid}/{oid}")
        if (cid, oid) in self._eio:
            raise EIOError(f"injected EIO on {cid}/{oid}")
        o = self._obj(cid, oid)
        end = len(o.data) if length is None else min(off + length, len(o.data))
        return bytes(o.data[off:end])

    def stat(self, cid: str, oid: str) -> int:
        return len(self._obj(cid, oid).data)

    def getattr(self, cid: str, oid: str, name: str) -> bytes:
        attrs = self._obj(cid, oid).attrs
        if name not in attrs:
            raise NoSuchObject(f"attr {name} on {cid}/{oid}")
        return attrs[name]

    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]:
        return dict(self._obj(cid, oid).attrs)

    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        return dict(self._obj(cid, oid).omap)

    def list_collections(self) -> list[str]:
        return sorted(self._colls)

    def list_objects(self, cid: str) -> list[str]:
        return sorted(self._coll(cid))

    # -- fault injection ----------------------------------------------
    def inject_data_error(self, cid: str, oid: str) -> None:
        self._eio.add((cid, oid))

    def clear_data_error(self, cid: str, oid: str) -> None:
        self._eio.discard((cid, oid))

    def inject_bit_flip(self, cid: str, oid: str, offset: int = 0,
                        length: int = 4) -> None:
        """Silent corruption: flip the stored bytes in place — reads
        return the rot with no error (deep scrub's detection target)."""
        o = self._obj(cid, oid)
        end = min(offset + length, len(o.data))
        o.data[offset:end] = bytes(b ^ 0xFF
                                   for b in o.data[offset:end])
