"""Client-side striping — Striper / libradosstriper / file_layout_t roles.

Reference: src/osdc/Striper.h (file offset -> object extents math),
src/include/fs_types.h:86 (``file_layout_t``: stripe_unit su,
stripe_count sc, object_size), src/libradosstriper (striped object API
over plain RADOS objects).

A logical byte range maps onto RADOS objects ``{soid}.{objectno:016x}``:
within each "object set" of ``stripe_count`` objects, stripe units
round-robin across the objects (su bytes to object 0, su to object 1,
...), and each object holds at most ``object_size`` bytes. A
``{soid}.meta`` object records layout + logical size (the reference
stores these in xattrs of the first object).
"""

from __future__ import annotations

import json
import uuid
from dataclasses import dataclass


@dataclass(frozen=True)
class FileLayout:
    """file_layout_t (fs_types.h:86); defaults mirror the reference's
    4 MiB objects, one stripe unit per object."""
    stripe_unit: int = 1 << 22
    stripe_count: int = 1
    object_size: int = 1 << 22

    def validate(self) -> None:
        if self.stripe_unit <= 0 or self.stripe_count <= 0 \
                or self.object_size <= 0:
            raise ValueError("layout fields must be positive")
        if self.object_size % self.stripe_unit:
            raise ValueError("object_size must be a multiple of "
                             "stripe_unit")


def file_to_extents(layout: FileLayout, offset: int, length: int
                    ) -> list[tuple[int, int, int]]:
    """Map a logical byte range to [(objectno, obj_off, len), ...] in
    logical order (Striper::file_to_extents role)."""
    layout.validate()
    su = layout.stripe_unit
    sc = layout.stripe_count
    spo = layout.object_size // su      # stripe units per object
    out: list[tuple[int, int, int]] = []
    pos = offset
    end = offset + length
    while pos < end:
        blockno = pos // su             # global stripe-unit index
        stripeno = blockno // sc        # which stripe row
        stripepos = blockno % sc        # which object in the set
        objectsetno = stripeno // spo   # which object set
        objectno = objectsetno * sc + stripepos
        block_off = pos % su
        obj_off = (stripeno % spo) * su + block_off
        n = min(su - block_off, end - pos)
        if out and out[-1][0] == objectno and \
                out[-1][1] + out[-1][2] == obj_off:
            out[-1] = (objectno, out[-1][1], out[-1][2] + n)
        else:
            out.append((objectno, obj_off, n))
        pos += n
    return out


class StripedObject:
    """libradosstriper-style striped read/write over an IoCtx."""

    META_SUFFIX = ".meta"

    def __init__(self, ioctx, soid: str,
                 layout: FileLayout | None = None,
                 cache=None, snapc: dict | None = None,
                 snapid: int = 0) -> None:
        self.io = ioctx
        self.soid = soid
        #: optional ObjectCacher (osdc/ObjectCacher role): piece
        #: reads fill it, piece writes invalidate write-through
        self.cache = cache
        #: self-managed SnapContext carried on every piece/meta write
        #: (the CephFS realm of the file — SnapContext role), and a
        #: snapid pinning reads to a snapshot (snap handles are
        #: read-only)
        self.snapc = snapc
        self.snapid = snapid
        existing = self._read_meta()
        if existing is not None:
            self.layout, self.size, self.tag = existing
            if layout is not None and layout != self.layout:
                raise ValueError(
                    f"{soid}: layout mismatch with stored layout")
        else:
            self.layout = layout or FileLayout()
            self.layout.validate()
            self.size = 0
            #: per-write-generation tag (rgw_gc chain-tag role): a
            #: fresh stream mints one on first write; it is stamped
            #: into the meta AND every piece's gc_tag xattr, so the
            #: deferred-GC reaper can tell THIS generation's pieces
            #: from a concurrent re-upload's (services/rgw.py
            #: gc_process). None until the first write; legacy
            #: streams (written before tagging) stay None.
            self.tag = None

    # -- meta ----------------------------------------------------------
    def _meta_oid(self) -> str:
        return self.soid + self.META_SUFFIX

    def _read_meta(self):
        try:
            raw = self.io.read(self._meta_oid(),
                               snap=getattr(self, "snapid", 0))
        except Exception:
            return None
        d = json.loads(raw)
        return (FileLayout(d["su"], d["sc"], d["os"]), d["size"],
                d.get("tag"))

    def _write_meta(self) -> None:
        meta = {
            "su": self.layout.stripe_unit,
            "sc": self.layout.stripe_count,
            "os": self.layout.object_size,
            "size": self.size}
        if self.tag is not None:
            meta["tag"] = self.tag
        self.io.write_full(self._meta_oid(), json.dumps(meta).encode(),
                           snapc=self.snapc)

    def _piece(self, objectno: int) -> str:
        return f"{self.soid}.{objectno:016x}"

    def refresh(self) -> None:
        """Re-read the stored meta (another handle may have grown the
        stream since this one opened)."""
        existing = self._read_meta()
        if existing is not None:
            self.layout, self.size, self.tag = existing

    # -- I/O -----------------------------------------------------------
    def write(self, data: bytes, offset: int = 0) -> None:
        if self.tag is None:
            self.tag = uuid.uuid4().hex[:16]
        pos = 0
        for objectno, obj_off, n in file_to_extents(
                self.layout, offset, len(data)):
            oid = self._piece(objectno)
            self.io.write(oid, data[pos:pos + n], offset=obj_off,
                          snapc=self.snapc)
            try:
                # generation stamp for the gc reaper; best-effort (an
                # untagged piece is merely unreapable by a TAGGED
                # enrollment — safe side)
                self.io.setxattr(oid, "gc_tag", self.tag.encode())
            except Exception:
                pass
            if self.cache is not None:
                # write-through: invalidate AFTER the write lands —
                # invalidating before would let a concurrent reader
                # refill pre-write bytes and pin them stale
                self.cache.invalidate_object(oid)
            pos += n
        self.size = max(self.size, offset + len(data))
        self._write_meta()

    def read(self, length: int | None = None, offset: int = 0) -> bytes:
        if length is None:
            length = max(self.size - offset, 0)
        length = min(length, max(self.size - offset, 0))
        if length <= 0:
            return b""
        out = bytearray(length)
        pos = 0
        for objectno, obj_off, n in file_to_extents(
                self.layout, offset, length):
            oid = self._piece(objectno)
            piece = self.cache.get(oid, obj_off, n) \
                if self.cache is not None else None
            if piece is None:
                gen = self.cache.generation() \
                    if self.cache is not None else 0
                try:
                    piece = self.io.read(oid, n, obj_off,
                                         snap=self.snapid)
                except Exception:
                    piece = b""      # sparse hole reads as zeros
                if self.cache is not None:
                    # gen guards the fill/invalidate race: a fetch
                    # that began before an invalidation is dropped
                    self.cache.put(oid, obj_off, n, piece, gen=gen)
            out[pos:pos + len(piece)] = piece
            pos += n
        return bytes(out)

    def stat(self) -> int:
        return self.size

    def remove(self) -> None:
        if self.cache is not None:
            self.cache.invalidate_all()
        objectnos = sorted({e[0] for e in file_to_extents(
            self.layout, 0, self.size)}) if self.size else []
        for objectno in objectnos:
            try:
                self.io.remove(self._piece(objectno),
                               snapc=self.snapc)
            except Exception:
                pass
        try:
            self.io.remove(self._meta_oid(), snapc=self.snapc)
        except Exception:
            pass
        self.size = 0
