"""rbd-lite — block images on RADOS (src/librbd role, reduced).

Reference: librbd stores an image as a header object + striped data
objects (``rbd_data.<id>.<objectno>``), with an ``rbd_directory``
listing images per pool. This lite version keeps that object model —
directory object, per-image header (size + layout), striped data via
ceph_tpu_torch.client.striper — and the core API: create/open/list/remove,
byte-addressed read/write, resize, and snapshots.

Snapshots are copy-on-write at data-object granularity (the
reference's object-clone model, reduced): ``snap_create`` is O(1) —
it records a layer; the FIRST head write touching a data object after
the snapshot copies that object into the newest snap's layer
(``rbd_snap.<image>@<snap>.<objno>``). A snap read resolves each
object through its own layer, then newer snaps' layers, then the
head (objects never written since the snap are shared, not copied);
``snap_remove`` merges the layer into the next-older snapshot so
older point-in-time views stay intact. Legacy full-copy snapshots
(pre-COW format) remain readable.

Journaling (librbd journaling feature, src/journal/ role): an image
created with ``journaling=True`` appends an event record to its
journal (services/journal.py) BEFORE applying each mutation — the
write-ahead ordering rbd-mirror replay depends on. Non-primary images
(mirror targets, ``primary=False``) refuse client mutations; the
replayer applies through the internal ``_apply_event`` path
(services/rbd_mirror.py).
"""

from __future__ import annotations

import json

from ceph_tpu_torch.client.striper import (
    FileLayout,
    StripedObject,
    file_to_extents,
)
from ceph_tpu_torch.services.journal import Journaler, JournalError
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.encoding import Decoder, Encoder

DIRECTORY_OID = "rbd_directory"

#: the writer's own journal-client id: tracks which events the PRIMARY
#: image has actually applied (mirror targets use their own client ids)
LOCAL_CLIENT = "local"


class RBDError(Exception):
    pass


def _load_dir(io) -> dict:
    """Directory view via the in-OSD rbd class (cls_rbd dir_list)."""
    try:
        return json.loads(io.execute(DIRECTORY_OID, "rbd", "dir_list"))
    except Exception:
        return {}


def _dir_call(io, method: str, **args) -> None:
    """One atomic rbd_directory mutation (cls_rbd dir_* role): two
    clients creating/removing images concurrently can never lose each
    other's entries the way a client-side read-modify-write of the
    directory blob could."""
    from ceph_tpu_torch.client.rados import RadosError
    try:
        io.execute(DIRECTORY_OID, "rbd", method,
                   json.dumps(args).encode())
    except RadosError as exc:
        if exc.code == -17:
            raise RBDError("image exists") from None
        if exc.code == -2:
            raise RBDError("no such image") from None
        raise


class RBD:
    """Pool-level image management (librbd::RBD role)."""

    def __init__(self, ioctx) -> None:
        self.io = ioctx

    def create(self, name: str, size: int,
               layout: FileLayout | None = None,
               journaling: bool = False,
               primary: bool = True,
               exclusive: bool = False) -> "Image":
        # reserve the directory entry FIRST (atomic in-OSD -EEXIST):
        # a racing create of the same name loses cleanly. A failure
        # AFTER the reservation rolls it back, so a half-created
        # image never wedges the name.
        _dir_call(self.io, "dir_add_image", name=name,
                  meta={"size": size})
        try:
            layout = layout or FileLayout(stripe_unit=1 << 20,
                                          stripe_count=1,
                                          object_size=1 << 20)
            header = {"size": size, "su": layout.stripe_unit,
                      "sc": layout.stripe_count,
                      "os": layout.object_size,
                      "snaps": {}, "journaling": journaling,
                      "primary": primary, "exclusive": exclusive}
            if journaling:
                Journaler(self.io, f"rbd.{name}").create()
            self.io.write_full(f"rbd_header.{name}",
                               json.dumps(header).encode())
        except Exception:
            try:
                _dir_call(self.io, "dir_remove_image", name=name)
            except RBDError:
                pass
            raise
        return Image(self.io, name)

    def list(self) -> list[str]:
        return sorted(_load_dir(self.io))

    def remove(self, name: str) -> None:
        img = Image(self.io, name)
        # bulk teardown: delete every snapshot layer piece directly —
        # the merge-preserving removal path would copy data down into
        # older layers that are about to be deleted anyway
        for snap, meta in list(img._header["snaps"].items()):
            if meta.get("cow"):
                for key, marker in meta.get("objects", {}).items():
                    if marker == "data":
                        try:
                            self.io.remove(
                                img._snap_piece(snap, int(key, 16)))
                        except Exception:
                            pass
            else:
                StripedObject(self.io,
                              img._snap_prefix(snap)).remove()
        img._header["snaps"].clear()
        img._header.pop("snap_order", None)
        if img.journal is not None:
            img.journal.remove()
        img._data.remove()
        try:
            self.io.remove(f"rbd_header.{name}")
        except Exception:
            pass
        try:
            self.io.remove(f"rbd_header_lock.{name}")
        except Exception:
            pass
        try:
            _dir_call(self.io, "dir_remove_image", name=name)
        except RBDError:
            pass

    def open(self, name: str, read_only: bool = False) -> "Image":
        """Open an image. The writing open (default) replays any
        journaled-but-unapplied tail; ``read_only`` skips replay —
        required for opens that may run concurrently with the live
        writer (admin inspection, mirror bootstrap), which must not
        mutate the image or its commit watermark."""
        return Image(self.io, name, replay=not read_only)


class Image:
    """One open image (librbd::Image role).

    ``cache=True`` attaches an :class:`ObjectCacher` to the data
    striper (rbd_cache role) AND a header WATCH: another handle's
    structural change (resize, snapshot, promote/demote) notifies
    the image header object, and this handle reloads the header and
    drops its cache — the librbd ImageWatcher coherence channel.
    As in the reference, the data cache assumes a single writer
    (exclusive-lock discipline); concurrent writers should open
    uncached."""

    def __init__(self, ioctx, name: str, replay: bool = False,
                 cache: bool | None = None) -> None:
        self.io = ioctx
        self.name = name
        try:
            self._header = json.loads(self.io.read(f"rbd_header.{name}"))
        except Exception:
            raise RBDError(f"no such image {name!r}")
        layout = FileLayout(self._header["su"], self._header["sc"],
                            self._header["os"])
        if cache is None:
            cache = bool(g_conf()["rbd_cache"])
        self.cache = None
        self._watch_cookie = None
        self._lock_held = False
        if cache:
            from ceph_tpu_torch.client.object_cacher import ObjectCacher
            self.cache = ObjectCacher(g_conf()["rbd_cache_size"])
        self._data = StripedObject(self.io, f"rbd_data.{name}", layout,
                                   cache=self.cache)
        self.journal = Journaler(self.io, f"rbd.{name}") \
            if self._header.get("journaling") else None
        if cache:
            # watch LAST: a notify can fire the callback the moment
            # the watch registers, and the callback touches
            # self._data — which must exist by then
            try:
                self._watch_cookie = self.io.watch(
                    f"rbd_header.{name}", self._on_header_notify)
            except Exception:
                self._watch_cookie = None   # cache still works solo
        #: next journal position the WRITER expects to commit; advances
        #: only contiguously (see _journal_committed)
        self._local_pos = 0
        # replay is for the WRITING opener only (RBD.open): the journal
        # is single-writer, and a read-side construction (rbd-mirror's
        # bootstrap open, admin helpers) replaying concurrently with
        # the live writer would race its header/COW updates
        if replay and self.journal is not None and \
                self._header.get("primary", True):
            self._replay_local_tail()

    # -- header --------------------------------------------------------
    def _on_header_notify(self, payload: bytes) -> None:
        """Another handle changed the image structurally: reload the
        header and drop the data cache (ImageWatcher role)."""
        try:
            self._header = json.loads(
                self.io.read(f"rbd_header.{self.name}"))
        except Exception:
            pass
        self._data.refresh()
        if self.cache is not None:
            self.cache.invalidate_all()

    def _notify_header(self) -> None:
        """Announce a structural header change to other open handles
        (resize/snapshot/promote — NOT per-write size bumps)."""
        try:
            self.io.notify(f"rbd_header.{self.name}", b"header",
                           timeout_ms=3000)
        except Exception:
            pass               # no watchers / primary briefly gone

    def close(self) -> None:
        """Drop the header watch and release a held exclusive lock
        (librbd close role) — a cleanly-closed holder must not leave
        the image locked forever (the only remedy would be a
        lock_break that blocklists a healthy client)."""
        if self._lock_held:
            self.lock_release()
        if self._watch_cookie is not None:
            try:
                self.io.unwatch(self._watch_cookie)
            except Exception:
                pass
            self._watch_cookie = None

    def _save_header(self) -> None:
        self.io.write_full(f"rbd_header.{self.name}",
                           json.dumps(self._header).encode())
        try:
            _dir_call(self.io, "dir_update_image", name=self.name,
                      meta={"size": self._header["size"]})
        except RBDError:
            pass                 # entry gone (concurrent remove)

    def size(self) -> int:
        return self._header["size"]

    def stat(self) -> dict:
        return {"name": self.name, "size": self._header["size"],
                "stripe_unit": self._header["su"],
                "stripe_count": self._header["sc"],
                "object_size": self._header["os"],
                "snaps": sorted(self._header["snaps"])}

    # -- journaling / mirroring roles ----------------------------------
    def is_primary(self) -> bool:
        return self._header.get("primary", True)

    def promote(self) -> None:
        self._header["primary"] = True
        self._save_header()
        self._notify_header()

    def demote(self) -> None:
        self._header["primary"] = False
        self._save_header()
        self._notify_header()

    def _replay_local_tail(self) -> None:
        """Close the write-ahead window on open: mutations journal
        BEFORE applying, so a crash (or an EIO raised mid-apply, e.g.
        in _cow_protect) can leave appended events the source never
        applied — while rbd-mirror replays them on the target, a
        silent permanent divergence. The reference replays the journal
        on image open (librbd Journal<I>::replay); we do the same from
        the writer's own commit position. Replaying an in-order SUFFIX
        that includes already-applied events is convergent (the events
        are deterministic and _apply_event guards creations/removals),
        so a commit position that lags an applied event is safe."""
        from ceph_tpu_torch.services.journal import JournalTrimmedError
        try:
            end = self.journal.end_position()
        except JournalError:
            return                    # journal object not created yet
        pos = self.journal.committed(LOCAL_CLIENT)
        applied = min(pos, end)
        try:
            for epos, payload in self.journal.read_from(applied):
                self._apply_event(*self.decode_event(payload))
                applied = epos + 1
        except JournalTrimmedError:
            # pre-replay-era image whose tail was trimmed: the lost
            # events cannot be replayed — adopt the tip and move on
            applied = end
        except JournalError:
            # a chunk read failed MID-tail: only the prefix that
            # actually applied may be committed — advancing to `end`
            # would mark never-applied events as applied (the silent
            # divergence this replay exists to close); the remainder
            # replays on the next open
            pass
        self._local_pos = applied
        self.journal.commit(LOCAL_CLIENT, applied)

    def _journal_event(self, kind: str, offset: int = 0,
                       data: bytes = b"", arg: str = "") -> int | None:
        if self.journal is None:
            return None
        e = Encoder()
        e.str(kind)
        e.u64(offset)
        e.bytes(data)
        e.str(arg)
        return self.journal.append(e.getvalue())

    def _journal_committed(self, pos: int | None) -> None:
        """Advance the writer's commit position once the mutation it
        journaled has fully applied (write-ahead completion marker).

        Advances CONTIGUOUSLY only: if event N's apply failed (its
        commit never ran), a later event N+1 completing must NOT move
        the high-watermark past N — replay-on-open would then skip N
        forever while mirror targets still apply it (the divergence
        this machinery exists to close). Leaving the watermark at N
        makes the next open re-apply N, N+1, ... in order, which
        converges."""
        if self.journal is not None and pos is not None \
                and pos == self._local_pos:
            self._local_pos = pos + 1
            self.journal.commit(LOCAL_CLIENT, pos + 1)

    @staticmethod
    def decode_event(payload: bytes) -> tuple[str, int, bytes, str]:
        d = Decoder(payload)
        return d.str(), d.u64(), d.bytes(), d.str()

    # -- exclusive lock (src/librbd/ManagedLock.h:28 role) -------------
    # The cooperative half is a cls exclusive lock on the header object
    # recording the holder's rados INSTANCE id; the fencing half is the
    # osdmap blocklist: lock_break() blocklists the recorded instance
    # before removing the lock, so a dead/hung holder's in-flight
    # writes can never land after the steal (the break/steal flow the
    # reference drives through its lock + blacklist pair).
    _LOCK_NAME = "rbd_lock"

    def _lock_oid(self) -> str:
        # dedicated object: cls lock state IS the object data, so it
        # must never share an oid with the header payload
        return f"rbd_header_lock.{self.name}"

    def lock_acquire(self) -> None:
        """Take (or re-assert) the exclusive lock. No expiry: holder
        death is handled by lock_break's fence, as in the reference."""
        from ceph_tpu_torch.client.rados import RadosError
        inst = self.io.client.instance
        try:
            self.io.execute(self._lock_oid(), "lock", "lock",
                            json.dumps({
                                "name": self._LOCK_NAME,
                                "cookie": inst,
                                "type": "exclusive",
                                "duration": 0,
                                "owner": inst}).encode())
        except RadosError as exc:
            if exc.code == -16:
                raise RBDError(
                    f"image {self.name!r} is exclusively locked by "
                    "another client") from None
            raise
        self._lock_held = True

    def lock_release(self) -> None:
        from ceph_tpu_torch.client.rados import RadosError
        self._lock_held = False
        try:
            self.io.execute(self._lock_oid(), "lock", "unlock",
                            json.dumps({
                                "name": self._LOCK_NAME,
                                "cookie": self.io.client.instance,
                            }).encode())
        except RadosError:
            pass                      # already broken/expired

    def lock_owner(self) -> str | None:
        """The current holder's instance id, or None."""
        try:
            st = json.loads(self.io.execute(self._lock_oid(), "lock",
                                            "info"))
        except Exception:
            return None
        for key, ent in st.get("lockers", {}).items():
            if key.startswith(f"{self._LOCK_NAME}/"):
                return ent.get("owner") or key.split("/", 1)[1]
        return None

    def lock_break(self, blocklist: bool = True) -> None:
        """Steal a (presumed dead) holder's lock. With ``blocklist``
        (the default, and the only safe mode for a live-but-hung
        holder) the holder's instance is fenced in the osdmap FIRST
        and the breaker waits for the fence epoch — after that none
        of the old holder's in-flight writes can land."""
        owner = self.lock_owner()
        if owner is None:
            return
        if blocklist:
            # 24h fence (see mds.py takeover note): the stolen-from
            # holder's first rejected op sticky-fences its client
            # instance long before the entry lapses
            code, _outs, data = self.io.client.mon_command(
                {"prefix": "osd blocklist", "blocklistop": "add",
                 "addr": owner, "expire": 86400.0})
            if code != 0:
                raise RBDError(
                    f"cannot fence lock owner {owner!r}: {code}")
            self.io.client.monc.wait_for_map(
                json.loads(data)["epoch"])
        from ceph_tpu_torch.client.rados import RadosError
        try:
            # break the EXACT lock we read and fenced — "*" could
            # wipe a new healthy holder who acquired after a clean
            # release during our fence round-trip (cookie == owner
            # instance by lock_acquire's construction)
            self.io.execute(self._lock_oid(), "lock", "break_lock",
                            json.dumps({"name": self._LOCK_NAME,
                                        "cookie": owner}).encode())
        except RadosError as exc:
            if exc.code != -2:        # already gone is success
                raise

    def _check_writable(self) -> None:
        if not self._header.get("primary", True):
            raise RBDError(
                f"image {self.name!r} is non-primary (mirror target)")
        if self._header.get("exclusive") and not self._lock_held:
            # exclusive-lock feature: auto-acquire on first write
            # (librbd acquires the managed lock lazily the same way)
            self.lock_acquire()

    def resize(self, new_size: int) -> None:
        self._check_writable()
        pos = self._journal_event("resize", new_size)
        self._resize_apply(new_size)
        self._journal_committed(pos)
        self._notify_header()

    def _resize_apply(self, new_size: int) -> None:
        old = self._header["size"]
        self._header["size"] = new_size
        self._save_header()
        if new_size < old:
            # shrink: zero the dropped tail so a later grow reads zeros
            # (object-level trim left as future work)
            self._data.size = min(self._data.size, new_size)
            self._data._write_meta()

    # -- data ----------------------------------------------------------
    def write(self, offset: int, data: bytes) -> int:
        self._check_writable()
        if offset + len(data) > self._header["size"]:
            raise RBDError("write past end of image")
        pos = self._journal_event("write", offset, bytes(data))
        self._cow_protect(self._touched_objnos(offset, len(data)))
        self._data.write(data, offset=offset)
        self._journal_committed(pos)
        return len(data)

    def read(self, offset: int, length: int) -> bytes:
        end = min(offset + length, self._header["size"])
        if end <= offset:
            return b""
        want = end - offset
        out = self._data.read(want, offset)
        # unwritten ranges read as zeros (sparse image semantics)
        return out + b"\x00" * (want - len(out))

    def discard(self, offset: int, length: int) -> None:
        self._check_writable()
        pos = self._journal_event("discard", offset,
                                  length.to_bytes(8, "little"))
        self._cow_protect(self._touched_objnos(offset, length))
        self._data.write(b"\x00" * length, offset=offset)
        self._journal_committed(pos)

    # -- snapshots (COW object-clone model) -----------------------------
    def _snap_prefix(self, snap: str) -> str:
        return f"rbd_snap.{self.name}@{snap}"

    def _snap_piece(self, snap: str, objno: int) -> str:
        return f"{self._snap_prefix(snap)}.{objno:016x}"

    def _snap_order(self) -> list[str]:
        return self._header.setdefault("snap_order", [])

    def snap_list(self) -> list[str]:
        return sorted(self._header["snaps"])

    def _objnos(self, size: int) -> list[int]:
        return self._touched_objnos(0, size)

    def _piece_limit(self, objno: int, size: int) -> int:
        """Valid byte prefix of data object ``objno`` when the logical
        data extends to ``size`` (raw piece reads must clamp here, or
        stale bytes beyond a shrink would resurrect in snapshots).
        O(1) layout arithmetic — enumerating the whole extent list
        would make rollback/copy-up quadratic in object count."""
        if size <= 0:
            return 0
        lay = self._data.layout
        su, sc, osz = (lay.stripe_unit, lay.stripe_count,
                       lay.object_size)
        set_idx, pos = objno // sc, objno % sc
        set_bytes = osz * sc
        if size >= (set_idx + 1) * set_bytes:
            return osz                 # object fully inside the data
        rem = size - set_idx * set_bytes
        if rem <= 0:
            return 0                   # object set beyond the data
        full_rounds, extra = divmod(rem, su * sc)
        return full_rounds * su + min(max(extra - pos * su, 0), su)

    def _cow_protect(self, objnos) -> None:
        """Before a head data object changes, copy its CURRENT content
        into the newest snapshot's layer (first-write copy; objects a
        snap already holds — or that were protected earlier — are
        shared and skipped)."""
        order = self._snap_order()
        if not order:
            return
        snap = order[-1]
        meta = self._header["snaps"].get(snap)
        if meta is None or not meta.get("cow"):
            return
        snap_dsize = meta.get("data_size", meta["size"])
        dirty = False
        for objno in objnos:
            key = f"{objno:x}"
            if key in meta["objects"]:
                continue
            limit = self._piece_limit(objno, snap_dsize)
            content = None
            if limit > 0:
                try:
                    content = self.io.read(self._data._piece(objno))
                except Exception as exc:
                    # ONLY absence is shareable-as-hole; a real I/O
                    # error (EIO etc.) must fail the write, or an
                    # 'absent' marker would silently zero the
                    # snapshot's only copy
                    if getattr(exc, "code", None) != -2:
                        raise
            if content is None:
                meta["objects"][key] = "absent"
            else:
                # clamp to the snapshot-time valid prefix: bytes past
                # a shrink are logically zeros, not stale data
                self.io.write_full(self._snap_piece(snap, objno),
                                   content[:limit])
                meta["objects"][key] = "data"
            dirty = True
        if dirty:
            self._save_header()

    def _touched_objnos(self, offset: int, length: int) -> list[int]:
        if length <= 0:
            return []
        return sorted({e[0] for e in file_to_extents(
            self._data.layout, offset, length)})

    def _resolve_piece(self, snap: str, objno: int) -> bytes:
        """Object content as of ``snap``: own layer, else newer snaps'
        layers (oldest-first), else the head object (shared)."""
        order = self._snap_order()
        start = order.index(snap)
        key = f"{objno:x}"
        for s in order[start:]:
            smeta = self._header["snaps"].get(s)
            if smeta is None:
                continue          # stale order entry
            marker = smeta.get("objects", {}).get(key)
            if marker == "absent":
                return b""
            if marker == "data":
                return self.io.read(self._snap_piece(s, objno))
        meta = self._header["snaps"][snap]
        limit = self._piece_limit(objno,
                                  meta.get("data_size", meta["size"]))
        if limit <= 0:
            return b""
        try:
            return self.io.read(self._data._piece(objno))[:limit]
        except Exception as exc:
            if getattr(exc, "code", None) != -2:
                raise
            return b""            # sparse hole

    def snap_read(self, snap: str) -> bytes:
        """Full point-in-time content of a snapshot."""
        meta = self._header["snaps"].get(snap)
        if meta is None:
            raise RBDError(f"no snap {snap!r}")
        if not meta.get("cow"):        # legacy full-copy snapshot
            return StripedObject(self.io,
                                 self._snap_prefix(snap)).read()
        size = meta["size"]
        pieces = {objno: self._resolve_piece(snap, objno)
                  for objno in self._objnos(size)}
        out = bytearray(size)
        pos = 0
        for objno, obj_off, n in file_to_extents(self._data.layout,
                                                 0, size):
            piece = pieces[objno][obj_off:obj_off + n]
            out[pos:pos + len(piece)] = piece
            pos += n
        return bytes(out)

    def _snap_ingest(self, snap: str, content: bytes,
                     size: int) -> None:
        """Mirror bootstrap: materialize a PEER snapshot's point-in-
        time content as a full local layer (the dst head may already
        be newer, so sharing-with-head is not an option)."""
        order = self._snap_order()
        insert_at = len(order)
        if snap in self._header["snaps"]:
            # forced resync: replace the layer IN PLACE — appending
            # would move this snap past chronologically newer ones,
            # and their unshared objects would then wrongly resolve
            # through this older layer
            if snap in order:
                insert_at = order.index(snap)
            self._snap_remove_apply(snap)
        meta = {"size": size, "cow": True, "objects": {},
                "data_size": size}
        pieces: dict[int, bytearray] = {}
        pos = 0
        for objno, obj_off, n in file_to_extents(self._data.layout,
                                                 0, size):
            buf = pieces.setdefault(objno, bytearray())
            if len(buf) < obj_off + n:
                buf.extend(b"\x00" * (obj_off + n - len(buf)))
            buf[obj_off:obj_off + n] = content[pos:pos + n]
            pos += n
        for objno, buf in pieces.items():
            self.io.write_full(self._snap_piece(snap, objno),
                               bytes(buf))
            meta["objects"][f"{objno:x}"] = "data"
        self._header["snaps"][snap] = meta
        self._snap_order().insert(insert_at, snap)
        self._save_header()

    def snap_create(self, snap: str) -> None:
        self._check_writable()
        if snap in self._header["snaps"]:
            raise RBDError(f"snap {snap!r} exists")
        pos = self._journal_event("snap_create", arg=snap)
        self._snap_create_apply(snap)
        self._journal_committed(pos)
        self._notify_header()

    def _snap_create_apply(self, snap: str) -> None:
        # O(1): record the layer; data objects are copied lazily on
        # the first post-snapshot write (librbd object-clone role)
        self._header["snaps"][snap] = {
            "size": self._header["size"], "cow": True, "objects": {},
            "data_size": self._data.size}
        self._snap_order().append(snap)
        self._save_header()

    def snap_rollback(self, snap: str) -> None:
        self._check_writable()
        if snap not in self._header["snaps"]:
            raise RBDError(f"no snap {snap!r}")
        pos = self._journal_event("snap_rollback", arg=snap)
        self._snap_rollback_apply(snap)
        self._journal_committed(pos)

    def _snap_rollback_apply(self, snap: str) -> None:
        content = self.snap_read(snap)
        # newer snapshots must keep their views: protect every head
        # object they might still share before clobbering the head
        self._cow_protect(self._objnos(
            max(self._header["size"], len(content))))
        self._data.remove()
        self._data = StripedObject(self.io, f"rbd_data.{self.name}",
                                   self._data.layout)
        if content:
            self._data.write(content)
        self._header["size"] = self._header["snaps"][snap]["size"]
        self._save_header()

    def snap_remove(self, snap: str) -> None:
        self._check_writable()
        if snap not in self._header["snaps"]:
            raise RBDError(f"no snap {snap!r}")
        pos = self._journal_event("snap_remove", arg=snap)
        self._snap_remove_apply(snap)
        self._journal_committed(pos)
        self._notify_header()

    def _snap_remove_apply(self, snap: str) -> None:
        meta = self._header["snaps"][snap]
        if not meta.get("cow"):        # legacy full-copy snapshot
            StripedObject(self.io, self._snap_prefix(snap)).remove()
            del self._header["snaps"][snap]
            self._save_header()
            return
        order = self._snap_order()
        idx = order.index(snap)
        older = order[idx - 1] if idx > 0 else None
        for key, marker in meta.get("objects", {}).items():
            objno = int(key, 16)
            if older is not None:
                ometa = self._header["snaps"][older]
                if key not in ometa["objects"]:
                    # the older snapshot shared this object THROUGH
                    # this layer: the content moves down a level
                    if marker == "data":
                        self.io.write_full(
                            self._snap_piece(older, objno),
                            self.io.read(self._snap_piece(snap,
                                                          objno)))
                    ometa["objects"][key] = marker
            if marker == "data":
                try:
                    self.io.remove(self._snap_piece(snap, objno))
                except Exception:
                    pass
        order.remove(snap)
        del self._header["snaps"][snap]
        self._save_header()

    # -- replay-side application (rbd-mirror ImageReplayer) -------------
    def _apply_event(self, kind: str, offset: int, data: bytes,
                     arg: str) -> None:
        """Apply one journal event WITHOUT writability checks or
        re-journaling — the mirror target's replay path."""
        if kind == "write":
            self._cow_protect(self._touched_objnos(offset, len(data)))
            self._data.write(data, offset=offset)
            if offset + len(data) > self._header["size"]:
                self._header["size"] = offset + len(data)
                self._save_header()
        elif kind == "discard":
            length = int.from_bytes(data, "little")
            self._cow_protect(self._touched_objnos(offset, length))
            self._data.write(b"\x00" * length, offset=offset)
        elif kind == "resize":
            self._resize_apply(offset)
        elif kind == "snap_create":
            if arg not in self._header["snaps"]:
                self._snap_create_apply(arg)
        elif kind == "snap_remove":
            if arg in self._header["snaps"]:
                self._snap_remove_apply(arg)
        elif kind == "snap_rollback":
            if arg in self._header["snaps"]:
                self._snap_rollback_apply(arg)
        else:
            raise RBDError(f"unknown journal event {kind!r}")
