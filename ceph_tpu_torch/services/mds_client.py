"""CephFS client mount against the MDS daemon (src/client/Client.cc
role).

The reference client sends every metadata op to the active MDS
(MClientRequest), caches inode state only under caps the MDS granted,
answers cap recalls (flush dirty state, release), and does file DATA
I/O directly against the OSDs through the striper — the MDS never sees
data. This mount keeps exactly that split: namespace + attribute ops
are MMDSOp RPCs, data rides ``StripedObject`` on the mount's own
ioctx, caps live in a local table mirroring the server grant and a
revoke push drops them mid-flight.

Failover (Client.cc ms_handle_reset / resend_unsafe_requests role):
the active MDS's address is read from the ``mdsmap`` object; an RPC
that times out or gets ESTALE re-reads the map and RESENDS THE SAME
tid — the new active's journal-seeded completed-request table replies
to mutations that already executed instead of re-running them.
"""

from __future__ import annotations

import errno
import json
import threading
import time
import uuid

from ceph_tpu_torch.analysis.lock_witness import make_lock, make_rlock
from ceph_tpu_torch.client.striper import FileLayout, StripedObject
from ceph_tpu_torch.parallel import messages as M
from ceph_tpu_torch.parallel.messenger import Messenger
from ceph_tpu_torch.services.cephfs import FSError
from ceph_tpu_torch.services.mds import MDSMAP_OID
from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.utils.workerpool import DaemonPool

log = Dout("fsclient")


class CephFSMount:
    """A mounted filesystem talking to the MDS daemon."""

    def __init__(self, ioctx, layout: FileLayout | None = None,
                 client_id: str | None = None,
                 op_timeout: float = 20.0) -> None:
        self.io = ioctx
        self.layout = layout or FileLayout(stripe_unit=1 << 20,
                                           stripe_count=1,
                                           object_size=1 << 20)
        self.client_id = client_id or f"fsclient-{uuid.uuid4().hex[:8]}"
        self.op_timeout = op_timeout
        self.msgr = Messenger(f"client.{self.client_id}")
        self.msgr.set_dispatcher(self._dispatch)
        self.msgr.start()
        self._lock = make_lock("fsclient")
        self._next_tid = 1
        self._pending: dict[int, list] = {}     # tid -> [Event, reply]
        self._mds_addr = ""
        #: local cap mirror: ino -> (type, client-side expiry). Always
        #: <= the server lease (stamped from before the RPC).
        self._caps: dict[int, tuple[str, float]] = {}
        self._attr: dict[int, dict] = {}        # valid only under cap
        self._caps_lock = make_lock("fsclient.caps")
        #: cap_acquire RPCs in flight per ino, with a revoked flag: a
        #: recall that lands BEFORE the grant is stored locally must
        #: not be dropped (the server would wait on a release that
        #: never comes) — it is parked here and honored post-store
        self._acquiring: dict[int, int] = {}
        self._revoked_midair: set[int] = set()
        self._ino_locks: dict[int, object] = {}
        # revoke handling must run OFF the messenger loop: the flush +
        # release RPC waits on replies dispatched by that very loop
        self._revoker = DaemonPool(
            max_workers=2, thread_name_prefix=f"fs-revoke")
        self._cap_ttl = 2.0
        self._rpc("session_open", {})

    # -- plumbing ------------------------------------------------------
    def _resolve_mds(self, force: bool = False) -> str:
        if self._mds_addr and not force:
            return self._mds_addr
        try:
            mdsmap = json.loads(self.io.read(MDSMAP_OID))
            self._mds_addr = mdsmap["addr"]
        except Exception:
            raise FSError(errno.ENXIO, "no active mds (no mdsmap)") \
                from None
        return self._mds_addr

    def _dispatch(self, msg: M.Message, conn) -> None:
        if isinstance(msg, M.MMDSOpReply):
            with self._lock:
                ent = self._pending.get(msg.tid)
            if ent is not None:
                ent[1] = msg
                ent[0].set()
        elif isinstance(msg, M.MMDSCapRevoke):
            self._revoker.submit(self._on_revoke, msg.ino, msg.keep)

    def _on_revoke(self, ino: int, keep: str) -> None:
        """Cap recall (MClientCaps revoke): serialize with in-flight
        I/O on the ino (the per-ino lock is held across a write and
        its setattr flush — so the release below always happens after
        the current mutation is fully flushed), drop the cache, give
        the cap back."""
        try:
            with self._ino_lock(ino):
                with self._caps_lock:
                    held = self._caps.get(ino)
                    if held is None:
                        if self._acquiring.get(ino):
                            # recall raced ahead of our acquire's
                            # local store: park it — _cap_get honors
                            # it right after storing the grant
                            self._revoked_midair.add(ino)
                        return
                    if keep == "shared" and held[0] == "shared":
                        return          # already no stronger than keep
                    self._caps.pop(ino, None)
                    self._attr.pop(ino, None)
                self._rpc("cap_release", {"ino": ino}, timeout=5.0)
        except Exception as exc:
            log(5, f"cap revoke handling on ino {ino}: {exc!r}")

    def _ino_lock(self, ino: int):
        with self._lock:
            lk = self._ino_locks.get(ino)
            if lk is None:
                lk = self._ino_locks[ino] = make_rlock("fsclient.ino")
            return lk

    def _rpc(self, op: str, args: dict,
             timeout: float | None = None) -> dict:
        timeout = timeout or self.op_timeout
        with self._lock:
            tid = self._next_tid
            self._next_tid += 1
        deadline = time.monotonic() + timeout
        per_try = min(2.0, timeout / 2)
        payload = json.dumps(args).encode()
        force_remap = False
        while True:
            try:
                addr = self._resolve_mds(force=force_remap)
            except FSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.2)
                force_remap = True
                continue
            with self._lock:
                ent = [threading.Event(), None]
                self._pending[tid] = ent
            self.msgr.send_message(
                M.MMDSOp(tid=tid, client=self.client_id, op=op,
                         args=payload), addr)
            step = min(per_try, max(deadline - time.monotonic(), 0.05))
            ok = ent[0].wait(step)
            with self._lock:
                self._pending.pop(tid, None)
            if not ok:
                if time.monotonic() >= deadline:
                    raise FSError(errno.ETIMEDOUT,
                                  f"mds op {op} timed out")
                force_remap = True     # maybe a failover: re-read map
                continue
            reply: M.MMDSOpReply = ent[1]
            if reply.code == -errno.ESTALE:
                # deposed daemon: the new active is in the mdsmap
                if time.monotonic() >= deadline:
                    raise FSError(errno.ESTALE, f"mds op {op}")
                force_remap = True
                time.sleep(0.1)
                continue
            if reply.code == -errno.EAGAIN and op == "cap_acquire":
                raise FSError(errno.EAGAIN, "cap held by another "
                              "client")
            if reply.code < 0:
                raise FSError(-reply.code, f"mds op {op}")
            return json.loads(reply.data) if reply.data else {}

    # -- namespace (libcephfs surface) --------------------------------
    def mkdir(self, path: str) -> None:
        self._rpc("mkdir", {"path": path})

    def rmdir(self, path: str) -> None:
        self._rpc("rmdir", {"path": path})

    def readdir(self, path: str) -> list[str]:
        return self._rpc("readdir", {"path": path})["entries"]

    def stat(self, path: str) -> dict:
        return self._rpc("stat", {"path": path})

    def unlink(self, path: str) -> None:
        self._rpc("unlink", {"path": path})

    def rename(self, old: str, new: str) -> None:
        self._rpc("rename", {"old": old, "new": new})

    def create(self, path: str) -> "MDSFile":
        out = self._rpc("create", {"path": path})
        return MDSFile(self, out["ino"],
                       snaps=out.get("snaps", []))

    def open(self, path: str, create: bool = False) -> "MDSFile":
        out = self._rpc("open", {"path": path, "create": create})
        return MDSFile(self, out["ino"],
                       snaps=out.get("snaps", []),
                       snapid=out.get("snapid", 0))

    # -- snapshots (SnapRealm-lite; ".snap" pseudo-dir surface) -------
    def mksnap(self, path: str, name: str) -> int:
        return self._rpc("mksnap", {"path": path,
                                    "name": name})["snapid"]

    def rmsnap(self, path: str, name: str) -> None:
        self._rpc("rmsnap", {"path": path, "name": name})

    def lssnap(self, path: str) -> dict:
        return self._rpc("lssnap", {"path": path})["snaps"]

    def umount(self) -> None:
        for ino in list(self._caps):
            try:
                self._cap_put(ino)
            except Exception:
                pass
        try:
            self._rpc("session_close", {}, timeout=5.0)
        except Exception:
            pass
        self._revoker.shutdown(wait=False)
        self.msgr.shutdown()

    def __enter__(self) -> "CephFSMount":
        return self

    def __exit__(self, *exc) -> None:
        self.umount()

    # -- caps ----------------------------------------------------------
    def _cap_get(self, ino: int, want: str,
                 timeout: float = 10.0) -> None:
        """Hold a live cap >= ``want`` on ino (RPC to the MDS when the
        local mirror is missing, expiring, or too weak). A recall that
        lands mid-acquire is honored immediately after the grant is
        stored (release + one retry) — dropping it would leave the
        server waiting on a release that never comes."""
        deadline = time.time() + timeout
        while True:
            with self._caps_lock:
                held = self._caps.get(ino)
                if held is not None and \
                        time.time() < held[1] - self._cap_ttl / 2 and \
                        (held[0] == want or held[0] == "exclusive"):
                    return
                eff = "exclusive" if want == "exclusive" or (
                    held is not None and held[0] == "exclusive"
                    and time.time() < held[1]) else want
                self._acquiring[ino] = \
                    self._acquiring.get(ino, 0) + 1
            t_req = time.time()
            try:
                out = self._rpc(
                    "cap_acquire",
                    {"ino": ino, "want": eff, "timeout": timeout},
                    timeout=timeout + 5.0)
            finally:
                revoked = False
                with self._caps_lock:
                    n = self._acquiring.get(ino, 1) - 1
                    if n:
                        self._acquiring[ino] = n
                    else:
                        self._acquiring.pop(ino, None)
                        revoked = ino in self._revoked_midair
                        self._revoked_midair.discard(ino)
            with self._lock:
                self._cap_ttl = float(out.get("ttl", self._cap_ttl))
            if revoked:
                # grant crossed a recall on the wire: give it back and
                # re-acquire (the conflicting holder goes first)
                self._rpc("cap_release", {"ino": ino}, timeout=5.0)
                if time.time() >= deadline:
                    raise FSError(errno.EAGAIN,
                                  "cap revoked while acquiring")
                continue
            with self._caps_lock:
                held = self._caps.get(ino)
                if held is None or held[0] != "exclusive" or \
                        out["type"] == "exclusive":
                    self._caps[ino] = (out["type"],
                                       t_req + self._cap_ttl)
            return

    def _cap_put(self, ino: int) -> None:
        with self._caps_lock:
            held = self._caps.pop(ino, None)
            self._attr.pop(ino, None)
        if held is not None:
            self._rpc("cap_release", {"ino": ino}, timeout=5.0)

    def _getattr(self, ino: int) -> dict:
        with self._caps_lock:
            held = self._caps.get(ino)
            if held is not None and time.time() < held[1]:
                cached = self._attr.get(ino)
                if cached is not None:
                    return cached
        attr = self._rpc("getattr", {"ino": ino})
        with self._caps_lock:
            held = self._caps.get(ino)
            if held is not None and time.time() < held[1]:
                self._attr[ino] = attr
        return attr


class MDSFile:
    """Open file handle (Fh role): data via the striper, attributes
    via the MDS, coherence via server-granted caps."""

    def __init__(self, mount: CephFSMount, ino: int,
                 snaps: list | None = None, snapid: int = 0) -> None:
        self.m = mount
        self.ino = ino
        #: governing realm snapids (newest-first) from the MDS open
        #: reply — data writes go DIRECTLY to the OSDs, so this
        #: handle carries the SnapContext itself; ``snapid`` pins a
        #: read-only snapshot handle
        self.snaps = [int(x) for x in (snaps or [])]
        self.snapid = int(snapid)
        snapc = {"snap_seq": max(self.snaps),
                 "snaps": self.snaps} if self.snaps else None
        self._snapc = snapc
        self._data = StripedObject(mount.io, f"fsdata.{ino}",
                                   mount.layout, snapc=snapc,
                                   snapid=self.snapid)
        self.cap_timeout = 10.0

    def release(self) -> None:
        self.m._cap_put(self.ino)

    close = release

    def __enter__(self) -> "MDSFile":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def write(self, data: bytes, offset: int = 0) -> int:
        if self.snapid:
            raise FSError(errno.EROFS,
                          "snapshot handles are read-only")
        with self.m._ino_lock(self.ino):
            self.m._cap_get(self.ino, "exclusive", self.cap_timeout)
            self._data.write(data, offset=offset)
            out = self.m._rpc("setattr",
                              {"ino": self.ino,
                               "size": offset + len(data),
                               "snaps": self.snaps,
                               "mtime": time.time()})
            with self.m._caps_lock:
                if self.ino in self.m._attr:
                    self.m._attr[self.ino]["size"] = out["size"]
        return len(data)

    def read(self, length: int | None = None,
             offset: int = 0) -> bytes:
        if self.snapid:
            # snapshot data is immutable: no caps, size from the
            # snapshotted meta the striper handle already read
            size = self._data.size
            if length is None:
                length = max(size - offset, 0)
            length = min(length, max(size - offset, 0))
            if length <= 0:
                return b""
            out = self._data.read(length, offset)
            return out + b"\x00" * (length - len(out))
        self.m._cap_get(self.ino, "shared", self.cap_timeout)
        size = self.m._getattr(self.ino).get("size", 0)
        # the MDS inode size is authoritative: sync the striper
        # handle's cached stream size, or a handle opened before
        # another client grew the file clamps its reads short
        self._data.size = size
        if length is None:
            length = max(size - offset, 0)
        length = min(length, max(size - offset, 0))
        if length <= 0:
            return b""
        out = self._data.read(length, offset)
        return out + b"\x00" * (length - len(out))

    def truncate(self, size: int) -> None:
        if self.snapid:
            raise FSError(errno.EROFS,
                          "snapshot handles are read-only")
        with self.m._ino_lock(self.ino):
            self.m._cap_get(self.ino, "exclusive", self.cap_timeout)
            self.m._rpc("setattr", {"ino": self.ino, "size": size,
                                    "force": True,
                                    "snaps": self.snaps,
                                    "mtime": time.time()})
            self._data.size = min(self._data.size, size)
            self._data._write_meta()
            with self.m._caps_lock:
                if self.ino in self.m._attr:
                    self.m._attr[self.ino]["size"] = size

    def size(self) -> int:
        self.m._cap_get(self.ino, "shared", self.cap_timeout)
        return self.m._getattr(self.ino).get("size", 0)
