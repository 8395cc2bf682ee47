"""cephfs-lite — a POSIX-ish filesystem on RADOS (src/mds + src/client
roles, massively reduced).

Reference: CephFS keeps a metadata tree in the MDS (journaled to RADOS
via osdc/Journaler) and file data striped over RADOS objects by
file_layout_t. This lite version drops the separate MDS daemon and
stores metadata DIRECTLY in RADOS, with the dirop atomicity the MDS
journal provides coming from in-OSD object-class methods instead:

- ``.fs_super``     — inode allocator (cls fs.alloc_ino)
- ``inode.<ino>``   — json inode: dirs carry {name: ino} entries
                      (mutated only via cls fs.dir_link/dir_unlink,
                      so concurrent clients cannot corrupt a dir),
                      files carry size/mtime
- ``fsdata.<ino>``  — file content through the striper

API mirrors libcephfs: mkdir/rmdir/readdir, open/read/write, unlink,
rename, stat. Reductions (documented): no hard links across dirs; no
permissions/uids; one flat namespace per pool.

Concurrent mounts are first-class: the mdslog journal runs
in multi-writer mode (atomic position allocator + OSD-atomic chunk
appends; each mount tracks its own commit position), dir mutations
were already atomic in-OSD cls methods, and per-file CAPABILITIES
(src/mds/Capability.h role) coordinate data access — shared-read /
exclusive-write leases taken through the cls lock family on a
``caps.<ino>`` object. A cap is a TTL lease: its holder may cache the
inode while it holds the cap; a conflicting opener blocks until
release or lease expiry (the reference's cap revoke collapsed to
lease expiry — there is no MDS daemon to recall through). A mount
that dies without ``umount()`` pins the journal trim floor at its
last commit until a later mount re-commits past it (the reference
evicts such sessions; space-only, never correctness).

Metadata journaling (the osdc/Journaler + MDLog role): every
MULTI-STEP namespace op (mkdir/create/unlink/rmdir/rename) appends an
intent record to the ``mdslog`` journal before executing its steps;
mount replays the un-committed tail, re-executing steps idempotently.
That closes the crash windows the reference closes with the MDS
journal — most importantly rename's link-then-unlink window (a crash
between the two no longer leaves both names) — and is the MDS
FAILOVER story: the next mount (the standby taking over) recovers the
half-done op from the journal, exactly as a standby MDS replays the
failed rank's journal.
"""

from __future__ import annotations

import errno
import json
import time
import uuid

from ceph_tpu_torch.analysis.lock_witness import make_lock
from ceph_tpu_torch.client.striper import FileLayout, StripedObject
from ceph_tpu_torch.services.journal import Journaler, JournalError

ROOT_INO = 1
SUPER_OID = ".fs_super"

#: legacy journal-client id (pre-multi-writer mounts); still honored
#: in the replay floor so an old journal replays correctly
MDS_CLIENT = "mds"

#: capability lease (Capability.h role): seconds a shared/exclusive
#: file cap stays valid without renewal; a dead holder's cap expires
#: and a blocked conflicting opener proceeds
CAP_TTL = 2.0
CAP_NAME = "fscap"


class FSError(Exception):
    def __init__(self, err: int, message: str = "") -> None:
        super().__init__(message or errno.errorcode.get(err, str(err)))
        self.errno = err


class CephFS:
    """A mounted filesystem (libcephfs ceph_mount role)."""

    def __init__(self, ioctx, layout: FileLayout | None = None,
                 journaling: bool = True, caps: bool = True,
                 client_id: str | None = None) -> None:
        self.io = ioctx
        self.layout = layout or FileLayout(stripe_unit=1 << 20,
                                           stripe_count=1,
                                           object_size=1 << 20)
        if client_id is None:
            client_id = f"mds-{uuid.uuid4().hex[:8]}"
        self.client_id = client_id
        self.caps_enabled = caps
        self.journal = Journaler(self.io, "mdslog",
                                 multi_writer=True) \
            if journaling else None
        self._mds_lock = make_lock("cephfs.mds")
        self._mds_pos = 0            # own commit floor
        #: positions THIS mount allocated and has not yet completed
        self._mds_pending: set[int] = set()
        #: MOUNT-level cap table (Capability.h: caps belong to the
        #: CLIENT session, not the fd): ino -> (type, expires). All
        #: File handles of this mount share one cls-lock cookie, so
        #: acquisition must go through here — a handle re-locking the
        #: shared cookie with a weaker type would silently downgrade
        #: a sibling handle's exclusive cap on the server.
        self._caps: dict[int, tuple[str, float]] = {}
        self._caps_lock = make_lock("cephfs.caps")
        #: MOUNT-level inode cache, valid only while the mount's cap
        #: on that ino is valid. Shared across handles: a sibling
        #: handle's write must be visible to every reader of this
        #: mount, cap or no cap (same-client coherence).
        self._ino_cache: dict[int, dict] = {}
        #: (client, tid) -> journal record, for every journaled intent
        #: seen during replay that carried a request id. The MDS daemon
        #: seeds its completed-request dedup from this (the reference
        #: journals completed_requests in the MDLog for the same
        #: reason: a client retrying across MDS failover must get the
        #: completed reply, not a re-execution — SessionMap.h role).
        self.replayed_requests: dict[tuple[str, int], dict] = {}
        if self.journal is not None:
            if not self.journal.exists():
                self.journal.create()
            self._replay_mds_tail()
        # bootstrap the root directory (idempotent)
        try:
            self._read_inode(ROOT_INO)
        except FSError:
            self._write_inode(ROOT_INO, {
                "type": "dir", "entries": {}, "mtime": time.time()})

    def umount(self, drain_timeout: float = 5.0) -> None:
        """Clean unmount: release every held cap (a waiting opener on
        another mount proceeds immediately), drain in-flight dirops,
        and retire this mount's journal client (its commit position
        stops pinning the trim floor for good — the session-eviction
        role). If dirops fail to drain within ``drain_timeout`` the
        retirement is skipped LOUDLY — the client id stays pinned so
        the un-finished intents remain replayable."""
        for ino in list(self._caps):
            self._cap_release(ino)
        if self.journal is None:
            return
        deadline = time.time() + drain_timeout
        while time.time() < deadline:
            with self._mds_lock:
                if not self._mds_pending:
                    self.journal.retire(self.client_id)
                    return
            time.sleep(0.05)
        import sys
        print(f"cephfs umount: {len(self._mds_pending)} dirops still "
              f"pending after {drain_timeout}s; journal client "
              f"{self.client_id} NOT retired (its intents stay "
              "replayable)", file=sys.stderr)

    # -- MDS journal (osdc/Journaler + MDLog roles) -------------------
    def _replay_mds_tail(self) -> None:
        """Mount-time recovery (the standby-MDS replay): re-execute
        journaled intents from the lowest committed position of ANY
        registered mount — a crashed mount's half-done op is finished
        here. Steps are idempotent-tolerant, so replaying an op that
        partially (or fully) applied — even one a LIVE mount is
        executing concurrently — converges."""
        try:
            end = self.journal.end_position()
        except JournalError:
            return
        clients = self.journal.clients()
        floor = min(clients.values()) if clients \
            else self.journal.trim_floor()
        applied = max(min(floor, end), self.journal.trim_floor())
        clean = True
        try:
            for epos, payload in self.journal.read_from(applied):
                self._apply_mds_event(json.loads(payload))
                applied = epos + 1
        except JournalError:
            clean = False   # commit only the prefix that applied: a
            # transient chunk-read failure must NOT advance the floor
            # past un-replayed intents (a later mount re-attempts)
        if clean:
            # trailing hole positions (alloc'd, never appended) have
            # nothing to replay: the floor may cover them
            applied = max(applied, end)
        with self._mds_lock:
            self._mds_pos = applied
        self.journal.commit(self.client_id, applied)

    def _mds_event(self, op: str, req: tuple[str, int] | None = None,
                   **args) -> int | None:
        if self.journal is None:
            return None
        rec = {"op": op, **args}
        if req is not None:
            rec["req"] = list(req)
        payload = json.dumps(rec).encode()
        with self._mds_lock:
            pos = self.journal.append(payload)
            self._mds_pending.add(pos)
        return pos

    def _mds_committed(self, pos: int | None) -> None:
        """Mark an op's intent completed — including DELIBERATE
        failures (EEXIST etc.): only a crash mid-steps may leave an
        intent for replay. This mount's commit position advances to
        just below its OLDEST still-pending op (positions interleave
        across mounts; other mounts' positions never hold ours back —
        each mount's pointer promises only 'none of MY incomplete ops
        are below this')."""
        if self.journal is None or pos is None:
            return
        with self._mds_lock:
            self._mds_pending.discard(pos)
            old_pos = self._mds_pos
            new_pos = min(self._mds_pending) if self._mds_pending \
                else pos + 1
            if new_pos > old_pos:
                self._mds_pos = new_pos
                self.journal.commit(self.client_id, new_pos)
                # boundary-crossing check: out-of-order completion can
                # advance PAST a multiple of 128 in one step
                if old_pos // 128 != new_pos // 128:
                    # reclaim consumed journal chunks (the reference
                    # trims MDLog segments the same way); without this
                    # the journal grows one entry per dirop forever
                    self.journal.trim()

    @staticmethod
    def _step(fn) -> None:
        """Run one replay step, tolerating already-applied state
        (EEXIST/ENOENT from a step that landed before the crash):
        tolerance must be PER STEP — an op's later steps are exactly
        what the replay exists to finish."""
        try:
            fn()
        except Exception:
            pass

    def _apply_mds_event(self, rec: dict) -> None:
        op = rec["op"]
        if "req" in rec:
            client, tid = rec["req"]
            self.replayed_requests[(client, int(tid))] = rec
        if op in ("mkdir", "create"):
            kind = "dir" if op == "mkdir" else "file"
            inode = {"type": kind, "mtime": time.time()}
            inode.update({"entries": {}} if kind == "dir"
                         else {"size": 0})

            def mk():
                try:
                    self._read_inode(rec["ino"])
                except FSError:
                    self._write_inode(rec["ino"], inode)
            self._step(mk)
            self._step(lambda: self._dir_link(rec["parent"],
                                              rec["name"],
                                              rec["ino"]))
        elif op == "unlink":
            self._step(lambda: self._dir_unlink(rec["parent"],
                                                rec["name"]))
            self._step(lambda: StripedObject(
                self.io, f"fsdata.{rec['ino']}").remove())
            self._step(lambda: self.io.remove(f"inode.{rec['ino']}"))
        elif op == "rmdir":
            self._step(lambda: self._dir_unlink(rec["parent"],
                                                rec["name"]))
            self._step(lambda: self.io.remove(f"inode.{rec['ino']}"))
        elif op == "mksnap":
            def addsnap():
                inode = dict(self._read_inode(rec["parent"]))
                snaps = dict(inode.get("snaps", {}))
                if snaps.get(rec["name"]) != rec["ino"]:
                    # the live path writes with the realm INCLUDING
                    # the new snapid, so the pre-snapshot dir state is
                    # COW-preserved under it; replay must match, or a
                    # crash mid-mksnap loses that clone (and the COW
                    # owed to other governing realm snaps)
                    realm = self._realm_for_ino(rec["parent"]) or []
                    snaps[rec["name"]] = rec["ino"]
                    inode["snaps"] = snaps
                    self._write_inode(
                        rec["parent"], inode,
                        snapc=self._realm_snapc(
                            sorted(set(realm) | {rec["ino"]})))
            self._step(addsnap)
        elif op == "rmsnap":
            def dropsnap():
                inode = dict(self._read_inode(rec["parent"]))
                snaps = dict(inode.get("snaps", {}))
                if rec["name"] in snaps:
                    # live rmsnap writes under the REMAINING realm so
                    # older snapshots keep their COW; replay matches
                    realm = self._realm_for_ino(rec["parent"]) or []
                    del snaps[rec["name"]]
                    inode["snaps"] = snaps
                    self._write_inode(
                        rec["parent"], inode,
                        snapc=self._realm_snapc(
                            sorted(set(realm) - {rec["ino"]})))
            self._step(dropsnap)
            self._step(lambda: self.io.selfmanaged_snap_remove(
                rec["ino"]))
        elif op == "rename":
            self._step(lambda: self._dir_link(rec["new_parent"],
                                              rec["new_name"],
                                              rec["ino"]))
            self._step(lambda: self._dir_unlink(rec["old_parent"],
                                                rec["old_name"]))

    def _realm_for_ino(self, target: int) -> list[int] | None:
        """Rebuild the governing realm for ``target`` by walking the
        tree from the root (journal replay records inos, not paths):
        the union of every directory's snapids on the root->target
        path, INCLUDING the target's own — exactly what _resolve2
        collects during a live descent. Returns None when the ino is
        unreachable (caller degrades to no SnapContext, the pre-fix
        behavior)."""
        def walk(ino: int, realm: frozenset,
                 seen: set) -> frozenset | None:
            try:
                inode = self._read_inode(ino)
            except FSError:
                return None
            realm = realm | frozenset(
                inode.get("snaps", {}).values())
            if ino == target:
                return realm
            if inode.get("type") != "dir":
                return None
            for child in inode.get("entries", {}).values():
                if child in seen:
                    continue
                seen.add(child)
                got = walk(child, realm, seen)
                if got is not None:
                    return got
            return None

        got = walk(ROOT_INO, frozenset(), {ROOT_INO})
        return sorted(got) if got is not None else None

    # -- inode plumbing ------------------------------------------------
    def _read_inode(self, ino: int, snap: int = 0) -> dict:
        try:
            return json.loads(self.io.read(f"inode.{ino}", snap=snap))
        except Exception:
            raise FSError(errno.ENOENT, f"no inode {ino}")

    def _write_inode(self, ino: int, inode: dict,
                     snapc: dict | None = None) -> None:
        self.io.write_full(f"inode.{ino}", json.dumps(inode).encode(),
                           snapc=snapc)

    def _alloc_ino(self) -> int:
        out = self.io.execute(SUPER_OID, "fs", "alloc_ino")
        return json.loads(out)["ino"]

    def _resolve(self, path: str) -> tuple[int, dict]:
        """path -> (ino, inode); raises ENOENT/ENOTDIR."""
        ino, inode, _realm = self._resolve2(path)
        return ino, inode

    def _resolve2(self, path: str) -> tuple[int, dict, list[int]]:
        """path -> (ino, inode, realm snapids). The realm is the
        union of every traversed directory's snapshots — SnapRealm
        resolution (src/mds/SnapRealm.h:27 get_snaps walks ancestors
        the same way); collected during the descent the resolver
        already performs, so realms cost no extra reads."""
        ino, inode = ROOT_INO, self._read_inode(ROOT_INO)
        realm: set[int] = set(inode.get("snaps", {}).values())
        for part in [p for p in path.split("/") if p]:
            if inode["type"] != "dir":
                raise FSError(errno.ENOTDIR, path)
            child = inode["entries"].get(part)
            if child is None:
                raise FSError(errno.ENOENT, path)
            ino, inode = child, self._read_inode(child)
            realm.update(inode.get("snaps", {}).values())
        return ino, inode, sorted(realm)

    @staticmethod
    def _realm_snapc(realm: list[int]) -> dict | None:
        """SnapContext for a write governed by ``realm`` (librados
        SnapContext: seq + snapids newest-first), or None when no
        snapshot governs the path."""
        if not realm:
            return None
        return {"snap_seq": max(realm),
                "snaps": sorted(realm, reverse=True)}

    def _resolve_parent(self, path: str) -> tuple[int, str]:
        ino, name, _ = self._resolve_parent3(path)
        return ino, name

    def _resolve_parent3(self, path: str) -> tuple[int, str, dict]:
        ino, name, inode, _realm = self._resolve_parent4(path)
        return ino, name, inode

    def _resolve_parent4(self, path: str
                         ) -> tuple[int, str, dict, list[int]]:
        """Like _resolve_parent but also hands back the parent inode
        and the governing realm snapids already collected during
        resolution (saves callers a second walk)."""
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise FSError(errno.EINVAL, "root has no parent")
        parent = "/".join(parts[:-1])
        ino, inode, realm = self._resolve2(parent)
        if inode["type"] != "dir":
            raise FSError(errno.ENOTDIR, parent)
        return ino, parts[-1], inode, realm

    def _dir_link(self, dir_ino: int, name: str, ino: int,
                  snapc: dict | None = None) -> None:
        from ceph_tpu_torch.client.rados import RadosError
        try:
            self.io.execute(f"inode.{dir_ino}", "fs", "dir_link",
                            json.dumps({"name": name,
                                        "ino": ino}).encode(),
                            snapc=snapc)
        except RadosError as exc:
            raise FSError(-exc.code) from None

    def _dir_unlink(self, dir_ino: int, name: str,
                    snapc: dict | None = None) -> int:
        from ceph_tpu_torch.client.rados import RadosError
        try:
            out = self.io.execute(f"inode.{dir_ino}", "fs",
                                  "dir_unlink",
                                  json.dumps({"name": name}).encode(),
                                  snapc=snapc)
        except RadosError as exc:
            raise FSError(-exc.code) from None
        return json.loads(out)["ino"]

    # -- namespace ops (libcephfs surface) ----------------------------
    def mkdir(self, path: str,
              req: tuple[str, int] | None = None) -> None:
        parent, name, pinode, realm = self._resolve_parent4(path)
        if name in pinode.get("entries", {}):
            raise FSError(errno.EEXIST, path)
        snapc = self._realm_snapc(realm)
        ino = self._alloc_ino()
        pos = self._mds_event("mkdir", parent=parent, name=name,
                              ino=ino, req=req)
        try:
            self._write_inode(ino, {"type": "dir", "entries": {},
                                    "mtime": time.time()},
                              snapc=snapc)
            self._dir_link(parent, name, ino, snapc=snapc)
        finally:
            self._mds_committed(pos)

    def readdir(self, path: str) -> list[str]:
        snap = self._snap_split(path)
        if snap is not None:
            dirpath, snapname, rest = snap
            if snapname is None:      # ".../<dir>/.snap" itself
                _, dinode = self._resolve(dirpath)
                if dinode["type"] != "dir":
                    raise FSError(errno.ENOTDIR, path)
                return sorted(dinode.get("snaps", {}))
            _, inode, _sid = self._resolve_snap(dirpath, snapname,
                                                rest)
            if inode["type"] != "dir":
                raise FSError(errno.ENOTDIR, path)
            return sorted(inode["entries"])
        _, inode = self._resolve(path)
        if inode["type"] != "dir":
            raise FSError(errno.ENOTDIR, path)
        return sorted(inode["entries"])

    def stat(self, path: str) -> dict:
        snap = self._snap_split(path)
        if snap is not None and snap[1] is not None:
            ino, inode, snapid = self._resolve_snap(*snap)
            out = {"ino": ino, "type": inode["type"],
                   "mtime": inode["mtime"], "snapid": snapid}
            if inode["type"] == "file":
                out["size"] = inode.get("size", 0)
            else:
                out["nentries"] = len(inode["entries"])
            return out
        ino, inode = self._resolve(path)
        out = {"ino": ino, "type": inode["type"],
               "mtime": inode["mtime"]}
        if inode["type"] == "file":
            out["size"] = inode.get("size", 0)
        else:
            out["nentries"] = len(inode["entries"])
        return out

    def rmdir(self, path: str,
              req: tuple[str, int] | None = None) -> None:
        ino, inode = self._resolve(path)
        if inode["type"] != "dir":
            raise FSError(errno.ENOTDIR, path)
        if inode["entries"]:
            raise FSError(errno.ENOTEMPTY, path)
        parent, name, _pinode, realm = self._resolve_parent4(path)
        snapc = self._realm_snapc(realm)
        pos = self._mds_event("rmdir", parent=parent, name=name,
                              ino=ino, req=req)
        try:
            self._dir_unlink(parent, name, snapc=snapc)
            self.io.remove(f"inode.{ino}", snapc=snapc)
        finally:
            self._mds_committed(pos)

    def create(self, path: str,
               req: tuple[str, int] | None = None) -> "File":
        parent, name, pinode, realm = self._resolve_parent4(path)
        if name in pinode.get("entries", {}):
            raise FSError(errno.EEXIST, path)
        snapc = self._realm_snapc(realm)
        ino = self._alloc_ino()
        pos = self._mds_event("create", parent=parent, name=name,
                              ino=ino, req=req)
        try:
            self._write_inode(ino, {"type": "file", "size": 0,
                                    "mtime": time.time()},
                              snapc=snapc)
            self._dir_link(parent, name, ino, snapc=snapc)
        finally:
            self._mds_committed(pos)
        return File(self, ino, snapc=snapc)

    def open(self, path: str, create: bool = False) -> "File":
        snap = self._snap_split(path)
        if snap is not None:
            ino, inode, snapid = self._resolve_snap(*snap)
            if inode["type"] != "file":
                raise FSError(errno.EISDIR, path)
            return File(self, ino, snapid=snapid)
        try:
            ino, inode, realm = self._resolve2(path)
        except FSError as exc:
            if create and exc.errno == errno.ENOENT:
                return self.create(path)
            raise
        if inode["type"] != "file":
            raise FSError(errno.EISDIR, path)
        return File(self, ino, snapc=self._realm_snapc(realm))

    # -- capabilities (Capability.h role, per-mount session) ----------
    def cap_holders(self, path: str) -> dict:
        """Live cap lockers of a file: {"name/cookie": {"type", ...}}
        (the MDS's cap tracking, surfaced for tests/tools)."""
        ino, _ = self._resolve(path)
        out = self.io.execute(f"caps.{ino}", "lock", "info")
        return json.loads(out).get("lockers", {})

    def _cap_acquire(self, ino: int, want: str,
                     timeout: float) -> None:
        """Take/renew this MOUNT's cap on ``ino`` — never weaker than
        what the mount already holds (an exclusive cap covers shared
        requests; re-locking the shared cookie with 'shared' would
        downgrade a sibling handle's exclusive on the server). The
        lease deadline is stamped from BEFORE the lock RPC, so the
        client-side expiry is always <= the server-side one. The
        table lock guards only table reads/writes — the RPC runs
        OUTSIDE it, so a contended file never stalls cap checks of
        other files in this mount."""
        if not self.caps_enabled:
            return
        from ceph_tpu_torch.client.rados import RadosError
        deadline = time.time() + timeout
        while True:
            with self._caps_lock:
                cur = self._caps.get(ino)
                now = time.time()
                if cur is not None and now < cur[1] - CAP_TTL / 2 \
                        and (cur[0] == want or cur[0] == "exclusive"):
                    return              # held, fresh, and sufficient
                eff = "exclusive" if want == "exclusive" or (
                    cur is not None and cur[0] == "exclusive"
                    and now < cur[1]) else want
            t_req = time.time()
            try:
                self.io.execute(
                    f"caps.{ino}", "lock", "lock",
                    json.dumps({"name": CAP_NAME,
                                "cookie": self.client_id,
                                "type": eff,
                                "duration": CAP_TTL}).encode())
                with self._caps_lock:
                    # keep the strongest view: a concurrent acquirer
                    # may have upgraded while our RPC was in flight
                    cur = self._caps.get(ino)
                    if cur is None or cur[0] != "exclusive" or \
                            eff == "exclusive":
                        self._caps[ino] = (eff, t_req + CAP_TTL)
                return
            except RadosError as exc:
                if exc.code != -16:      # not EBUSY
                    raise FSError(-exc.code) from None
                with self._caps_lock:
                    self._caps.pop(ino, None)
                    self._ino_cache.pop(ino, None)
            if time.time() >= deadline:
                raise FSError(errno.EAGAIN,
                              "file cap held by another client")
            time.sleep(0.05)

    def _cap_release(self, ino: int) -> None:
        """Drop the mount's cap on ``ino`` (all handles lose it; the
        next op re-acquires)."""
        with self._caps_lock:
            held = self._caps.pop(ino, None)
            self._ino_cache.pop(ino, None)
        if held is None or not self.caps_enabled:
            return
        from ceph_tpu_torch.client.rados import RadosError
        try:
            self.io.execute(
                f"caps.{ino}", "lock", "unlock",
                json.dumps({"name": CAP_NAME,
                            "cookie": self.client_id}).encode())
        except RadosError:
            pass                        # already expired/stolen

    def _cap_valid(self, ino: int) -> bool:
        with self._caps_lock:
            cur = self._caps.get(ino)
            return cur is not None and time.time() < cur[1]

    def _cached_inode(self, ino: int) -> "dict | None":
        """Mount-level cached inode, valid only under a live cap."""
        with self._caps_lock:
            cur = self._caps.get(ino)
            if cur is None or time.time() >= cur[1]:
                self._ino_cache.pop(ino, None)
                return None
            return self._ino_cache.get(ino)

    def _cache_inode(self, ino: int, inode: dict) -> None:
        with self._caps_lock:
            cur = self._caps.get(ino)
            if cur is not None and time.time() < cur[1]:
                self._ino_cache[ino] = inode

    def unlink(self, path: str,
               req: tuple[str, int] | None = None) -> None:
        ino, inode = self._resolve(path)
        if inode["type"] == "dir":
            raise FSError(errno.EISDIR, path)
        parent, name, _pinode, realm = self._resolve_parent4(path)
        snapc = self._realm_snapc(realm)
        pos = self._mds_event("unlink", parent=parent, name=name,
                              ino=ino, req=req)
        try:
            self._dir_unlink(parent, name, snapc=snapc)
            # carried snapc: removal COW-preserves the file's data
            # and inode for governing snapshots (snapshotted files
            # survive their deletion — the point of the snapshot)
            StripedObject(self.io, f"fsdata.{ino}",
                          snapc=snapc).remove()
            self.io.remove(f"inode.{ino}", snapc=snapc)
        finally:
            self._mds_committed(pos)

    def rename(self, old: str, new: str,
               req: tuple[str, int] | None = None) -> None:
        """Link under the new name, then unlink the old. The journaled
        intent makes the pair crash-atomic: a mount after a crash
        between the steps replays the intent and finishes the unlink
        (the MDS journal's dirop atomicity, MDLog/EUpdate role)."""
        ino, _ = self._resolve(old)
        new_parent, new_name, _pi, new_realm = \
            self._resolve_parent4(new)
        old_parent, old_name, _pi2, old_realm = \
            self._resolve_parent4(old)
        pos = self._mds_event(
            "rename", ino=ino, new_parent=new_parent,
            new_name=new_name, old_parent=old_parent,
            old_name=old_name, req=req)
        try:
            self._dir_link(new_parent, new_name, ino,
                           snapc=self._realm_snapc(new_realm))
            self._dir_unlink(old_parent, old_name,
                             snapc=self._realm_snapc(old_realm))
        finally:
            self._mds_committed(pos)


    # -- snapshots (SnapRealm-lite: src/mds/SnapRealm.h:27,
    # SnapServer.h roles) ---------------------------------------------
    # A snapshot lives on a DIRECTORY: its snapid is allocated from
    # the pool's self-managed snap sequence (the SnapServer table
    # role, delegated to the pool like librados selfmanaged snaps),
    # recorded in the directory inode, and every write under the
    # directory carries a SnapContext including it — the OSD's
    # make_writeable COW preserves both metadata objects (inodes,
    # journaled dir entries) and striped data, so reading any inode
    # or data object at the snapid reconstructs the subtree as of the
    # snapshot. Surfaced through the ".snap" pseudo-directory
    # convention: readdir("/d/.snap") lists snapshots and
    # "/d/.snap/<name>/..." resolves inside one, as in the reference.

    def mksnap(self, path: str, name: str,
               req: tuple[str, int] | None = None) -> int:
        """Snapshot directory ``path`` as ``name``; returns the
        snapid. Journaled (mksnap intent carries the allocated
        snapid, so a crash mid-op replays to completion)."""
        ino, inode, realm = self._resolve2(path)
        if inode["type"] != "dir":
            raise FSError(errno.ENOTDIR, path)
        if name in inode.get("snaps", {}):
            raise FSError(errno.EEXIST, f"{path}@{name}")
        snapid = self.io.selfmanaged_snap_create()
        pos = self._mds_event("mksnap", parent=ino, name=name,
                              ino=snapid, req=req)
        try:
            inode = dict(self._read_inode(ino))
            snaps = dict(inode.get("snaps", {}))
            snaps[name] = snapid
            inode["snaps"] = snaps
            # the inode write carries the NEW snap too: COW preserves
            # the pre-snapshot dir state under the new snapid
            self._write_inode(
                ino, inode,
                snapc=self._realm_snapc(sorted(set(realm)
                                               | {snapid})))
        finally:
            self._mds_committed(pos)
        return snapid

    def rmsnap(self, path: str, name: str,
               req: tuple[str, int] | None = None) -> None:
        ino, inode, realm = self._resolve2(path)
        if inode["type"] != "dir":
            raise FSError(errno.ENOTDIR, path)
        snapid = inode.get("snaps", {}).get(name)
        if snapid is None:
            raise FSError(errno.ENOENT, f"{path}@{name}")
        pos = self._mds_event("rmsnap", parent=ino, name=name,
                              ino=snapid, req=req)
        try:
            inode = dict(self._read_inode(ino))
            snaps = dict(inode.get("snaps", {}))
            snaps.pop(name, None)
            inode["snaps"] = snaps
            self._write_inode(
                ino, inode,
                snapc=self._realm_snapc(
                    sorted(set(realm) - {snapid})))
            # retire the snapid: OSD trimmers reclaim its clones
            self.io.selfmanaged_snap_remove(snapid)
        finally:
            self._mds_committed(pos)

    def lssnap(self, path: str) -> dict:
        """{name: snapid} of the directory's snapshots."""
        _, inode = self._resolve(path)
        if inode["type"] != "dir":
            raise FSError(errno.ENOTDIR, path)
        return dict(inode.get("snaps", {}))

    @staticmethod
    def _snap_split(path: str):
        """Detect the ".snap" pseudo-directory: returns
        (dirpath, snapname | None, rest) or None for ordinary
        paths."""
        parts = [p for p in path.split("/") if p]
        if ".snap" not in parts:
            return None
        i = parts.index(".snap")
        dirpath = "/".join(parts[:i])
        tail = parts[i + 1:]
        if not tail:
            return dirpath, None, []
        return dirpath, tail[0], tail[1:]

    def _resolve_snap(self, dirpath: str, snapname: str,
                      rest: list[str]) -> tuple[int, dict, int]:
        """Resolve a path inside a snapshot: the snapshotted dir is
        read at HEAD to find the snapid, then every descent below it
        reads inodes AT the snapid (the realm's frozen namespace)."""
        dino, dinode = self._resolve(dirpath)
        if dinode["type"] != "dir":
            raise FSError(errno.ENOTDIR, dirpath)
        snapid = dinode.get("snaps", {}).get(snapname)
        if snapid is None:
            raise FSError(errno.ENOENT, f"{dirpath}@{snapname}")
        # the dir itself as of the snapshot
        ino = dino
        inode = self._read_inode(dino, snap=snapid)
        for part in rest:
            if inode["type"] != "dir":
                raise FSError(errno.ENOTDIR, part)
            child = inode["entries"].get(part)
            if child is None:
                raise FSError(errno.ENOENT, part)
            ino = child
            inode = self._read_inode(child, snap=snapid)
        return ino, inode, snapid


class File:
    """An open file handle (libcephfs Fh role) with per-file
    CAPABILITIES (src/mds/Capability.h role, reduced to leases):

    - reads take a SHARED cap, writes an EXCLUSIVE cap, on the file's
      ``caps.<ino>`` object via the cls lock family — any number of
      readers, one writer, cluster-wide;
    - a cap is a CAP_TTL lease renewed lazily by use; while held, the
      inode may be cached (cache validity == cap validity — the
      coherence contract caps exist for);
    - a conflicting opener blocks until release or lease expiry
      (the reference's revoke recall, collapsed to lease expiry), then
      raises EAGAIN past ``cap_timeout``.
    """

    def __init__(self, fs: CephFS, ino: int,
                 snapc: dict | None = None, snapid: int = 0) -> None:
        self.fs = fs
        self.ino = ino
        #: realm SnapContext (writes) / pinned snapid (snapshot
        #: handles are read-only). The realm is captured at open; a
        #: snapshot created while a writer holds the handle applies
        #: from its next open (documented reduction of the
        #: reference's cap-recall realm push).
        self.snapc = snapc
        self.snapid = snapid
        self._data = StripedObject(fs.io, f"fsdata.{ino}", fs.layout,
                                   snapc=snapc, snapid=snapid)
        self.cap_timeout = 10.0

    # -- caps (delegated to the MOUNT's session table) ----------------
    def _acquire_cap(self, want: str) -> None:
        self.fs._cap_acquire(self.ino, want, self.cap_timeout)

    def release(self) -> None:
        """Drop the mount's cap on this file (libcephfs close role): a
        waiting conflicting opener proceeds immediately instead of at
        lease expiry. Sibling handles of the same mount simply
        re-acquire on their next op."""
        self.fs._cap_release(self.ino)

    close = release

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def _inode(self) -> dict:
        """Inode view — cached at the MOUNT level while the mount's
        cap on this ino is unexpired (sibling handles of one mount
        share the cache, so one handle's write is visible to the
        others immediately); re-read otherwise."""
        if self.snapid:
            return self.fs._read_inode(self.ino, snap=self.snapid)
        if self.fs.caps_enabled:
            cached = self.fs._cached_inode(self.ino)
            if cached is not None:
                return cached
        inode = self.fs._read_inode(self.ino)
        if self.fs.caps_enabled:
            self.fs._cache_inode(self.ino, inode)
        return inode

    def _put_inode(self, inode: dict) -> None:
        self.fs._write_inode(self.ino, inode, snapc=self.snapc)
        if self.fs.caps_enabled:
            self.fs._cache_inode(self.ino, inode)

    # -- I/O ----------------------------------------------------------
    def write(self, data: bytes, offset: int = 0) -> int:
        if self.snapid:
            raise FSError(errno.EROFS, "snapshot handles are "
                          "read-only")
        self._acquire_cap("exclusive")
        self._data.write(data, offset=offset)
        inode = self._inode()
        inode = dict(inode)
        inode["size"] = max(inode.get("size", 0), offset + len(data))
        inode["mtime"] = time.time()
        self._put_inode(inode)
        return len(data)

    def read(self, length: int | None = None, offset: int = 0) -> bytes:
        if not self.snapid:
            self._acquire_cap("shared")
        inode = self._inode()
        size = inode.get("size", 0)
        # inode size is authoritative: sync the striper handle's
        # cached stream size, or a handle opened before another
        # client grew the file clamps its reads short
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
            raise FSError(errno.EROFS, "snapshot handles are "
                          "read-only")
        self._acquire_cap("exclusive")
        inode = dict(self._inode())
        inode["size"] = size
        self._put_inode(inode)
        self._data.size = min(self._data.size, size)
        self._data._write_meta()

    def size(self) -> int:
        self._acquire_cap("shared")
        return self._inode().get("size", 0)
