"""MDS — the standalone metadata server daemon (src/mds/MDSDaemon.cc,
src/mds/Server.cc, src/mds/Locker.cc roles).

The reference runs CephFS metadata through a separate daemon: clients
send MClientRequest to the active MDS, which journals every namespace
mutation to RADOS (MDLog/osdc Journaler) before applying it, and
coordinates client caching with server-driven CAPABILITIES — the MDS
grants caps and RECALLS them (MClientCaps revoke) when another client
wants a conflicting one (src/mds/Locker.cc:2482 issue_caps /
revoke path). A standby MDS takes over a failed rank by replaying its
journal (MDSDaemon state machine: up:replay -> up:active).

This daemon keeps that architecture on the framework's substrate:

- **namespace ownership**: all metadata ops arrive as MMDSOp over the
  messenger and execute inside the daemon against its ``CephFS``
  engine (journaling on, client cls-caps off — the daemon replaces
  them). Clients never touch inode objects; file DATA still flows
  client -> OSD directly through the striper, exactly the reference's
  split (data path bypasses the MDS).
- **journaled ops + request dedup**: every namespace mutation journals
  an intent (with the requesting (client, tid)) before its steps; a
  retry after failover finds the completed request in the replayed
  journal and gets its reply back instead of a re-execution — the
  reference's completed_requests in SessionMap (src/mds/Server.cc
  handle_client_request "completed request" path).
- **server-driven caps** (Capability.h / Locker.cc): in-memory cap
  table ino -> {client: (type, expires)}. A conflicting acquire makes
  the MDS push MMDSCapRevoke to the holders; their release (or lease
  expiry / session death, the dead-client backstop) unblocks the
  waiter. Caps are leases renewed by use; the client may cache inode
  attributes only while its cap is live.
- **active/standby failover**: the active MDS holds an exclusive cls
  lock lease on the ``mdsmap.lock`` object and publishes its address
  in ``mdsmap`` (the FSMap role, stored in the metadata pool rather
  than the mon — documented reduction) and
  re-asserts it from its tick thread. A standby acquires the lock when
  the lease lapses, bumps the map epoch, REPLAYS the journal tail
  (finishing any half-done multi-step op — rename's crash window), and
  serves. A deposed active notices its renewal failing and fences
  itself (ops get ESTALE; clients re-read the mdsmap and re-target).

Fencing is airtight: the takeover blocklists the
predecessor's rados INSTANCE in the osdmap before replaying or
serving (src/mon/MDSMonitor.cc:729-741 fail_mds -> blacklist), and
waits for its own client to hold the blocklist epoch. From then on
every op the new active sends carries epoch >= fence, forcing each
OSD it touches up to that map first — so any OSD that has executed
one of our ops rejects everything the deposed instance still has in
flight (EBLOCKLISTED at admission). A deposed write can only land
BEFORE our first contact with that OSD, which linearizes it before
the takeover — the same argument the reference's blocklist fence
rests on.
"""

from __future__ import annotations

import errno
import json
import threading
import time
from collections import OrderedDict

from ceph_tpu_torch.analysis.lock_witness import make_condition, make_lock
from ceph_tpu_torch.parallel import messages as M
from ceph_tpu_torch.parallel.messenger import Connection, Messenger
from ceph_tpu_torch.services.cephfs import CephFS, FSError
from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.utils.workerpool import DaemonPool

log = Dout("mds")

MDSMAP_OID = "mdsmap"
#: the active lease lives on its OWN object: cls lock state IS the
#: object data, so it must never share an oid with the map payload
MDSLOCK_OID = "mdsmap.lock"
ACTIVE_LOCK = "mds_active"

#: cap lease seconds (client renews by use; a dead client's cap
#: expires and a blocked conflicting acquirer proceeds)
CAP_TTL = 2.0

#: completed-request replies retained per session (SessionMap
#: trim_completed_requests role)
DEDUP_KEEP = 256


class MDSDaemon:
    """One metadata server. ``standby_for`` semantics are implicit:
    every started daemon races for the active lock; losers poll as
    standbys (the reference's standby -> replay -> active)."""

    def __init__(self, name: str, mon_addr: str, pool: str,
                 auth: tuple[str, bytes] | None = None,
                 active_ttl: float = 8.0,
                 cap_ttl: float = CAP_TTL) -> None:
        self.name = name
        self.mon_addr = mon_addr
        self.pool = pool
        self.auth = auth
        self.active_ttl = active_ttl
        #: the cap lease a grant carries (the reference's CAP_TTL). A
        #: writer's setattr must land inside it: a deployment whose
        #: striped writes outlast 2 s (a 12-OSD EC pool's partial-write
        #: re-encode) sets a longer one, as Ceph's client sessions keep
        #: their caps for ``mds_session_timeout`` (60 s)
        self.cap_ttl = cap_ttl
        self.epoch = 0
        self.fs: CephFS | None = None
        self.msgr = Messenger(f"mds.{name}")
        self.msgr.set_dispatcher(self._dispatch)
        self.addr = ""
        self._rados = None
        self.io = None
        self._stop = threading.Event()
        self._deposed = False
        self._tick_thread: threading.Thread | None = None
        # potentially-blocking ops (cap_acquire waits on revokes) run
        # here, OFF the messenger loop; cap_release/session ops are
        # handled inline in dispatch so a pool full of blocked
        # acquirers can never starve the releases that unblock them
        self._workers = DaemonPool(
            max_workers=8, thread_name_prefix=f"mds-{name}")
        # the revoke-flush path (setattr/getattr) gets its OWN small
        # pool: a revoked writer must flush before releasing, and that
        # flush must never queue behind a main pool saturated with
        # blocked cap_acquire workers waiting on that very release
        self._flush_workers = DaemonPool(
            max_workers=2, thread_name_prefix=f"mds-{name}-flush")
        # -- cap state (Locker.cc role) --
        self._cap_lock = make_lock("mds.caps")
        self._cap_cv = make_condition("mds.caps", self._cap_lock)
        #: ino -> client -> [type, expires]
        self._captab: dict[int, dict[str, list]] = {}
        #: live sessions: client -> Connection (for revoke pushes)
        self._sessions: dict[str, Connection] = {}
        #: revokes in flight: (ino, client) -> sent stamp
        self._revoking: dict[tuple[int, str], float] = {}
        # -- completed-request dedup (SessionMap role) --
        self._dedup_lock = make_lock("mds.dedup")
        self._completed: OrderedDict[tuple[str, int], tuple] = \
            OrderedDict()
        #: requests currently EXECUTING: a timeout-retry of the same
        #: (client, tid) must not run the mutation a second time in
        #: parallel — the duplicate is dropped and the original
        #: execution's reply reaches the client when it lands
        self._inflight: set[tuple[str, int]] = set()

    # -- lifecycle ----------------------------------------------------
    def start(self, wait_active: bool = False,
              timeout: float = 30.0) -> "MDSDaemon":
        from ceph_tpu_torch.client.rados import RadosClient
        self._rados = RadosClient(self.mon_addr,
                                  name=f"mds.{self.name}",
                                  auth=self.auth).connect()
        self.io = self._rados.open_ioctx(self.pool)
        self.addr = self.msgr.bind()
        self._tick_thread = threading.Thread(
            target=self._run, name=f"mds-{self.name}-main", daemon=True)
        self._tick_thread.start()
        if wait_active:
            deadline = time.monotonic() + timeout
            while not self.is_active():
                if self._stop.is_set() or \
                        time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"mds.{self.name} not active in {timeout}s")
                time.sleep(0.05)
        return self

    def is_active(self) -> bool:
        return self.fs is not None and not self._deposed

    def stop(self) -> None:
        """Clean shutdown: release the active lock so a standby takes
        over immediately instead of at lease expiry."""
        self._stop.set()
        if self._tick_thread is not None:
            self._tick_thread.join(timeout=5)
        if self.fs is not None and not self._deposed:
            try:
                self.io.execute(
                    MDSLOCK_OID, "lock", "unlock",
                    json.dumps({"name": ACTIVE_LOCK,
                                "cookie": self.name}).encode())
            except Exception:
                pass
        self._teardown()

    def kill(self) -> None:
        """Hard failure injection: drop off the network with the lock
        still held — the standby must wait out the lease (the
        reference's mds_beacon_grace path)."""
        self._stop.set()
        self._teardown()

    def _teardown(self) -> None:
        self._workers.shutdown(wait=False)
        self._flush_workers.shutdown(wait=False)
        self.msgr.shutdown()
        with self._cap_cv:
            self._cap_cv.notify_all()
        if self._rados is not None:
            try:
                self._rados.shutdown()
            except Exception:
                pass

    # -- active election (FSMap + mds_beacon_grace roles) -------------
    def _run(self) -> None:
        from ceph_tpu_torch.client.rados import RadosError
        # standby loop: poll for the active lock
        while not self._stop.is_set():
            try:
                self.io.execute(
                    MDSLOCK_OID, "lock", "lock",
                    json.dumps({"name": ACTIVE_LOCK,
                                "cookie": self.name,
                                "type": "exclusive",
                                "duration": self.active_ttl}).encode())
                break
            except RadosError as exc:
                if exc.code != -errno.EBUSY:
                    log(0, f"mds.{self.name}: lock error {exc}")
            except Exception as exc:
                log(0, f"mds.{self.name}: lock error {exc}")
            self._stop.wait(self.active_ttl / 4)
        if self._stop.is_set():
            return
        # became active: bump the map epoch, publish our addr, replay
        try:
            try:
                mdsmap = json.loads(self.io.read(MDSMAP_OID))
            except Exception:
                mdsmap = {"epoch": 0}
            # fence the predecessor BEFORE replay/serving: blocklist
            # its rados instance in the osdmap so any write it still
            # has in flight can never land after our takeover (the
            # reference's fail_mds waits for the osdmon writeable to
            # blacklist the dead MDS the same way,
            # src/mon/MDSMonitor.cc:729-741). Our own ops then carry
            # the blocklist epoch, so every OSD serving us enforces
            # the fence before anything of ours executes there.
            # guard on the INSTANCE, not the name: a restarted daemon
            # reusing its name (same supervisor slot) must still fence
            # its own dead predecessor instance
            prev = mdsmap.get("instance", "")
            if prev and prev != self._rados.instance:
                # 24h fence (the reference's mds_blocklist_interval
                # default): long enough that a paused-and-resumed
                # predecessor re-learns its fate client-side (its
                # first rejected op sticky-fences its objecter) well
                # before the entry lapses
                code, _outs, data = self._rados.mon_command(
                    {"prefix": "osd blocklist",
                     "blocklistop": "add", "addr": prev,
                     "expire": 86400.0})
                if code == 0:
                    fence_epoch = json.loads(data)["epoch"]
                    # retry transient map-push delays (mon election,
                    # slow push) instead of dying mid-takeover with
                    # the active lock held
                    while not self._stop.is_set():
                        try:
                            self._rados.monc.wait_for_map(
                                fence_epoch, timeout=10.0)
                            break
                        except TimeoutError:
                            log(1, f"mds.{self.name}: waiting for "
                                f"fence epoch {fence_epoch}")
                else:
                    log(0, f"mds.{self.name}: predecessor blocklist "
                        f"failed (code {code}) — serving anyway")
            self.epoch = int(mdsmap.get("epoch", 0)) + 1
            self.io.write_full(MDSMAP_OID, json.dumps(
                {"epoch": self.epoch, "active": self.name,
                 "addr": self.addr,
                 "instance": self._rados.instance}).encode())
            # up:replay — CephFS.__init__ replays the journal tail,
            # finishing any predecessor's half-done dirop
            fs = CephFS(self.io, journaling=True, caps=False,
                        client_id="mds")
            with self._dedup_lock:
                for (client, tid), rec in \
                        fs.replayed_requests.items():
                    self._completed[(client, tid)] = \
                        self._replay_reply(fs, rec)
                self.fs = fs
            log(1, f"mds.{self.name}: active, epoch {self.epoch}")
        except Exception as exc:
            log(0, f"mds.{self.name}: activation failed: {exc!r}")
            self._stop.set()
            return
        # active tick: renew the lease, prune dead sessions/caps
        last_renewed = time.monotonic()
        while not self._stop.is_set():
            self._stop.wait(min(self.active_ttl / 4, 0.5))
            if self._stop.is_set():
                return
            try:
                self.io.execute(
                    MDSLOCK_OID, "lock", "lock",
                    json.dumps({"name": ACTIVE_LOCK,
                                "cookie": self.name,
                                "type": "exclusive",
                                "duration": self.active_ttl}).encode())
                last_renewed = time.monotonic()
            except RadosError as exc:
                if exc.code == -errno.EBUSY:
                    # definitively stolen: a standby holds the lock —
                    # fence ourselves, never serve split-brain
                    log(0, f"mds.{self.name}: deposed (lease stolen)")
                    self._depose()
                    return
                log(1, f"mds.{self.name}: lease renewal error "
                    f"{exc!r}")
            except Exception as exc:
                # transient (osd op timeout, map churn): keep retrying
                # while OUR lease could still be live server-side;
                # past that a standby may have taken over — fence
                log(1, f"mds.{self.name}: lease renewal failed "
                    f"{exc!r}")
            if time.monotonic() - last_renewed >= self.active_ttl:
                log(0, f"mds.{self.name}: deposed (lease expired, "
                    "renewals failing)")
                self._depose()
                return
            self._prune_sessions()

    def _depose(self) -> None:
        self._deposed = True
        with self._cap_cv:
            self._cap_cv.notify_all()

    @staticmethod
    def _replay_reply(fs: CephFS, rec: dict) -> tuple[int, bytes]:
        """Reconstruct a completed request's (code, payload) from its
        journal record. mkdir/create can fail EEXIST AFTER journaling
        (they lost a same-name race at dir_link), so their outcome is
        verified against the replayed namespace — a loser's retry must
        see its real failure, not a fabricated success. The other
        journaled ops (unlink/rmdir/rename) validate before
        journaling; post-journal their steps only fail by crashing,
        and replay finishes them — success is the true outcome."""
        if rec.get("op") in ("create", "mkdir") and "ino" in rec:
            try:
                entries = fs._read_inode(
                    rec["parent"]).get("entries", {})
            except FSError:
                entries = {}
            if entries.get(rec["name"]) != rec["ino"]:
                return (-errno.EEXIST, b"")
            return (0, json.dumps({"ino": rec["ino"],
                                   "size": 0}).encode())
        if rec.get("op") == "mksnap":
            # the journaled intent carries the allocated snapid in
            # "ino" — the retried request needs it back
            return (0, json.dumps({"snapid": rec["ino"]}).encode())
        return (0, b"{}")

    def _prune_sessions(self) -> None:
        """Drop caps of dead sessions (connection closed) — the
        session-eviction role; their waiters proceed."""
        with self._cap_cv:
            dead = [c for c, conn in self._sessions.items()
                    if conn.closed]
            changed = False
            for client in dead:
                del self._sessions[client]
            for ino in list(self._captab):
                held = self._captab[ino]
                for client in list(held):
                    if client in dead:
                        del held[client]
                        changed = True
                if not held:
                    del self._captab[ino]
            if changed or dead:
                self._cap_cv.notify_all()

    # -- dispatch ------------------------------------------------------
    def _dispatch(self, msg: M.Message, conn: Connection) -> None:
        if not isinstance(msg, M.MMDSOp):
            return
        # any op (re-)registers the session connection: after an MDS
        # failover clients just talk to the new daemon — the reconnect
        # phase collapses to this re-registration
        with self._cap_cv:
            self._sessions[msg.client] = conn
        if msg.op in ("cap_release", "session_close", "session_open"):
            # non-blocking: run inline on the messenger loop so blocked
            # cap_acquire workers can always be unblocked
            self._handle(msg, conn)
            return
        if msg.op in ("setattr", "getattr"):
            # revoke-flush path: own pool (see __init__)
            self._flush_workers.submit(self._handle, msg, conn)
            return
        self._workers.submit(self._handle, msg, conn)

    def _handle(self, msg: M.MMDSOp, conn: Connection) -> None:
        key = (msg.client, msg.tid)
        with self._dedup_lock:
            hit = self._completed.get(key)
            if hit is None:
                if key in self._inflight:
                    # a timeout-retry of a request still executing:
                    # drop it — the original execution's reply rides
                    # the same connection when it completes
                    return
                self._inflight.add(key)
        if hit is not None:
            conn.send_message(M.MMDSOpReply(
                tid=msg.tid, code=hit[0], data=hit[1]))
            return
        try:
            if self._deposed or self.fs is None:
                conn.send_message(M.MMDSOpReply(
                    tid=msg.tid, code=-errno.ESTALE, data=b""))
                return
            try:
                args = json.loads(msg.args) if msg.args else {}
                data = self._execute(msg.client, msg.tid, msg.op,
                                     args)
                code, payload = 0, json.dumps(data).encode()
            except FSError as exc:
                code, payload = -exc.errno, b""
            except Exception as exc:  # noqa: BLE001 — ops must reply
                log(0, f"mds.{self.name}: {msg.op} failed: {exc!r}")
                code, payload = -errno.EIO, b""
            if msg.op not in ("cap_acquire",):
                # cap grants are leases, not idempotent facts: a
                # retried acquire must re-check conflicts, never
                # replay a grant
                with self._dedup_lock:
                    self._completed[key] = (code, payload)
                    while len(self._completed) > DEDUP_KEEP:
                        self._completed.popitem(last=False)
            conn.send_message(M.MMDSOpReply(
                tid=msg.tid, code=code, data=payload))
        finally:
            with self._dedup_lock:
                self._inflight.discard(key)

    # -- op execution (Server.cc handle_client_request role) ----------
    def _execute(self, client: str, tid: int, op: str,
                 args: dict) -> dict:
        fs = self.fs
        req = (client, tid)
        if op == "session_open":
            return {"epoch": self.epoch, "name": self.name}
        if op == "session_close":
            self._drop_client_caps(client)
            return {}
        if op == "mkdir":
            fs.mkdir(args["path"], req=req)
            return {}
        if op == "rmdir":
            fs.rmdir(args["path"], req=req)
            return {}
        if op == "create":
            f = fs.create(args["path"], req=req)
            return {"ino": f.ino, "size": 0,
                    "snaps": (f.snapc or {}).get("snaps", [])}
        if op == "open":
            snap = fs._snap_split(args["path"])
            if snap is not None:
                ino, inode, snapid = fs._resolve_snap(*snap)
                if inode["type"] != "file":
                    raise FSError(errno.EISDIR, args["path"])
                return {"ino": ino, "size": inode.get("size", 0),
                        "snapid": snapid}
            try:
                ino, inode, realm = fs._resolve2(args["path"])
            except FSError as exc:
                if args.get("create") and exc.errno == errno.ENOENT:
                    f = fs.create(args["path"], req=req)
                    return {"ino": f.ino, "size": 0,
                            "snaps": (f.snapc or {}).get("snaps", [])}
                raise
            if inode["type"] != "file":
                raise FSError(errno.EISDIR, args["path"])
            # the realm snapids ride the reply: the client writes
            # data DIRECTLY to the OSDs (the MDS is not on the data
            # path), so it must carry the realm SnapContext itself
            return {"ino": ino, "size": inode.get("size", 0),
                    "snaps": sorted(realm, reverse=True)}
        if op == "mksnap":
            snapid = fs.mksnap(args["path"], args["name"], req=req)
            return {"snapid": snapid}
        if op == "rmsnap":
            fs.rmsnap(args["path"], args["name"], req=req)
            return {}
        if op == "lssnap":
            return {"snaps": fs.lssnap(args["path"])}
        if op == "unlink":
            fs.unlink(args["path"], req=req)
            return {}
        if op == "rename":
            fs.rename(args["old"], args["new"], req=req)
            return {}
        if op == "readdir":
            return {"entries": fs.readdir(args["path"])}
        if op == "stat":
            return fs.stat(args["path"])
        if op == "getattr":
            inode = fs._read_inode(int(args["ino"]))
            out = {"type": inode["type"],
                   "mtime": inode.get("mtime", 0.0)}
            if inode["type"] == "file":
                out["size"] = inode.get("size", 0)
            return out
        if op == "setattr":
            return self._setattr(client, args)
        if op == "cap_acquire":
            return self._cap_acquire(client, int(args["ino"]),
                                     args["want"],
                                     float(args.get("timeout", 10.0)))
        if op == "cap_release":
            self._cap_release(client, int(args["ino"]))
            return {}
        raise FSError(errno.EOPNOTSUPP, op)

    def _setattr(self, client: str, args: dict) -> dict:
        """Inode attribute update from a writer. Requires the caller to
        HOLD an exclusive cap on the ino (Locker.cc checks the same
        before accepting a cap flush) — an expired or revoked writer
        must not clobber the inode behind the new holder's back."""
        ino = int(args["ino"])
        # the whole read-modify-write runs UNDER the cap lock: checking
        # the cap and then writing outside it would let a writer whose
        # lease expired mid-flight clobber the new holder's inode
        # (grants and expiry pruning take this same lock; waiters in
        # _cap_acquire release it while waiting, so no deadlock)
        snaps = [int(x) for x in args.get("snaps", [])]
        snapc = {"snap_seq": max(snaps),
                 "snaps": sorted(snaps, reverse=True)} \
            if snaps else None
        with self._cap_lock:
            held = self._captab.get(ino, {}).get(client)
            if held is None or held[0] != "exclusive" or \
                    time.time() >= held[1]:
                raise FSError(errno.EPERM,
                              "setattr without exclusive cap")
            inode = dict(self.fs._read_inode(ino))
            if "size" in args:
                size = int(args["size"])
                inode["size"] = size if args.get("force") \
                    else max(inode.get("size", 0), size)
            inode["mtime"] = float(args.get("mtime", time.time()))
            # the writer's realm SnapContext rides the flush so the
            # pre-write inode is COW-preserved for its snapshots
            self.fs._write_inode(ino, inode, snapc=snapc)
        return {"size": inode.get("size", 0)}

    # -- caps (Locker.cc issue/revoke role) ----------------------------
    def _cap_acquire(self, client: str, ino: int, want: str,
                     timeout: float) -> dict:
        if want not in ("shared", "exclusive"):
            raise FSError(errno.EINVAL, f"cap type {want!r}")
        deadline = time.time() + min(timeout, 30.0)
        with self._cap_cv:
            while True:
                if self._deposed or self._stop.is_set():
                    raise FSError(errno.ESTALE, "mds deposed")
                now = time.time()
                held = self._captab.setdefault(ino, {})
                for c in [c for c, h in held.items() if h[1] <= now]:
                    del held[c]            # lease lapsed (dead client)
                    self._revoking.pop((ino, c), None)
                mine = held.get(client)
                eff = want
                if mine is not None and mine[0] == "exclusive":
                    eff = "exclusive"      # never downgrade a sibling
                conflicts = [
                    c for c, h in held.items()
                    if c != client
                    and (eff == "exclusive" or h[0] == "exclusive")]
                if not conflicts:
                    held[client] = [eff, now + self.cap_ttl]
                    return {"type": eff, "ttl": self.cap_ttl}
                # recall the conflicting caps (Locker revoke push);
                # re-push at most once per half-lease so a lost frame
                # doesn't strand the waiter until lease expiry
                keep = "shared" if eff == "shared" else ""
                for c in conflicts:
                    sent = self._revoking.get((ino, c), 0.0)
                    sess = self._sessions.get(c)
                    if sess is not None and not sess.closed and \
                            now - sent > self.cap_ttl / 2:
                        self._revoking[(ino, c)] = now
                        sess.send_message(M.MMDSCapRevoke(
                            ino=ino, keep=keep, epoch=self.epoch))
                if now >= deadline:
                    raise FSError(errno.EAGAIN,
                                  f"cap on ino {ino} held")
                self._cap_cv.wait(
                    min(0.25, max(deadline - now, 0.01)))

    def _cap_release(self, client: str, ino: int) -> None:
        with self._cap_cv:
            held = self._captab.get(ino)
            if held and client in held:
                del held[client]
                if not held:
                    del self._captab[ino]
            self._revoking.pop((ino, client), None)
            self._cap_cv.notify_all()

    def _drop_client_caps(self, client: str) -> None:
        with self._cap_cv:
            self._sessions.pop(client, None)
            for ino in list(self._captab):
                self._captab[ino].pop(client, None)
                if not self._captab[ino]:
                    del self._captab[ino]
            self._cap_cv.notify_all()

    # -- introspection (tests/tools) ----------------------------------
    def cap_holders(self, ino: int) -> dict:
        with self._cap_lock:
            now = time.time()
            return {c: h[0]
                    for c, h in self._captab.get(ino, {}).items()
                    if h[1] > now}
