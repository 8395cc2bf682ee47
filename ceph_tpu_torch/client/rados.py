"""librados-style client API (src/librados/ RadosClient/IoCtxImpl roles).

Usage mirrors the reference's bindings:

    client = RadosClient(mon_addr)
    client.connect()
    ioctx = client.open_ioctx("mypool")
    ioctx.write_full("obj", b"hello")
    data = ioctx.read("obj")
    client.shutdown()

Admin commands go through ``client.mon_command`` (the reference's
``rados_mon_command``).
"""

from __future__ import annotations

import json

from ceph_tpu_torch.client.object_cacher import ObjectCacher
from ceph_tpu_torch.client.objecter import Objecter, ObjecterError
from ceph_tpu_torch.parallel import messages as M
from ceph_tpu_torch.parallel.messenger import Messenger
from ceph_tpu_torch.parallel.mon_client import MonClient
from ceph_tpu_torch.utils import flow_telemetry as _flow_tel
from ceph_tpu_torch.utils.config import g_conf

_client_seq = [0]

#: ops whose success invalidates the client cache's copy of the oid
#: (every head mutation librados can issue against cached data).
#: Invalidate AFTER the ack, matching the striper's ordering: dropping
#: before lets a concurrent reader refill pre-write bytes and pin them.
_CACHE_INVAL_OPS = frozenset((
    M.OSD_OP_WRITE_FULL, M.OSD_OP_WRITE, M.OSD_OP_APPEND,
    M.OSD_OP_REMOVE, M.OSD_OP_CREATE, M.OSD_OP_TRUNCATE,
    M.OSD_OP_ZERO, M.OSD_OP_ROLLBACK, M.OSD_OP_WRITESAME,
    M.OSD_OP_CALL))


class RadosError(Exception):
    def __init__(self, code: int, message: str = "") -> None:
        super().__init__(message or f"rados error {code}")
        self.code = code


class IoCtx:
    """Per-pool I/O context (IoCtxImpl role)."""

    def __init__(self, client: "RadosClient", pool_id: int,
                 pool_name: str) -> None:
        self.client = client
        self.pool_id = pool_id
        self.pool_name = pool_name
        #: per-ioctx op timeout override (seconds); benches raise it
        #: so device-kernel compile stalls slow ops instead of
        #: failing them
        self.op_timeout: float | None = None
        #: tenant/flow label stamped on every op this ioctx submits
        #: (ISSUE 20; falls back to the client-level label, then to
        #: the thread's ambient flow context)
        self.flow: str | None = None

    def set_flow(self, label: str | None) -> None:
        """Tag subsequent ops from this ioctx with a tenant/flow
        label ('' or None clears back to the client default)."""
        self.flow = label or None

    def _flow_label(self) -> str:
        return (self.flow or self.client.flow
                or _flow_tel.current_flow() or "")

    def _submit(self, oid: str, op: int, **kw) -> M.MOSDOpReply:
        if self.op_timeout is not None:
            kw.setdefault("timeout", self.op_timeout)
        kw.setdefault("flow", self._flow_label())
        # cache-tier overlay (OSDMap read_tier/write_tier role): object
        # ops against a base pool with an overlay go to the CACHE pool;
        # its OSDs promote on miss and the agent writes back. PGLS
        # stays on the opened pool (reference behavior: the redirect is
        # an object-op affair).
        pool_id = self.pool_id
        m = self.client.monc.osdmap
        p = m.pools.get(pool_id) if m else None
        if p is not None and p.read_tier >= 0 and \
                op != M.OSD_OP_LIST:
            pool_id = p.read_tier
        try:
            rep = self.client.objecter.op_submit(
                pool_id, oid, op, **kw)
        except ObjecterError as exc:
            raise RadosError(exc.code, str(exc)) from None
        # cache-tier coherence, local half (read-your-writes): our own
        # successful mutation drops our cached copy AFTER the ack —
        # the OSD's inval-hold handles every OTHER client's copy
        cache = self.client.cache
        if cache is not None and op in _CACHE_INVAL_OPS:
            cache.invalidate_object(oid)
        return rep

    def _snapc(self) -> dict:
        """The pool's snap context for mutations (librados attaches
        the SnapContext to every write the same way)."""
        m = self.client.monc.osdmap
        pool = m.pools.get(self.pool_id) if m else None
        if pool is None or not pool.snap_seq:
            return {}
        seq, snaps = pool.snap_context()
        return {"snap_seq": seq, "snaps": snaps}

    # -- data ops -----------------------------------------------------
    def write_full(self, oid: str, data: bytes,
                   snapc: dict | None = None) -> int:
        """Replace the object; returns the new object version.
        ``snapc``: an explicit self-managed SnapContext
        ({"snap_seq": s, "snaps": [...]}) overriding the pool's
        (rados_ioctx_selfmanaged_snap_set_write_ctx role)."""
        return self._submit(oid, M.OSD_OP_WRITE_FULL, data=data,
                            **(snapc or self._snapc())).version

    def write(self, oid: str, data: bytes, offset: int = 0,
              snapc: dict | None = None) -> int:
        return self._submit(oid, M.OSD_OP_WRITE, data=data,
                            offset=offset,
                            **(snapc or self._snapc())).version

    def append(self, oid: str, data: bytes,
               snapc: dict | None = None) -> int:
        return self._submit(oid, M.OSD_OP_APPEND, data=data,
                            **(snapc or self._snapc())).version

    def _cacheable(self) -> bool:
        """Head reads of a plain pool may use the client cache; a
        tiering overlay redirects both reads and writes to the cache
        POOL, so our inval watch on the base pool would never fire —
        those reads stay uncached."""
        if self.client.cache is None:
            return False
        m = self.client.monc.osdmap
        p = m.pools.get(self.pool_id) if m else None
        return p is not None and p.read_tier < 0

    def read(self, oid: str, length: int = 0, offset: int = 0,
             snap: int = 0) -> bytes:
        """``snap``: read the object's state as of that pool snapshot
        (0 = head). With ``client_cache`` on, head reads are served
        from the local cache tier when covered — the hit path is a
        dict probe, no wire. Coherence: a per-object inval watch is
        registered BEFORE the filling read, and the OSD holds every
        mutating op's ack until all inval watchers dropped their
        copies, so a hit can never return bytes older than any write
        whose ack anyone has seen."""
        if snap != 0 or not self._cacheable():
            return self._submit(oid, M.OSD_OP_READ, offset=offset,
                                length=length, snapid=snap).data
        cache = self.client.cache
        data = cache.get(oid, offset, length)
        if data is not None:
            return data
        # the watch must be live BEFORE the read: a write landing
        # between read and watch would otherwise not invalidate us
        watched = self.client._ensure_inval_watch(self, oid)
        gen = cache.generation()
        data = self._submit(oid, M.OSD_OP_READ, offset=offset,
                            length=length, snapid=0).data
        if watched:
            cache.put(oid, offset, length, data, gen=gen,
                      whole=(length == 0 and offset == 0))
        return data

    def stat(self, oid: str, snap: int = 0) -> int:
        """Object size in bytes."""
        rep = self._submit(oid, M.OSD_OP_STAT, snapid=snap)
        return json.loads(rep.data)["size"]

    def remove(self, oid: str, snapc: dict | None = None) -> None:
        self._submit(oid, M.OSD_OP_REMOVE, **(snapc or self._snapc()))

    def truncate(self, oid: str, size: int,
                 snapc: dict | None = None) -> int:
        """rados_trunc: shrink or zero-extend to ``size`` (creates a
        zero-filled object when absent, like the reference's
        write-class truncate)."""
        return self._submit(oid, M.OSD_OP_TRUNCATE, offset=size,
                            **(snapc or self._snapc())).version

    def zero(self, oid: str, offset: int, length: int) -> int:
        """rados write-op zero: clear [offset, offset+length)."""
        return self._submit(oid, M.OSD_OP_ZERO, offset=offset,
                            length=length, **self._snapc()).version

    # -- pool snapshots (librados snap API role) ----------------------
    def snap_create(self, name: str) -> int:
        """Pool snapshot (rados_ioctx_snap_create): returns the snap
        id. Subsequent writes COW-preserve pre-snap object states."""
        code, outs, data = self.client.mon_command(
            {"prefix": "osd pool mksnap", "pool": self.pool_name,
             "snap": name})
        if code != 0:
            raise RadosError(code, outs)
        snapid = json.loads(data)["snapid"]
        self._wait_map(lambda p: snapid in p.snaps)
        return snapid

    def snap_remove(self, name: str) -> None:
        """Delete a pool snapshot; OSD trimmers reclaim its clones."""
        code, outs, _ = self.client.mon_command(
            {"prefix": "osd pool rmsnap", "pool": self.pool_name,
             "snap": name})
        if code != 0:
            raise RadosError(code, outs)
        self._wait_map(lambda p: name not in p.snaps.values())

    def snap_list(self) -> dict[int, str]:
        m = self.client.monc.osdmap
        return dict(m.pools[self.pool_id].snaps)

    def snap_lookup(self, name: str) -> int:
        for sid, n in self.snap_list().items():
            if n == name:
                return sid
        raise RadosError(-2, f"no snap {name!r}")

    def snap_rollback(self, oid: str, name: str) -> None:
        """Restore the head to its state at the snapshot — ONE
        server-side op (CEPH_OSD_OP_ROLLBACK, PrimaryLogPG::
        _rollback_to), atomic under the PG lock, instead of the old
        client-side read+rewrite which could interleave with other
        writers."""
        self._submit(oid, M.OSD_OP_ROLLBACK,
                     snapid=self.snap_lookup(name), **self._snapc())

    def _wait_map(self, pred, timeout: float = 10.0) -> None:
        import time as _time
        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            m = self.client.monc.osdmap
            pool = m.pools.get(self.pool_id) if m else None
            if pool is not None and pred(pool):
                return
            _time.sleep(0.05)
        raise RadosError(-110, "osdmap never reflected snap change")

    def execute(self, oid: str, cls: str, method: str,
                inp: bytes = b"", snapc: dict | None = None) -> bytes:
        """Run an in-OSD object-class method (librados exec role).
        ``snapc``: self-managed SnapContext so a mutating class method
        COW-preserves the pre-call object (CephFS dir entries)."""
        return self._submit(oid, M.OSD_OP_CALL, data=inp, cls=cls,
                            method=method, **(snapc or {})).data

    # -- self-managed snapshots (librados selfmanaged_snap API) -------
    def selfmanaged_snap_create(self) -> int:
        """Allocate a snapid from the pool sequence
        (rados_ioctx_selfmanaged_snap_create): the caller builds its
        own SnapContext for subsequent writes."""
        code, outs, data = self.client.mon_command(
            {"prefix": "osd pool selfmanaged-snap create",
             "pool": self.pool_name})
        if code != 0:
            raise RadosError(code, outs)
        out = json.loads(data)
        self.client.monc.wait_for_map(out["epoch"])
        return out["snapid"]

    def selfmanaged_snap_remove(self, snapid: int) -> None:
        """Retire a snapid (rados_ioctx_selfmanaged_snap_remove): OSD
        trimmers reclaim clones it covered, map-driven."""
        code, outs, data = self.client.mon_command(
            {"prefix": "osd pool selfmanaged-snap rm",
             "pool": self.pool_name, "snapid": snapid})
        if code != 0:
            raise RadosError(code, outs)
        self.client.monc.wait_for_map(json.loads(data)["epoch"])

    # -- xattrs (rados_{get,set,rm}xattr / getxattrs roles) -----------
    @staticmethod
    def _guard_kw(guard) -> dict:
        """``guard=(name, op, value)`` attaches an atomic cmpxattr
        guard to any op (the reference couples a CMPXATTR to the ops
        after it in one transaction); op is a M.CMPXATTR_* mode. A
        4th element ``"omap"`` compares an omap value instead (the
        CEPH_OSD_OP_OMAP_CMP guard)."""
        if guard is None:
            return {}
        name, gop, gval = guard[:3]
        kw = {"gname": name, "gop": int(gop), "gval": bytes(gval)}
        if len(guard) > 3 and guard[3] == "omap":
            kw["gflags"] = M.GUARD_OMAP
        return kw

    def getxattr(self, oid: str, name: str) -> bytes:
        return self._submit(oid, M.OSD_OP_GETXATTR, xname=name).data

    def setxattr(self, oid: str, name: str, value: bytes,
                 guard=None) -> int:
        return self._submit(oid, M.OSD_OP_SETXATTR, xname=name,
                            data=value,
                            **self._guard_kw(guard)).version

    def rmxattr(self, oid: str, name: str) -> None:
        self._submit(oid, M.OSD_OP_RMXATTR, xname=name)

    def getxattrs(self, oid: str) -> dict[str, bytes]:
        rep = self._submit(oid, M.OSD_OP_GETXATTRS)
        return {n: bytes.fromhex(v)
                for n, v in json.loads(rep.data).items()}

    def cmpxattr(self, oid: str, name: str, op: int,
                 value: bytes) -> bool:
        """True when the comparison holds; False on -ECANCELED
        mismatch (other errors raise)."""
        try:
            self._submit(oid, M.OSD_OP_CMPXATTR, xname=name,
                         xop=int(op), data=bytes(value))
            return True
        except RadosError as exc:
            if exc.code == -125:
                return False
            raise

    # -- omap (rados_omap_* roles; replicated pools only, EC pools
    # answer -EOPNOTSUPP exactly like the reference) -------------------
    def omap_set(self, oid: str, kv: dict[str, bytes],
                 guard=None) -> int:
        payload = json.dumps({k: bytes(v).hex()
                              for k, v in kv.items()}).encode()
        return self._submit(oid, M.OSD_OP_OMAPSET, data=payload,
                            **self._guard_kw(guard)).version

    def omap_get(self, oid: str, keys: list[str] | None = None, *,
                 prefix: str = "", start_after: str = "",
                 max_return: int = 0) -> dict[str, bytes]:
        """Exact keys (``keys``) or a ranged page (``prefix``/
        ``start_after``/``max_return`` — the omap-get-vals paging
        contract; the server sends only the page)."""
        if prefix or start_after or max_return:
            payload = json.dumps({"prefix": prefix,
                                  "start_after": start_after,
                                  "max": max_return}).encode()
        else:
            payload = json.dumps(list(keys or [])).encode()
        rep = self._submit(oid, M.OSD_OP_OMAPGET, data=payload)
        return {k: bytes.fromhex(v)
                for k, v in json.loads(rep.data).items()}

    def omap_get_keys(self, oid: str) -> list[str]:
        rep = self._submit(oid, M.OSD_OP_OMAPGETKEYS)
        return json.loads(rep.data)

    def omap_rm_keys(self, oid: str, keys: list[str]) -> None:
        self._submit(oid, M.OSD_OP_OMAPRMKEYS,
                     data=json.dumps(list(keys)).encode())

    def omap_get_header(self, oid: str) -> bytes:
        """rados_omap_get_header: the object's omap header blob
        (b"" when never set)."""
        return self._submit(oid, M.OSD_OP_OMAPGETHEADER).data

    def omap_set_header(self, oid: str, data: bytes,
                        guard=None) -> int:
        return self._submit(oid, M.OSD_OP_OMAPSETHEADER,
                            data=bytes(data),
                            **self._guard_kw(guard)).version

    def omap_cmp(self, oid: str, key: str, op: int,
                 value: bytes) -> bool:
        """CEPH_OSD_OP_OMAP_CMP as a standalone check: True when the
        comparison holds, False on -ECANCELED mismatch."""
        try:
            self._submit(oid, M.OSD_OP_OMAPCMP, xname=key,
                         xop=int(op), data=bytes(value))
            return True
        except RadosError as exc:
            if exc.code == -125:
                return False
            raise

    # -- sparse / pattern I/O (round-4 do_osd_ops widening) ------------
    def sparse_read(self, oid: str, length: int = 0, offset: int = 0,
                    snap: int = 0) -> list[tuple[int, bytes]]:
        """CEPH_OSD_OP_SPARSE_READ: [(offset, bytes), ...] — only the
        allocated (non-hole) extents of the range come back."""
        rep = self._submit(oid, M.OSD_OP_SPARSE_READ, length=length,
                           offset=offset, snapid=snap)
        doc = json.loads(rep.data)
        blob = bytes.fromhex(doc["data"])
        out, pos = [], 0
        for off, n in doc["extents"]:
            out.append((off, blob[pos:pos + n]))
            pos += n
        return out

    def writesame(self, oid: str, data: bytes, length: int,
                  offset: int = 0, guard=None) -> int:
        """CEPH_OSD_OP_WRITESAME: tile ``data`` across
        [offset, offset+length); length must be a multiple of
        len(data)."""
        return self._submit(oid, M.OSD_OP_WRITESAME, data=bytes(data),
                            length=length, offset=offset,
                            **self._guard_kw(guard),
                            **self._snapc()).version

    def list_snaps(self, oid: str) -> dict:
        """CEPH_OSD_OP_LIST_SNAPS: the object's snapset — {"seq",
        "clones": [{"id", "snaps", "size"}], "head_exists"}."""
        return json.loads(self._submit(oid,
                                       M.OSD_OP_LIST_SNAPS).data)

    # -- watch/notify (rados_watch / rados_notify roles) --------------
    def watch(self, oid: str, callback) -> int:
        """Register ``callback(payload: bytes)`` to fire on every
        notify against ``oid``; returns the watch cookie (pass to
        unwatch). Watches are connection-scoped on the primary: a
        primary change drops them and this client RE-WATCHES
        automatically on the next map epoch (the linger behavior)."""
        return self.client._watch(self, oid, callback)

    def unwatch(self, cookie: int) -> None:
        self.client._unwatch(cookie)

    def notify(self, oid: str, payload: bytes = b"",
               timeout_ms: int = 5000) -> tuple[int, int]:
        """Deliver ``payload`` to every watcher of ``oid``; returns
        (acked, missed) once every watcher answered or the timeout
        passed — the caller KNOWS who saw it (notify contract)."""
        return self.client._notify(self, oid, payload, timeout_ms)

    def create(self, oid: str, exclusive: bool = False,
               guard=None) -> int:
        """Materialize an empty object (CEPH_OSD_OP_CREATE);
        ``exclusive`` raises -EEXIST when it already exists."""
        return self._submit(oid, M.OSD_OP_CREATE,
                            xop=1 if exclusive else 0,
                            **self._guard_kw(guard)).version

    def write_full_guarded(self, oid: str, data: bytes,
                           guard) -> int:
        """write_full coupled to a cmpxattr guard, atomically."""
        return self._submit(oid, M.OSD_OP_WRITE_FULL, data=data,
                            **self._guard_kw(guard),
                            **self._snapc()).version

    def list_objects(self) -> list[str]:
        """Union of per-PG listings (PGLS role)."""
        osdmap = self.client.monc.osdmap
        out: set[str] = set()
        for ps in osdmap.pgs_of_pool(self.pool_id):
            rep = self._submit("", M.OSD_OP_LIST, ps=ps)
            out.update(json.loads(rep.data))
        return sorted(out)


class RadosClient:
    def __init__(self, mon_addr: str, name: str | None = None,
                 auth: tuple[str, bytes] | None = None,
                 instance: str | None = None) -> None:
        import uuid
        if name is None:
            _client_seq[0] += 1
            # globally unique across processes: the mon dedups commands
            # on (client name, tid), so two CLI invocations must never
            # share a name (both would start tids at 1)
            name = f"client.{uuid.uuid4().hex[:8]}.{_client_seq[0]}"
        #: per-INSTANCE identity carried on every osd op — the
        #: entity_addr:nonce analog the osdmap blocklist fences
        #: (src/osd/OSDMap.h:561): a restarted daemon reusing the same
        #: NAME gets a fresh nonce, so fencing a dead instance never
        #: blocks its successor. ``instance`` is injectable for tests
        #: that impersonate a fenced instance.
        self.instance = instance or f"{name}:{uuid.uuid4().hex[:8]}"
        self.msgr = Messenger(name)
        self.monc = MonClient(self.msgr, mon_addr)
        self.objecter: Objecter | None = None
        #: client-wide default tenant/flow label (ISSUE 20): every
        #: ioctx without its own label stamps ops with this one
        self.flow: str | None = None
        self._auth = auth          # (entity, secret) for cephx clusters
        self._connected = False
        # watch/notify client state
        import threading as _th
        self._wn_lock = _th.Lock()
        self._wn_seq = 0
        #: cookie -> {"pool", "oid", "cb", "osd", "epoch"}
        self._watches: dict[int, dict] = {}
        #: tid -> [Event, reply]
        self._wn_waits: dict[int, list] = {}
        # librados cache tier (ROADMAP 3): per-client read cache kept
        # coherent through per-object inval watches + the OSD's
        # reply-hold (osd._inval_hold)
        self.cache: ObjectCacher | None = None
        if bool(g_conf()["client_cache"]):
            self.cache = ObjectCacher(
                int(g_conf()["client_cache_bytes"]))
            # capacity is a tuner-stepped Knob: observe it
            g_conf().add_observer("client_cache_bytes",
                                  self._on_cache_bytes)
        #: (pool_id, oid) -> inval-watch cookie; registration is
        #: serialized by _inval_reg_lock (one wire round trip per
        #: object, ever — never on the hit path)
        self._inval_cookies: dict[tuple[int, str], int] = {}
        self._inval_reg_lock = _th.Lock()

    def connect(self, timeout: float = 10.0) -> "RadosClient":
        self.msgr.set_dispatcher(self._dispatch)
        self.msgr.start()
        # clients bind too: OSD replies ride the same connection the op
        # arrived on, but map pushes need our listening addr
        self.msgr.bind()
        self.objecter = Objecter(self.msgr, self.monc,
                                 client_id=self.instance)
        if self._auth is not None:
            # must precede subscribe: an authed cluster drops every
            # unsigned frame except the MAuth exchange itself
            self.monc.authenticate(*self._auth, timeout=timeout)
        self.monc.subscribe()
        self.monc.wait_for_map(1, timeout)
        self._connected = True
        return self

    def _on_cache_bytes(self, _name: str, value) -> None:
        try:
            value = int(value)
        except (TypeError, ValueError):
            return
        if self.cache is not None:
            self.cache.resize(value)

    def shutdown(self) -> None:
        if self.cache is not None:
            try:
                g_conf().remove_observer("client_cache_bytes",
                                         self._on_cache_bytes)
            except Exception:
                pass
        if self.objecter:
            self.objecter.shutdown()
        self.msgr.shutdown()
        self._connected = False

    def _dispatch(self, msg, conn) -> None:
        if isinstance(msg, M.MWatchNotify):
            self._on_watch_notify(msg, conn)
            return
        if isinstance(msg, (M.MWatchAck, M.MNotifyComplete)):
            with self._wn_lock:
                ent = self._wn_waits.get(msg.tid)
            if ent is not None:
                ent[1] = msg
                ent[0].set()
            return
        if isinstance(msg, M.MOSDMap):
            # piggyback on the map push: re-establish watches whose
            # primary moved (linger re-registration). Off-thread: the
            # re-watch BLOCKS on acks that arrive through this very
            # dispatcher.
            self.monc.handle_message(msg, conn)
            with self._wn_lock:
                have = bool(self._watches)
            if have:
                import threading as _th
                _th.Thread(target=self._rewatch,
                           name="rados-rewatch", daemon=True).start()
            return
        if self.monc.handle_message(msg, conn):
            return
        if self.objecter and self.objecter.handle_message(msg, conn):
            return

    # -- watch/notify plumbing ----------------------------------------
    def _mwatch(self, **kw) -> "M.MWatch":
        """Build an MWatch with this client's identity and map epoch
        filled in — every registration must carry both (the osdmap
        blocklist fence checks the instance id, and the epoch makes a
        stale-map OSD park the registration instead of missing a
        fresh fence). One builder so a future call site cannot
        silently bypass the fence."""
        return M.MWatch(
            client=self.instance,
            epoch=self.monc.osdmap.epoch if self.monc.osdmap else 0,
            **kw)

    def _primary_addr(self, pool: int, oid: str) -> tuple[str, int, int]:
        osdmap = self.monc.osdmap
        ps = osdmap.object_to_pg(pool, oid)
        _, _, primary = osdmap.pg_to_up_acting(pool, ps)
        info = osdmap.osds.get(primary)
        if primary < 0 or info is None or not info.up or not info.addr:
            raise RadosError(-110, f"no primary for {oid!r}")
        return info.addr, ps, primary

    def _wn_call(self, msg, addr: str, timeout: float = 10.0):
        import threading as _th
        ev = _th.Event()
        with self._wn_lock:
            self._wn_waits[msg.tid] = ent = [ev, None]
        try:
            self.msgr.send_message(msg, addr)
            if not ev.wait(timeout):
                raise RadosError(-110, "watch/notify op timed out")
            return ent[1]
        finally:
            with self._wn_lock:
                self._wn_waits.pop(msg.tid, None)

    def _watch(self, io: IoCtx, oid: str, callback,
               inval: bool = False) -> int:
        addr, ps, primary = self._primary_addr(io.pool_id, oid)
        with self._wn_lock:
            self._wn_seq += 1
            cookie = self._wn_seq
            tid = 1_000_000 + cookie
            # register BEFORE the wire round trip: the OSD adds the
            # watcher before acking, so a notify fanned out in that
            # window must find the callback (a silent ack-without-
            # callback would count an unseen notify as seen)
            self._watches[cookie] = {
                "pool": io.pool_id, "oid": oid, "cb": callback,
                "osd": primary, "addr": addr, "inval": inval}
        try:
            rep = self._wn_call(self._mwatch(
                tid=tid, pool=io.pool_id, ps=ps, oid=oid,
                cookie=cookie, watch=True, inval=inval), addr)
        except RadosError:
            with self._wn_lock:
                self._watches.pop(cookie, None)
            raise
        if rep.code != 0:
            with self._wn_lock:
                self._watches.pop(cookie, None)
            raise RadosError(rep.code, "watch refused")
        return cookie

    def _ensure_inval_watch(self, io: IoCtx, oid: str) -> bool:
        """A live invalidation watch on ``(pool, oid)`` — register
        one on first miss; True when the object is covered (only
        covered reads may fill the cache). Serialized per client: the
        round trip happens once per object, never on the hit path."""
        key = (io.pool_id, oid)
        with self._inval_reg_lock:
            with self._wn_lock:
                if key in self._inval_cookies:
                    return True

            def cb(_payload: bytes, oid: str = oid) -> None:
                if self.cache is not None:
                    self.cache.invalidate_object(oid)

            try:
                cookie = self._watch(io, oid, cb, inval=True)
            except RadosError:
                return False     # uncovered: this read stays uncached
            with self._wn_lock:
                self._inval_cookies[key] = cookie
            return True

    def _unwatch(self, cookie: int) -> None:
        with self._wn_lock:
            w = self._watches.pop(cookie, None)
        if w is None:
            return
        try:
            addr, ps, _ = self._primary_addr(w["pool"], w["oid"])
            self._wn_call(self._mwatch(
                tid=2_000_000 + cookie, pool=w["pool"], ps=ps,
                oid=w["oid"], cookie=cookie, watch=False), addr,
                timeout=3.0)
        except RadosError:
            pass                      # primary gone: nothing to drop

    def _notify(self, io: IoCtx, oid: str, payload: bytes,
                timeout_ms: int) -> tuple[int, int]:
        addr, ps, _ = self._primary_addr(io.pool_id, oid)
        with self._wn_lock:
            self._wn_seq += 1
            tid = 3_000_000 + self._wn_seq
        rep = self._wn_call(M.MNotify(
            tid=tid, pool=io.pool_id, ps=ps, oid=oid,
            payload=bytes(payload), timeout_ms=timeout_ms), addr,
            timeout=timeout_ms / 1000.0 + 5.0)
        return rep.acked, rep.missed

    def _on_watch_notify(self, msg: M.MWatchNotify, conn) -> None:
        # callbacks run OFF the messenger dispatch loop: they may do
        # blocking I/O (reload a header) whose replies arrive through
        # this very dispatcher; the ack follows the callback (ack ==
        # 'watcher processed it', the notify contract)
        import threading as _th

        def run():
            with self._wn_lock:
                w = self._watches.get(msg.cookie)
            if w is None:
                # GHOST watch (the OSD registered it but our watch()
                # call gave up/timed out): do NOT ack — the notifier
                # must never be told an unseen notify was processed —
                # and purge the stale registration
                try:
                    conn.send_message(self._mwatch(
                        tid=5_000_000 + msg.cookie, pool=msg.pool,
                        ps=0, oid=msg.oid, cookie=msg.cookie,
                        watch=False))
                except Exception:
                    pass
                return
            try:
                w["cb"](bytes(msg.payload))
            except Exception:
                pass
            # ack even on a failing callback: a buggy callback must
            # not stall the notifier (the watch itself processed it)
            try:
                conn.send_message(M.MWatchNotifyAck(
                    notify_id=msg.notify_id, cookie=msg.cookie))
            except Exception:
                pass

        _th.Thread(target=run, name="rados-watch-cb",
                   daemon=True).start()

    def _rewatch(self) -> None:
        """Re-register every watch whose primary moved (the Objecter
        linger resend on map change)."""
        with self._wn_lock:
            watches = dict(self._watches)
        for cookie, w in watches.items():
            try:
                addr, ps, primary = self._primary_addr(w["pool"],
                                                       w["oid"])
            except RadosError:
                continue
            if primary == w["osd"] and addr == w["addr"]:
                # same osd at the SAME address: nothing moved. A
                # restarted osd (same id, wiped in-memory watch
                # table) rebinds to a new addr, so the addr compare
                # is what makes 're-watches automatically' true
                continue
            if w.get("inval"):
                # an inval watch died with its primary: writes landed
                # in the gap WITHOUT holding for us. Drop the cached
                # copy and the registration — the next read miss
                # re-registers on the current primary through the
                # normal path, so every post-gap fill is covered
                with self._wn_lock:
                    self._watches.pop(cookie, None)
                    k = (w["pool"], w["oid"])
                    if self._inval_cookies.get(k) == cookie:
                        self._inval_cookies.pop(k, None)
                if self.cache is not None:
                    self.cache.invalidate_object(w["oid"])
                continue
            try:
                rep = self._wn_call(self._mwatch(
                    tid=4_000_000 + cookie, pool=w["pool"], ps=ps,
                    oid=w["oid"], cookie=cookie, watch=True), addr,
                    timeout=3.0)
                if rep.code == 0:
                    with self._wn_lock:
                        if cookie in self._watches:
                            self._watches[cookie]["osd"] = primary
                            self._watches[cookie]["addr"] = addr
            except RadosError:
                pass                  # next map push retries



    # -- admin --------------------------------------------------------
    def mon_command(self, cmd: dict, timeout: float = 10.0
                    ) -> tuple[int, str, bytes]:
        return self.monc.command(cmd, timeout)

    @staticmethod
    def dump_op_timelines() -> list[dict]:
        """Recently completed per-op stage timelines (the data-plane
        decomposition this client's ops contributed to): the merged
        client/primary/shard view, newest last. The same payload the
        OSD serves as ``dump_op_timeline``; here for tools (gap
        report) and tests that sit on the client side."""
        from ceph_tpu_torch.utils.dataplane import dataplane
        return dataplane().recent()

    def open_ioctx(self, pool_name: str) -> IoCtx:
        osdmap = self.monc.osdmap
        pid = osdmap.pool_by_name.get(pool_name)
        if pid is None:
            # maybe our map is stale; wait for a newer epoch once
            osdmap = self.monc.wait_for_map(osdmap.epoch + 1, 5.0)
            pid = osdmap.pool_by_name.get(pool_name)
        if pid is None:
            raise RadosError(-2, f"pool {pool_name!r} not found")
        return IoCtx(self, pid, pool_name)

    def wait_for_epoch(self, epoch: int, timeout: float = 10.0) -> None:
        self.monc.wait_for_map(epoch, timeout)
