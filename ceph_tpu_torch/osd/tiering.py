"""Cache tiering — the PrimaryLogPG cache-pool machinery
(src/osd/PrimaryLogPG.cc:2754 maybe_handle_cache_detail, :13842
agent_work, src/osd/TierAgentState.h), reduced to a writeback tier.

Shape of the reduction (same data flow as the reference):

- clients reach the CACHE pool via the OSDMap overlay redirect
  (client/rados.py `_submit`);
- a read/partial-write MISS on the cache pool parks the op and
  PROMOTES the object from the base pool (data + user xattrs + omap)
  on a dedicated tier worker — never on the op-queue shard, whose
  worker could be the one the base-pool op itself needs;
- deletes become WHITEOUTS (the reference's whiteout object state):
  reads see ENOENT without promoting, and the agent later propagates
  the delete to the base pool;
- mutations mark the object DIRTY (xattr ``t/d``); the flush/evict
  AGENT (agent_work role) writes dirty objects back to the base pool,
  stamps them clean (``t/c``), and evicts clean objects when the pool
  is over its target_max_objects/bytes budget. An object with NEITHER
  stamp (e.g. created by a full write that skipped promotion) counts
  dirty — eviction can never drop bytes the base pool has not seen.

Flush/clear race: the agent records the object's store version
(the ``v`` attr every versioned write carries) when it reads the
data, and clears the dirty stamp only if the version is unchanged —
a write landing mid-flush keeps its dirty mark and re-flushes next
pass.
"""

from __future__ import annotations

import json
import threading

from ceph_tpu_torch.utils.noop_hooks import make_lock
import time
from ceph_tpu_torch.utils.workerpool import DaemonPool

from ceph_tpu_torch.parallel import messages as M
from ceph_tpu_torch.utils.dout import Dout

log = Dout("tier")

#: xattr names (t/ = tier-internal namespace, never user-visible
#: through GETXATTRS? — they are; documented internal prefix)
DIRTY_ATTR = "t/d"
CLEAN_ATTR = "t/c"
WHITEOUT_ATTR = "t/wo"

#: seconds a promote outcome (success OR base-miss) suppresses
#: re-promotion of the same oid
PROMOTE_RECENT = 5.0

#: full-object-overwrite ops that need no base content on a miss
#: (CREATE is NOT here: exclusive-create must see a base-resident
#: object to answer EEXIST correctly, so it promotes first)
_FULL_WRITE_OPS = (M.OSD_OP_WRITE_FULL,)

#: read-class ops a cold miss may PROXY to the base pool instead of
#: promoting (do_proxy_read, src/osd/PrimaryLogPG.cc:2445): pure
#: reads whose request shape the base pool answers directly
_PROXYABLE_OPS = (M.OSD_OP_READ, M.OSD_OP_STAT, M.OSD_OP_SPARSE_READ,
                  M.OSD_OP_GETXATTR, M.OSD_OP_GETXATTRS)


class TierService:
    """Per-OSD cache-tiering engine (promote + agent)."""

    def __init__(self, osd) -> None:
        self.osd = osd
        self._objecter = None
        self._obj_lock = make_lock("tiering.objects")
        self._wq = DaemonPool(
            max_workers=2, thread_name_prefix=f"osd{osd.whoami}-tier")
        self._agent_running = False
        self._agent_lock = make_lock("tiering.agent")

    def shutdown(self) -> None:
        self._wq.shutdown(wait=False)
        with self._obj_lock:
            if self._objecter is not None:
                try:
                    self._objecter.shutdown()   # stops its tick thread
                except Exception:
                    pass

    # -- internal client to the base pool -----------------------------
    @property
    def objecter(self):
        with self._obj_lock:
            if self._objecter is None:
                from ceph_tpu_torch.client.objecter import Objecter
                self._objecter = Objecter(self.osd.msgr, self.osd.monc)
            return self._objecter

    def handle_reply(self, msg, conn) -> bool:
        """Route MOSDOpReply frames of our internal client."""
        if self._objecter is None:
            return False
        return self._objecter.handle_message(msg, conn)

    def _obj_version(self, pg, oid: str) -> bytes:
        """The object's STORE version attr (the ``v`` every versioned
        write stamps) — the flush/clear race token. Cache pools are
        replicated (mon enforces), so the local store holds it."""
        try:
            return self.osd.store.getattrs(
                pg.backend.local_cid(pg), oid).get("v", b"")
        except Exception:
            return b""

    # -- op intercept (maybe_handle_cache_detail role) ----------------
    def intercept(self, pg, pool, msg, conn, reply) -> bool:
        """Called under pg.lock before op execution on a cache-pool
        primary. Returns True when the op was fully handled (replied
        or parked); False lets the normal op path run."""
        from ceph_tpu_torch.osd.osd import ENOENT
        from ceph_tpu_torch.store.object_store import (NoSuchCollection,
                                                 NoSuchObject)
        be = pg.backend
        op = msg.op
        if op == M.OSD_OP_LIST:
            return False
        mutating = op in self.osd._MUTATING_OPS
        # hit-set accounting (HitSet.h role): recency is judged
        # BEFORE this access is recorded, so a first touch never
        # counts itself (min_read_recency_for_promote=1 means
        # "promote on the second access within the window")
        recency = self._hit_recency(pg, pool, msg.oid)
        self._record_hit(pg, pool, msg.oid)
        try:
            attrs = be.get_xattrs(pg, msg.oid)
        except (NoSuchObject, NoSuchCollection):
            return self._on_miss(pg, pool, msg, conn, reply, recency)
        if WHITEOUT_ATTR in attrs:
            if op == M.OSD_OP_REMOVE or not mutating:
                reply(ENOENT)     # deleted; never promote through it
                return True
            # write onto a whiteout: becomes a fresh dirty object
            version = pg.alloc_version()
            be.submit_setattrs(
                pg, msg.oid, {DIRTY_ATTR: b"1"},
                [WHITEOUT_ATTR, CLEAN_ATTR], version,
                lambda code: None)
            if op == M.OSD_OP_CREATE:
                # the whiteout object's empty body IS the created
                # object (exclusive-create succeeds: logically the
                # key did not exist)
                reply(0, b"", version)
                return True
            return False
        if op == M.OSD_OP_REMOVE:
            # whiteout conversion (the reference's writeback delete):
            # the object appears gone; the agent propagates. REMOVE
            # first so the dead object's xattrs AND omap go with it —
            # a later write onto the whiteout must not resurrect the
            # deleted generation's metadata
            version = pg.alloc_version()
            be.submit_remove(pg, msg.oid, version,
                             lambda code: None)
            v1 = pg.alloc_version()
            be.submit_write(pg, msg.oid, b"", v1,
                            lambda code: None)
            v2 = pg.alloc_version()
            be.submit_setattrs(
                pg, msg.oid, {WHITEOUT_ATTR: b"1", DIRTY_ATTR: b"1"},
                [], v2,
                lambda code, v=v2: reply(code, b"", v))
            return True
        if mutating and DIRTY_ATTR not in attrs:
            version = pg.alloc_version()
            be.submit_setattrs(pg, msg.oid, {DIRTY_ATTR: b"1"}, [],
                               version, lambda code: None)
        return False

    def _roll_hit_sets(self, pg, pool) -> None:
        """Advance the hit-set window (caller holds pg.lock)."""
        now = time.monotonic()
        if pg.hit_set_start == 0.0:
            pg.hit_set_start = now
            return
        if now - pg.hit_set_start >= pool.hit_set_period:
            pg.hit_set_archive.insert(0, pg.hit_set_live)
            del pg.hit_set_archive[max(pool.hit_set_count - 1, 0):]
            pg.hit_set_live = set()
            pg.hit_set_start = now

    def _hit_recency(self, pg, pool, oid: str) -> int:
        """How many tracked hit-set windows contain ``oid`` (caller
        holds pg.lock); -1 = hit sets disabled (always promote)."""
        if not pool.hit_set_period:
            return -1
        self._roll_hit_sets(pg, pool)
        n = 1 if oid in pg.hit_set_live else 0
        return n + sum(1 for hs in pg.hit_set_archive if oid in hs)

    def _record_hit(self, pg, pool, oid: str) -> None:
        if pool.hit_set_period:
            pg.hit_set_live.add(oid)

    def _on_miss(self, pg, pool, msg, conn, reply,
                 recency: int = -1) -> bool:
        """Cache miss: full overwrites proceed (they need no base
        content and are dirty-by-absence-of-stamps); COLD reads are
        proxied to the base pool without promotion (hit sets gate
        promotion — promote-on-every-miss thrashes the tier under
        scan workloads, the pathology hit sets exist to prevent);
        everything else parks behind a promote."""
        if msg.op in _FULL_WRITE_OPS:
            return False
        if recency >= 0 and msg.op in _PROXYABLE_OPS and \
                recency < pool.min_read_recency_for_promote:
            self._wq.submit(self._proxy_read, pool, msg, reply)
            return True
        now = time.monotonic()
        recent = pg.tier_recent.get(msg.oid, 0.0)
        if now - recent < PROMOTE_RECENT:
            return False          # base-miss just recorded: run the
            # op against what the cache holds (natural ENOENT). Only
            # FAILED promotes park here — a successful promote leaves
            # no marker, so an object evicted right after promotion
            # re-promotes instead of spuriously ENOENTing.
            # (A REMOVE miss promotes the full object only to white
            # it out — wasteful but correct; the remove must answer
            # ENOENT truthfully when the base never had the key.)
        parked = pg.tier_parked.setdefault(msg.oid, [])
        parked.append((msg, conn))
        if len(parked) == 1:
            self._wq.submit(self._promote, pg, pool, msg.oid)
        return "parked"

    def _proxy_read(self, pool, msg, reply) -> None:
        """Serve a cold read from the BASE pool without promoting
        (do_proxy_read, src/osd/PrimaryLogPG.cc:2445). Tier-worker
        context, no pg.lock."""
        from ceph_tpu_torch.client.objecter import ObjecterError
        try:
            # the op's snap context rides along: a pool-snapshot read
            # proxied to the base pool must resolve through the base's
            # snapset to the covering clone, not answer HEAD data
            rep = self.objecter.op_submit(
                pool.tier_of, msg.oid, msg.op, offset=msg.offset,
                length=msg.length, xname=msg.xname,
                snapid=msg.snapid)
            self.osd.logger.inc("tier_proxy_read")
            reply(rep.code, bytes(rep.data), rep.version)
        except ObjecterError as exc:
            reply(exc.code)
        except Exception:
            from ceph_tpu_torch.osd.osd import EIO
            reply(EIO)

    def _promote(self, pg, pool, oid: str) -> None:
        """Tier-worker context, NO pg.lock held: pull the object from
        the base pool, install it CLEAN in the cache PG, re-run the
        parked ops."""
        base = pool.tier_of
        data = None
        attrs: dict[str, bytes] = {}
        omap: dict[str, bytes] = {}
        try:
            rep = self.objecter.op_submit(base, oid, M.OSD_OP_READ)
            data = bytes(rep.data)
            rep = self.objecter.op_submit(base, oid,
                                          M.OSD_OP_GETXATTRS)
            # client-view names (the u/ store prefix is already
            # stripped); exclude our own t/* bookkeeping
            attrs = {n: bytes.fromhex(v) for n, v in
                     json.loads(rep.data).items()
                     if not n.startswith("t/")}
            try:
                rep = self.objecter.op_submit(
                    base, oid, M.OSD_OP_OMAPGET,
                    data=json.dumps([]).encode())
                omap = {k: bytes.fromhex(v) for k, v in
                        json.loads(rep.data).items()}
                rep = self.objecter.op_submit(
                    base, oid, M.OSD_OP_OMAPGETHEADER)
                if rep.data:
                    from ceph_tpu_torch.osd.osd import OMAP_HDR_KEY
                    omap[OMAP_HDR_KEY] = bytes(rep.data)
            except Exception:
                omap = {}         # EC base pool: no omap there
        except Exception as exc:
            log(10, f"promote {oid}: base read failed ({exc!r})")
            data = None
        from ceph_tpu_torch.store.object_store import (NoSuchCollection,
                                                 NoSuchObject)
        with pg.lock:
            if data is None:
                # record FAILED promotes only: the requeued ops run
                # against the cache (natural ENOENT) instead of
                # re-parking forever; successful promotes leave no
                # marker so post-eviction misses re-promote
                pg.tier_recent[oid] = time.monotonic()
            if len(pg.tier_recent) > 10000:
                cutoff = time.monotonic() - PROMOTE_RECENT
                for k in [k for k, t in pg.tier_recent.items()
                          if t < cutoff]:
                    del pg.tier_recent[k]
            parked = pg.tier_parked.pop(oid, [])
            if data is None:
                # base miss: requeue — the ops get their natural
                # ENOENT (or create the object) against the cache
                self._requeue(pg, parked)
                return
            be = pg.backend
            try:
                be.get_xattrs(pg, oid)
                # the object APPEARED while our base read was in
                # flight (a full write took the _FULL_WRITE_OPS fast
                # path): it is newer than the base copy — installing
                # ours would overwrite an acked write and stamp it
                # clean. The cache object wins; just requeue.
                self._requeue(pg, parked)
                return
            except (NoSuchObject, NoSuchCollection):
                pass
            version = pg.alloc_version()
            be.submit_write(pg, oid, data, version,
                            lambda code: None)
            v2 = pg.alloc_version()
            be.submit_setattrs(
                pg, oid, {**attrs, CLEAN_ATTR: b"1"}, [], v2,
                lambda code: self._requeue(pg, parked))
            if omap and be.omap_supported():
                v3 = pg.alloc_version()
                be.submit_omap(pg, oid, omap, [], v3,
                               lambda code: None)
            self.osd.logger.inc("tier_promote")

    def _requeue(self, pg, parked) -> None:
        for m, c in parked:
            self.osd.op_wq.enqueue(
                (m.pool, m.ps),
                lambda m=m, c=c: self.osd._handle_osd_op(m, c))

    # -- flush / evict agent (agent_work role) ------------------------
    def agent_tick(self) -> None:
        """Called from the OSD heartbeat loop: schedule one agent pass
        if none is running."""
        with self._agent_lock:
            if self._agent_running:
                return
            self._agent_running = True
        self._wq.submit(self._agent_pass)

    def _agent_pass(self) -> None:
        try:
            osdmap = self.osd.get_osdmap()
            if osdmap is None:
                return
            for pg in list(self.osd.pgs.values()):
                pool = osdmap.pools.get(pg.pool)
                if pool is None or not pool.is_cache_tier:
                    continue
                _, _, primary = osdmap.pg_to_up_acting(pg.pool, pg.ps)
                if primary != self.osd.whoami:
                    continue
                try:
                    self._agent_pg(pg, pool)
                except Exception as exc:
                    log(5, f"agent pass {pg}: {exc!r}")
        finally:
            with self._agent_lock:
                self._agent_running = False

    def _agent_pg(self, pg, pool) -> None:
        from ceph_tpu_torch.store.object_store import (NoSuchCollection,
                                                 NoSuchObject)
        with pg.lock:
            if pg.state != pg.ACTIVE:
                return
            oids = self.osd._list_pg(pg)
        clean: list[tuple[str, int]] = []     # (oid, size)
        for oid in oids:
            with pg.lock:
                if pg.state != pg.ACTIVE:
                    return
                be = pg.backend
                try:
                    attrs = be.get_xattrs(pg, oid)
                except (NoSuchObject, NoSuchCollection):
                    continue
                dirty = DIRTY_ATTR in attrs or CLEAN_ATTR not in attrs
                if not dirty:
                    try:
                        clean.append((oid, be.stat_object(pg, oid)))
                    except (NoSuchObject, NoSuchCollection):
                        pass
                    continue
                if WHITEOUT_ATTR in attrs:
                    self._flush_whiteout(pg, pool, oid)
                    continue
                data = bytes(be.read_object(pg, oid))
                ver = self._obj_version(pg, oid)
                uattrs = {n: v for n, v in attrs.items()
                          if not n.startswith("t/")}
                omap = be.get_omap(pg, oid) \
                    if be.omap_supported() else {}
            self._flush(pg, pool, oid, data, uattrs, omap, ver)
        self._evict(pg, pool, clean)

    def _flush_whiteout(self, pg, pool, oid: str) -> None:
        """Propagate a delete to the base pool, then drop the
        whiteout (caller holds pg.lock — the base-pool op runs after
        we release it via the worker? No: run inline; the whiteout
        body is empty and the base delete is the only I/O)."""
        from ceph_tpu_torch.store.object_store import (NoSuchCollection,
                                                 NoSuchObject)
        base = pool.tier_of

        def still_whiteout() -> bool:
            # caller holds pg.lock: a client write meanwhile turns
            # the whiteout into a FRESH object (intercept clears the
            # attr) — deleting it would lose that acked write
            try:
                return WHITEOUT_ATTR in pg.backend.get_xattrs(pg, oid)
            except (NoSuchObject, NoSuchCollection):
                return False

        def work():
            with pg.lock:
                if not still_whiteout():
                    return
            try:
                self.objecter.op_submit(base, oid, M.OSD_OP_REMOVE)
            except Exception as exc:
                if getattr(exc, "code", None) != -2:
                    log(5, f"whiteout flush {oid}: {exc!r}")
                    return        # keep the whiteout; retry next pass
            with pg.lock:
                if not still_whiteout():
                    return        # re-written mid-flight: now a
                    # fresh dirty object the next pass flushes
                version = pg.alloc_version()
                pg.backend.submit_remove(pg, oid, version,
                                         lambda code: None)
                self.osd.logger.inc("tier_flush")
        self._wq.submit(work)

    def _flush(self, pg, pool, oid: str, data: bytes,
               uattrs: dict, omap: dict, ver: bytes) -> None:
        """Write one dirty object back to the base pool (NO pg.lock
        held), then stamp it clean iff unmodified meanwhile."""
        from ceph_tpu_torch.store.object_store import (NoSuchCollection,
                                                 NoSuchObject)
        from ceph_tpu_torch.osd.osd import OMAP_HDR_KEY
        base = pool.tier_of
        hdr = omap.pop(OMAP_HDR_KEY, None)
        try:
            # REMOVE first: the base copy is rebuilt from scratch, so
            # attrs/omap keys DELETED in the cache stay deleted (an
            # add-only flush would resurrect them on the next
            # evict+promote cycle). Nothing reads the base directly
            # while the overlay is installed, so the non-atomic
            # rebuild window is invisible.
            try:
                self.objecter.op_submit(base, oid, M.OSD_OP_REMOVE)
            except Exception as exc:
                if getattr(exc, "code", None) != -2:
                    raise
            self.objecter.op_submit(base, oid, M.OSD_OP_WRITE_FULL,
                                    data=data)
            for n, v in uattrs.items():
                self.objecter.op_submit(base, oid, M.OSD_OP_SETXATTR,
                                        xname=n, data=v)
            if omap or hdr:
                try:
                    if omap:
                        self.objecter.op_submit(
                            base, oid, M.OSD_OP_OMAPSET,
                            data=json.dumps({k: v.hex() for k, v in
                                             omap.items()}).encode())
                    if hdr:
                        self.objecter.op_submit(
                            base, oid, M.OSD_OP_OMAPSETHEADER,
                            data=hdr)
                except Exception:
                    pass          # EC base: omap not representable
        except Exception as exc:
            log(5, f"flush {oid}: {exc!r}")
            return                # still dirty; retried next pass
        with pg.lock:
            be = pg.backend
            try:
                be.get_xattrs(pg, oid)    # existence check
            except (NoSuchObject, NoSuchCollection):
                return
            if self._obj_version(pg, oid) != ver:
                return            # modified mid-flush: stays dirty
            version = pg.alloc_version()
            be.submit_setattrs(pg, oid, {CLEAN_ATTR: b"1"},
                               [DIRTY_ATTR], version,
                               lambda code: None)
            self.osd.logger.inc("tier_flush")

    def _evict(self, pg, pool, clean: list) -> None:
        """Drop clean objects while the PG is over its share of the
        pool budget (agent evict_mode role)."""
        if not clean:
            return
        # a PG's share floors at 1: a target below pg_num must still
        # evict (integer division alone would disable eviction)
        share_objs = max(1, pool.target_max_objects // pool.pg_num) \
            if pool.target_max_objects else 0
        share_bytes = max(1, pool.target_max_bytes // pool.pg_num) \
            if pool.target_max_bytes else 0
        if not share_objs and not share_bytes:
            return
        from ceph_tpu_torch.store.object_store import (NoSuchCollection,
                                                 NoSuchObject)
        with pg.lock:
            if pg.state != pg.ACTIVE:
                return
            be = pg.backend
            count = len(self.osd._list_pg(pg))
            total = sum(s for _, s in clean)
            for oid, size in sorted(clean):
                over = (share_objs and count > share_objs) or \
                    (share_bytes and total > share_bytes)
                if not over:
                    break
                # revalidate NOW: the clean list was captured before
                # the (slow) flush phase — a write since then made
                # the object dirty and evicting it would lose data
                try:
                    cur = be.get_xattrs(pg, oid)
                except (NoSuchObject, NoSuchCollection):
                    continue
                if DIRTY_ATTR in cur or CLEAN_ATTR not in cur or \
                        WHITEOUT_ATTR in cur:
                    continue
                version = pg.alloc_version()
                be.submit_remove(pg, oid, version,
                                 lambda code: None)
                count -= 1
                total -= size
                self.osd.logger.inc("tier_evict")
