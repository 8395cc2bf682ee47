"""Objecter — the client-side op engine (src/osdc/Objecter.{h,cc}).

``op_submit`` (Objecter.cc:2265) assigns a tid, computes the target
primary from the current osdmap (+CRUSH) the way ``_calc_target``
(:2795) does, and sends one MOSDOp. Reliability over the lossy
messenger is this layer's job, as in the reference:

  - on every new map epoch, every pending op is retargeted and resent
    (the primary may have moved);
  - a tick thread resends ops that have been in flight longer than
    ``objecter_resend_interval`` (lost message / dead primary);
  - an ESTALE reply (op reached a non-primary) leaves the op pending
    for the next map push / tick instead of hammering the ex-primary
    with the same stale target at RTT rate.

Placement-affine reads (ROADMAP 3): with ``objecter_read_affinity``
on, plain head reads target the PG's CRUSH-stable affine acting
member (the same ``stable_hash`` the server-side placement map uses
to pick a PG's chip slot) instead of always the primary — every
client lands the same member per PG, so a hot PG's reads coalesce
there and a zipfian storm spreads across the acting set instead of
melting the primaries. The member serves committed data (every
acting position acked the write before the client saw its ack); if
its map disagrees it answers ESTALE and the op falls back to the
primary IMMEDIATELY — affine routing is an optimization and must
never add a map-push round trip to correctness.

Duplicate delivery on resend is safe for ALL ops: the OSD keeps a
(client, tid) dup-op cache and answers a resend of an already-applied
mutation with the original reply instead of re-executing it (the
reference's reqid-based dup detection in the pg log).
"""

from __future__ import annotations

import threading

from ceph_tpu_torch.analysis.lock_witness import make_lock
import time

from ceph_tpu_torch.parallel import messages as M
from ceph_tpu_torch.parallel.messenger import Connection, Messenger
from ceph_tpu_torch.parallel.mon_client import MonClient
from ceph_tpu_torch.parallel.osdmap import OSDMap
from ceph_tpu_torch.parallel.placement import stable_hash
from ceph_tpu_torch.utils import profiler as _profiler
from ceph_tpu_torch.utils import stage_clock
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.dataplane import dataplane
from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.utils.store_telemetry import telemetry as _store_tel
from ceph_tpu_torch.utils.dispatch_telemetry import telemetry as _dsp_tel
from ceph_tpu_torch.utils import flow_telemetry as _flows

log = Dout("objecter")

ESTALE = -116


class ObjecterError(Exception):
    def __init__(self, code: int, message: str = "") -> None:
        super().__init__(message or f"op failed: code {code}")
        self.code = code


class _Op:
    __slots__ = ("tid", "msg", "event", "reply", "sent_at", "attempts",
                 "wake_t", "affine", "no_affine", "skey", "rsalt")

    def __init__(self, tid: int, msg: M.MOSDOp) -> None:
        self.tid = tid
        self.msg = msg
        self.event = threading.Event()
        self.reply: M.MOSDOpReply | None = None
        self.sent_at = 0.0
        self.attempts = 0
        #: monotonic stamp taken just before event.set() — the waiter
        #: side measures signal->wake latency from it (ISSUE 17)
        self.wake_t = 0.0
        #: last transmission targeted a non-primary affine member
        self.affine = False
        #: affine routing disabled for this op's lifetime (an affine
        #: ESTALE demoted it; every retransmission pins the primary)
        self.no_affine = False
        #: stream key the op entered _streams under (None = never
        #: streamed; _stream_note_done keys its drain off this)
        self.skey: tuple | None = None
        #: any-k rotation salt, fixed at first submission: 0 for cold
        #: objects (the CRUSH-stable affine member — full coalescing),
        #: advancing once per _ROT_WINDOW reads of a hot object so its
        #: serving fans out over the whole acting set
        self.rsalt = 0


EBLOCKLISTED = -108

#: errno replies that mark the op's trace errored for the tail
#: sampler (ISSUE 10). Infrastructure trouble only — EIO and client
#: timeouts; semantic errnos (ENOENT, EEXIST, ECANCELED...) are
#: normal protocol outcomes a busy rgw/cephfs workload produces by
#: the thousand and must not saturate the keep/autopsy rings.
TRACE_ERRNOS = (-5, -110)


#: op codes the streaming seam may coalesce (plain data writes and —
#: round 19 — plain head reads; the guarded / snap-context / cls
#: families keep singleton frames). Read and write runs stream under
#: SEPARATE keys: a read frame targets the PG's affine acting member,
#: a write frame its primary.
_STREAM_OPS = (1, 2, 5, 6)       # WRITE_FULL, READ, WRITE, APPEND

#: client-side any-k rotation window: an object's affine target stays
#: put for this many of OUR reads, then rotates one acting position.
#: Cold objects (fewer reads than the window) never leave the
#: CRUSH-stable pick, so cross-client coalescing is undisturbed; a
#: hot object's storm fans out over every acting member — all of
#: which hold every acked write (the commit rule acks only after all
#: acting positions commit), so any member serves consistent reads.
_ROT_WINDOW = 16

#: per-object read-count book cap (mirrors utils/read_heat): at the
#: cap the coldest half is dropped — losing a count only resets a
#: cold object's rotation to the stable pick
_ROT_CAP = 8192


class Objecter:
    def __init__(self, msgr: Messenger, monc: MonClient,
                 client_id: str | None = None) -> None:
        self.msgr = msgr
        self.monc = monc
        #: the identity ops carry (blocklist fencing + dup-op cache
        #: key); an instance-qualified id when the owning RadosClient
        #: provides one, else the bare messenger entity name
        self.client_id = client_id or msgr.entity_name
        #: sticky client-side fence (librbd's is-blocklisted
        #: invalidation role): once ANY op is rejected EBLOCKLISTED,
        #: this instance never submits again — even after the osdmap
        #: entry expires, a fenced instance must not resume with
        #: stale state; the process gets a fresh instance by
        #: reconnecting (new RadosClient)
        self.fenced = False
        self._lock = make_lock("objecter.state")
        self._next_tid = 1
        self._pending: dict[int, _Op] = {}
        # the streaming submission seam (ROADMAP 1b): per-(pool, PG,
        # kind) coalescing state — ops arriving while that stream has
        # a frame in flight accumulate and ship as ONE MOSDOpBatch the
        # moment the in-flight frame drains (no hold timer: solo
        # traffic ships immediately; batching emerges under
        # concurrency, exactly the adjacency the PR-14 ledger
        # measured). kind splits reads from writes, and affine reads
        # further split by target member: frames to different acting
        # members fly concurrently (the any-k read parallelism).
        self._streams: dict[tuple, dict] = {}
        self._stream_enabled = bool(g_conf()["objecter_stream"])
        # placement-affine read routing (ROADMAP 3): plain literal
        # read — an on/off policy switch, not a tuner-stepped knob
        self._read_affinity = bool(g_conf()["objecter_read_affinity"])
        # per-object read counts driving client-side any-k rotation
        # (under _lock; capped at _ROT_CAP, coldest half dropped).
        # The per-client seed de-phases concurrent clients: a storm
        # from N clients lands N different acting members at any
        # instant instead of all rotating onto the same one together.
        self._read_rot: dict[tuple[int, str], int] = {}
        self._rot_seed = stable_hash(self.client_id)
        # the batch window is a tuner-managed Knob: cache it through
        # the config-observer seam, never a hot-path config read
        self._stream_max = int(g_conf()["objecter_stream_max_ops"])
        g_conf().add_observer("objecter_stream_max_ops",
                              self._on_stream_window)
        self._stop = threading.Event()
        self._tick = threading.Thread(
            target=self._tick_loop, name="objecter-tick", daemon=True)
        self._tick.start()
        monc.add_map_callback(self._on_map)

    def _on_stream_window(self, _name: str, value) -> None:
        try:
            value = max(int(value), 1)
        except (TypeError, ValueError):
            return
        with self._lock:       # read under _lock on the submit path
            self._stream_max = value

    def shutdown(self) -> None:
        self._stop.set()
        try:
            g_conf().remove_observer("objecter_stream_max_ops",
                                     self._on_stream_window)
        except Exception:
            pass
        self._tick.join(timeout=5)

    # -- inbound ------------------------------------------------------
    def handle_message(self, msg: M.Message, conn: Connection) -> bool:
        if isinstance(msg, M.MOSDOpReplyBatch):
            # wakeup accounting (ISSUE 17): frames count HERE, once
            # per sweep — _handle_reply runs once per contained tid
            try:
                _dsp_tel().note_reply_frame(self.client_id,
                                            len(msg.tids))
            except Exception:
                pass
            # one frame = one reply sweep: every contained tid wakes
            # exactly as if its singleton MOSDOpReply arrived
            for i, tid in enumerate(msg.tids):
                self._handle_reply(M.MOSDOpReply(
                    tid=tid,
                    code=msg.codes[i] if i < len(msg.codes) else 0,
                    epoch=int(msg.epochs[i])
                    if i < len(msg.epochs) else 0,
                    data=msg.datas[i] if i < len(msg.datas) else b"",
                    version=msg.versions[i]
                    if i < len(msg.versions) else 0,
                    stages=msg.stages[i]
                    if i < len(msg.stages) else ""))
            return True
        if not isinstance(msg, M.MOSDOpReply):
            return False
        try:
            _dsp_tel().note_reply_frame(self.client_id, 1)
        except Exception:
            pass
        self._handle_reply(msg)
        return True

    def _handle_reply(self, msg: M.MOSDOpReply) -> None:
        if msg.code == EBLOCKLISTED:
            # sticky even when the op already timed out locally (a
            # parked op's late rejection must still fence us)
            self.fenced = True
        with self._lock:
            op = self._pending.get(msg.tid)
        if op is None:
            return             # dup reply after resend: drop
        if msg.code == ESTALE:
            if op.affine:
                # the AFFINE member declined (its map disagrees /
                # mid-backfill): demote this op to primary routing
                # and resend NOW — the primary is always correct, and
                # an optimization must not cost a map-push round trip
                op.affine = False
                op.no_affine = True
                self._send(op)
                return
            # reached a non-primary; our map is behind. Leave the op
            # pending: the mon's map push retargets it (and the tick
            # loop backstops a lost push).
            return
        with self._lock:
            self._pending.pop(msg.tid, None)
        self._stream_note_done(op)
        op.reply = msg
        op.wake_t = time.monotonic()
        op.event.set()

    # -- submit -------------------------------------------------------
    def op_submit(self, pool: int, oid: str, op: int, *, offset: int = 0,
                  length: int = 0, data: bytes = b"", ps: int = -1,
                  cls: str = "", method: str = "",
                  snap_seq: int = 0, snaps: list | tuple = (),
                  snapid: int = 0, xname: str = "", xop: int = 0,
                  gname: str = "", gop: int = 0, gval: bytes = b"",
                  gflags: int = 0, flow: str = "",
                  timeout: float = 30.0) -> M.MOSDOpReply:
        """Synchronous submit (the aio variant is just this on a
        thread); raises ObjecterError on errno replies."""
        from ceph_tpu_torch.utils.tracing import tracer
        if self.fenced:
            raise ObjecterError(
                EBLOCKLISTED,
                f"client instance {self.client_id!r} is fenced "
                "(blocklisted); reconnect for a fresh instance")
        # the op's StageClock anchors here: the per-op data-plane
        # timeline every daemon downstream continues (always on —
        # marks are a list append, recording a few histogram incs).
        # The profiler stage join brackets the same interval: a
        # sample of this thread until the send hand-off is
        # objecter_encode work.
        _pstage = _profiler.push_stage("objecter_encode")
        clock = stage_clock.StageClock()
        with self._lock:
            tid = self._next_tid
            self._next_tid += 1
        span = tracer().new_trace(f"osd_op(op={op} oid={oid})",
                                  self.msgr.entity_name,
                                  op_type=f"osd_op_{op}")
        # flow attribution (ISSUE 20): the tenant label rides the op
        # end to end; with flows disabled the wire field stays "" and
        # nothing is accounted (the literal-NOOP contract)
        ft = _flows.flows_if_active()
        if ft is None:
            flow = ""
        msg = M.MOSDOp(tid=tid, client=self.client_id, epoch=0,
                       pool=pool, ps=max(ps, 0), oid=oid, op=op,
                       offset=offset, length=length, data=bytes(data),
                       trace=span.wire(), cls=cls, method=method,
                       snap_seq=snap_seq, snaps=list(snaps),
                       snapid=snapid, xname=xname, xop=xop,
                       gname=gname, gop=gop, gval=bytes(gval),
                       gflags=gflags, flow=flow)
        if ft is not None and flow:
            try:
                ft.note_demand(flow, nbytes=len(data))
            except Exception:
                pass   # telemetry faults never cost an op
        clock.mark("objecter_encode")
        # the messenger marks send_queue_wait and serializes the
        # marks-so-far into msg.stages right before the frame build
        msg._stage_clock = clock
        rec = _Op(tid, msg)
        if (self._read_affinity and op == M.OSD_OP_READ
                and not snapid and not cls and not gname):
            rec.rsalt = self._rot_salt(pool, oid)
        with self._lock:
            self._pending[tid] = rec
        span.event("submitted")
        try:
            if self._streamable(msg):
                self._stream_submit(rec)
            else:
                self._send(rec)
        finally:
            _profiler.pop_stage(_pstage)
        # the submission-stream ledger (ISSUE 14, ROADMAP 1b's
        # measurement): this op's (pool, PG) arrival + live in-flight
        # depth feed the streaming-objecter what-if — how many of
        # these per-op submits a streaming seam would have coalesced.
        # _send resolved msg.ps; telemetry faults never cost an op.
        try:
            _store_tel().note_objecter_submit(msg.pool, msg.ps)
            _stream_noted = True
        except Exception:
            _stream_noted = False
        try:
            # blocked on the cluster: a sample of this thread here is
            # client wait, not encode work (the classifier would
            # otherwise charge the park to objecter_encode)
            _pwait = _profiler.push_stage("client_wait")
            try:
                committed = rec.event.wait(timeout)
            finally:
                _profiler.pop_stage(_pwait)
            if committed and rec.wake_t:
                # signal->wake->running latency, per connection: the
                # run-to-completion ledger's wakeup-cost input
                try:
                    _dsp_tel().note_wakeup(
                        self.client_id,
                        time.monotonic() - rec.wake_t)
                except Exception:
                    pass
            if not committed:
                with self._lock:
                    self._pending.pop(tid, None)
                self._stream_note_done(rec)
                span.event("timeout")
                # the tail sampler keeps errored traces: a timed-out
                # op is exactly the outlier worth an autopsy
                span.set_error("timeout")
                raise ObjecterError(-110, f"op on {oid!r} timed out")
            span.event("reply")
            reply = rec.reply
            # the reply carries the merged timeline (client marks +
            # primary + shard children): close it, hang it on the
            # root span (slow/error keeps autopsy it), and — on
            # success — record the client-owned stages + total with
            # the trace_id as the histogram exemplar
            timeline = stage_clock.StageClock.from_wire(reply.stages)
            if timeline is not stage_clock.NOOP:
                timeline.mark("commit_reply")
                span.attach_clock(timeline)
            if reply.code < 0:
                # errno replies may carry the daemon's diagnostic as
                # data (e.g. the EC read ladder naming the unreachable
                # shard set) — surface it instead of a bare code
                detail = b""
                try:
                    detail = bytes(reply.data or b"")
                except Exception:
                    pass
                if reply.code in TRACE_ERRNOS:
                    # only infrastructure failures mark the trace:
                    # semantic errnos (ENOENT stats, EEXIST creates)
                    # are normal outcomes and must not flood the
                    # keep ring / autopsy ring
                    span.set_error(f"code={reply.code}")
                raise ObjecterError(
                    reply.code,
                    f"op failed: code {reply.code}: "
                    f"{detail.decode('utf-8', 'replace')}"
                    if detail else "")
            if timeline is not stage_clock.NOOP:
                try:
                    dataplane().record_op(
                        timeline, trace_id=span.trace_id or None)
                except Exception:
                    pass   # telemetry faults never cost an op
                try:
                    # causal chain (ISSUE 17): hops this op crossed,
                    # derived from the merged timeline — no new wire
                    # fields
                    _dsp_tel().note_op_chain(timeline.dump())
                except Exception:
                    pass
            if ft is not None and flow:
                try:
                    # the fairness ledger's served half: demand was
                    # noted at submit, so a starved flow's deficit is
                    # exactly its unserved backlog
                    ft.note_served(flow, nbytes=len(reply.data or b""))
                except Exception:
                    pass
            return reply
        finally:
            if _stream_noted:
                try:
                    _store_tel().note_objecter_done(msg.pool, msg.ps)
                except Exception:
                    pass
            span.finish()

    # -- streaming submission seam (ROADMAP 1b) ------------------------
    def _streamable(self, msg: M.MOSDOp) -> bool:
        """Plain data writes and plain head reads: guarded,
        snap-context, xattr/omap, cls and snapshot reads keep their
        singleton frames (their reply shapes and admission paths are
        op-specific)."""
        return (self._stream_enabled and self._stream_max > 1
                and msg.op in _STREAM_OPS and not msg.cls
                and not msg.gname and not msg.xname
                and not msg.snap_seq and not msg.snaps
                and not msg.snapid)

    def _stream_submit(self, rec: _Op) -> None:
        """First-transmission vehicle selection: ship immediately
        while the op's (pool, PG) stream is idle; while a frame is in
        flight, accumulate — the accumulated run ships as ONE
        MOSDOpBatch the moment the in-flight frame drains (or sooner,
        when it reaches the batch window). The op itself stays a
        fully-formed singleton MOSDOp in ``_pending``: map pushes and
        the resend tick retransmit it individually, so reliability is
        exactly the singleton machinery."""
        osdmap = self.monc.osdmap
        msg = rec.msg
        if osdmap is None or osdmap.pools.get(msg.pool) is None:
            return              # wait for a map that has the pool
        ps, acting, primary = osdmap.object_locator(msg.pool, msg.oid)
        msg.ps = ps
        kind = "r" if msg.op == M.OSD_OP_READ else "w"
        # read streams split by affine target: each acting member
        # gets its OWN in-flight frame window, so a hot PG's reads
        # pipeline to several members concurrently instead of
        # serializing behind one frame — the any-k parallelism is
        # client-visible, not just server-side shard balance. Writes
        # (and affinity-off reads) keep the single (pool, PG) stream.
        tgt = -1
        if kind == "r" and self._read_affinity and not rec.no_affine:
            tgt = self._read_target(osdmap, msg.pool, ps, acting,
                                    primary, salt=rec.rsalt)
        key = (msg.pool, ps, kind, tgt)
        rec.skey = key
        ship = None
        with self._lock:
            st = self._streams.get(key)
            if st is None:
                st = self._streams[key] = {"inflight": set(),
                                           "pending": []}
            if not st["inflight"]:
                # idle stream: this op leads (zero added latency)
                st["inflight"].add(rec.tid)
            else:
                st["pending"].append(rec)
                rec.sent_at = time.monotonic()
                if len(st["pending"]) >= self._stream_max:
                    ship = self._stream_take_locked(st)
                else:
                    return
        if ship is None:
            self._send(rec)
        else:
            self._ship_stream(key, ship)

    @staticmethod
    def _stream_take_locked(st: dict) -> list:
        """Take the pending run to ship — EXCLUDING any op the tick
        loop already singleton-sent while it waited (shipping it
        again would race the in-flight execution of a non-idempotent
        op like append; an already-sent op is the resend machinery's
        to finish)."""
        batch = [r for r in st["pending"] if r.attempts == 0]
        st["pending"] = []
        st["inflight"].update(r.tid for r in batch)
        return batch

    def _stream_note_done(self, rec: _Op) -> None:
        """An op left ``_pending`` (reply or timeout): drain its
        stream bookkeeping, and when the in-flight frame is done,
        ship the accumulated run."""
        key = rec.skey
        if key is None:
            return              # never entered a stream
        ship = None
        with self._lock:
            st = self._streams.get(key)
            if st is None:
                return
            st["inflight"].discard(rec.tid)
            if st["pending"] and not st["inflight"]:
                ship = self._stream_take_locked(st)
            elif not st["pending"] and not st["inflight"]:
                del self._streams[key]
        if ship:
            self._ship_stream(key, ship)

    def _ship_stream(self, key: tuple, recs: list) -> None:
        """Frame the accumulated run: one MOSDOpBatch per (pool, PG,
        kind, affine target) — one serialize, one wire traversal, one
        reply sweep. A run of one keeps the singleton frame (no batch
        overhead for solo traffic). Write frames target the primary;
        read frames the PG's affine acting member (same-slot reads
        coalesce server-side — the whole point of placement
        affinity). The target is recomputed from the run's rotation
        salt against the CURRENT map, not trusted from the key."""
        if not recs:
            return
        if len(recs) == 1:
            self._send(recs[0])
            return
        osdmap = self.monc.osdmap
        if osdmap is None:
            return              # tick/map-push resend singletons
        pool, ps, kind = key[0], key[1], key[2]
        _, acting, primary = osdmap.pg_to_up_acting(pool, ps)
        target = primary
        affine = False
        if (kind == "r" and self._read_affinity
                and not any(r.no_affine for r in recs)):
            target = self._read_target(osdmap, pool, ps, acting,
                                       primary, salt=recs[0].rsalt)
            affine = target != primary
        info = osdmap.osds.get(target) if target >= 0 else None
        if info is None or not info.addr:
            return              # PG unserviceable; tick retries
        for r in recs:
            r.affine = affine
        now = time.monotonic()
        stages = []
        for r in recs:
            r.msg.epoch = osdmap.epoch
            r.sent_at = now
            r.attempts += 1
            clock = getattr(r.msg, "_stage_clock", None)
            if clock is not None:
                # the batch is the send hand-off: each entry keeps
                # its OWN timeline (unlike MECSubWriteBatch entries,
                # which are born sharing the frame clock)
                clock.mark_once("send_queue_wait", t=now)
                stages.append(clock.to_wire())
            else:
                stages.append("")
        with self._lock:
            tid = self._next_tid
            self._next_tid += 1
        batch = M.MOSDOpBatch(
            tid=tid, client=self.client_id, epoch=osdmap.epoch,
            pool=pool, ps=ps,
            tids=[r.tid for r in recs],
            oids=[r.msg.oid for r in recs],
            ops=[r.msg.op for r in recs],
            offsets=[r.msg.offset for r in recs],
            lengths=[r.msg.length for r in recs],
            datas=[r.msg.data for r in recs],
            traces=[r.msg.trace for r in recs],
            stages=stages,
            # per-entry flow labels (ISSUE 20): coalescing must not
            # lose attribution — each entry keeps its own tenant
            flows=[r.msg.flow for r in recs])
        try:
            _store_tel().note_stream_batch(len(recs))
        except Exception:
            pass                # telemetry faults never cost an op
        self.msgr.send_message(batch, info.addr)

    def _rot_salt(self, pool: int, oid: str) -> int:
        """Count this read and return the object's any-k rotation
        salt: the per-client seed plus the read-count window. The
        seed spreads DIFFERENT clients over different acting members
        from their very first read (balance without coordination);
        the window term walks each client's pick around the set as
        its own storm grows."""
        key = (pool, oid)
        with self._lock:
            n = self._read_rot.get(key, 0) + 1
            self._read_rot[key] = n
            if len(self._read_rot) > _ROT_CAP:
                keep = sorted(self._read_rot.items(),
                              key=lambda kv: kv[1],
                              reverse=True)[:_ROT_CAP // 2]
                self._read_rot = dict(keep)
        return self._rot_seed + n // _ROT_WINDOW

    @staticmethod
    def _read_target(osdmap: OSDMap, pool: int, ps: int,
                     acting: list, primary: int,
                     salt: int = 0) -> int:
        """The PG's placement-affine read member: the CRUSH-stable
        ``stable_hash`` pick over the acting set — the same pure
        function the server-side placement map keys a PG's chip slot
        on, so every client (and every retry with the same map)
        lands the SAME member and its reads coalesce there. A
        nonzero ``salt`` (the client's per-object rotation window,
        any-k balanced reads) steps the pick around the acting set —
        every member holds every acked write, so any of them serves
        a consistent read. Falls back to the primary when the pick
        is down or addressless."""
        live = [o for o in acting if o >= 0]
        if live:
            cand = live[(stable_hash((pool, ps)) + salt) % len(live)]
            info = osdmap.osds.get(cand)
            if info is not None and getattr(info, "up", True) \
                    and info.addr:
                return cand
        return primary

    def _send(self, op: _Op) -> None:
        osdmap = self.monc.osdmap
        if osdmap is None:
            return
        pool = osdmap.pools.get(op.msg.pool)
        if pool is None:
            return                      # wait for a map that has it
        if op.msg.op == M.OSD_OP_LIST:
            ps = op.msg.ps
            _, acting, primary = osdmap.pg_to_up_acting(op.msg.pool,
                                                        ps)
        else:
            ps, acting, primary = osdmap.object_locator(op.msg.pool,
                                                        op.msg.oid)
            op.msg.ps = ps
        if primary < 0:
            return                      # PG unserviceable; tick retries
        target = primary
        op.affine = False
        if (self._read_affinity and not op.no_affine
                and op.msg.op == M.OSD_OP_READ
                and not op.msg.snapid and not op.msg.cls
                and not op.msg.gname):
            target = self._read_target(osdmap, op.msg.pool, ps,
                                       acting, primary,
                                       salt=op.rsalt)
            op.affine = target != primary
        info = osdmap.osds.get(target)
        if info is None or not info.addr:
            return
        op.msg.epoch = osdmap.epoch
        op.sent_at = time.monotonic()
        op.attempts += 1
        self.msgr.send_message(op.msg, info.addr)

    # -- resend machinery ---------------------------------------------
    def _on_map(self, newmap: OSDMap) -> None:
        with self._lock:
            ops = list(self._pending.values())
        for op in ops:
            self._send(op)

    def _tick_loop(self) -> None:
        import random
        interval = g_conf()["objecter_resend_interval"]
        cap = g_conf()["objecter_resend_max"]
        while not self._stop.wait(interval / 2):
            now = time.monotonic()
            with self._lock:
                # bounded exponential backoff + full jitter per op
                # (ISSUE 8): a resend storm against a struggling
                # primary is exactly the cascade the online-EC study
                # warns about — each unanswered attempt doubles the
                # op's resend delay up to the cap, while a map change
                # still retargets/resends immediately (_on_map)
                ops = []
                for o in self._pending.values():
                    delay = min(interval * (1 << min(o.attempts - 1,
                                                     16)), cap) \
                        if o.attempts else 0.0
                    if now - o.sent_at > delay * (0.5 +
                                                  random.random() / 2):
                        ops.append(o)
            for op in ops:
                log(10, f"resending tid {op.tid} ({op.msg.oid}) "
                    f"attempt {op.attempts + 1}")
                self._send(op)
