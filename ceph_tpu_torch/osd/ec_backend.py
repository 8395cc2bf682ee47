"""ECBackend — erasure-coded PG backend (src/osd/ECBackend.{h,cc}).

Write path (submit_transaction -> try_reads_to_commit semantics,
ECBackend.cc:1447,1901-2048): the primary encodes the object into k+m
chunks in ONE batched kernel call (osd/ec_util.encode — the device
translation of the per-stripe loop), builds one shard-local
transaction per acting position (chunk data + version attr + hinfo +
the PG log entry, all atomic), applies its own locally and fans the
rest out as MECSubWrite; the client is acked when every up shard
committed (handle_sub_write_reply -> on_all_commit, :1090).

Read path (objects_read_and_reconstruct, :2301): choose the cheapest
sufficient shard set via the codec's ``minimum_to_decode``
(get_min_avail_to_read_shards role, :1558), fan out MECSubRead, and
either fast-path concatenate (all data shards present) or decode the
missing ones (ECUtil::decode role). Shard reads are crc-verified
against the stored hinfo on the serving OSD (handle_sub_read
:1032-1051), so a silently-corrupt shard answers -EIO and the read
retries around it.

Recovery (recover_object/continue_recovery_op, :537,703): reconstruct
the missing position's chunk from surviving shards and MPGPush it.

Object layout per shard: the object's chunk stream concatenated across
stripes (what ECTransaction::encode_and_write writes per shard); attrs:
``v`` (version), ``sz`` (logical size before padding), ``hinfo``
(cumulative shard crcs, ECUtil.h:101-162).

The port's device seam: a pool whose profile names a device backend
(``DEVICE_BACKENDS``) gets its device codec from the port's registry on
the card (``cuda``; ``auto_device`` raises without one) or on the CPU
(``torch``, the kernels' plain versions), and the OSD's device engine.
Where the reference finishes an op on its host twin after a device
fault (the encode continuation, ``_decode`` and decode-on-read), the
port completes it with EIO (:class:`DeviceFault`); the engine counts
the fault (``errors`` / ``decode_errors``).
"""

from __future__ import annotations

import json
import random
import threading
import time
from collections import OrderedDict
from typing import Callable

import numpy as np

from ceph_tpu_torch.models import registry as ec_registry
from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.osd import device_engine as _dev_engine
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.ec_util import HashInfo, StripeInfo
from ceph_tpu_torch.osd.pg import (
    LOG_REMOVE,
    LOG_WRITE,
    PG,
    LogEntry,
    pg_cid,
)
from ceph_tpu_torch.osd.pg_backend import (
    SUBOP_TIMEOUT,
    InflightWrite,
    Listener,
    PGBackend,
    SubOpWait,
    object_remove_txn,
    object_write_txn,
)
from ceph_tpu_torch.parallel import messages as M
from ceph_tpu_torch.parallel.placement import stable_hash
from ceph_tpu_torch.utils import read_heat
from ceph_tpu_torch.store.object_store import (
    EIOError,
    NoSuchCollection,
    NoSuchObject,
    StoreError,
    Transaction,
)
from ceph_tpu_torch.utils import stage_clock, tracing
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.dataplane import dataplane
from ceph_tpu_torch.utils import dispatch_telemetry
from ceph_tpu_torch.utils import flow_telemetry as _flows
from ceph_tpu_torch.utils.dout import Dout

log = Dout("osd")


class ECReadError(StoreError):
    """Not enough readable shards to reconstruct."""


class DeviceFault(ECReadError):
    """A device encode or decode failed; the op completes with EIO (the
    port keeps no host fallback that would hide the device)."""


#: profile backends that run on the device through the batched stripe
#: engine (everything else is a host backend used synchronously):
#: ``cuda`` (the hand-written kernels on the card), ``torch`` (their
#: plain versions on the codec's device, the CPU tests' route), and
#: ``auto_device``, which resolves to ``cuda``
DEVICE_BACKENDS = ("cuda", "torch", "auto_device")

#: the host twin's backend: the native host library's GF matvec
#: (ops/native.py), as the reference's host twin takes its ``native``
HOST_BACKEND = "native"

#: errno carried to the client when a device fault fails an op
EIO = -5


def _require_card(name: str) -> None:
    import torch
    if not torch.cuda.is_available():
        raise ErasureCodeError(
            f"backend {name}: no CUDA device (backend=torch runs the "
            "plain versions on the CPU)")


def resolve_auto_device() -> str:
    """``auto_device`` is the card. Without one it raises: the device
    path never runs on the CPU without being asked to."""
    _require_card("auto_device")
    return "cuda"


def profile_device(profile: dict) -> str:
    """The torch device a profile's codec lives on: the card for
    ``cuda`` and ``auto_device`` (each raises without one, so the mon
    refuses such a profile on a machine with no card), the CPU for
    ``torch`` (the plain versions) and every host backend."""
    want = profile.get("backend")
    if want == "auto_device":
        want = resolve_auto_device()
    if want == "cuda":
        _require_card("cuda")
        return "cuda"
    return "cpu"


class ECBackend(PGBackend):
    def __init__(self, parent: Listener, pool_info) -> None:
        super().__init__(parent, pool_info)
        profile = dict(pool_info.ec_profile)
        want = profile.get("backend")
        if want == "auto_device":
            want = profile["backend"] = resolve_auto_device()
        self.device = None
        self.device_codec = None
        if want in DEVICE_BACKENDS:
            # device backends serve the BATCHED stripe engine: full-
            # object writes coalesce across PGs into one kernel
            # launch, and degraded-read / recovery reconstructs batch
            # by erasure signature (stage_decode). The host twin
            # serves RMW re-encode of tiny windows and codecs the
            # batched decode cannot take (ec_util.device_decodable);
            # a device fault fails the op instead of falling back
            self.device_codec = ec_registry.instance().factory(
                profile.get("plugin", "jerasure"), profile,
                device=profile_device(profile))
            self.device = parent.device_engine()
            profile = dict(profile)
            profile["backend"] = HOST_BACKEND
        elif want is None:
            # the ISA-L seat: the host GF tables
            profile["backend"] = HOST_BACKEND
        self.codec = ec_registry.instance().factory(
            profile.get("plugin", "jerasure"), profile, device="cpu")
        self.k = self.codec.get_data_chunk_count()
        self.n = self.codec.get_chunk_count()
        stripe_unit = pool_info.stripe_unit
        self.sinfo = StripeInfo(stripe_width=self.k * stripe_unit,
                                chunk_size=stripe_unit)
        # any-k balanced reads (ROADMAP 3): reads past this per-object
        # count rotate their shard read set. The threshold is a plain
        # cached read (not tuner-managed); the rotation WIDTH comes
        # from the parent's cached osd_read_set_spread observer
        self._hot_threshold = int(g_conf()["osd_hot_read_threshold"])
        self._spread_src = getattr(parent, "read_set_spread", None)
        # hot-shard cache (ISSUE 19): remotely-fetched partner chunks
        # of HOT objects, keyed (pool, ps, oid, pos) -> (version,
        # chunk bytes). A hit makes a rotated hot serve fully local —
        # no MECSubRead to a partner that is itself busy serving — so
        # the acting members stop queueing on each other and any-k
        # rotation actually multiplies serving capacity. Consistency
        # is by VERSION, not invalidation messages: every acting
        # position commits (and bumps its shard's "v" attr) before a
        # write acks, so the serving member's LOCAL shard version is
        # always current; a cached entry is used only when its stored
        # version equals the local one, and a mismatch drops it. The
        # existing version-agreement check in _read_shards then
        # revalidates the assembled set end to end.
        self._shard_cache: OrderedDict[tuple, tuple[int, np.ndarray]] \
            = OrderedDict()
        self._shard_cache_lock = threading.Lock()

    #: hot-shard cache entry cap — entries are single chunks of hot
    #: objects only, so this bounds worst-case memory at cap × chunk
    SHARD_CACHE_ENTRIES = 128

    def _shard_cache_get(self, pg: PG, oid: str, pos: int,
                         version: int) -> np.ndarray | None:
        """Version-checked lookup; a stale entry self-invalidates."""
        key = (pg.pool, pg.ps, oid, pos)
        with self._shard_cache_lock:
            ent = self._shard_cache.get(key)
            if ent is None:
                return None
            if ent[0] != version:
                del self._shard_cache[key]
                return None
            self._shard_cache.move_to_end(key)
            return ent[1]

    def _shard_cache_put(self, pg: PG, oid: str, pos: int,
                         version: int, chunk: np.ndarray) -> None:
        key = (pg.pool, pg.ps, oid, pos)
        with self._shard_cache_lock:
            self._shard_cache[key] = (version, chunk)
            self._shard_cache.move_to_end(key)
            while len(self._shard_cache) > self.SHARD_CACHE_ENTRIES:
                self._shard_cache.popitem(last=False)

    # -- layout helpers -----------------------------------------------
    def local_cid(self, pg: PG) -> str:
        pos = self.my_position(pg)
        return pg_cid(pg.pool, pg.ps, pos if pos >= 0 else 0)

    def my_position(self, pg: PG) -> int:
        try:
            return pg.acting.index(self.parent.whoami)
        except ValueError:
            return -1

    def _pad(self, data: bytes) -> bytes:
        sw = self.sinfo.stripe_width
        rem = len(data) % sw
        if rem == 0 and data:
            return data
        return data + b"\x00" * (sw - rem if rem else sw)

    def _decode(self, pg: PG, shards: dict[int, np.ndarray],
                want: list[int]) -> dict[int, np.ndarray]:
        """Reconstruct ``want`` chunk streams — on the DEVICE when the
        pool runs a device backend (the round-3 seam: degraded reads
        and recovery decode batch through the engine grouped by
        erasure signature, objects_read_and_reconstruct /
        continue_recovery_op roles, src/osd/ECBackend.cc:2301,537),
        host twin otherwise; a device fault raises DeviceFault."""
        missing = [i for i in want if i not in shards]
        if missing and self.device is not None and \
                self.device_codec is not None and \
                ec_util.device_decodable(self.device_codec):
            # the op's dataflow trace continues into the engine's
            # signature-batched decode flush (NOOP when tracing off),
            # and so does its stage timeline
            out = self.device.decode_sync(
                pg.pgid, self.device_codec, self.sinfo, shards, want,
                span=tracing.current().child("engine_decode"),
                clock=stage_clock.current())
            if out is not None:
                return out
            # the engine counted the fault (decode_errors); no host
            # twin hides it: the op fails with EIO
            log(0, f"{pg}: device decode failed (want {want})")
            raise DeviceFault(f"{pg}: device decode failed "
                              f"(want {want})")
        return ec_util.decode(self.sinfo, self.codec, shards, want)

    def _chunks_to_logical(self, shards: dict[int, np.ndarray],
                           size: int) -> bytes:
        cs = self.sinfo.chunk_size
        arr = np.stack([np.asarray(shards[i], dtype=np.uint8)
                        for i in range(self.k)])
        s = arr.shape[1] // cs
        out = arr.reshape(self.k, s, cs).transpose(1, 0, 2).tobytes()
        return out[:size]

    # -- writes -------------------------------------------------------
    def _fan_out(self, pg: PG, oid: str, version: int, op: int,
                 txn_builder: Callable[[int, str], "Transaction"],
                 on_commit: Callable[[int], None],
                 span_label: str, supersedes_recovery: bool) -> None:
        """Shared write fan-out (the try_reads_to_commit dispatch,
        ECBackend.cc:1986-2048): stage the log entry, build one
        shard-local txn per up position, apply ours locally, ship the
        rest as MECSubWrite, ack the client when every position
        committed."""
        entry = LogEntry(version, op, oid)
        kv, drop = pg.log.stage(entry)
        positions = self.up_positions(pg)
        tid = self.parent.new_tid()
        # the commit-wait envelope (ISSUE 14): a child timeline
        # anchored where commit_wait starts measuring (the op clock's
        # newest mark — device_finalize on the engine path, pg_process
        # on the host path) whose consecutive intervals partition the
        # primary's commit_wait: dispatch/txn-build -> flush-group
        # ship -> shard-ack wait. Merged under the op at completion so
        # dump_op_timeline and the dataplane histograms say WHY commit
        # waited.
        op_clock0 = stage_clock.current()
        cclock = None
        if op_clock0 is not stage_clock.NOOP:
            cclock = stage_clock.StageClock(
                name="commit_start", t=op_clock0.last_mark_t())
            # commit_handoff (ISSUE 17): when this fan-out runs inside
            # an engine continuation dequeued from the op-wq, the wq
            # worker published the hop it crossed — mark the dequeue
            # instant so the envelope splits queue wait (handoff) from
            # continuation run (dispatch). Ops after the first in one
            # continuation absorb earlier fan-out run time into their
            # handoff-to-dispatch split exactly as the wq served them.
            hop = dispatch_telemetry.current_hop()
            if hop is not None and hop[0] == "wq_continuation" \
                    and hop[1] > op_clock0.last_mark_t():
                cclock.mark("commit_handoff", t=hop[1])

        def all_committed() -> None:
            if cclock is not None:
                # ship may not have marked yet (all-local completions
                # can finish inside the group ship itself): close the
                # ship interval at the ack instant, once
                cclock.mark_once("commit_ship_wait")
                cclock.mark("commit_ack_wait")
                op_clock0.merge_child("commit", cclock)
                try:
                    dataplane().record_stages(cclock.durations())
                except Exception:
                    pass   # telemetry faults never cost an op
            on_commit(0)

        iw = InflightWrite(tid, pg, oid, version, set(positions),
                           all_committed)
        # an abandoned write must still drop its extent-cache pin:
        # a leaked entry would make covers()/overlay() feed stale
        # content to every later RMW on the object
        iw.on_expire = lambda: pg.extent_cache.unpin(oid, version)
        self.parent.register_write(iw)
        epoch = self.parent.get_osdmap().epoch
        # dataflow trace: one child span per shard sub-op, carried in
        # the message (ECBackend.cc:2022-2026 role); the op's stage
        # timeline hangs on the inflight record so shard sub-op
        # timelines returning in MECSubWriteReply merge under it
        op_span = tracing.current()
        op_span.event(f"start {span_label}")
        op_clock = op_clock0
        if op_clock is not stage_clock.NOOP:
            iw.clock = op_clock
        # bulk ingest (ISSUE 9): inside a flush-group continuation the
        # fan-out DEFERS its cross-PG work — every shard sub-write of
        # the whole flush destined for one peer ships as ONE
        # MECSubWriteBatch, and this OSD's local shard txns apply as
        # one queued txn group — instead of one message / one store
        # txn per (op, shard). Outside a group (host backends,
        # barriers, host-fallback-after-drain) everything ships
        # immediately, exactly as before.
        group = _dev_engine.current_group()
        for pos in positions:
            osd = pg.acting[pos]
            cid = pg_cid(pg.pool, pg.ps, pos)
            txn = txn_builder(pos, cid)
            pg.log.apply_to_txn(txn, cid, kv, drop)
            if osd == self.parent.whoami:
                commit_cb = (lambda p=pos:
                             iw.complete(p) and iw.on_all_commit())
                if group is not None:
                    # the group ships from whichever thread finishes
                    # last, with no tenant context — stamp the flow on
                    # the txn so the ship-time store attribution keeps
                    # per-item labels (ISSUE 20)
                    txn._flow = _flows.current_flow() or ""
                    group.defer((id(self.parent), "local"),
                                self._apply_local_txn_group,
                                (txn, commit_cb))
                else:
                    self.parent.queue_local_txn(txn, commit_cb)
            else:
                child = op_span.child(f"{span_label}(shard={pos})")
                if group is not None:
                    group.defer(
                        (id(self.parent), osd),
                        lambda items, osd=osd:
                        self._ship_subwrite_batch(osd, items),
                        (tid, pg.pool, pg.ps, pos, oid, version,
                         txn.encode(), child.wire(), epoch,
                         op_clock is not stage_clock.NOOP,
                         _flows.current_flow() or ""))
                else:
                    sub = M.MECSubWrite(
                        tid=tid, pool=pg.pool, ps=pg.ps, shard=pos,
                        epoch=epoch, oid=oid, version=version,
                        txn_bytes=txn.encode(), trace=child.wire(),
                        flow=_flows.current_flow() or "")
                    if op_clock is not stage_clock.NOOP:
                        # child timeline anchor: handed to the
                        # messenger (which serializes it into
                        # sub.stages)
                        sub._stage_clock = stage_clock.StageClock(
                            name="subop_send")
                    self.parent.send_osd(osd, sub)
                child.finish()
        if cclock is not None:
            # the dispatch interval (continuation queue wait + PG
            # lock + txn build) ends here; the ship interval closes
            # when the flush group actually ships (immediately on the
            # ungrouped path: its sends just happened inline)
            cclock.mark("commit_dispatch")
            if group is not None:
                group.after_flush(
                    lambda: cclock.mark_once("commit_ship_wait"))
            else:
                cclock.mark_once("commit_ship_wait")
        if supersedes_recovery:
            # a write of every shard supersedes pending recovery for it
            for missing in pg.peer_missing.values():
                missing.pop(oid, None)

    def _apply_local_txn_group(self, items: list) -> None:
        """Flush-group ship for this OSD's own shards: every local
        sub-write txn of the flush applies as ONE queued store txn
        (one commit callback fans the per-op completions out)."""
        self.parent.queue_local_txn_group(items)

    def _ship_subwrite_batch(self, osd: int, items: list) -> None:
        """Flush-group ship for one peer: every sub-write of the
        flush destined for ``osd`` rides ONE MECSubWriteBatch — one
        serialize, one dispatch-queue traversal, one batched reply
        acking every contained tid (the ISSUE-9 fan-out contract).
        Entry order is continuation order, so two writes of one
        object reach the shard in version order."""
        batch = M.MECSubWriteBatch(
            tid=self.parent.new_tid(),
            epoch=max(it[8] for it in items),
            tids=[it[0] for it in items],
            pools=[it[1] for it in items],
            pss=[it[2] for it in items],
            shards=[it[3] for it in items],
            oids=[it[4] for it in items],
            versions=[it[5] for it in items],
            txns=[it[6] for it in items],
            traces=[it[7] for it in items],
            flows=[it[10] for it in items])
        if any(it[9] for it in items):
            # ONE child-timeline anchor for the whole frame: every
            # contained sub-op genuinely shares the batch's send/
            # wire/dispatch intervals; the shard forks a child clock
            # per entry (one per tid comes home in the reply)
            batch._stage_clock = stage_clock.StageClock(
                name="subop_send")
        logger = getattr(self.parent, "logger", None)
        if logger is not None:
            logger.inc("subwrite_batches")
            logger.hinc("subwrite_batch_size", len(items))
        self.parent.send_osd(osd, batch)

    def _unpin_on_commit(self, pg: PG, oid: str, version: int,
                         on_commit: Callable[[int], None]
                         ) -> Callable[[int], None]:
        def done(code: int) -> None:
            pg.extent_cache.unpin(oid, version)
            on_commit(code)
        return done

    def submit_write(self, pg: PG, oid: str, data: bytes, version: int,
                     on_commit: Callable[[int], None]) -> None:
        data = bytes(data)
        pg.extent_cache.pin(oid, version, 0, data, len(data), full=True)
        if self.device is not None:
            # the device path: stage into the device stripe-batch engine;
            # the continuation (hinfo + txns + fan-out) runs on this
            # PG's wq shard in staging order, so per-PG commit order is
            # preserved across the async flush (check_ops invariant,
            # ECBackend.cc:2107-2112)
            buf = np.frombuffer(self._pad(data), dtype=np.uint8)

            # the continuation runs on an op-wq thread whose current
            # span is NOOP: carry the op span AND the op's stage
            # clock across the engine boundary or both die here
            op_span = tracing.current()
            op_clock = stage_clock.current()
            # pg_process ends where the engine staging begins
            op_clock.mark("pg_process")

            def cont(shards, crcs, err, pg=pg, oid=oid, data=data,
                     version=version, on_commit=on_commit,
                     op_span=op_span, op_clock=op_clock):
                if shards is None:
                    # the engine counted the fault (errors); no host
                    # twin hides it: the write fails with EIO
                    log(0, f"device encode failed for {oid} ({err!r})")
                    # keep-worthy outcome: the tail sampler retains
                    # this op's trace (error rule)
                    op_span.set_error(f"engine_error: {err!r}")
                    with pg.lock:
                        self._unpin_on_commit(pg, oid, version,
                                              on_commit)(EIO)
                    return
                with pg.lock:
                    tracing.set_current(op_span)
                    stage_clock.set_current(op_clock)
                    try:
                        self._finish_write(pg, oid, data, version,
                                           shards, on_commit,
                                           crcs=crcs)
                    finally:
                        tracing.set_current(tracing.NOOP)
                        stage_clock.set_current(stage_clock.NOOP)

            # dataflow trace across the engine boundary: one child
            # span rides the staged op through batch flush + kernel
            # dispatch + crc pass (tracing off -> NOOP, zero Spans)
            eng_span = op_span.child("engine_flush")
            if eng_span is not tracing.NOOP:
                eng_span.event(f"staged oid={oid}")
            self.device.stage_encode(pg.pgid, self.device_codec,
                                     self.sinfo, buf, cont,
                                     span=eng_span, clock=op_clock)
            return
        stage_clock.current().mark("pg_process")
        shards = ec_util.encode(self.sinfo, self.codec, self._pad(data))
        self._finish_write(pg, oid, data, version, shards, on_commit)

    def _finish_write(self, pg: PG, oid: str, data: bytes, version: int,
                      shards: dict[int, np.ndarray],
                      on_commit: Callable[[int], None],
                      crcs: dict[int, int] | None = None) -> None:
        """Post-encode tail of a full-object write: hinfo, per-shard
        txns, fan-out (caller holds pg.lock on the async path).
        ``crcs``: per-shard crc LINEAR parts computed on device from
        the encode's own device buffers (Checksummer.h role, SURVEY.md §0
        item (c)) — combined with the hinfo seed host-side."""
        hinfo = HashInfo(self.n)
        if crcs is not None and shards:
            hinfo.append_linear(0, crcs,
                                len(next(iter(shards.values()))))
        else:
            hinfo.append(0, shards)
        hinfo_raw = json.dumps(hinfo.to_dict()).encode()
        size_raw = len(data).to_bytes(8, "little")
        self._fan_out(
            pg, oid, version, LOG_WRITE,
            lambda pos, cid: object_write_txn(
                cid, oid, shards[pos].tobytes(), version,
                attrs={"sz": size_raw, "hinfo": hinfo_raw}),
            self._unpin_on_commit(pg, oid, version, on_commit),
            "ec_sub_write", supersedes_recovery=True)

    def submit_remove(self, pg: PG, oid: str, version: int,
                      on_commit: Callable[[int], None]) -> None:
        pg.extent_cache.pin(oid, version, 0, b"", 0, full=True,
                            remove=True)

        def run() -> None:
            self._fan_out(
                pg, oid, version, LOG_REMOVE,
                lambda pos, cid: object_remove_txn(cid, oid),
                self._unpin_on_commit(pg, oid, version, on_commit),
                "ec_sub_remove", supersedes_recovery=True)

        if self.device is not None:
            # ordering barrier: a staged-but-unflushed write to this
            # object must fan out BEFORE the remove, or the remove
            # would be resurrected by the older write's txn (the op
            # span rides along — barriers run on the engine's
            # dispatch, where current() is NOOP)
            op_span = tracing.current()

            op_clock = stage_clock.current()
            op_clock.mark("pg_process")

            def barrier(pg=pg, op_span=op_span,
                        op_clock=op_clock) -> None:
                with pg.lock:
                    tracing.set_current(op_span)
                    stage_clock.set_current(op_clock)
                    try:
                        run()
                    finally:
                        tracing.set_current(tracing.NOOP)
                        stage_clock.set_current(stage_clock.NOOP)
            self.device.stage_barrier(pg.pgid, barrier)
            return
        run()

    def submit_truncate(self, pg: PG, oid: str, new_size: int,
                        version: int,
                        on_commit: Callable[[int], None]) -> None:
        """Truncate = ordered read + full rewrite. On the device path
        the read DEFERS behind an engine barrier, exactly like
        submit_remove/partial-write: a pipelined in-flight write of
        this object fans out first, and the version-agreement retry
        in _read_shards then sees its bytes — no lost update."""
        def run() -> None:
            try:
                cur = self.read_object(pg, oid)
            except (NoSuchObject, NoSuchCollection):
                cur = b""
            except StoreError:
                on_commit(-5)
                return
            if new_size <= len(cur):
                data = bytes(cur[:new_size])
            else:
                data = bytes(cur) + b"\x00" * (new_size - len(cur))
            self.submit_write(pg, oid, data, version, on_commit)

        if self.device is not None:
            op_span = tracing.current()

            op_clock = stage_clock.current()
            op_clock.mark("pg_process")

            def barrier(pg=pg, op_span=op_span,
                        op_clock=op_clock) -> None:
                with pg.lock:
                    tracing.set_current(op_span)
                    stage_clock.set_current(op_clock)
                    try:
                        run()
                    finally:
                        tracing.set_current(tracing.NOOP)
                        stage_clock.set_current(stage_clock.NOOP)
            self.device.stage_barrier(pg.pgid, barrier)
            return
        run()

    def submit_setattrs(self, pg: PG, oid: str,
                        sets: dict[str, bytes], rms: list[str],
                        version: int,
                        on_commit: Callable[[int], None]) -> None:
        """Client xattr mutation: the attrs ride EVERY shard (so any
        surviving shard set answers a degraded getxattr, and recovery
        pushes them back — the SETATTR log-entry role of
        ecbackend.rst:9-26)."""
        from ceph_tpu_torch.osd.pg_backend import USER_XATTR

        def run() -> None:
            try:
                self.stat_object(pg, oid)
                exists = True
            except (NoSuchObject, NoSuchCollection):
                exists = False

            def build(pos: int, cid: str) -> Transaction:
                txn = Transaction()
                txn.create_collection(cid)
                txn.touch(cid, oid)
                for name, val in sets.items():
                    txn.setattr(cid, oid, USER_XATTR + name, val)
                for name in rms:
                    txn.rmattr(cid, oid, USER_XATTR + name)
                txn.setattr(cid, oid, "v",
                            version.to_bytes(8, "little"))
                if not exists:
                    # attr ops imply create (reference semantics):
                    # materialize an empty object
                    txn.setattr(cid, oid, "sz", (0).to_bytes(8,
                                                             "little"))
                return txn

            self._fan_out(pg, oid, version, LOG_WRITE, build,
                          on_commit, "ec_sub_setattr",
                          supersedes_recovery=False)

        if self.device is not None:
            # ordering barrier: a staged-but-unflushed write of this
            # object must fan out first, or its (deferred) txn would
            # land after ours with an OLDER "v" — shard versions would
            # regress against the log
            op_span = tracing.current()

            op_clock = stage_clock.current()
            op_clock.mark("pg_process")

            def barrier(pg=pg, op_span=op_span,
                        op_clock=op_clock) -> None:
                with pg.lock:
                    tracing.set_current(op_span)
                    stage_clock.set_current(op_clock)
                    try:
                        run()
                    finally:
                        tracing.set_current(tracing.NOOP)
                        stage_clock.set_current(stage_clock.NOOP)
            self.device.stage_barrier(pg.pgid, barrier)
            return
        run()

    def get_xattrs(self, pg: PG, oid: str) -> dict[str, bytes]:
        from ceph_tpu_torch.osd.pg_backend import user_xattrs
        mypos = self.my_position(pg)
        if mypos >= 0:
            cid = pg_cid(pg.pool, pg.ps, mypos)
            try:
                return user_xattrs(self.parent.store.getattrs(cid,
                                                              oid))
            except (NoSuchObject, NoSuchCollection):
                # authoritative ENOENT when nothing is degraded: a
                # cluster fan-out (with its retry ladder, under
                # pg.lock) just to rediscover ENOENT would stall the
                # PG's op pipeline on every guarded op / getxattr of
                # a nonexistent object
                if not any(oid in m for m in pg.peer_missing.values()):
                    raise
            except StoreError:
                pass       # local shard unreadable (EIO): fan out
        # degraded: any shard's attrs carry the client xattrs
        # (_read_shards raises NoSuchObject on ENOENT everywhere)
        _, attrs = self._read_shards(pg, oid, [0])
        return user_xattrs(attrs)

    def submit_partial_write(self, pg: PG, oid: str, offset: int,
                             data: bytes, version: int,
                             on_commit: Callable[[int], None],
                             old_size: int | None = None) -> None:
        """Partial-stripe overwrite (start_rmw / ECTransaction
        get_write_plan roles, ECBackend.cc:1800): read only the stripe
        WINDOW the write touches, splice, re-encode those stripes, and
        range-write each shard — instead of reconstructing and
        re-encoding the whole object.

        The cumulative full-shard hinfo cannot survive a range
        overwrite, so the write drops it; integrity then rests on the
        store's own blob checksums, exactly as the reference requires
        bluestore for EC-overwrite pools (ecbackend.rst:7-12).

        Raises StoreError when the object's current state cannot be
        read (degraded beyond reach): a transient read failure must
        fail the op, never silently truncate to old_size=0.
        """
        data = bytes(data)
        if self.device is not None:
            # defer behind the engine as an ordering barrier: a staged
            # full write of this object must fan out first, or its
            # whole-object txn (landing later) would clobber this
            # range write. A THIN marker pin goes in NOW so ops that
            # run before the barrier (a subsequent append's offset
            # computation, an overlapping RMW's overlay) already see
            # this write's bytes and size; the barrier body re-pins
            # the full spliced window at the same version, and the
            # commit unpins both.
            end = offset + len(data)
            base = old_size if old_size is not None else 0
            pg.extent_cache.pin(oid, version, offset, data,
                                max(base, end), full=False)

            op_span = tracing.current()
            op_clock = stage_clock.current()
            op_clock.mark("pg_process")

            def barrier(pg=pg, oid=oid, offset=offset, data=data,
                        version=version, on_commit=on_commit,
                        old_size=old_size, op_span=op_span,
                        op_clock=op_clock) -> None:
                with pg.lock:
                    tracing.set_current(op_span)
                    stage_clock.set_current(op_clock)
                    try:
                        self._submit_partial_write_sync(
                            pg, oid, offset, data, version, on_commit,
                            old_size)
                    except StoreError as exc:
                        log(1, f"deferred partial write {oid} "
                            f"v{version} failed: {exc}")
                        pg.extent_cache.unpin(oid, version)
                        on_commit(-5)
                    finally:
                        tracing.set_current(tracing.NOOP)
                        stage_clock.set_current(stage_clock.NOOP)

            self.device.stage_barrier(pg.pgid, barrier)
            return
        self._submit_partial_write_sync(pg, oid, offset, data, version,
                                        on_commit, old_size)

    def _submit_partial_write_sync(self, pg: PG, oid: str, offset: int,
                                   data: bytes, version: int,
                                   on_commit: Callable[[int], None],
                                   old_size: int | None = None) -> None:
        sw, cs = self.sinfo.stripe_width, self.sinfo.chunk_size
        end = offset + len(data)
        if old_size is None:
            try:
                old_size = self.stat_object(pg, oid)
            except (NoSuchObject, NoSuchCollection):
                old_size = 0           # first write to this object
        # fold in in-flight writes (idempotent if the local stat
        # already reflects them; required when the stat fell back to a
        # degraded read of committed-only shard attrs)
        old_size = pg.extent_cache.effective_size(oid, old_size, -1)
        new_size = max(old_size, end)
        a = (offset // sw) * sw                       # window start
        b = -(-end // sw) * sw                        # window end
        window = bytearray(b - a)
        old_aligned = -(-old_size // sw) * sw
        if old_size > a and (offset > a or end < min(b, old_aligned)):
            # edge stripes keep existing bytes: ranged RMW read.
            # The shards can only answer with COMMITTED state — an
            # earlier write to this object may still be in flight (no
            # shard committed it yet, so the version-agreement check
            # cannot see it). Overlay every in-flight entry newer than
            # the version the read agreed on (ExtentCache role,
            # src/osd/ExtentCache.h:37-45) or the re-encode would
            # write pre-overwrite bytes back (lost update).
            read_to = min(b, old_aligned)
            want = list(range(self.k))
            base_ver = 0
            # ONE snapshot drives covers/versions/overlay: an entry
            # unpinned mid-compose (its commit landing on the store
            # thread) must still contribute its bytes here — its
            # content is the committed content in that case
            snap = pg.extent_cache.snapshot(oid)
            if snap.covers(a, read_to):
                # in-flight windows alone determine every needed byte:
                # no shard read at all (the pure pipelined case)
                chunks = None
            else:
                try:
                    chunks, rattrs = self._read_shards(
                        pg, oid, want,
                        chunk_off=(a // sw) * cs,
                        chunk_len=((read_to - a) // sw) * cs,
                        accept_versions=snap.versions())
                except NoSuchObject:
                    # committed state doesn't exist yet: the whole
                    # object is in flight — the overlay reconstructs it
                    chunks, rattrs = None, {}
            if chunks is not None:
                base_ver = int.from_bytes(rattrs.get("v", b""),
                                          "little")
                if not all(i in chunks for i in want):
                    chunks = self._decode(pg, chunks, want)
                old_win = self._chunks_to_logical(
                    {i: chunks[i] for i in want}, read_to - a)
                window[:len(old_win)] = old_win
            snap.overlay(window, a, base_ver)
        window[offset - a:end - a] = data
        # pin the WHOLE spliced window, not just the written bytes: a
        # later overlapping RMW that reads a mixed-version shard set
        # must be able to replace every stripe this write re-encodes
        pg.extent_cache.pin(oid, version, a, bytes(window), new_size,
                            full=False)
        shards = ec_util.encode(self.sinfo, self.codec, bytes(window))
        chunk_off = (a // sw) * cs
        size_raw = new_size.to_bytes(8, "little")

        def build(pos: int, cid: str) -> Transaction:
            txn = Transaction()
            txn.create_collection(cid)
            txn.touch(cid, oid)
            txn.write(cid, oid, chunk_off, shards[pos].tobytes())
            txn.setattr(cid, oid, "v", version.to_bytes(8, "little"))
            txn.setattr(cid, oid, "sz", size_raw)
            txn.rmattr(cid, oid, "hinfo")
            return txn

        self._fan_out(pg, oid, version, LOG_WRITE, build,
                      self._unpin_on_commit(pg, oid, version, on_commit),
                      "ec_sub_rmw", supersedes_recovery=False)

    # -- shard read fan-out -------------------------------------------
    MAX_READ_ATTEMPTS = 6

    def _backoff_sleep(self, attempt: int) -> None:
        """Jittered bounded exponential backoff between shard-read
        fan-out attempts (ISSUE 8: the ladder used to re-fan
        back-to-back, so a degraded burst turned every retry into
        synchronized load on the surviving shards — the retry-storm
        pathology the online-EC study measures). Full jitter keeps
        concurrent retriers decorrelated."""
        conf = g_conf()
        base = conf["osd_ec_read_backoff_base"]
        cap = conf["osd_ec_read_backoff_max"]
        time.sleep(min(cap, base * (1 << attempt))
                   * (0.5 + random.random() * 0.5))

    def _shard_osd_map(self, pg: PG, positions) -> dict[int, int]:
        return {p: pg.acting[p] for p in sorted(positions)
                if 0 <= p < len(pg.acting)}

    def _version_split_avoid(self, pg: PG, want_chunks: list[int],
                             base_avoid: set[int],
                             known_vers: dict[int, int]) -> set[int]:
        """Resolve a persistent shard-version split: pick the NEWEST
        observed version that still leaves a decodable shard set and
        return the positions to read around (shards at other
        versions). Positions whose version is still unknown stay in
        play — the next attempt observes them and the caller
        re-resolves with the grown evidence."""
        up = self.up_positions(pg)
        for target in sorted(set(known_vers.values()), reverse=True):
            ver_avoid = {p for p, v in known_vers.items()
                         if v != target}
            available = [p for p in up
                         if p not in base_avoid and p not in ver_avoid]
            try:
                self.codec.minimum_to_decode(want_chunks, available)
            except Exception:
                continue
            return ver_avoid
        return set()

    #: consecutive reads of one hot object that share a rotated set
    #: before advancing to the next rotation: the erasure signature
    #: (survivor set + missing set) stays fixed inside the window, so
    #: the engine's signature-grouped decode flushes still coalesce
    ROTATE_WINDOW = 64

    def _rotated_plan(self, oid: str, want_chunks: list[int],
                      available: list[int], count: int,
                      mypos: int = -1):
        """Any-k balanced reads (ROADMAP 3): a hot object's reads
        cycle through up to ``osd_read_set_spread`` rotations of the
        available positions, so one primary's shards stop carrying
        every hot read. Locality-first: the serving member's OWN
        shard position (``mypos``) always leads the rotated set —
        its chunk is a local store read, so a rotated serve never
        costs more sub-op wire bytes than the canonical one; the
        rotation spreads which REMOTE partners fill the rest.
        Returns a decode plan, or None to take the canonical
        (primary-preferred) set — rotation NEVER costs availability:
        any failure falls back to the full set."""
        spread = 1
        if self._spread_src is not None:
            try:
                spread = int(self._spread_src())
            except Exception:
                spread = 1
        spread = min(spread, len(available))
        if spread <= 1 or len(available) <= len(want_chunks):
            return None
        r = (stable_hash(oid) + count // self.ROTATE_WINDOW) % spread
        if not r:
            return None          # rotation 0 IS the canonical set
        rot = available[r:] + available[:r]
        if mypos in available:
            rot = [mypos] + [p for p in rot if p != mypos]
        subset = rot[:len(want_chunks)]
        try:
            plan = self.codec.minimum_to_decode(want_chunks, subset)
        except Exception:
            return None          # codec cannot decode from this set
        logger = getattr(self.parent, "logger", None)
        if logger is not None:
            logger.inc("anyk_rotated_reads")
        return plan

    def _read_shards(self, pg: PG, oid: str, want_chunks: list[int],
                     avoid: set[int] | None = None,
                     chunk_off: int = 0, chunk_len: int = 0,
                     accept_versions: frozenset[int] | None = None,
                     rotate_count: int | None = None
                     ) -> tuple[dict[int, np.ndarray], dict[str, bytes]]:
        """Read the chunks named by minimum_to_decode over (up - avoid)
        positions; returns ({chunk: bytes}, attrs-from-one-shard).
        ``chunk_off/chunk_len`` restrict to a range of each shard's
        chunk stream (the partial-stripe RMW read); short/absent ranges
        pad with zeros (virtual zero stripes — parity of zeros is
        zeros, so the code stays consistent).

        Retries around shards that time out or answer EIO
        (get_min_avail_to_read_shards + send_all_remaining_reads role),
        and REFUSES to combine chunks that disagree on the object
        version: a shard whose commit lags (its sub-write is still in
        flight) answers with the previous version; mixing it into a
        decode would produce silent garbage, so the read backs off and
        retries until the shards agree (the ordering guarantee the
        reference gets from the ECBackend rmw pipeline + ExtentCache).

        ``accept_versions`` (the RMW pipelining mode): versions whose
        full window content the caller holds in the extent cache. A
        mixed-version read is then accepted as long as every version
        above the floor is in this set — stripes those in-flight
        writes touched get REPLACED by cache overlay, and stripes they
        did not touch are byte-identical across the versions, so the
        mix is safe. attrs returned are the FLOOR shard's (the overlay
        base version).
        """
        orig_avoid = set(avoid or ())
        base_avoid = set(orig_avoid)
        mypos = self.my_position(pg)
        enoent_everywhere = True
        logger = getattr(self.parent, "logger", None)
        vers: dict[int, int] = {}
        #: versions observed across ALL attempts (a shard outside the
        #: current plan keeps its last known version) — the evidence
        #: the version-split resolution below works from
        known_vers: dict[int, int] = {}
        #: shards excluded because their version disagrees with the
        #: currently targeted one (NOT failures: never in base_avoid)
        ver_avoid: set[int] = set()
        disagreements = 0
        for attempt in range(self.MAX_READ_ATTEMPTS):
            if attempt and logger is not None:
                logger.inc("read_retries")
            # re-seed from peer_missing every attempt: a degraded
            # object's entries drain as recovery pushes land, so a read
            # that initially lacks enough shards waits for recovery
            # (the reference blocks reads on degraded objects) instead
            # of failing on the first try
            avoid = set(base_avoid) | ver_avoid
            with pg.lock:
                for pos, missing in pg.peer_missing.items():
                    if oid in missing:
                        avoid.add(pos)
            available = [p for p in self.up_positions(pg)
                         if p not in avoid]
            plan = None
            if rotate_count is not None and attempt == 0 \
                    and avoid == orig_avoid:
                # hot object, healthy PG, first attempt: try a rotated
                # any-k set; degraded objects and every retry keep the
                # canonical selection (signature + availability first)
                plan = self._rotated_plan(oid, want_chunks, available,
                                          rotate_count, mypos=mypos)
            try:
                if plan is None:
                    plan = self.codec.minimum_to_decode(
                        want_chunks, available)
            except Exception:
                if enoent_everywhere and attempt > 0:
                    # every shard said ENOENT: the object does not
                    # exist — exit fast, don't burn the retry ladder
                    raise NoSuchObject(oid)
                if attempt < self.MAX_READ_ATTEMPTS - 1:
                    self._backoff_sleep(attempt)
                    continue
                raise ECReadError(
                    f"{oid}: cannot reconstruct chunks {want_chunks} "
                    f"from positions {available} after {attempt + 1} "
                    f"attempts (unreachable shards->osds "
                    f"{self._shard_osd_map(pg, avoid)})")
            need = sorted(plan)
            results: dict[int, np.ndarray] = {}
            vers: dict[int, int] = {}
            attrs: dict[str, bytes] = {}
            attrs_by_pos: dict[int, dict] = {}
            remote = {p for p in need if p != mypos}

            def local_read() -> None:
                nonlocal attrs, enoent_everywhere
                cid = pg_cid(pg.pool, pg.ps, mypos)
                try:
                    results[mypos] = np.frombuffer(
                        self.parent.store.read(
                            cid, oid, chunk_off,
                            chunk_len or None),
                        dtype=np.uint8)
                    local_attrs = self.parent.store.getattrs(
                        cid, oid)
                    vers[mypos] = int.from_bytes(
                        local_attrs.get("v", b""), "little")
                    attrs = attrs or local_attrs
                    attrs_by_pos[mypos] = local_attrs
                    enoent_everywhere = False
                except (NoSuchObject, NoSuchCollection):
                    # match the remote mapping: a shard whose PG
                    # collection does not exist yet answers ENOENT
                    base_avoid.add(mypos)
                except StoreError:
                    enoent_everywhere = False
                    base_avoid.add(mypos)

            # hot-shard cache: full-chunk hot reads do the LOCAL read
            # first (its "v" attr is current — every acting position
            # commits before a write acks) and serve partner positions
            # whose cached chunk matches that version without any
            # MECSubRead at all. Partial ranges and the RMW overlay
            # mode (accept_versions) never touch the cache.
            local_done = False
            cacheable = (rotate_count is not None and not chunk_off
                         and not chunk_len and accept_versions is None
                         and mypos in need)
            if cacheable:
                local_read()
                local_done = True
                lv = vers.get(mypos)
                if lv is not None:
                    for pos in sorted(remote):
                        hit = self._shard_cache_get(pg, oid, pos, lv)
                        if hit is None:
                            continue
                        results[pos] = hit
                        vers[pos] = lv
                        remote.discard(pos)
                        if logger is not None:
                            logger.inc("hot_shard_cache_hits")
            tid = self.parent.new_tid()
            wait = SubOpWait(set(remote))
            self.parent.register_wait(tid, wait)
            try:
                for pos in remote:
                    self.parent.send_osd(pg.acting[pos], M.MECSubRead(
                        tid=tid, pool=pg.pool, ps=pg.ps, shard=pos,
                        oid=oid, offset=chunk_off, length=chunk_len,
                        want_attrs=True))
                if mypos in need and not local_done:
                    local_read()
                replies = wait.wait(SUBOP_TIMEOUT) if remote else {}
            finally:
                self.parent.unregister_wait(tid)
            failed = set()
            for pos in remote:
                rep = replies.get(pos)
                if rep is None or rep.code != 0:
                    failed.add(pos)
                    if rep is not None and rep.code != -2:
                        enoent_everywhere = False
                    continue
                enoent_everywhere = False
                results[pos] = np.frombuffer(rep.data, dtype=np.uint8)
                vers[pos] = rep.version
                if rep.attrs:
                    attrs = dict(rep.attrs)
                    attrs_by_pos[pos] = dict(rep.attrs)
                if cacheable:
                    self._shard_cache_put(pg, oid, pos, rep.version,
                                          results[pos])
            missing_reads = set(need) - set(results)
            if missing_reads:
                base_avoid |= failed | missing_reads
                # back off before re-fanning around the failed shards:
                # if they are waiting on recovery pushes, an immediate
                # re-read just re-times-out against the same hole
                if attempt < self.MAX_READ_ATTEMPTS - 1:
                    self._backoff_sleep(attempt)
                continue
            known_vers.update(vers)
            if len(set(vers.values())) > 1:
                floor = min(vers.values())
                if accept_versions is not None and all(
                        v == floor or v in accept_versions
                        for v in vers.values()):
                    # RMW pipelining: the newer versions are in-flight
                    # writes whose windows the caller overlays; pick
                    # the floor shard's attrs as the overlay base
                    for pos, v in vers.items():
                        if v == floor and pos in attrs_by_pos:
                            attrs = attrs_by_pos[pos]
                            break
                elif attempt >= self.MAX_READ_ATTEMPTS - 1:
                    break      # ladder spent: terminal error below
                else:
                    disagreements += 1
                    if disagreements <= 2:
                        # a shard is mid-commit: back off and re-read;
                        # do NOT avoid it — it is catching up
                        log(10, f"{oid}: shard versions disagree "
                            f"{vers}, retrying")
                    else:
                        # the split PERSISTS: the ahead shards hold an
                        # UNACKED write (acks require every position's
                        # commit), e.g. a fan-out cut short by an OSD
                        # kill. Stop waiting for a catch-up that is
                        # not coming and serve the newest version that
                        # can still assemble k shards — exactly the
                        # content recovery's roll-forward/rollback
                        # converges to (test_cluster_failure pins it)
                        ver_avoid = self._version_split_avoid(
                            pg, want_chunks, base_avoid, known_vers)
                        log(1, f"{oid}: persistent shard version "
                            f"split {known_vers}; re-reading around "
                            f"positions {sorted(ver_avoid)}")
                        if logger is not None:
                            logger.inc("read_version_splits")
                    self._backoff_sleep(attempt)
                    continue
            if chunk_len:
                # ranged read: short shards (range beyond their data)
                # pad with zeros — virtual zero stripes
                for pos, arr in results.items():
                    if len(arr) < chunk_len:
                        results[pos] = np.concatenate(
                            [arr, np.zeros(chunk_len - len(arr),
                                           dtype=np.uint8)])
            if logger is not None:
                logger.hinc("read_retry_attempts", attempt + 1)
            return results, attrs
        if enoent_everywhere:
            raise NoSuchObject(oid)
        # the terminal error names WHICH shards were unreachable and
        # on which OSDs (ISSUE 8: it used to say only "no consistent
        # readable shard set", leaving the operator to re-derive the
        # failure domain from scattered logs)
        bad = self._shard_osd_map(pg, base_avoid - orig_avoid)
        raise ECReadError(
            f"{oid}: no consistent readable shard set after "
            f"{self.MAX_READ_ATTEMPTS} attempts (want {want_chunks}; "
            f"unreachable shards->osds {bad}; "
            f"observed shard versions {known_vers or vers})")

    def _attr_size(self, attrs: dict[str, bytes]) -> int:
        raw = attrs.get("sz")
        if raw is None:
            raise NoSuchObject("no sz attr")
        return int.from_bytes(raw, "little")

    # -- reads --------------------------------------------------------
    def read_object(self, pg: PG, oid: str) -> bytes:
        want = list(range(self.k))
        chunks, attrs = self._read_shards(pg, oid, want)
        size = self._attr_size(attrs)
        if all(i in chunks for i in want):
            return self._chunks_to_logical(chunks, size)
        decoded = self._decode(pg, chunks, want)
        return self._chunks_to_logical(decoded, size)

    def read_object_current(self, pg: PG, oid: str) -> bytes | None:
        """The object as the next op of its PG sees it, or None when it
        does not exist: the committed shards with every in-flight write
        of the object laid over them in version order (the ExtentCache
        overlay the partial-write RMW takes). An object class's method
        reads the whole object, changes it and writes it back under
        ``pg.lock``; on a device backend a write commits only after its
        engine flush, with the lock released, so a method that read the
        committed shards alone would undo the writes still in flight
        (concurrent ``rgw.bucket_add`` calls lost index entries)."""
        snap = pg.extent_cache.snapshot(oid)
        if not len(snap):
            try:
                return self.read_object(pg, oid)
            except (NoSuchObject, NoSuchCollection):
                return None
        want = list(range(self.k))
        try:
            chunks, attrs = self._read_shards(
                pg, oid, want, accept_versions=snap.versions())
        except (NoSuchObject, NoSuchCollection):
            base, base_ver = None, 0
        else:
            base_ver = int.from_bytes(attrs.get("v", b""), "little")
            if not all(i in chunks for i in want):
                chunks = self._decode(pg, chunks, want)
            base = self._chunks_to_logical({i: chunks[i] for i in want},
                                           self._attr_size(attrs))
        removed = snap.removed_after(base_ver)
        if removed or (removed is None and base is None):
            return None
        base = base or b""
        window = bytearray(snap.effective_size(len(base), base_ver))
        window[:len(base)] = base[:len(window)]
        snap.overlay(window, 0, base_ver)
        return bytes(window)

    def read_object_async(self, pg: PG, oid: str,
                          cont: Callable[[bytes | None,
                                          Exception | None],
                                         None]) -> None:
        """Batched decode-on-read (ISSUE 8). Intact objects answer
        inline (the fast path is unchanged). A DEGRADED read stages
        its reconstruct on the device engine and returns — the op
        worker is free for the next op, so concurrent degraded reads
        of objects sharing an erasure signature (same survivor set,
        same missing set — exactly the post-failure steady state,
        where ONE dead OSD degrades every object of a PG the same
        way) land in the engine queue together and coalesce into one
        signature-grouped decode flush instead of N serial
        ``decode_sync`` launches. ``cont(data, err)`` then runs on
        the engine thread; a device fault fails the read with
        DeviceFault (counted by the engine, never hidden).

        Hot objects (read_heat past osd_hot_read_threshold) rotate
        their shard read set (any-k balanced reads, ROADMAP 3): a
        rotated set that includes parity positions reconstructs
        through the SAME signature-batched decode machinery, and the
        ROTATE_WINDOW keeps consecutive reads on one signature so
        they still coalesce."""
        want = list(range(self.k))
        count = read_heat.note((pg.pool, oid))
        rotate = count if count >= self._hot_threshold else None
        try:
            chunks, attrs = self._read_shards(pg, oid, want,
                                              rotate_count=rotate)
            size = self._attr_size(attrs)
        except Exception as exc:
            cont(None, exc)
            return
        if all(i in chunks for i in want):
            cont(self._chunks_to_logical(chunks, size), None)
            return
        logger = getattr(self.parent, "logger", None)
        if logger is not None:
            logger.inc("degraded_reads")
        missing = [i for i in want if i not in chunks]
        if ec_util.xor_decodable(self.codec, chunks, missing):
            # host XOR reconstruction is microseconds for these
            # signatures — a device staging round-trip (batched or
            # not) can only lose. This is what keeps the any-k
            # rotated hot-read sets of single-parity pools near
            # canonical-read cost.
            try:
                dec = ec_util.decode(self.sinfo, self.codec, chunks,
                                     want)
                data = self._chunks_to_logical(dec, size)
            except Exception as exc:
                cont(None, exc)
                return
            if logger is not None:
                logger.inc("xor_fast_decodes")
            cont(data, None)
            return
        if self.device is not None and self.device_codec is not None \
                and ec_util.device_decodable(self.device_codec):
            span = tracing.current().child("engine_decode")

            def decoded(out, err, chunks=chunks, size=size):
                if out is None:
                    # device fault (the engine counted it in
                    # decode_errors): no host twin hides it, the read
                    # fails with EIO
                    log(0, f"{pg}: batched decode-on-read failed for "
                        f"{oid} ({err!r})")
                    cont(None, DeviceFault(
                        f"{oid}: device decode failed ({err!r})"))
                    return
                merged = dict(chunks)
                merged.update(out)
                try:
                    data = self._chunks_to_logical(
                        {i: merged[i] for i in want}, size)
                except Exception as exc:
                    cont(None, exc)
                    return
                cont(data, None)

            self.device.stage_decode(
                pg.pgid, self.device_codec, self.sinfo, chunks,
                missing, decoded, span=span,
                clock=stage_clock.current())
            return
        try:
            dec = self._decode(pg, chunks, want)
            cont(self._chunks_to_logical(dec, size), None)
        except Exception as exc:
            cont(None, exc)

    def stat_object(self, pg: PG, oid: str) -> int:
        mypos = self.my_position(pg)
        if mypos >= 0:
            cid = pg_cid(pg.pool, pg.ps, mypos)
            try:
                return int.from_bytes(
                    self.parent.store.getattr(cid, oid, "sz"), "little")
            except StoreError:
                pass
        # degraded: any shard's attrs carry the size
        _, attrs = self._read_shards(pg, oid, [0])
        return self._attr_size(attrs)

    # -- recovery -----------------------------------------------------
    def build_push(self, pg: PG, oid: str, shard: int, version: int,
                   tid: int) -> M.MPGPush | None:
        if shard >= len(pg.acting) or pg.acting[shard] < 0:
            return None
        if version <= 0:     # missed removal (removal log v = -version)
            return M.MPGPush(
                pool=pg.pool, ps=pg.ps, shard=shard, oid=oid,
                version=-version, data=b"", attrs={}, remove=True,
                tid=tid)
        try:
            got = self._repair_read(pg, oid, shard)
            if got is not None:
                chunk, attrs = got
                return self._push_from_chunk(pg, oid, shard, version,
                                             chunk, attrs, tid)
            chunks, attrs = self._read_shards(
                pg, oid, [shard], avoid={shard})
        except StoreError as exc:
            log(1, f"recover {oid} shard {shard}: {exc}")
            return None
        if shard in chunks:
            chunk = chunks[shard]
        else:
            decoded = self._decode(pg, chunks, [shard])
            chunk = decoded[shard]
        return self._push_from_chunk(pg, oid, shard, version, chunk,
                                     attrs, tid)

    def _push_from_chunk(self, pg: PG, oid: str, shard: int,
                         version: int, chunk, attrs: dict,
                         tid: int) -> M.MPGPush | None:
        # push the version the surviving shards actually agree on: the
        # wanted version may have been superseded by a later write
        # (actual_v higher) or may never have committed anywhere (every
        # sub-op of that write lost — actual_v lower). Pushing what
        # survives is right in both cases: the push guard refuses it if
        # the target is already newer, and a target behind converges to
        # the cluster-wide surviving state (the unacked write's client
        # resends).
        actual_v = int.from_bytes(attrs.get("v", b""), "little")
        if actual_v < version:
            log(1, f"recover {oid} shard {shard}: shards at v"
                f"{actual_v} < wanted v{version}; pushing surviving "
                "state (the wanted write never fully committed)")
        push_attrs = {"v": actual_v.to_bytes(8, "little")}
        from ceph_tpu_torch.osd.pg_backend import USER_XATTR
        for name in attrs:
            if name in ("sz", "hinfo") or name.startswith(USER_XATTR):
                push_attrs[name] = attrs[name]
        return M.MPGPush(
            pool=pg.pool, ps=pg.ps, shard=shard, oid=oid,
            version=actual_v, data=np.asarray(chunk).tobytes(),
            attrs=push_attrs, remove=False, tid=tid)

    def _repair_read(self, pg: PG, oid: str, shard: int
                     ) -> tuple[np.ndarray, dict] | None:
        """Sub-chunk fragmented repair read (ECBackend.cc:978-1002 +
        the clay repair path): when the codec's minimum_to_decode asks
        for PARTIAL sub-chunk ranges (a repair-bandwidth-optimal code),
        read only those byte ranges from each helper and reconstruct
        per stripe from the fragments. Returns (chunk, attrs) or None
        when whole-chunk recovery should run instead."""
        sub = self.codec.get_sub_chunk_count()
        if sub <= 1:
            return None
        with pg.lock:
            avoid = {p for p, m in pg.peer_missing.items() if oid in m}
        avoid.add(shard)
        available = [p for p in self.up_positions(pg) if p not in avoid]
        try:
            plan = self.codec.minimum_to_decode([shard], available)
        except Exception:
            return None
        ranges = next(iter(plan.values()))
        frac = sum(cnt for _, cnt in ranges)
        if frac >= sub or any(plan[c] != ranges for c in plan):
            return None               # full-chunk plan (or asymmetric)
        cs = self.sinfo.chunk_size
        subsz = cs // sub
        # need the shard length to know the stripe count: probe attrs
        try:
            _, attrs = self._read_shards(pg, oid, [next(iter(plan))],
                                         chunk_off=0, chunk_len=subsz)
            size = self._attr_size(attrs)
        except StoreError:
            return None
        probe_v = int.from_bytes(attrs.get("v", b""), "little")
        padded = size + (-size % self.sinfo.stripe_width) \
            if size % self.sinfo.stripe_width else size
        shard_len = max(padded // self.k, cs)
        n_stripes = shard_len // cs
        # absolute byte ranges: the plan's sub-chunk ranges replayed in
        # every stripe of the shard
        offsets, lengths = [], []
        for t in range(n_stripes):
            for off, cnt in ranges:
                offsets.append(t * cs + off * subsz)
                lengths.append(cnt * subsz)
        frag_per_stripe = frac * subsz
        # brief retry before abandoning the bandwidth optimization: a
        # transient mid-commit version disagreement (a helper's sub-write
        # still in flight) resolves in one commit round trip, and falling
        # back costs d full-chunk reads
        frags = None
        for attempt in range(3):
            if attempt:
                time.sleep(0.05 * attempt)
            frags, attrs, retryable = self._read_fragments(
                pg, oid, sorted(plan), offsets, lengths,
                n_stripes * frag_per_stripe, expect_version=probe_v)
            if frags is not None or not retryable:
                break
        if frags is None:
            return None
        out = np.empty(shard_len, dtype=np.uint8)
        for t in range(n_stripes):
            sl = slice(t * frag_per_stripe, (t + 1) * frag_per_stripe)
            stripe_frags = {c: buf[sl] for c, buf in frags.items()}
            dec = self.codec.decode([shard], stripe_frags, cs)
            out[t * cs:(t + 1) * cs] = np.asarray(dec[shard],
                                                  dtype=np.uint8)
        # fragmented reads bypass the per-helper hinfo gate (the stored
        # crc covers the whole chunk), so verify the reconstruction
        # before pushing: helper bit rot must not become recovered state
        hraw = attrs.get("hinfo")
        if hraw:
            from ceph_tpu_torch.utils import checksum
            hinfo = HashInfo.from_dict(json.loads(hraw))
            crc = checksum.crc32c(out.tobytes(), ec_util.HINFO_SEED)
            if crc != hinfo.get_chunk_hash(shard):
                log(1, f"repair-read {oid} shard {shard}: reconstructed "
                    f"crc {crc:#x} != hinfo "
                    f"{hinfo.get_chunk_hash(shard):#x}; falling back")
                return None
        log(10, f"repair-read {oid} shard {shard}: {frac}/{sub} "
            f"sub-chunks from {len(frags)} helpers")
        logger = getattr(self.parent, "logger", None)
        if logger is not None:
            logger.inc("recovery_subchunk_reads")
        return out, attrs

    def _read_fragments(self, pg: PG, oid: str, positions: list[int],
                        offsets: list[int], lengths: list[int],
                        expect_len: int, expect_version: int = -1):
        """Fan a multi-range MECSubRead to ``positions``.

        ``expect_version``: the version the geometry probe observed; a
        write landing between probe and fragment read would otherwise
        pass the internal agreement check while the stripe count (and
        hence the fragment offsets) are stale.

        Returns (results, attrs, retryable): retryable is True for
        transient mid-commit disagreement (worth one more try), False
        for hard failures and for a probe superseded by a newer write
        (stale geometry — the caller must re-plan, not retry)."""
        mypos = self.my_position(pg)
        results: dict[int, np.ndarray] = {}
        attrs: dict = {}
        vers: dict[int, int] = {}
        remote = [p for p in positions if p != mypos]
        tid = self.parent.new_tid()
        wait = SubOpWait(set(remote))
        self.parent.register_wait(tid, wait)
        try:
            for pos in remote:
                self.parent.send_osd(pg.acting[pos], M.MECSubRead(
                    tid=tid, pool=pg.pool, ps=pg.ps, shard=pos,
                    oid=oid, want_attrs=True,
                    offsets=list(offsets), lengths=list(lengths)))
            if mypos in positions:
                cid = pg_cid(pg.pool, pg.ps, mypos)
                try:
                    parts = []
                    for off, ln in zip(offsets, lengths):
                        piece = self.parent.store.read(cid, oid, off,
                                                       ln)
                        parts.append(piece + b"\x00" *
                                     (ln - len(piece)))
                    results[mypos] = np.frombuffer(
                        b"".join(parts), dtype=np.uint8)
                    local = self.parent.store.getattrs(cid, oid)
                    vers[mypos] = int.from_bytes(
                        local.get("v", b""), "little")
                    attrs = attrs or local
                except StoreError:
                    return None, None, False
            replies = wait.wait(SUBOP_TIMEOUT) if remote else {}
        finally:
            self.parent.unregister_wait(tid)
        for pos in remote:
            rep = replies.get(pos)
            if rep is None or rep.code != 0 or \
                    len(rep.data) != expect_len:
                return None, None, False
            results[pos] = np.frombuffer(rep.data, dtype=np.uint8)
            vers[pos] = rep.version
            if rep.attrs:
                attrs = dict(rep.attrs)
        if len(set(vers.values())) > 1:
            return None, None, True    # mid-commit: retryable
        if expect_version >= 0 and vers and \
                next(iter(vers.values())) != expect_version:
            return None, None, False   # superseded the probe: re-plan
        return results, attrs, False

    def recover_rollback(self, pg: PG, oid: str, wanted: int
                         ) -> dict[int, M.MPGPush] | None:
        """EC log rollback (ecbackend.rst:9-26 role): a write that never
        reached k shards can neither be acked (the client saw a timeout)
        nor reconstructed — recovery would retry it forever. Probe every
        up shard; if no version >= wanted has k chunks, rewrite the
        object on EVERY up shard at the newest version that does (same
        version label as the dead write, so the push guard accepts it
        everywhere and peering sees a consistent object), or remove the
        partial chunks entirely if no version ever reached k.

        The caller asks only after two recovery rounds failed. If a
        version >= wanted does have k chunks, the normal path can rebuild
        the object, and returns None as the reference does; but first the
        ``pg.peer_missing`` entries of positions the probe found holding a
        version >= wanted are dropped: stale, they are what made the
        recovery read, which avoids listed positions, see fewer than k
        (the reference keeps them, and its recovery retries forever,
        ROADMAP §C). Nothing is written for them."""
        positions = self.up_positions(pg)
        if len(positions) < len(pg.acting) or \
                any(o < 0 for o in pg.acting):
            # a down shard may hold chunks we cannot see: rolling back
            # on partial visibility could destroy an acked object.
            # Defer until the acting set is whole (recovery retries).
            return None
        tid = self.parent.new_tid()
        wait = SubOpWait(set(positions))
        self.parent.register_wait(tid, wait)
        for pos in positions:
            self.parent.send_osd(pg.acting[pos], M.MECSubRead(
                tid=tid, pool=pg.pool, ps=pg.ps, shard=pos, oid=oid,
                offset=0, length=0, want_attrs=True))
        replies = wait.wait(SUBOP_TIMEOUT)
        self.parent.unregister_wait(tid)
        vers: dict[int, list[int]] = {}      # version -> holders
        chunks: dict[int, np.ndarray] = {}
        attrs_by_pos: dict[int, dict] = {}
        for pos in positions:
            rep = replies.get(pos)
            if rep is None:
                return None      # a shard's state is unknown: no guess
            if rep.code == -2:
                continue         # absent here
            if rep.code != 0:
                continue         # EIO: unusable shard, scrub's business
            vers.setdefault(rep.version, []).append(pos)
            chunks[pos] = np.frombuffer(rep.data, dtype=np.uint8)
            attrs_by_pos[pos] = dict(rep.attrs)
        usable = [v for v, poss in vers.items() if len(poss) >= self.k]
        if usable and max(usable) >= wanted:
            holding = {pos for v, poss in vers.items() if v >= wanted
                       for pos in poss}
            with pg.lock:
                for pos in holding:
                    missing = pg.peer_missing.get(pos)
                    if missing and missing.get(oid, wanted + 1) <= wanted:
                        del missing[oid]
                        log(1, f"{pg}: {oid} is at v>={wanted} on pos "
                            f"{pos}; dropped its stale missing entry")
                        if not missing:
                            del pg.peer_missing[pos]
            return None          # reconstructible: normal path handles
        # label every rewrite with the highest version any shard holds,
        # so the push guard accepts it on the ahead shards too
        label = max([wanted] + list(vers))

        def mk(pos: int, data: bytes, attrs: dict,
               remove: bool) -> M.MPGPush:
            return M.MPGPush(pool=pg.pool, ps=pg.ps, shard=pos, oid=oid,
                             version=label, data=data, attrs=attrs,
                             remove=remove, tid=0)

        if not usable:
            # no version ever reached k chunks: the object cannot exist
            # — roll back to nonexistence wherever a partial chunk sits
            log(1, f"{pg}: {oid} has no version with k={self.k} "
                "chunks; rolling back to nonexistence")
            return {pos: mk(pos, b"", {}, True)
                    for poss in vers.values() for pos in poss}
        best = max(usable)
        have = {p: chunks[p] for p in vers[best]}
        size = int.from_bytes(
            attrs_by_pos[vers[best][0]].get("sz", b""), "little")
        want_data = list(range(self.k))
        if all(i in have for i in want_data):
            data_chunks = {i: have[i] for i in want_data}
        else:
            data_chunks = self._decode(pg, have, want_data)
        logical = self._chunks_to_logical(data_chunks, size)
        padded = self._pad(bytes(logical))
        shards = ec_util.encode(self.sinfo, self.codec, padded)
        hinfo = HashInfo(self.n)
        hinfo.append(0, shards)
        attrs = {"sz": size.to_bytes(8, "little"),
                 "hinfo": json.dumps(hinfo.to_dict()).encode()}
        from ceph_tpu_torch.osd.pg_backend import USER_XATTR
        for name, val in attrs_by_pos[vers[best][0]].items():
            if name.startswith(USER_XATTR):
                attrs[name] = val
        log(1, f"{pg}: rolling back {oid} to content of v{best} "
            f"(labelled v{label}) on positions {positions}")
        return {pos: mk(pos, shards[pos].tobytes(), attrs, False)
                for pos in positions}

    # -- shard-side read service (handle_sub_read role) ---------------
    @staticmethod
    def serve_sub_read(store, msg: M.MECSubRead,
                       cid: str | None = None) -> M.MECSubReadReply:
        """Runs on the shard OSD: read + hinfo crc verify
        (ECBackend.cc:955-1051). ``csum_only`` serves scrub: return
        (version, crc) without the data and WITHOUT the hinfo gate —
        scrub wants the raw observation, not a -EIO verdict."""
        from ceph_tpu_torch.utils import checksum
        if cid is None:
            cid = pg_cid(msg.pool, msg.ps, msg.shard)
        reply = M.MECSubReadReply(
            tid=msg.tid, pool=msg.pool, ps=msg.ps, shard=msg.shard,
            oid=msg.oid, code=0, data=b"", attrs={})
        try:
            if msg.offsets:
                # fragmented sub-chunk read: concatenate the ranges
                # (short ranges pad zeros — virtual zero stripes)
                parts = []
                for off, ln in zip(msg.offsets, msg.lengths):
                    piece = store.read(cid, msg.oid, off, ln)
                    if len(piece) < ln:
                        piece += b"\x00" * (ln - len(piece))
                    parts.append(piece)
                data = b"".join(parts)
            else:
                length = msg.length or None
                data = store.read(cid, msg.oid, msg.offset, length)
            attrs = store.getattrs(cid, msg.oid)
            reply.version = int.from_bytes(attrs.get("v", b""), "little")
            if msg.csum_only:
                reply.crc = checksum.crc32c(data, ec_util.HINFO_SEED)
                if msg.want_attrs:
                    reply.attrs = dict(attrs)
                return reply
            hraw = attrs.get("hinfo")
            if hraw and msg.offset == 0 and not msg.length \
                    and not msg.offsets and not msg.raw:
                hinfo = HashInfo.from_dict(json.loads(hraw))
                crc = checksum.crc32c(data, ec_util.HINFO_SEED)
                if crc != hinfo.get_chunk_hash(msg.shard):
                    raise EIOError(
                        f"{msg.oid} shard {msg.shard}: crc {crc:#x} != "
                        f"hinfo {hinfo.get_chunk_hash(msg.shard):#x}")
            reply.data = data
            if msg.want_attrs:
                reply.attrs = dict(attrs)
                if msg.offset == 0 and not msg.length \
                        and not msg.offsets:
                    # full-object pull: ship the omap too (replicated
                    # recovery; EC objects carry no client omap)
                    try:
                        reply.omap = store.omap_get(cid, msg.oid)
                    except StoreError:
                        pass
        except EIOError as exc:
            log(1, f"sub_read EIO: {exc}")
            reply.code = -5
        except StoreError:
            reply.code = -2
        return reply
