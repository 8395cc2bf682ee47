"""DeviceEncodeEngine — the OSD's device-side stripe-batch pipeline.

Port of ``ceph_tpu/osd/device_engine.py``. The reference encodes
synchronously inside try_reads_to_commit (src/osd/ECBackend.cc:1986-2048,
per-stripe loop ECUtil.cc:120-159); a device cannot be fed per-4KiB-op
without drowning in launch cost, so the daemon's encode work is decoupled
from the op path:

- ``stage_encode`` queues an op's stripe-aligned payload; the engine folds
  every queued payload (across PGs — batching across placement groups is
  where the batch size comes from) into ONE fused device flush via
  :class:`ceph_tpu_torch.osd.ec_util.StripeBatcher` (kernels B1 and B2 on
  CUDA), then dispatches each op's continuation back onto the caller's
  per-key executor.
- ``stage_barrier`` queues a NON-encode mutation. A barrier flushes
  everything staged before it and is dispatched after those
  continuations, so per-PG commit order is exactly submission order (the
  check_ops pipeline-ordering invariant, ECBackend.cc:2107-2112).
- ``stage_decode`` queues a reconstruct. Decodes group by ERASURE
  SIGNATURE (present-set, want-set) and each group flushes as ONE device
  product. Decode continuations run INLINE on the engine thread: callers
  block synchronously (``decode_sync``).

Batching policy ("batch while busy"): the engine thread drains whatever is
queued and launches it; while the device works, new ops accumulate for the
next launch. A size cap (``flush_bytes``) bounds the device working set.

Launch pipeline: the reference rides JAX async dispatch; here a flush
enqueues its upload, kernels and download on one of the device's side
streams (:func:`slot_stream`, one a window slot, so consecutive
flushes overlap across streams) and parks its ``finalize`` — which waits
on that stream's event — on a bounded in-flight deque. Up to ``window``
(default 3) batches stay in flight. A RETIRE thread harvests them strictly
FIFO, so continuations dispatch in submission order, and every ordering
point — ``stage_barrier``, ``run_sync``, ``stop``, a launch failure —
drains the whole window first. ``window=1`` is the serial engine. On the
CPU the same threads run the kernels' plain versions.

Failure: a failed launch or fused flush reaches the op continuations as
``err`` (the port has no fused-to-plain fallback: ``ec_util`` raises).

Bulk ingest (``CEPH_TPU_BULK_INGEST``, default on): zero-copy staging into
a per-signature concat buffer on the producer thread
(:class:`_ConcatStager`), batched continuation dispatch (one wrapper per
key sharing a :class:`FlushGroup`), and the shared engine service
(:func:`shared_engine_attach`).

Knobs: the window, the flush threshold and the two crossovers resolve
explicit argument > environment (``CEPH_TPU_*``) > ``g_conf`` Option >
default, as in the reference. Each knob that no argument or environment
variable pins registers a config observer, so the mgr tuner's pushes
through the ``mon`` layer land as one attribute write — never a per-flush
config read; ``stop()`` detaches them.

Not ported yet: the multi-device mesh route (ROADMAP A.5: the placement
slot is always 0 and ``ec_util`` raises on a mesh). The engine's locks
are the lock witness's named seams (``analysis/lock_witness``); the
other host hooks are the port's copies of the reference's modules.
"""

from __future__ import annotations

import collections
import contextlib
import os
import queue
import threading
import time as _time
from typing import Callable

import numpy as np
import torch

from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.utils import faults as _faults
from ceph_tpu_torch.utils import profiler as _prof
from ceph_tpu_torch.utils import stage_clock as _stage_clock
from ceph_tpu_torch.utils.device_telemetry import telemetry as _telemetry
from ceph_tpu_torch.utils import dispatch_telemetry as _dsp
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils import flow_telemetry as _flows
from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.utils import tracepoints as _tracepoints
from ceph_tpu_torch.analysis.lock_witness import make_condition, make_lock
from ceph_tpu_torch.utils.tracing import NOOP

log = Dout("osd")

_TP_FLUSH = _tracepoints.provider("osd").point(
    "device_flush", "ops", "bytes")
_TP_DECODE_FLUSH = _tracepoints.provider("osd").point(
    "device_decode_flush", "ops", "signature")


def bulk_ingest_enabled() -> bool:
    """The data-plane master switch: batched continuation dispatch +
    zero-copy staging + the shared engine service. Read at engine
    construction so ``CEPH_TPU_BULK_INGEST=0|1`` can A/B two engines in
    one process."""
    return os.environ.get("CEPH_TPU_BULK_INGEST", "1") != "0"


def _conf_knob(env_name: str, option: str) -> tuple[int, bool]:
    """Resolve one engine knob at construction: the environment (the
    reference's ``CEPH_TPU_*`` name) beats the ``g_conf`` Option, whose
    schema holds the default. Returns (value, pinned): a knob the
    environment pins must NOT track runtime config pushes, an unpinned
    one must (the tuner's actuation path is a runtime ``config set``).
    An explicit constructor argument beats both and pins (the caller
    checks it first)."""
    env = os.environ.get(env_name)
    if env is not None:
        return int(env), True
    return int(g_conf()[option]), False


_streams_lock = threading.Lock()
_slot_streams: dict[tuple[str, int], torch.cuda.Stream] = {}


def slot_stream(device, slot: int) -> torch.cuda.Stream:
    """The side stream of launch-window ``slot`` on a CUDA ``device``,
    created once a process. One stream a slot: a single stream runs in
    order, so batch N+1's upload would queue behind batch N's kernels;
    with one a slot, upload, compute and download overlap across the
    window. Each flush also allocates on its slot's stream, where the
    caching allocator reuses its blocks only after that stream's earlier
    work. Streams are made on first use and kept: a window that the
    tuner widens to the ``engine_window`` knob's bound (16) makes at
    most 16 a device."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (str(device), slot)
    stream = _slot_streams.get(key)
    if stream is None:
        with _streams_lock:
            stream = _slot_streams.get(key)
            if stream is None:
                stream = _slot_streams[key] = torch.cuda.Stream(device)
    return stream


def _launch_context(codec, slot: int):
    """Where window slot ``slot``'s flush launches: inside that slot's
    side stream for a CUDA codec (the flush enqueues and allocates
    there), in place on the CPU."""
    device = getattr(codec, "device", None)
    if getattr(device, "type", "") != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(slot_stream(device, slot))


def _placement_slot(key) -> int:
    """The PG-placement slot of one staged op's key: always 0, since the
    port has no mesh or placement map yet (ROADMAP A.5)."""
    return 0


class _ConcatStager:
    """Per-signature concat buffers, written at staging time.
    ``append`` copies the op's payload into the signature's open buffer
    on the PRODUCER thread; ``take`` hands the engine the consumed prefix
    as one contiguous buffer plus per-op views into it — no flush-time
    np.concatenate. Ownership of the handed buffer passes to the flush.

    Two changes from the reference's stager. A buffer closes once it
    holds ``seg_bytes`` (the engine's flush threshold) and the next op
    opens a new one, so a backlog is held as flush-sized segments: a
    flush takes the head of the first segment, and only the ops staged
    past the engine's cut inside that segment move to a fresh buffer (the
    reference keeps one buffer, so each flush of a backlog re-copied all
    of the backlog behind it). A buffer grows by doubling from
    ``_MIN_CAP``, as the reference's does, except one opened behind a
    full one (a backlog), which starts at ``seg_bytes``. And for a CUDA
    codec the buffers are pinned tensors from PyTorch's caching host
    allocator, and ``take`` hands the batch over as one: the fused flush
    uploads it as it lies, asynchronously, and the upload's event keeps
    the block from reuse until it has been read."""

    _MIN_CAP = 256 << 10

    def __init__(self, seg_bytes: int | None = None) -> None:
        self.lock = make_lock("engine.stager")
        self.seg_bytes = seg_bytes
        #: (id(codec), placement slot) -> [segment, ...], oldest first;
        #: a segment is {"buf", "np", "used", "slots": [[off, len], ...]}
        #: with "np" the host numpy view of "buf"
        self._by_codec: dict[tuple, list] = {}
        self.stats = {"staged_bytes": 0, "relocated_bytes": 0,
                      "joined_bytes": 0}

    @staticmethod
    def _alloc(codec, nbytes: int) -> tuple:
        """(buffer, its numpy view): a pinned tensor for a CUDA codec,
        host numpy otherwise."""
        if getattr(getattr(codec, "device", None), "type", "") == "cuda":
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            return buf, buf.numpy()
        buf = np.empty(nbytes, dtype=np.uint8)
        return buf, buf

    def _segment(self, codec, nbytes: int, full: bool = False) -> dict:
        floor = self.seg_bytes if full and self.seg_bytes else 0
        cap = self._MIN_CAP
        while cap < max(nbytes, floor):
            cap <<= 1
        buf, view = self._alloc(codec, cap)
        return {"buf": buf, "np": view, "used": 0, "slots": []}

    def append_locked(self, codec, pslot: int,
                      data: np.ndarray) -> None:
        """Caller holds ``self.lock`` (the engine queue put rides the
        same critical section so per-(codec, slot) order == queue
        order)."""
        segs = self._by_codec.setdefault((id(codec), pslot), [])
        if not segs or (self.seg_bytes is not None and
                        segs[-1]["used"] >= self.seg_bytes):
            segs.append(self._segment(codec, data.nbytes, full=bool(segs)))
        st = segs[-1]
        need = st["used"] + data.nbytes
        if need > len(st["np"]):
            cap = len(st["np"])
            while cap < need:
                cap <<= 1
            buf, view = self._alloc(codec, cap)
            view[:st["used"]] = st["np"][:st["used"]]
            st["buf"], st["np"] = buf, view
        st["np"][st["used"]:need] = data.ravel()
        st["slots"].append([st["used"], data.nbytes])
        st["used"] = need
        self.stats["staged_bytes"] += data.nbytes

    def take(self, codec, pslot: int, count: int) -> tuple:
        """Detach the first ``count`` staged ops of this
        (signature, slot): returns (contiguous batch — a pinned tensor
        for a CUDA codec, numpy otherwise — and per-op numpy views into
        it). Ops of the last segment touched that were staged after the
        engine's cut move to a fresh buffer, so their queued tokens stay
        valid; a cut across segments joins them into one buffer."""
        with self.lock:
            segs = self._by_codec.setdefault((id(codec), pslot), [])
            pieces = []
            while count > 0 and segs:
                st = segs[0]
                taken = st["slots"][:count]
                tail = st["slots"][count:]
                cut = taken[-1][0] + taken[-1][1] if taken else 0
                pieces.append((st["buf"], st["np"], taken, cut))
                if tail:
                    tail_bytes = st["used"] - cut
                    fresh = self._segment(codec, tail_bytes)
                    fresh["np"][:tail_bytes] = st["np"][cut:st["used"]]
                    for slot in tail:
                        slot[0] -= cut
                    fresh["used"], fresh["slots"] = tail_bytes, tail
                    segs[0] = fresh
                    self.stats["relocated_bytes"] += tail_bytes
                else:
                    segs.pop(0)
                count -= len(taken)
            if len(pieces) == 1:
                buf, view, taken, cut = pieces[0]
                return buf[:cut], [view[off:off + ln] for off, ln in taken]
            total = sum(cut for _b, _v, _t, cut in pieces)
            out, out_np = self._alloc(codec, total)
            pos, views = 0, []
            for _buf, view, taken, cut in pieces:
                out_np[pos:pos + cut] = view[:cut]
                views += [out_np[pos + off:pos + off + ln]
                          for off, ln in taken]
                pos += cut
            self.stats["joined_bytes"] += total
            return out[:total], views


class FlushGroup:
    """Per-retired-flush rendezvous: the engine dispatches one
    continuation wrapper per distinct key; each wrapper's ops may
    :meth:`defer` cross-PG work, and the LAST wrapper to finish ships it
    — after the PREVIOUS flush's group shipped, so sends to a peer keep
    flush order. Barriers chain behind the flush via
    :meth:`after_flush`."""

    def __init__(self, nkeys: int,
                 prev_group: "FlushGroup | None") -> None:
        self._lock = make_lock("engine.flush_group")
        self._pending = max(1, nkeys)
        #: bucket -> (ship_fn, [items]); insertion-ordered
        self._deferred: dict = {}
        self._after: list = []
        self._prev_group = prev_group
        self._flushed = False
        self.event = threading.Event()

    def defer(self, bucket, ship_fn, item) -> None:
        """Queue ``item`` for ``ship_fn(items)`` at group flush; items of
        one bucket ship together."""
        with self._lock:
            ent = self._deferred.get(bucket)
            if ent is None:
                ent = self._deferred[bucket] = (ship_fn, [])
            ent[1].append(item)

    def after_flush(self, cb) -> None:
        """Run ``cb`` once the group has shipped (immediately if it
        already has)."""
        with self._lock:
            if not self._flushed:
                self._after.append(cb)
                return
        cb()

    def done(self) -> None:
        """One per-key wrapper finished; the last one ships — after the
        PREVIOUS flush's group shipped. The fence is NON-blocking: when
        the predecessor is still open, the ship runs as its after-flush
        callback instead of parking this worker on a wait."""
        with self._lock:
            self._pending -= 1
            if self._pending > 0:
                return
        prev, self._prev_group = self._prev_group, None
        if prev is not None:
            prev.after_flush(self._ship)
        else:
            self._ship()

    def _ship(self) -> None:
        with self._lock:
            deferred = list(self._deferred.values())
            self._deferred = {}
        for ship_fn, items in deferred:
            try:
                ship_fn(items)
            except Exception as exc:
                log(0, f"flush-group ship failed: {exc!r}")
        with self._lock:
            self._flushed = True
            after, self._after = self._after, []
        self.event.set()
        for cb in after:
            try:
                cb()
            except Exception as exc:
                log(0, f"flush-group after-flush cb failed: {exc!r}")


_group_tls = threading.local()


def current_group() -> "FlushGroup | None":
    """The FlushGroup whose continuation wrapper is running on this
    thread (None outside one)."""
    return getattr(_group_tls, "group", None)


class _StagedRef:
    """Placeholder riding the queue in place of the payload when the
    bytes already live in the stager's concat buffer (only the byte
    count is still needed on the engine loop's flush threshold)."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int) -> None:
        self.nbytes = nbytes


class DeviceEncodeEngine:
    """One per OSD — or one per PROCESS through the shared engine
    service (:func:`shared_engine_attach`); owns the device dispatch
    thread and the retire thread."""

    def __init__(self, dispatch: Callable[[object, Callable], None],
                 flush_bytes: int | None = None,
                 counters=None, window: int | None = None,
                 mesh_flush_bytes: int | None = None,
                 host_flush_bytes: int | None = None) -> None:
        #: dispatch(key, fn): run fn on the per-key FIFO executor. None
        #: for the shared engine service, where every key is an
        #: AttachedKey routed through the per-OSD dispatcher table.
        self._dispatch_default = dispatch
        #: attach token -> that OSD's dispatch fn (shared engine)
        self._dispatchers: dict[int, Callable] = {}
        self._bulk = bulk_ingest_enabled()
        #: flush-order chain: each retired flush's FlushGroup waits for
        #: its predecessor's event before shipping
        self._last_group: FlushGroup | None = None
        self._last_group_event: threading.Event | None = None
        self._counters = counters
        #: (option, observer) pairs registered on g_conf; stop()
        #: detaches them
        self._cfg_observers: list[tuple[str, Callable]] = []

        def knob(arg, env_name: str, option: str) -> tuple[int, bool]:
            if arg is not None:
                return int(arg), True
            return _conf_knob(env_name, option)

        #: staged payload bytes that force a launch
        self._flush_bytes, fb_pinned = knob(
            flush_bytes, "CEPH_TPU_ENGINE_FLUSH_BYTES",
            "engine_flush_bytes")
        #: zero-copy staging, in segments of one flush each
        self._stager = _ConcatStager(self._flush_bytes) \
            if self._bulk else None
        #: max launched-not-retired encode batches; 1 = serial engine
        window, w_pinned = knob(window, "CEPH_TPU_ENGINE_WINDOW",
                                "engine_window")
        self._window = max(1, window)
        #: kept for the reference's interface: no mesh route yet
        self._mesh_flush_bytes, mfb_pinned = knob(
            mesh_flush_bytes, "CEPH_TPU_MESH_FLUSH_BYTES",
            "mesh_flush_bytes")
        #: flushes SMALLER than this take the host matvec instead of a
        #: device launch (the bottom rung of the routing ladder); 0
        #: disables; bulk-ingest only
        self._host_flush_bytes, hfb_pinned = knob(
            host_flush_bytes, "CEPH_TPU_HOST_FLUSH_BYTES",
            "host_flush_bytes")
        #: which knobs track runtime config pushes (pins do not)
        self._knob_unpinned = {"engine_flush_bytes": not fb_pinned,
                               "engine_window": not w_pinned,
                               "mesh_flush_bytes": not mfb_pinned,
                               "host_flush_bytes": not hfb_pinned}
        #: device launches so far: launch n runs on window slot
        #: n % (the window when it launches)
        self._launch_seq = 0
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._running = True
        self.stats = {"flushes": 0, "ops": 0, "bytes": 0,
                      "max_batch_ops": 0, "errors": 0,
                      "decode_flushes": 0, "decode_ops": 0,
                      "decode_bytes": 0, "max_decode_batch_ops": 0,
                      "decode_errors": 0, "device_fused_fallbacks": 0,
                      # the deepest the in-flight window ever got (>= 2
                      # proves upload/compute/download overlapped)
                      "max_inflight_depth": 0, "mesh_flushes": 0,
                      "mesh_decode_flushes": 0,
                      "placement_flushes": 0,
                      "per_slot_flushes": {},
                      # small flushes routed to the host matvec
                      "host_flushes": 0,
                      # auxiliary device work run via run_sync
                      "aux_runs": 0,
                      # engine-thread seconds spent launching +
                      # finalizing device batches
                      "busy_s": 0.0,
                      # "window:slot" -> device flushes launched on
                      # that slot while the window had that depth
                      "window_slot_flushes": {},
                      # window -> deepest in-flight depth reached while
                      # the window had that value
                      "window_max_depth": {}}
        _telemetry().note_engine_window(self._window)
        #: launch pipeline: deque of (items, finalize, kspans, launch_t,
        #: nbytes) batches launched but not yet harvested, up to
        #: ``window`` deep; the RETIRE thread harvests strictly FIFO
        self._inflight: collections.deque = collections.deque()
        self._ifcv = make_condition("engine.inflight")
        self._retiring = False        # retire thread mid-harvest
        self._retire_stop = False
        self._thread = threading.Thread(
            target=self._run, name="ec-device-engine", daemon=True)
        self._thread.start()
        self._retire_thread = threading.Thread(
            target=self._retire_run, name="ec-device-retire",
            daemon=True)
        self._retire_thread.start()
        # runtime knob observers attach LAST (fully-built engine: the
        # window observer touches the inflight CV)
        self._observe_knob("engine_flush_bytes", self._set_flush_bytes)
        self._observe_knob("engine_window", self._set_window)
        self._observe_knob("mesh_flush_bytes",
                           self._set_mesh_flush_bytes)
        self._observe_knob("host_flush_bytes",
                           self._set_host_flush_bytes)

    # -- runtime knob observers ---------------------------------------
    def _observe_knob(self, option: str, fn) -> None:
        if not self._knob_unpinned[option]:
            return              # an argument or env pin wins
        g_conf().add_observer(option, fn)
        self._cfg_observers.append((option, fn))

    def _set_window(self, _name: str, value) -> None:
        """Runtime window change: widening wakes launchers blocked in
        _wait_window; shrinking takes effect at their next wait check
        (batches already out above the new bound drain naturally — the
        window is a launch gate, not a cap on what is in flight)."""
        with self._ifcv:
            self._window = max(1, int(value))
            self._ifcv.notify_all()
        _telemetry().note_engine_window(self._window)

    def _set_flush_bytes(self, _name: str, value) -> None:
        """Runtime flush-threshold change. The engine loop reads the
        threshold at each staged op; the stager takes it as the size
        of its NEXT segment (a segment holds whole ops, so no staged
        op is cut, and the open segment keeps its size). Pinned host
        memory for staging then scales with the threshold."""
        value = max(1, int(value))
        if self._stager is not None:
            with self._stager.lock:
                self._stager.seg_bytes = value
        self._flush_bytes = value

    def _set_mesh_flush_bytes(self, _name: str, value) -> None:
        self._mesh_flush_bytes = max(0, int(value))

    def _set_host_flush_bytes(self, _name: str, value) -> None:
        self._host_flush_bytes = max(0, int(value))

    # -- dispatch routing (per-OSD when shared) -----------------------
    def _dispatch(self, key, fn) -> None:
        if isinstance(key, AttachedKey):
            d = self._dispatchers.get(key[0])
            if d is None:
                log(1, "dropping continuation for detached engine "
                    f"attachment {key[0]}")
                return
            d(key[1], fn)
            return
        self._dispatch_default(key, fn)

    def register_dispatcher(self, token: int, dispatch) -> None:
        self._dispatchers[token] = dispatch
        _telemetry().note_attached_osds(len(self._dispatchers))

    def unregister_dispatcher(self, token: int) -> None:
        self._dispatchers.pop(token, None)
        _telemetry().note_attached_osds(len(self._dispatchers))

    # -- batched continuation dispatch --------------------------------
    def _dispatch_entries(self, entries) -> None:
        """Dispatch a retired flush's continuations: one wrapper per
        distinct key (batched mode) sharing a FlushGroup, or one
        callable per op. ``entries`` is ordered [(key, fn)]."""
        if not self._bulk:
            for key, fn in entries:
                self._dispatch(key, fn)
            return
        by_key: dict = {}
        for key, fn in entries:
            by_key.setdefault(key, []).append(fn)
        group = FlushGroup(len(by_key), self._last_group)
        self._last_group = group
        self._last_group_event = group.event

        for key, fns in by_key.items():
            def run(fns=fns, group=group):
                _group_tls.group = group
                try:
                    for fn in fns:
                        try:
                            fn()
                        except Exception as exc:
                            log(0, f"batched continuation failed: "
                                f"{exc!r}")
                finally:
                    _group_tls.group = None
                    group.done()
            run._profile_stage = "commit_wait"
            self._dispatch(key, run)

    def _after_last_group(self, cb) -> None:
        """Run ``cb`` after the most recently dispatched flush group has
        shipped (immediately when there is none)."""
        group = self._last_group
        if group is not None and self._bulk:
            group.after_flush(cb)
        else:
            cb()

    # -- producer side (op-shard threads) -----------------------------
    @staticmethod
    def _note_staged_flow(cont, nbytes: int) -> None:
        """Tenant attribution at the staging seam: the producer's flow
        label rides the continuation."""
        ft = _flows.flows_if_active()
        if ft is None:
            return
        cont._flow = _flows.current_flow() or ""
        ft.note_engine_staged(cont._flow, nbytes)

    def stage_encode(self, key, codec, sinfo: ec_util.StripeInfo,
                     data: np.ndarray,
                     cont: Callable[[dict | None, dict | None,
                                     Exception | None], None],
                     span=NOOP, clock=_stage_clock.NOOP) -> None:
        """Queue one op's stripe-aligned payload for batched device
        encode; ``cont(shards, crcs, err)`` is dispatched on ``key``
        (crcs = per-shard LINEAR crc parts computed on the device from
        the same buffers, or None; err set and shards None on a device
        failure). ``clock``: the op's StageClock — the engine marks
        engine_stage_wait / device_window_wait / device_finalize on
        it."""
        # HBM ledger: bytes enter the staged bucket here and leave it
        # at launch (-> in-window) or on a launch fault (-> retired)
        _telemetry().note_hbm(staged_delta=data.nbytes)
        self._note_staged_flow(cont, data.nbytes)
        pslot = _placement_slot(key)
        _telemetry().note_slot_staged(pslot, data.nbytes)
        if self._stager is not None:
            # zero-copy staging: the payload lands in the signature's
            # concat buffer NOW, on this producer thread. The queue put
            # rides the stager lock so per-signature slot order ==
            # queue order.
            ref = _StagedRef(data.nbytes)
            with self._stager.lock:
                self._stager.append_locked(codec, pslot, data)
                self._q.put(("enc", key, codec, sinfo, ref, cont,
                             span, clock, _time.monotonic(), pslot))
            return
        self._q.put(("enc", key, codec, sinfo, data, cont, span,
                     clock, _time.monotonic(), pslot))

    def stage_barrier(self, key, fn: Callable[[], None]) -> None:
        """Queue an ordering barrier: ``fn`` dispatches on ``key`` after
        every previously staged op's continuation."""
        self._q.put(("bar", key, fn))

    def stage_decode(self, key, codec, sinfo: ec_util.StripeInfo,
                     shards: dict[int, np.ndarray], want: list[int],
                     cont: Callable[[dict | None, Exception | None],
                                    None], span=NOOP,
                     clock=_stage_clock.NOOP) -> None:
        """Queue a reconstruct of ``want`` chunk streams from the
        surviving ``shards``; ``cont(decoded, err)`` runs INLINE on the
        engine thread (it must be cheap — typically it publishes the
        result and sets an event for a blocked decode_sync caller)."""
        _telemetry().note_hbm(staged_delta=_shards_nbytes(shards))
        self._note_staged_flow(cont, _shards_nbytes(shards))
        pslot = _placement_slot(key)
        _telemetry().note_slot_staged(pslot, _shards_nbytes(shards))
        self._q.put(("dec", key, codec, sinfo, shards, want, cont,
                     span, clock, _time.monotonic(), pslot))

    def decode_sync(self, key, codec, sinfo: ec_util.StripeInfo,
                    shards: dict[int, np.ndarray], want: list[int],
                    timeout: float = 60.0,
                    span=NOOP,
                    clock=_stage_clock.NOOP) -> dict[int, np.ndarray] | None:
        """Blocking decode through the batched engine; returns the
        decoded {chunk: bytes} map or None on a device fault or timeout.
        Safe to call from op-worker threads: the continuation runs on
        the engine thread, not the caller's."""
        ev = threading.Event()
        box: list = [None, None]

        def cont(out, err):
            box[0], box[1] = out, err
            ev.set()

        self.stage_decode(key, codec, sinfo, shards, want, cont,
                          span=span, clock=clock)
        if not ev.wait(timeout):
            log(0, f"device decode timed out after {timeout}s")
            self.stats["decode_errors"] += 1
            return None
        if box[1] is not None:
            return None
        return box[0]

    def run_sync(self, fn: Callable[[], object],
                 timeout: float = 120.0):
        """Run ``fn`` on the engine thread after everything staged
        before it has flushed and retired, and return its result.
        Raises what ``fn`` raises; raises TimeoutError when the engine
        is stopped or wedged."""
        ev = threading.Event()
        box: list = [None, None]
        self._q.put(("run", fn, box, ev))
        if not ev.wait(timeout):
            raise TimeoutError("device engine run_sync timed out")
        if box[1] is not None:
            raise box[1]
        return box[0]

    def stop(self) -> None:
        # detach the knob observers first: a tuner push must not land
        # an attribute write on an engine that is tearing down
        for option, fn in self._cfg_observers:
            g_conf().remove_observer(option, fn)
        self._cfg_observers = []
        self._running = False
        self._q.put(None)
        self._thread.join(timeout=10)
        with self._ifcv:
            self._retire_stop = True
            self._ifcv.notify_all()
        self._retire_thread.join(timeout=10)
        # the last flush group ships on a dispatch worker: wait for
        # that ship so nothing chained behind it is dropped
        ev = self._last_group_event
        if ev is not None and not ev.wait(10):
            log(1, "engine stop: last flush group never shipped")

    # -- retire thread ------------------------------------------------
    def _retire_run(self) -> None:
        """Harvest launched batches strictly FIFO on a dedicated thread:
        while batch N's finalize waits HERE, the engine thread keeps
        staging and launching batches N+1.."""
        while True:
            with self._ifcv:
                while not self._inflight and not self._retire_stop:
                    self._ifcv.wait()
                if not self._inflight and self._retire_stop:
                    return
                entry = self._inflight.popleft()
                self._retiring = True
                self._ifcv.notify_all()
            try:
                self._retire_one(entry)
            finally:
                with self._ifcv:
                    self._retiring = False
                    self._ifcv.notify_all()

    # -- engine thread ------------------------------------------------
    def _run(self) -> None:
        while True:
            pidle = _prof.push_stage("idle")
            item = self._q.get()
            _prof.pop_stage(pidle)
            if item is None:
                self._drain_inflight()
                return
            # (id(codec), placement slot) -> (codec, sinfo, slot, items)
            pending: dict[tuple, tuple] = {}
            # (id(codec), present, want, slot) -> state
            dec_pending: dict[tuple, tuple] = {}
            nbytes = 0
            while True:
                if item is None:
                    self._flush(pending)
                    self._flush_decodes(dec_pending)
                    self._drain_inflight()
                    return
                if item[0] == "enc":
                    (_, key, codec, sinfo, data, cont, span, clock,
                     ts, pslot) = item
                    _dsp.telemetry().note_handoff(
                        "engine_stage", _time.monotonic() - ts)
                    _, _, _, items = pending.setdefault(
                        (id(codec), pslot), (codec, sinfo, pslot, []))
                    items.append((key, data, cont, span, clock, ts))
                    nbytes += data.nbytes
                    if nbytes >= self._flush_bytes:
                        # flush BOTH kinds: the byte counter is shared,
                        # and a staged decode left behind would wait
                        # while its decode_sync caller blocks
                        self._flush(pending)
                        self._flush_decodes(dec_pending)
                        pending, dec_pending, nbytes = {}, {}, 0
                elif item[0] == "dec":
                    (_, key, codec, sinfo, shards, want, cont, span,
                     clock, ts, pslot) = item
                    _dsp.telemetry().note_handoff(
                        "engine_stage", _time.monotonic() - ts)
                    sig = (id(codec),
                           tuple(sorted(shards)), tuple(sorted(want)),
                           pslot)
                    _, _, _, items = dec_pending.setdefault(
                        sig, (codec, sinfo, pslot, []))
                    items.append((key, shards, want, cont, span,
                                  clock, ts))
                    nbytes += sum(np.asarray(v).nbytes
                                  for v in shards.values())
                    if nbytes >= self._flush_bytes:
                        self._flush(pending)
                        self._flush_decodes(dec_pending)
                        pending, dec_pending, nbytes = {}, {}, 0
                elif item[0] == "run":
                    # auxiliary device work: runs after the in-flight
                    # batches drain
                    self._flush(pending)
                    self._flush_decodes(dec_pending)
                    self._drain_inflight()
                    pending, dec_pending, nbytes = {}, {}, 0
                    _, fn, box, ev = item
                    t0 = _time.perf_counter()
                    prev_stage = _prof.push_stage("scrub")
                    try:
                        box[0] = fn()
                    except Exception as exc:
                        box[1] = exc
                    finally:
                        _prof.pop_stage(prev_stage)
                    self.stats["aux_runs"] += 1
                    self.stats["busy_s"] += _time.perf_counter() - t0
                    ev.set()
                else:                        # barrier
                    self._flush(pending)
                    self._flush_decodes(dec_pending)
                    # the barrier fn must run AFTER every prior op's
                    # continuation: drain the launch pipeline first
                    self._drain_inflight()
                    pending, dec_pending, nbytes = {}, {}, 0
                    _, key, fn = item
                    # ...and after the last flush group SHIPPED
                    self._after_last_group(
                        lambda key=key, fn=fn:
                        self._dispatch(key, fn))
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    # nothing else queued: launch what we have now (an
                    # idle engine adds no batching latency); the RETIRE
                    # thread harvests it
                    self._flush(pending)
                    self._flush_decodes(dec_pending)
                    pending, dec_pending, nbytes = {}, {}, 0
                    break
            # shutdown is the None sentinel, NOT self._running: ops
            # staged before stop() must still flush

    def _flush(self, pending: dict) -> None:
        if not pending:
            return
        prev_stage = _prof.push_stage("engine_stage_wait")
        try:
            self._flush_inner(pending)
        finally:
            _prof.pop_stage(prev_stage)

    def _flush_inner(self, pending: dict) -> None:
        t0 = _time.perf_counter()
        for codec, sinfo, pslot, items in pending.values():
            if self._stager is not None:
                # zero-copy staging: detach the consumed prefix of the
                # signature's concat buffer as one view
                batch, views = self._stager.take(codec, pslot,
                                                 len(items))
                nbytes = batch.nbytes
            else:
                batch = None
                views = [d for _k, d, _c, _s, _cl, _t in items]
                nbytes = sum(d.nbytes for d in views)
            _telemetry().note_slot_staged(pslot, -nbytes)
            # SMALL flushes route to the HOST matvec, encoded at
            # finalize time on the RETIRE thread, riding the same FIFO
            # as device batches
            host = (self._bulk and nbytes < self._host_flush_bytes
                    and ec_util.host_flushable(codec))
            if batch is not None:
                _telemetry().note_staging_copies_avoided(nbytes)
            if not host:
                batcher = ec_util.StripeBatcher(
                    sinfo, codec, on_fallback=self._note_fused_fallback)
                for i, buf in enumerate(views):
                    batcher.append(i, buf)
                if batch is not None:
                    batcher.set_preconcat(batch)
            # window backpressure BEFORE the launch: with window=1 batch
            # N+1 launches only after N fully retired
            window = self._wait_window()
            if not host:
                # Slot invariant: while the window holds still, launch
                # n's slot was last used by launch n - window, which
                # retired before n passed _wait_window. Across a window
                # change two in-flight launches may share a slot; its
                # stream runs them in order (and the caching allocator
                # reuses a block only after that stream's earlier
                # work), so they serialize and never race.
                slot = self._launch_seq % window
                self._launch_seq += 1
                key = f"{window}:{slot}"
                wsf = self.stats["window_slot_flushes"]
                wsf[key] = wsf.get(key, 0) + 1
            try:
                _faults.engine_fault("launch")
                if host:
                    finalize = ec_util.flush_host_async(
                        sinfo, codec, list(range(len(views))),
                        views, batch=batch)
                    self.stats["host_flushes"] += 1
                else:
                    with _launch_context(codec, slot):
                        finalize = batcher.flush_async(
                            with_crcs=ec_util.fuse_crc_policy(codec))
            except Exception as exc:
                # launch failed: older batches' continuations must still
                # run BEFORE these error continuations — ride the SAME
                # in-flight FIFO as a poison entry whose finalize raises
                def _poison(exc=exc):
                    raise exc
                kspans = [span.child("kernel_dispatch")
                          for _k, _d, _c, span, _cl, _t in items]
                self._park((items, _poison, kspans,
                            _time.perf_counter(), nbytes))
                continue
            if _TP_FLUSH.enabled:
                _TP_FLUSH(len(items), nbytes)
            launched = _time.monotonic()
            tel = _telemetry()
            kspans = []
            for _key, _data, _cont, span, clock, ts in items:
                # queue wait = stage -> launch
                tel.note_queue_wait("encode", launched - ts)
                clock.mark("engine_stage_wait", t=launched)
                if span is not NOOP:   # no formatting when untraced
                    span.event(f"batch_flush ops={len(items)} "
                               f"bytes={nbytes}")
                kspans.append(span.child("kernel_dispatch"))
            entry = (items, finalize, kspans,
                     _time.perf_counter(), nbytes)
            if host and not self._inflight and not self._retiring:
                # light-load fast path: nothing in flight, so FIFO order
                # is trivially kept — retire the host flush INLINE
                tel.note_hbm(staged_delta=-nbytes,
                             inflight_delta=nbytes)
                self._retire_one(entry)
            else:
                self._park(entry)
        if pending:
            with self._ifcv:
                self.stats["busy_s"] += _time.perf_counter() - t0
        pending.clear()

    def _wait_window(self) -> int:
        """Block until the launch window has a free slot (counting a
        batch mid-harvest); returns the window it was free in."""
        with self._ifcv:
            while len(self._inflight) + \
                    (1 if self._retiring else 0) >= self._window:
                self._ifcv.wait()
            return self._window

    def _park(self, entry) -> None:
        """Hand a launched (or poison) batch to the retire thread:
        staged -> in-window on the HBM ledger; the byte count rides the
        entry so retirement reconciles it on both outcomes."""
        nbytes = entry[-1]
        tel = _telemetry()
        tel.note_hbm(staged_delta=-nbytes, inflight_delta=nbytes)
        with self._ifcv:
            self._inflight.append(entry)
            depth = len(self._inflight) + \
                (1 if self._retiring else 0)
            window = self._window
            self._ifcv.notify_all()
        self.stats["max_inflight_depth"] = max(
            self.stats["max_inflight_depth"], depth)
        wmd = self.stats["window_max_depth"]
        wmd[window] = max(wmd.get(window, 0), depth)
        tel.note_inflight_depth(depth)
        tel.note_engine_inflight(depth)

    def _drain_inflight(self) -> float:
        """Wait until the retire thread has harvested EVERY in-flight
        batch (ordering points: barrier, run_sync, stop)."""
        with self._ifcv:
            while self._inflight or self._retiring:
                self._ifcv.wait()
        return 0.0

    def _retire_one(self, entry) -> float:
        """Harvest one in-flight batch (wait for its device work, split
        the results, dispatch its continuations); returns seconds spent
        (also accumulated into busy_s). Runs on the retire thread, or
        inline on the engine thread for an idle host flush."""
        prev_stage = _prof.push_stage("device_finalize")
        t0 = _time.perf_counter()
        harvest_t = _time.monotonic()
        (items, finalize, kspans, launch_t, nbytes) = entry
        for _key, _data, _cont, _span, clock, _ts in items:
            clock.mark("device_window_wait", t=harvest_t)
        try:
            results = finalize()
        except Exception as exc:
            log(0, f"device encode batch of {len(items)} ops "
                f"failed: {exc!r}")
            self.stats["errors"] += 1
            entries = []
            for (key, _data, cont, span, _clock, _ts), kspan in \
                    zip(items, kspans):
                kspan.event(f"device_error {exc!r}")
                kspan.set_error(f"engine_launch: {exc!r}")
                kspan.finish()
                span.set_error(f"engine_launch: {exc!r}")
                span.finish()
                entries.append((key, _bind(cont, None, None, exc)))
            self._dispatch_entries(entries)
            results = None
        if results is not None:
            done_t = _time.monotonic()
            self.stats["flushes"] += 1
            self.stats["ops"] += len(items)
            self.stats["bytes"] += nbytes
            self.stats["max_batch_ops"] = max(
                self.stats["max_batch_ops"], len(items))
            if self._counters is not None:
                self._counters.inc("device_batches")
                self._counters.inc("device_batch_ops", len(items))
            entries = []
            for (key, _data, cont, span, clock, _ts), \
                    (_i, shards, crcs), kspan in zip(items, results,
                                                     kspans):
                if crcs is not None:
                    kspan.event("crc_pass")
                kspan.finish()
                span.finish()
                clock.mark("device_finalize", t=done_t)
                entries.append((key, _bind(cont, shards, crcs, None)))
            self._dispatch_entries(entries)
            _telemetry().note_encode_flush(
                len(items), nbytes, _time.perf_counter() - t0,
                trace_id=_first_trace_id(items, span_idx=3))
        dt = _time.perf_counter() - t0
        # overlap: launch -> harvest-begin passed while the engine did
        # OTHER work; the remainder of the lifetime is this harvest
        tel = _telemetry()
        tel.note_overlap(t0 - launch_t,
                         _time.perf_counter() - launch_t)
        tel.note_engine_retired()
        tel.note_engine_inflight(len(self._inflight))
        # the batch's bytes leave the window on BOTH outcomes — the
        # gauges-to-zero invariant
        tel.note_hbm(inflight_delta=-nbytes, retired=nbytes)
        with self._ifcv:     # busy_s has two writers (launch/retire)
            self.stats["busy_s"] += dt
        _prof.pop_stage(prev_stage)
        return dt

    def _note_fused_fallback(self, path: str, exc: Exception) -> None:
        """The reference counts a fused flush that fell back to the
        plain path here. The port's ``StripeBatcher`` raises instead and
        never calls it; it is kept as the ``on_fallback`` it is handed."""
        self.stats["device_fused_fallbacks"] += 1
        _telemetry().note_fused_fallback()
        if self._counters is not None:
            self._counters.inc("device_fused_fallbacks")

    def _flush_decodes(self, dec_pending: dict) -> None:
        """One device product per erasure signature: every queued op of
        a signature shares the decode matrix, so their shard streams
        concatenate along the byte axis into a single launch.
        Continuations run inline (see stage_decode)."""
        if not dec_pending:
            return
        prev_stage = _prof.push_stage("device_finalize")
        try:
            self._flush_decodes_inner(dec_pending)
        finally:
            _prof.pop_stage(prev_stage)

    def _flush_decodes_inner(self, dec_pending: dict) -> None:
        for (_cid, present, want, pslot), \
                (codec, sinfo, _slot, items) in dec_pending.items():
            launched = _time.monotonic()
            t0 = _time.perf_counter()
            tel = _telemetry()
            # staged bytes leave the ledger here: whatever happens below
            # (decode or fault), this group's buffers are done
            staged = sum(_shards_nbytes(shards)
                         for _k, shards, _w, _c, _s, _cl, _t in items)
            tel.note_hbm(staged_delta=-staged, retired=staged)
            tel.note_slot_staged(pslot, -staged)
            for _key, _shards, _want, _cont, span, clock, ts in items:
                tel.note_queue_wait("decode", launched - ts)
                clock.mark("engine_stage_wait", t=launched)
                if span is not NOOP:   # no formatting when untraced
                    span.event(f"decode_flush ops={len(items)} "
                               f"sig={list(present)}->{list(want)}")
            try:
                _faults.engine_fault("decode")
                merged = {
                    c: np.concatenate(
                        [np.asarray(shards[c], dtype=np.uint8)
                         for _k, shards, _w, _c, _s, _cl, _t in items])
                    for c in present}
                lens = [len(np.asarray(shards[present[0]]))
                        for _k, shards, _w, _c, _s, _cl, _t in items]
                out = ec_util.decode(sinfo, codec, merged, list(want))
            except Exception as exc:
                log(0, f"device decode batch of {len(items)} ops "
                    f"(sig {present}->{want}) failed: {exc!r}")
                self.stats["decode_errors"] += 1
                for (_key, _shards, _want, cont, span, _clock,
                     _ts) in items:
                    span.event(f"device_error {exc!r}")
                    span.set_error(f"engine_decode: {exc!r}")
                    span.finish()
                    cont(None, exc)
                continue
            if _TP_DECODE_FLUSH.enabled:
                _TP_DECODE_FLUSH(len(items), str(present))
            nbytes = sum(ln * len(present) for ln in lens)
            self.stats["decode_flushes"] += 1
            self.stats["decode_ops"] += len(items)
            self.stats["decode_bytes"] += nbytes
            self.stats["max_decode_batch_ops"] = max(
                self.stats["max_decode_batch_ops"], len(items))
            if self._counters is not None:
                self._counters.inc("device_decode_batches")
                self._counters.inc("device_decode_ops", len(items))
            tel.note_decode_flush(
                len(items), nbytes, _time.perf_counter() - t0,
                trace_id=_first_trace_id(items, span_idx=4))
            done_t = _time.monotonic()
            off = 0
            for (_key, _shards, _want, cont, span, clock, _ts), ln \
                    in zip(items, lens):
                span.event("decode_done")
                span.finish()
                clock.mark("device_finalize", t=done_t)
                cont({c: v[off:off + ln] for c, v in out.items()},
                     None)
                off += ln
        dec_pending.clear()


def _first_trace_id(items, span_idx: int) -> str | None:
    """First traced op's trace_id in a flush batch — the histogram
    exemplar candidate (NOOP spans carry an empty trace_id)."""
    for it in items:
        tid = getattr(it[span_idx], "trace_id", "")
        if tid:
            return tid
    return None


def _shards_nbytes(shards: dict) -> int:
    """Byte count of one staged decode's survivor map — the SAME
    expression on the staging and retiring side, so the HBM ledger
    reconciles exactly."""
    return sum(np.asarray(v).nbytes for v in shards.values())


class AttachedKey(tuple):
    """(attach token, key): routes a shared-engine continuation to the
    attaching OSD's dispatcher while hashing like a tuple. A plain
    tuple subclass so it stays hashable and cheap."""
    __slots__ = ()


class EngineHandle:
    """One OSD's view of the process-wide shared engine: the same
    surface as a private DeviceEncodeEngine (stage_*, decode_sync,
    run_sync, stats, stop), with every key wrapped in this attachment's
    token so continuations land on the owner OSD's dispatcher. ``stop``
    detaches; the engine itself stops when the last attachment
    leaves."""

    def __init__(self, engine: DeviceEncodeEngine, token: int) -> None:
        self.engine = engine
        self._token = token
        self._detached = False

    @property
    def stats(self) -> dict:
        return self.engine.stats

    def _key(self, key) -> AttachedKey:
        return AttachedKey((self._token, key))

    def stage_encode(self, key, *a, **kw) -> None:
        self.engine.stage_encode(self._key(key), *a, **kw)

    def stage_barrier(self, key, fn) -> None:
        self.engine.stage_barrier(self._key(key), fn)

    def stage_decode(self, key, *a, **kw) -> None:
        self.engine.stage_decode(self._key(key), *a, **kw)

    def decode_sync(self, key, *a, **kw):
        return self.engine.decode_sync(self._key(key), *a, **kw)

    def run_sync(self, fn, timeout: float = 120.0):
        return self.engine.run_sync(fn, timeout)

    def stop(self) -> None:
        """Detach this OSD: drain everything staged so far (its
        continuations are dispatched before the dispatcher goes), then
        stop the engine if this was the last attachment."""
        if self._detached:
            return
        self._detached = True
        try:
            # a run_sync flushes all pending work and drains the
            # in-flight window on the engine thread
            self.engine.run_sync(lambda: None, timeout=30)
        except Exception:
            pass
        _detach(self.engine, self._token)


_shared_lock = make_lock("engine.shared_service")
_shared_engine: DeviceEncodeEngine | None = None
_attach_seq = 0


def shared_engine_attach(dispatch, flush_bytes: int | None = None
                         ) -> EngineHandle:
    """Attach one OSD to the process-wide shared engine: co-located OSDs
    feed ONE device pipeline, so cross-OSD flushes aggregate into bigger
    batches. Creates the engine on first attach, restarts it if a
    previous generation fully detached."""
    global _shared_engine, _attach_seq
    with _shared_lock:
        eng = _shared_engine
        if eng is None or not eng._running:
            eng = _shared_engine = DeviceEncodeEngine(
                None, flush_bytes=flush_bytes)
        _attach_seq += 1
        token = _attach_seq
        eng.register_dispatcher(token, dispatch)
        return EngineHandle(eng, token)


def _detach(engine: DeviceEncodeEngine, token: int) -> None:
    global _shared_engine
    stop = False
    with _shared_lock:
        engine.unregister_dispatcher(token)
        if not engine._dispatchers:
            stop = True
            if _shared_engine is engine:
                _shared_engine = None
    if stop:
        engine.stop()


def _bind(cont, shards, crcs, err):
    # re-install the flow label stamped at stage time (the retire thread
    # has no tenant context of its own)
    flow = getattr(cont, "_flow", "")

    def fn():
        with _flows.flow_scope(flow or None):
            cont(shards, crcs, err)

    fn._profile_stage = "commit_wait"
    return fn
