"""Device-path telemetry — PerfCounters for the EC device pipeline. A
copy of ``ceph_tpu/utils/device_telemetry.py``: the port's engine
(``osd/device_engine.py``) feeds the flush, window and HBM counters, and
the fused flush (``osd/ec_util.py``) calls :meth:`timed_call` under its
``fused_crc[...]`` signature (no jit behind it: the first call of a
signature counts as its compile). The reference's persistent compile-cache
ledger has no counterpart here: the port's kernel libraries are named by
a hash of their source (``ops/cuda_build.py``). The reference's
description follows.

The paper's metric is encode/decode GB/s, but a number that moves
needs an explanation: batching and data-movement effects dominate the
online-EC hot path (arXiv:1709.05365) and per-stage timing is what
makes a pipelined code debuggable (arXiv:1207.6744). Ceph's answer is
PerfCounters + ``perf dump``; this module is that answer for the
device path — one process-wide registry fed by:

- the Pallas/XLA compile entry points (``ops/gf_pallas``,
  ``ops/gf_block_sparse``, ``models/clay_device``,
  ``parallel/sharded_codec``): per-codec-signature compile counts and
  compile wall time. A signature that compiles MORE THAN ONCE is a
  bug-class signal (an unbucketed shape leaking into a jit cache —
  the recompile storm every device entry point is designed to
  prevent), surfaced as the ``recompiles`` counter;
- ``osd/device_engine.py``: batch-occupancy histograms for
  stage_encode/stage_decode flushes, flush sizes, the queue-wait vs
  device-time latency split, bytes encoded/decoded, fused-path
  fallbacks;
- ``models/clay_device.build_decode_matvec``: sparse-vs-dense
  calibration outcomes (winner + measured timings, per signature);
- ``models/clay.py``: linearized-transform LRU hits/misses;
- the port's set-up phases (``note_setup``: kernel library loads in
  ``ops/cuda_build.load``, Clay's calibration and encode tables), and
  every ``utils/lru.BoundedLRU``'s hits, misses and evictions by cache
  name, in the snapshot.

Counters are ALWAYS ON and cheap (one lock, integer adds); the
per-signature side tables are bounded dicts. ``snapshot()`` is the
JSON-able view served by the ``device perf dump`` admin command, the
mgr dashboard's device panel, and the telemetry field bench.py
attaches to every metric line. The plain counters also live in the
process PerfCounters collection under the ``device`` logger, so
``perf dump`` and the prometheus exporter pick them up for free.
"""

from __future__ import annotations

import threading
import time

from ceph_tpu_torch.utils.perf_counters import PerfCounters, collection

#: bound on the per-signature side tables (compiles / calibrations):
#: signatures are O(erasure signatures x shape buckets) in practice,
#: but a pathological caller must not grow the dump without bound
_MAX_SIGNATURES = 256


class DeviceTelemetry:
    """Process-wide device-path counters (one per process, like the
    reference's per-daemon PerfCounters — the device is per-process
    here, so the registry is too)."""

    def __init__(self, name: str = "device") -> None:
        self.name = name
        self._lock = threading.Lock()
        perf = collection().get(name)
        if perf is None:
            perf = collection().create(name)
            self._declare(perf)
        self.perf = perf
        #: signature -> {"compiles": n, "seconds": total}
        self._compiles: dict[str, dict] = {}
        #: "label|signature" -> calibration outcome dict
        self._calibrations: dict[str, dict] = {}
        #: signature -> compiled cost analysis (flops/bytes_accessed)
        self._costs: dict[str, dict] = {}
        #: set-up phase -> {"seconds": total, "count": n}
        self._setup: dict[str, dict] = {}
        #: exact live-byte mirrors of the hbm gauges (kept here so
        #: the peak update is race-free under one lock)
        self._hbm_staged = 0
        self._hbm_inflight = 0
        self._hbm_peak = 0
        #: placement slot -> live staged bytes (ISSUE 13: the tuner's
        #: chip-load signal for load-aware PG->slot weighting); bytes
        #: enter at stage time and leave at flush take, so idle reads
        #: all-zero like the hbm gauges
        self._slot_staged: dict[int, int] = {}

    @staticmethod
    def _declare(perf: PerfCounters) -> None:
        perf.add_u64_counter("compiles",
                             "device kernel/program compilations")
        perf.add_u64_counter("recompiles",
                             "signatures compiled more than once "
                             "(shape leaking into a jit cache)")
        perf.add_time_avg("compile_time",
                          "wall seconds per compilation")
        perf.add_u64_counter("compile_cache_hits",
                             "kernel libraries this process found "
                             "built (build ledger)")
        perf.add_u64_counter("compile_cache_misses",
                             "kernel libraries this process ran nvcc "
                             "for (build ledger)")
        perf.add_histogram("encode_batch_ops",
                           "ops per stage_encode flush (occupancy)")
        perf.add_histogram("decode_batch_ops",
                           "ops per stage_decode flush (occupancy)")
        perf.add_histogram("flush_bytes",
                           "payload bytes per encode flush")
        perf.add_time_avg("encode_queue_wait",
                          "stage_encode -> flush launch wait")
        perf.add_time_avg("decode_queue_wait",
                          "stage_decode -> flush launch wait")
        perf.add_time_avg("flush_device_time",
                          "engine-thread seconds per encode-flush "
                          "harvest (device wait + download + "
                          "continuation dispatch)")
        perf.add_time_avg("decode_flush_device_time",
                          "engine-thread seconds per decode flush")
        perf.add_u64_counter("bytes_encoded",
                             "payload bytes through device encode")
        perf.add_u64_counter("bytes_decoded",
                             "shard bytes through device decode")
        perf.add_u64_counter("fused_fallbacks",
                             "mesh/fused flush paths that fell back")
        perf.add_u64_counter("engine_decode_fallbacks",
                             "degraded-read/recovery decodes that fell "
                             "back from the batched engine route to "
                             "the host twin (ISSUE 8: silent before)")
        perf.add_u64_counter("calibrations",
                             "sparse-vs-dense on-device calibrations")
        perf.add_u64_counter("calibrations_sparse_won",
                             "calibrations the sparse kernel won")
        perf.add_u64_counter("lin_matvec_hits",
                             "clay linearized-transform LRU hits")
        perf.add_u64_counter("lin_matvec_misses",
                             "clay linearized-transform LRU builds")
        perf.add_u64_counter("mesh_dispatches",
                             "multi-chip sharded-codec step calls")
        # pod-scale sharded serving (ISSUE 12): how much of the data
        # path actually rode the mesh, and through which compile seam
        perf.add_u64_counter("mesh_flushes",
                             "engine encode flushes routed through "
                             "the sharded mesh step")
        perf.add_u64_counter("mesh_decode_flushes",
                             "signature-batched decode flushes "
                             "(degraded reads / recovery) routed "
                             "through the mesh twin")
        perf.add_u64_counter("mesh_scrub_batches",
                             "deep-scrub verify launches routed "
                             "through the mesh twin")
        perf.add_u64_counter("placement_flushes",
                             "flushes launched on a PG-placement "
                             "slot's submesh (disjoint chips per "
                             "slot; overlapped in the engine window)")
        perf.add_gauge("placement_slots",
                       "slots in the active PG->chip placement map "
                       "(0 = no map: single-chip or placement off)")
        perf.add_u64_counter("mesh_compile_pjit",
                             "mesh steps compiled through the "
                             "jit+in_shardings (pjit) seam")
        perf.add_u64_counter("mesh_compile_shard_map",
                             "mesh steps compiled through the "
                             "shard_map fallback shim")
        # pipelined engine (osd/device_engine.py): launch-window
        # accounting — depth proves batches overlap, overlap-pct is
        # the share of a batch's device lifetime hidden behind other
        # engine work (100% = the download wait fully overlapped)
        perf.add_histogram("engine_inflight_depth",
                           "launched-not-retired batches at each "
                           "flush launch (window occupancy)")
        perf.add_histogram("engine_overlap_pct",
                           "percent of a batch's launch->retire "
                           "lifetime spent overlapped with other "
                           "engine work")
        # stall detection inputs (mgr/health.py ENGINE_STALL): the
        # health engine reads the current window occupancy and checks
        # the retirement counter for progress over its window
        perf.add_gauge("engine_inflight",
                       "launched-not-retired batches right now")
        perf.add_gauge("engine_window",
                       "configured launch-window depth (0 = no "
                       "engine constructed yet)")
        perf.add_u64_counter("engine_retired",
                             "batches retired (downloaded + "
                             "continuations dispatched)")
        # deep-scrub engine (osd/scrub_engine.py): the background-
        # verification pipeline's own accounting
        perf.add_u64_counter("scrub_batches",
                             "deep-scrub device verify launches")
        perf.add_u64_counter("scrub_bytes_verified",
                             "shard bytes through the fused crc + "
                             "parity-re-encode verify pass")
        perf.add_u64_counter("scrub_mismatch_stripes",
                             "objects flagged by the device mismatch "
                             "bitmap / crc vector")
        perf.add_u64_counter("scrub_repaired_shards",
                             "shards rebuilt by deep-scrub sparse "
                             "decode + recovery push")
        perf.add_u64_counter("scrub_host_fallbacks",
                             "objects judged by the host shallow "
                             "oracle (device fault or ambiguous "
                             "conviction)")
        perf.add_histogram("scrub_batch_objs",
                           "objects per deep-scrub verify launch")
        perf.add_time_avg("scrub_device_time",
                          "wall seconds per deep-scrub verify launch")
        # live HBM accounting (osd/device_engine.py): every buffer
        # byte the engine holds is in exactly one of staged (queued,
        # pre-launch) or in-window (launched, not retired); both
        # gauges reconcile to 0 at idle — the shutdown-safety bar the
        # PR-6 queue-depth gauges set — and the peak gauges feed the
        # HBM_PRESSURE health check (mgr/health.py)
        perf.add_gauge("hbm_staged_bytes",
                       "payload bytes queued in the engine, not yet "
                       "launched")
        perf.add_gauge("hbm_inflight_bytes",
                       "payload bytes in launched-not-retired "
                       "batches (the pipeline window's working set)")
        perf.add_gauge("hbm_live_bytes",
                       "staged + in-window bytes (the HBM_PRESSURE "
                       "input)")
        perf.add_gauge("hbm_peak_live_bytes",
                       "high-water mark of hbm_live_bytes")
        perf.add_u64_counter("hbm_retired_bytes",
                             "bytes that left the launch window "
                             "(downloaded or failed over)")
        # bulk-ingest data plane (ISSUE 9)
        perf.add_u64_counter("staging_copies_avoided_bytes",
                             "flush bytes handed to the device as one "
                             "preconcatenated staging view (no flush-"
                             "time np.concatenate on the engine "
                             "thread)")
        perf.add_gauge("attached_osds",
                       "OSDs attached to the shared device engine "
                       "(0 = per-OSD engines / none attached)")

    # -- bulk-ingest accounting (ISSUE 9) -----------------------------
    def note_staging_copies_avoided(self, nbytes: int) -> None:
        self.perf.inc("staging_copies_avoided_bytes", nbytes)

    def note_attached_osds(self, n: int) -> None:
        self.perf.set_gauge("attached_osds", n)

    # -- compile accounting -------------------------------------------
    def note_compile(self, signature: str, seconds: float) -> None:
        """One compilation of ``signature`` took ``seconds`` wall.
        The second compile of the same signature counts a recompile —
        the bug-class every pow2-bucketed entry point exists to
        prevent. (``compile_cache_hits`` / ``compile_cache_misses``
        count kernel libraries found built or built with ``nvcc``:
        ``utils/compile_cache.note_build``.)"""
        self.perf.inc("compiles")
        self.perf.tinc("compile_time", seconds)
        with self._lock:
            ent = self._compiles.get(signature)
            if ent is None:
                if len(self._compiles) >= _MAX_SIGNATURES:
                    self._compiles.pop(next(iter(self._compiles)))
                ent = self._compiles[signature] = {"compiles": 0,
                                                   "seconds": 0.0}
            ent["compiles"] += 1
            ent["seconds"] += seconds
            recompiled = ent["compiles"] > 1
        if recompiled:
            self.perf.inc("recompiles")

    def compile_count(self, signature: str) -> int:
        with self._lock:
            ent = self._compiles.get(signature)
            return ent["compiles"] if ent else 0

    def timed_call(self, signature: str, fn, *args, **kwargs):
        """Call a jitted device entry point, accounting a compile when
        the jit cache grows underneath it (``_cache_size`` on jitted
        functions); falls back to first-call-per-signature counting on
        runtimes without that introspection. The non-compiling path
        costs two attribute loads and a perf_counter pair."""
        cache_size = getattr(fn, "_cache_size", None)
        before = None
        if cache_size is not None:
            try:
                before = cache_size()
            except Exception:
                cache_size = None
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        dt = time.perf_counter() - t0
        if cache_size is not None:
            try:
                if cache_size() > before:
                    self.note_compile(signature, dt)
            except Exception:
                pass
        else:
            with self._lock:
                seen = signature in self._compiles
            if not seen:
                self.note_compile(signature, dt)
        return out

    # -- engine flush accounting --------------------------------------
    def note_encode_flush(self, ops: int, nbytes: int,
                          device_s: float,
                          trace_id: str | None = None) -> None:
        """``trace_id`` (a traced op riding the flush) attaches as the
        histogram-bucket exemplar: a dashboard's outlier flush bucket
        links straight to a kept trace (ISSUE 10)."""
        self.perf.hinc("encode_batch_ops", ops, exemplar=trace_id)
        self.perf.hinc("flush_bytes", nbytes, exemplar=trace_id)
        self.perf.tinc("flush_device_time", device_s)
        self.perf.inc("bytes_encoded", nbytes)

    def note_decode_flush(self, ops: int, nbytes: int,
                          device_s: float,
                          trace_id: str | None = None) -> None:
        self.perf.hinc("decode_batch_ops", ops, exemplar=trace_id)
        self.perf.tinc("decode_flush_device_time", device_s)
        self.perf.inc("bytes_decoded", nbytes)

    def note_queue_wait(self, kind: str, seconds: float) -> None:
        self.perf.tinc(f"{kind}_queue_wait", seconds)

    def note_fused_fallback(self) -> None:
        self.perf.inc("fused_fallbacks")

    def note_decode_fallback(self) -> None:
        """A degraded read / recovery decode left the batched engine
        route for the host twin (device fault, timeout, or injected
        failure) — previously invisible; the degraded path's health
        depends on this staying near zero."""
        self.perf.inc("engine_decode_fallbacks")

    def note_inflight_depth(self, depth: int) -> None:
        """Launch-window occupancy at one flush launch (pipelined
        engine): depth >= 2 is the proof batches overlap."""
        self.perf.hinc("engine_inflight_depth", depth)

    def note_engine_window(self, window: int) -> None:
        """An engine came up with this launch-window depth."""
        self.perf.set_gauge("engine_window", window)

    def note_engine_inflight(self, depth: int) -> None:
        """Current launched-not-retired count (set on every launch
        AND retire, so the health engine sees saturation live)."""
        self.perf.set_gauge("engine_inflight", depth)

    def note_engine_retired(self) -> None:
        self.perf.inc("engine_retired")

    def note_overlap(self, overlapped_s: float,
                     lifetime_s: float) -> None:
        """One retired batch's overlap: ``overlapped_s`` of its
        ``lifetime_s`` launch->retire window passed while the engine
        did other work (staging/launching younger batches) instead of
        blocking on this one's download."""
        if lifetime_s <= 0:
            return
        pct = int(round(100.0 * max(0.0, min(overlapped_s,
                                             lifetime_s))
                        / lifetime_s))
        self.perf.hinc("engine_overlap_pct", pct)

    # -- codec-layer accounting ---------------------------------------
    def note_calibration(self, label: str, signature: str,
                         winner: str, measured: dict) -> None:
        """One build_decode_matvec outcome: which path won this
        signature on this chip and what both paths measured."""
        self.perf.inc("calibrations")
        if winner == "sparse":
            self.perf.inc("calibrations_sparse_won")
        with self._lock:
            if len(self._calibrations) >= _MAX_SIGNATURES:
                self._calibrations.pop(next(iter(self._calibrations)))
            self._calibrations[f"{label}|{signature}"] = {
                "winner": winner, **measured}

    def note_lin_matvec(self, hit: bool) -> None:
        self.perf.inc("lin_matvec_hits" if hit else "lin_matvec_misses")

    def note_setup(self, phase: str, seconds: float) -> None:
        """``seconds`` of the port's own set-up in ``phase``: a kernel
        library's load (with its ``nvcc`` build when it was not on disk,
        ``kernel_load``), a repair signature's calibration
        (``calibration``), Clay's encode tables (``b3_tables``)."""
        with self._lock:
            ent = self._setup.setdefault(phase, {"seconds": 0.0,
                                                 "count": 0})
            ent["seconds"] += seconds
            ent["count"] += 1

    def setup_seconds(self) -> dict[str, dict]:
        with self._lock:
            return {p: dict(v) for p, v in self._setup.items()}

    def note_mesh_dispatch(self) -> None:
        self.perf.inc("mesh_dispatches")

    # -- pod-scale sharded serving (ISSUE 12) -------------------------
    def note_mesh_flush(self, kind: str) -> None:
        """One engine flush routed through the mesh: ``kind`` is
        "encode" or "decode" (the two data-path twins)."""
        self.perf.inc("mesh_flushes" if kind == "encode"
                      else "mesh_decode_flushes")

    def note_mesh_scrub_batch(self) -> None:
        self.perf.inc("mesh_scrub_batches")

    def note_placement_flush(self) -> None:
        self.perf.inc("placement_flushes")

    def note_placement_slots(self, n: int) -> None:
        self.perf.set_gauge("placement_slots", n)

    def note_mesh_compile(self, path: str) -> None:
        """One mesh step built: which compile seam produced it."""
        self.perf.inc("mesh_compile_pjit" if path == "pjit"
                      else "mesh_compile_shard_map")

    def note_cost(self, signature: str, cost: dict) -> None:
        """One compiled cost analysis (ops/cost_model.analyze): the
        per-signature FLOPs/bytes table the dashboard and ``device
        perf dump`` serve next to the compile table."""
        with self._lock:
            if signature not in self._costs and \
                    len(self._costs) >= _MAX_SIGNATURES:
                self._costs.pop(next(iter(self._costs)))
            self._costs[signature] = dict(cost)

    # -- HBM accounting (osd/device_engine.py) ------------------------
    def note_hbm(self, staged_delta: int = 0,
                 inflight_delta: int = 0, retired: int = 0) -> None:
        """Move bytes between the engine's HBM buckets. Every staged
        byte is later either launched (staged->inflight) or abandoned
        (staged->out); every launched byte retires — so live bytes
        read 0 at idle (asserted across cluster lifecycles)."""
        with self._lock:
            self._hbm_staged = max(0, self._hbm_staged + staged_delta)
            self._hbm_inflight = max(
                0, self._hbm_inflight + inflight_delta)
            live = self._hbm_staged + self._hbm_inflight
            self._hbm_peak = max(self._hbm_peak, live)
            staged, inflight, peak = (self._hbm_staged,
                                      self._hbm_inflight,
                                      self._hbm_peak)
        self.perf.set_gauge("hbm_staged_bytes", staged)
        self.perf.set_gauge("hbm_inflight_bytes", inflight)
        self.perf.set_gauge("hbm_live_bytes", staged + inflight)
        self.perf.set_gauge("hbm_peak_live_bytes", peak)
        if retired > 0:
            self.perf.inc("hbm_retired_bytes", retired)

    def hbm_live_bytes(self) -> int:
        with self._lock:
            return self._hbm_staged + self._hbm_inflight

    def note_slot_staged(self, slot: int, delta: int) -> None:
        """Move live staged bytes on one placement slot's ledger
        (floored at zero per slot — the same self-healing the hbm
        gauges use, so an accounting slip decays instead of
        compounding)."""
        with self._lock:
            self._slot_staged[slot] = max(
                0, self._slot_staged.get(slot, 0) + delta)

    def slot_staged_bytes(self) -> dict[int, int]:
        """Per-slot live staged bytes — the queue-depth half of the
        tuner's chip-load signal (HBM pressure is the other half)."""
        with self._lock:
            return dict(self._slot_staged)

    # -- deep-scrub accounting ----------------------------------------
    def note_scrub_flush(self, objs: int, nbytes: int,
                         device_s: float) -> None:
        """One deep-scrub verify launch: ``objs`` objects, ``nbytes``
        shard bytes verified, in ``device_s`` wall seconds."""
        self.perf.inc("scrub_batches")
        self.perf.inc("scrub_bytes_verified", nbytes)
        self.perf.hinc("scrub_batch_objs", objs)
        self.perf.tinc("scrub_device_time", device_s)

    def note_scrub_mismatch(self) -> None:
        self.perf.inc("scrub_mismatch_stripes")

    def note_scrub_repair(self) -> None:
        self.perf.inc("scrub_repaired_shards")

    def note_scrub_host_fallback(self) -> None:
        self.perf.inc("scrub_host_fallbacks")

    # -- export ---------------------------------------------------------
    def snapshot(self) -> dict:
        """The full JSON-able view: counters + per-signature tables
        (the ``device perf dump`` payload)."""
        with self._lock:
            compiles = {s: dict(v) for s, v in self._compiles.items()}
            calibrations = {s: dict(v)
                            for s, v in self._calibrations.items()}
            costs = {s: dict(v) for s, v in self._costs.items()}
        with self._lock:
            slot_staged = dict(self._slot_staged)
        from ceph_tpu_torch.utils.lru import cache_stats
        return {"counters": self.perf.dump(),
                "compiles_by_signature": compiles,
                "calibrations": calibrations,
                "costs_by_signature": costs,
                "slot_staged_bytes": slot_staged,
                "setup_seconds": self.setup_seconds(),
                "caches": cache_stats()}

    def snapshot_brief(self) -> dict:
        """Compact view for bench metric lines: scalar counters plus
        calibration winners, no histograms (a metric line must stay
        one readable line)."""
        counters = self.perf.dump()
        brief = {}
        for key in ("compiles", "recompiles", "compile_cache_hits",
                    "compile_cache_misses", "bytes_encoded",
                    "bytes_decoded", "fused_fallbacks", "calibrations",
                    "calibrations_sparse_won", "lin_matvec_hits",
                    "lin_matvec_misses", "mesh_dispatches",
                    "mesh_flushes", "mesh_decode_flushes",
                    "mesh_scrub_batches", "placement_flushes",
                    "mesh_compile_pjit", "mesh_compile_shard_map",
                    "scrub_batches",
                    "scrub_bytes_verified", "scrub_mismatch_stripes",
                    "scrub_repaired_shards", "scrub_host_fallbacks"):
            val = counters.get(key)
            if val:
                brief[key] = val
        ct = counters.get("compile_time") or {}
        if ct.get("avgcount"):
            brief["compile_time_s"] = round(ct["sum"], 3)
        with self._lock:
            if self._calibrations:
                brief["calibration_winners"] = {
                    s: v["winner"]
                    for s, v in self._calibrations.items()}
        return brief

    def reset(self) -> None:
        """Test hook: drop the logger and side tables (a fresh
        telemetry() call re-creates both)."""
        collection().remove(self.name)
        global _telemetry
        with _module_lock:
            _telemetry = None


_module_lock = threading.Lock()
_telemetry: DeviceTelemetry | None = None


def telemetry() -> DeviceTelemetry:
    global _telemetry
    with _module_lock:
        if _telemetry is None:
            _telemetry = DeviceTelemetry()
        return _telemetry


def register_asok(asok) -> None:
    """The ``device perf dump`` admin command (the device-path
    counterpart of ``perf dump``)."""
    asok.register_command(
        "device perf dump", lambda a: telemetry().snapshot(),
        "device-path telemetry: compiles, flushes, occupancy, "
        "calibration outcomes")
