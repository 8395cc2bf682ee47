"""Store-path telemetry — the commit-path X-ray (ISSUE 14).

``commit_wait`` has been the dominant stage of every gap report since
PR 6, and ROADMAP item 1 names its three fixes (group-commit stores, a
streaming objecter, real-wire bulk framing) — but the stage timeline
used to END at one ``commit_wait`` mark: everything below it was a
black box. This module is the measurement layer underneath that mark,
in the measure-don't-assume spirit of the online-EC SSD study
(arXiv:1709.05365): instrument where commits actually stall and
quantify the batching opportunity BEFORE rebuilding the machinery.

Three instruments share the process-wide ``store`` PerfCounters
registry:

1. **Txn lifecycle decomposition** — every
   ``ObjectStore.queue_transaction`` (memstore / blockstore / kstore)
   runs under a :class:`TxnTimer` that clocks the commit's sub-stages:
   ``queue_wait`` (store serialization point), ``apply`` (mutate /
   payload staging), ``kv_build`` (metadata batch construction),
   ``wal_append`` (WAL record write+flush, recorded by
   ``store/kv.FileDB``), ``fsync`` (every durability barrier, counted
   + timed PER CALL SITE through the :func:`timed_fsync` /
   :func:`timed_fdatasync` / :func:`timed_sync` seam — the lint in
   ``analysis/linters.py`` forbids untimed fsyncs under
   ``ceph_tpu/store/``), and ``on_commit`` (completion-callback
   dispatch). Sub-stage sums == the txn's commit span (injectable
   clock; pinned in tests/test_store_telemetry.py).

2. **Group-commit what-if ledger** — txn arrival timestamps ring-
   buffered per store instance; :meth:`group_commit_projection`
   replays them under configurable adjacency windows and reports how
   many fsyncs a ``queue_local_txn_group``-style group commit WOULD
   have shared (projected fsyncs-saved + wall-saved). On a memstore
   run (no real fsyncs) the projection prices barriers with the
   durable-store profile and says so (``fsync_model``).

3. **Objecter submission-stream ledger** — the client leg still
   submits per-op (ROADMAP 1b); :func:`note_objecter_submit` records
   per-(pool, PG) submit arrivals + live in-flight depth, and
   :meth:`objecter_adjacency` computes how many in-flight ops a
   streaming submission seam would coalesce per batch (size histogram
   ``objecter_batch_ops``).

Export: ``dump_store`` asok on every OSD, ``/api/store`` + a
dashboard panel, prometheus for free (the registry lives in the
process PerfCounters collection), a ``store`` brief on cluster bench
metric lines, and the ``commit path`` table + ``what_if`` object in
``tools/gap_report.py``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from ceph_tpu_torch.utils.perf_counters import PerfCounters, collection

#: the txn commit sub-stages, in canonical commit order
SUB_STAGES = ("queue_wait", "apply", "kv_build", "wal_append",
              "fsync", "on_commit")

#: one-line glossary (dump_store + BASELINE.md "Reading the commit
#: path")
GLOSSARY = {
    "queue_wait": "wait to enter the store's txn serialization point",
    "apply": "mutation/staging work (validate, payload append, dict "
             "mutate)",
    "kv_build": "metadata kv-batch construction",
    "wal_append": "WAL record encode + write + flush (pre-fsync)",
    "fsync": "durability barriers (fsync/fdatasync), via the timed "
             "seam",
    "on_commit": "commit-callback dispatch",
}

#: adjacency windows (seconds) the what-if ledgers replay by default;
#: override with CEPH_TPU_WHATIF_WINDOWS_MS="0.5,2,10"
_DEFAULT_WINDOWS_S = (0.0005, 0.002, 0.010)

#: durable-store barrier profile used when the measured run had no
#: real fsyncs (memstore): blockstore's commit discipline is one data
#: fdatasync + one WAL fsync per txn, and a mid-2020s NVMe flush is
#: ~0.5 ms — the projection LABELS itself with the model it used
_PROFILE_FSYNCS_PER_TXN = 2.0
_PROFILE_FSYNC_S = 5e-4

#: bounds on the side tables (a pathological caller must not grow the
#: dump without bound)
_MAX_STORES = 64
_MAX_ARRIVALS = 4096
_MAX_PGS = 512
_MAX_PG_ARRIVALS = 1024
_MAX_SITES = 64


def whatif_windows_s() -> tuple[float, ...]:
    raw = os.environ.get("CEPH_TPU_WHATIF_WINDOWS_MS", "")
    if not raw:
        return _DEFAULT_WINDOWS_S
    try:
        out = tuple(float(p) / 1e3 for p in raw.split(",") if p.strip())
        return out or _DEFAULT_WINDOWS_S
    except ValueError:
        return _DEFAULT_WINDOWS_S


class StoreTelemetry:
    """Process-wide commit-path counters (one per process, like the
    device and dataplane registries — daemons share the process)."""

    def __init__(self, name: str = "store") -> None:
        self.name = name
        self._lock = threading.Lock()
        perf = collection().get(name)
        if perf is None:
            perf = collection().create(name)
            self._declare(perf)
        self.perf = perf
        #: fsync call site -> {"count", "seconds", "bytes"}
        self._fsync_sites: dict[str, dict] = {}
        #: (kind, store id) -> deque[(arrival_t, fsyncs, fsync_s)] —
        #: the group-commit what-if ledger, one ring per store
        #: instance (adjacency only means anything within ONE store)
        self._arrivals: dict[tuple[str, int], deque] = {}
        #: (pool, ps) -> deque[submit_t] — the objecter stream ledger
        self._pg_arrivals: dict[tuple[int, int], deque] = {}
        #: (pool, ps) -> live in-flight op count on the client
        self._pg_inflight: dict[tuple[int, int], int] = {}

    @staticmethod
    def _declare(perf: PerfCounters) -> None:
        perf.add_u64_counter("txns", "store transactions committed")
        perf.add_histogram("txn_ops", "ops per store transaction")
        # one time_avg (exact sums for share math) + one pow2-us
        # histogram (p99s) per sub-stage — literal keys so the
        # registry-drift lint sees registration and update agree
        perf.add_time_avg("txn_queue_wait", GLOSSARY["queue_wait"])
        perf.add_histogram("txn_queue_wait_us", GLOSSARY["queue_wait"])
        perf.add_time_avg("txn_apply", GLOSSARY["apply"])
        perf.add_histogram("txn_apply_us", GLOSSARY["apply"])
        perf.add_time_avg("txn_kv_build", GLOSSARY["kv_build"])
        perf.add_histogram("txn_kv_build_us", GLOSSARY["kv_build"])
        perf.add_time_avg("txn_wal_append", GLOSSARY["wal_append"])
        perf.add_histogram("txn_wal_append_us", GLOSSARY["wal_append"])
        perf.add_time_avg("txn_fsync", GLOSSARY["fsync"])
        perf.add_histogram("txn_fsync_us", GLOSSARY["fsync"])
        perf.add_time_avg("txn_on_commit", GLOSSARY["on_commit"])
        perf.add_histogram("txn_on_commit_us", GLOSSARY["on_commit"])
        perf.add_u64_counter("fsyncs", "durability barriers issued "
                             "(fsync + fdatasync, all sites)")
        perf.add_u64_counter("fsync_bytes",
                             "bytes made durable per barrier, summed")
        perf.add_time_avg("fsync_time",
                          "wall seconds per durability barrier")
        # the objecter submission-stream ledger (ROADMAP 1b's
        # measurement): live depth at submit + the coalescable batch
        # sizes the windowed analysis computes
        perf.add_u64_counter("objecter_ops",
                             "client ops through the stream ledger")
        perf.add_histogram("objecter_pg_inflight",
                           "in-flight ops on the op's (pool, PG) at "
                           "submit (live streaming opportunity)")
        perf.add_histogram("objecter_batch_ops",
                           "ops per would-be streaming batch under "
                           "the default adjacency window")
        # ROADMAP item 1 landed (ISSUE 15): the measured twins of the
        # two what-if ledgers above — group commits the stores
        # actually formed, and MOSDOpBatch frames the streaming
        # objecter actually shipped
        perf.add_u64_counter("store_group_commits",
                             "txn groups committed under one shared "
                             "barrier set (queue_transaction_group)")
        perf.add_histogram("store_group_size",
                           "txns per committed group")
        perf.add_u64_counter("objecter_stream_batches",
                             "batched MOSDOp frames the streaming "
                             "objecter shipped")
        perf.add_histogram("objecter_stream_batch_ops",
                           "ops per shipped streaming batch")

    # -- txn lifecycle -------------------------------------------------
    def txn_timer(self, kind: str, store_id: int = 0,
                  now=None) -> "TxnTimer":
        """A sub-stage clock for one ``queue_transaction`` call.
        ``now`` injects a clock for tests (defaults to
        ``time.perf_counter``)."""
        return TxnTimer(self, kind, store_id,
                        now if now is not None else time.perf_counter)

    def note_txn(self, kind: str, store_id: int, arrival_t: float,
                 n_ops: int, durations: dict[str, float],
                 fsyncs: int, fsync_s: float,
                 n_txns: int = 1) -> None:
        """One committed txn's decomposition lands in the registry
        and its arrival in the group-commit ledger. ``n_txns > 1``
        marks a group commit: the group counts as ``n_txns`` logical
        txns (so ``fsyncs_per_txn`` reflects the sharing) but ONE
        arrival/commit in the adjacency ledger."""
        self.perf.inc("txns", max(n_txns, 1))
        self.perf.hinc("txn_ops", n_ops)
        if n_txns > 1:
            self.perf.inc("store_group_commits")
            self.perf.hinc("store_group_size", n_txns)
        for stage, dt in durations.items():
            if stage in SUB_STAGES and dt >= 0:
                self.perf.tinc(f"txn_{stage}", dt)
                self.perf.hinc(f"txn_{stage}_us", dt * 1e6)
        key = (kind, store_id)
        with self._lock:
            ring = self._arrivals.get(key)
            if ring is None:
                if len(self._arrivals) >= _MAX_STORES:
                    self._arrivals.pop(next(iter(self._arrivals)))
                ring = self._arrivals[key] = deque(
                    maxlen=_MAX_ARRIVALS)
            ring.append((arrival_t, fsyncs, fsync_s))

    def note_fsync(self, site: str, seconds: float,
                   nbytes: int = 0) -> None:
        """One durability barrier at ``site`` (the named-seam
        accounting every fsync in ceph_tpu/store/ must go through)."""
        self.perf.inc("fsyncs")
        if nbytes:
            self.perf.inc("fsync_bytes", nbytes)
        self.perf.tinc("fsync_time", seconds)
        with self._lock:
            ent = self._fsync_sites.get(site)
            if ent is None:
                if len(self._fsync_sites) >= _MAX_SITES:
                    self._fsync_sites.pop(
                        next(iter(self._fsync_sites)))
                ent = self._fsync_sites[site] = {
                    "count": 0, "seconds": 0.0, "bytes": 0}
            ent["count"] += 1
            ent["seconds"] = round(ent["seconds"] + seconds, 9)
            ent["bytes"] += nbytes

    # -- group-commit what-if ------------------------------------------
    def group_commit_projection(
            self, windows_s: tuple[float, ...] | None = None) -> list:
        """Replay the recorded txn arrivals under each adjacency
        window: txns whose arrivals fall within ``window`` of a group
        leader (per store instance) would have shared ONE barrier set
        under ``queue_local_txn_group``-style group commit. Returns
        one dict per window with projected fsyncs/wall saved."""
        if windows_s is None:
            windows_s = whatif_windows_s()
        with self._lock:
            rings = {k: list(v) for k, v in self._arrivals.items()}
        total_txns = sum(len(r) for r in rings.values())
        total_fsyncs = sum(f for r in rings.values()
                           for _, f, _ in r)
        total_fsync_s = sum(s for r in rings.values()
                            for _, _, s in r)
        # price barriers with measured reality when the run had real
        # fsyncs, else with the durable-store profile — labeled
        if total_fsyncs > 0:
            fsyncs_per_txn = total_fsyncs / max(total_txns, 1)
            fsync_cost_s = total_fsync_s / total_fsyncs
            model = "measured"
        else:
            fsyncs_per_txn = _PROFILE_FSYNCS_PER_TXN
            fsync_cost_s = _PROFILE_FSYNC_S
            model = "durable_profile"
        out = []
        for window in windows_s:
            groups = 0
            grouped_txns = 0
            max_group = 0
            for ring in rings.values():
                ts = sorted(t for t, _, _ in ring)
                i = 0
                while i < len(ts):
                    j = i
                    while j < len(ts) and ts[j] - ts[i] <= window:
                        j += 1
                    groups += 1
                    grouped_txns += j - i
                    max_group = max(max_group, j - i)
                    i = j
            saved_txn_barriers = grouped_txns - groups
            fsyncs_saved = saved_txn_barriers * fsyncs_per_txn
            out.append({
                "window_ms": round(window * 1e3, 3),
                "txns": total_txns,
                "groups": groups,
                "max_group": max_group,
                "fsyncs_saved": round(fsyncs_saved, 1),
                "wall_saved_s": round(fsyncs_saved * fsync_cost_s, 6),
                "fsync_model": model,
            })
        return out

    # -- objecter stream ledger ----------------------------------------
    def note_objecter_submit(self, pool: int, ps: int,
                             t: float | None = None) -> None:
        key = (int(pool), int(ps))
        self.perf.inc("objecter_ops")
        with self._lock:
            ring = self._pg_arrivals.get(key)
            if ring is None:
                if len(self._pg_arrivals) >= _MAX_PGS:
                    self._pg_arrivals.pop(
                        next(iter(self._pg_arrivals)))
                ring = self._pg_arrivals[key] = deque(
                    maxlen=_MAX_PG_ARRIVALS)
            ring.append(time.monotonic() if t is None else t)
            depth = self._pg_inflight.get(key, 0) + 1
            self._pg_inflight[key] = depth
        self.perf.hinc("objecter_pg_inflight", depth)

    def note_stream_batch(self, n_ops: int) -> None:
        """One batched MOSDOp frame actually shipped by the streaming
        objecter (the measured twin of ``objecter_batch_ops``)."""
        self.perf.inc("objecter_stream_batches")
        self.perf.hinc("objecter_stream_batch_ops", n_ops)

    def note_objecter_done(self, pool: int, ps: int) -> None:
        key = (int(pool), int(ps))
        with self._lock:
            depth = self._pg_inflight.get(key, 0) - 1
            if depth <= 0:
                self._pg_inflight.pop(key, None)
            else:
                self._pg_inflight[key] = depth

    def objecter_adjacency(
            self, window_s: float | None = None) -> dict:
        """The streaming-objecter what-if: group each (pool, PG)'s
        submit arrivals under ``window_s``; each group is one batch a
        streaming seam would have coalesced into one framed submit.
        Feeds the ``objecter_batch_ops`` histogram."""
        if window_s is None:
            window_s = whatif_windows_s()[-1]
        with self._lock:
            rings = {k: sorted(v) for k, v in
                     self._pg_arrivals.items()}
        batches = 0
        ops = 0
        coalescable = 0
        max_batch = 0
        sizes: list[int] = []
        for ts in rings.values():
            i = 0
            while i < len(ts):
                j = i
                while j < len(ts) and ts[j] - ts[i] <= window_s:
                    j += 1
                size = j - i
                batches += 1
                ops += size
                coalescable += size - 1
                max_batch = max(max_batch, size)
                sizes.append(size)
                i = j
        for size in sizes:
            self.perf.hinc("objecter_batch_ops", size)
        return {
            "window_ms": round(window_s * 1e3, 3),
            "pgs": len(rings),
            "ops": ops,
            "batches": batches,
            "mean_batch": round(ops / batches, 2) if batches else 0.0,
            "max_batch": max_batch,
            "coalescable_ops": coalescable,
        }

    # -- views ---------------------------------------------------------
    def txn_breakdown(self) -> dict:
        """Per-sub-stage mean + share of the summed txn commit span
        (the gap report's commit-path store table)."""
        snap = self.perf.dump()
        total = sum(snap[f"txn_{s}"]["sum"] for s in SUB_STAGES)
        out = {"txns": snap["txns"], "span_s": round(total, 6),
               "stages": {}}
        for stage in SUB_STAGES:
            ent = snap[f"txn_{stage}"]
            if not ent["avgcount"]:
                continue
            out["stages"][stage] = {
                "mean_us": round(ent["avg"] * 1e6, 1),
                "share_pct": round(100.0 * ent["sum"] / total, 1)
                if total else 0.0,
            }
        return out

    def fsync_sites(self) -> dict:
        with self._lock:
            return {s: dict(v) for s, v in self._fsync_sites.items()}

    def snapshot(self) -> dict:
        """Full JSON-able view (the ``dump_store`` asok payload)."""
        return {"glossary": dict(GLOSSARY),
                "counters": self.perf.dump(),
                "txn_breakdown": self.txn_breakdown(),
                "fsync_sites": self.fsync_sites(),
                "group_commit": self.group_commit_projection(),
                "objecter_stream": self.objecter_adjacency()}

    def snapshot_brief(self) -> dict:
        """Compact view for bench metric lines: scalar facts only."""
        c = self.perf.dump()
        brief = {"txns": c["txns"], "fsyncs": c["fsyncs"]}
        if c["txns"]:
            brief["fsyncs_per_txn"] = round(c["fsyncs"] / c["txns"], 2)
        ft = c.get("fsync_time") or {}
        if ft.get("avgcount"):
            brief["fsync_time_s"] = round(ft["sum"], 4)
        if c["objecter_ops"]:
            brief["objecter_ops"] = c["objecter_ops"]
        groups = c.get("store_group_commits", 0)
        if groups:
            sizes = c.get("store_group_size") or []
            grouped = sum(n * (1 << max(i - 1, 0))
                          for i, n in enumerate(sizes))
            brief["group_commits"] = groups
            # pow2 buckets: the reconstructed mean is a lower bound,
            # good enough for the brief's at-a-glance group size
            brief["mean_group_size"] = round(grouped / groups, 1)
        batches = c.get("objecter_stream_batches", 0)
        if batches:
            sizes = c.get("objecter_stream_batch_ops") or []
            ops = sum(n * (1 << max(i - 1, 0))
                      for i, n in enumerate(sizes))
            brief["stream_batches"] = batches
            brief["mean_stream_batch"] = round(ops / batches, 1)
        return brief

    def reset(self) -> None:
        """Test/report hook: drop the logger and side tables (a fresh
        telemetry() call re-creates both)."""
        collection().remove(self.name)
        global _telemetry
        with _module_lock:
            _telemetry = None


def sweep_completions(cbs) -> None:
    """Run a group's commit callbacks in submission order; one
    failing ack must not starve the rest of the group (the OSD's old
    merged-callback wrapper's guard, now owned by the store layer)."""
    for cb in cbs:
        if cb is None:
            continue
        try:
            cb()
        except Exception as exc:
            from ceph_tpu_torch.utils.dout import Dout
            Dout("store")(0, f"group commit callback failed: {exc!r}")


class TxnTimer:
    """Sub-stage clock for one ``queue_transaction`` call.

    Usage (see the three stores)::

        tmr = store_telemetry.txn_timer("kstore", id(self))
        with tmr:                      # publishes as the thread's
            with tmr.stage("apply"):   # current timer: FileDB and the
                ...                    # fsync seam record into it
            tmr.run_on_commit(on_commit)
        # registry lands at __exit__: sub-stage sums == commit span

    The timer is also the thread-local rendezvous for the layers the
    store calls into: ``store/kv.FileDB`` records ``wal_append`` and
    the :func:`timed_fsync` seam records ``fsync`` into the CURRENT
    timer when one is active (else straight into the registry).
    """

    __slots__ = ("_tel", "kind", "store_id", "_now", "arrival_t",
                 "start_t", "durations", "fsyncs", "fsync_s", "_prev",
                 "n_ops", "n_txns")

    def __init__(self, tel: StoreTelemetry, kind: str, store_id: int,
                 now) -> None:
        self._tel = tel
        self.kind = kind
        self.store_id = store_id
        self._now = now
        self.arrival_t = time.monotonic()
        self.start_t = now()
        self.durations: dict[str, float] = {}
        self.fsyncs = 0
        self.fsync_s = 0.0
        self._prev = None
        self.n_ops = 0
        self.n_txns = 1       # >1: a queue_transaction_group commit

    def now(self) -> float:
        return self._now()

    # -- spans ---------------------------------------------------------
    def stage(self, name: str) -> "_StageSpan":
        return _StageSpan(self, name)

    def add(self, name: str, dt: float) -> None:
        if dt > 0:
            self.durations[name] = self.durations.get(name, 0.0) + dt

    def mark_wait(self, name: str, t0: float) -> None:
        """Record now - t0 as ``name`` (the lock-acquisition idiom:
        stamp before ``with lock:``, mark first inside it)."""
        self.add(name, self.now() - t0)

    def add_fsync(self, site: str, seconds: float,
                  nbytes: int = 0) -> None:
        self.add("fsync", seconds)
        self.fsyncs += 1
        self.fsync_s += seconds
        self._tel.note_fsync(site, seconds, nbytes)

    def run_on_commit(self, cb) -> None:
        """Dispatch the commit callback under the ``on_commit``
        span (None-tolerant)."""
        if cb is None:
            return
        with self.stage("on_commit"):
            cb()

    def run_on_commit_sweep(self, cbs) -> None:
        """The group-commit completion sweep: every callback of the
        group, in submission order, under ONE ``on_commit`` span. A
        failing callback is logged and must not starve the rest of
        the group's acks."""
        if not cbs:
            return
        with self.stage("on_commit"):
            sweep_completions(cbs)

    # -- thread-local current-timer protocol ---------------------------
    def __enter__(self) -> "TxnTimer":
        self._prev = getattr(_tls, "timer", None)
        _tls.timer = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _tls.timer = self._prev
        if exc_type is None:
            self._tel.note_txn(self.kind, self.store_id,
                               self.arrival_t, self.n_ops,
                               self.durations, self.fsyncs,
                               self.fsync_s, n_txns=self.n_txns)

    def total(self) -> float:
        return sum(self.durations.values())


class _StageSpan:
    __slots__ = ("_tmr", "_name", "_t0")

    def __init__(self, tmr: TxnTimer, name: str) -> None:
        self._tmr = tmr
        self._name = name

    def __enter__(self):
        self._t0 = self._tmr.now()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._tmr.add(self._name, self._tmr.now() - self._t0)


_tls = threading.local()


def current_timer() -> TxnTimer | None:
    """The txn timer active on this thread (how FileDB and the fsync
    seam attribute their work to the enclosing store txn)."""
    return getattr(_tls, "timer", None)


# -- the named timed-fsync seam ---------------------------------------
# Every durability barrier under ceph_tpu/store/ MUST go through one
# of these three (the untimed-fsync lint in analysis/linters.py is the
# enforcement): count, bytes, and wall time land per call site, and
# inside a queue_transaction they also land on the txn's fsync span.

def _record(site: str, seconds: float, nbytes: int) -> None:
    tmr = current_timer()
    if tmr is not None:
        tmr.add_fsync(site, seconds, nbytes)
    else:
        telemetry().note_fsync(site, seconds, nbytes)


def timed_fsync(fd: int, site: str, nbytes: int = 0) -> None:
    """``os.fsync`` through the accounting seam (call-time attribute
    lookup, so the lock witness's blocking-call wrapper still sees
    it)."""
    t0 = time.perf_counter()
    os.fsync(fd)
    _record(site, time.perf_counter() - t0, nbytes)


def timed_fdatasync(fd: int, site: str, nbytes: int = 0) -> None:
    """``os.fdatasync`` through the accounting seam."""
    t0 = time.perf_counter()
    os.fdatasync(fd)
    _record(site, time.perf_counter() - t0, nbytes)


def timed_sync(site: str, sync_fn, nbytes: int = 0) -> None:
    """Time an opaque durability barrier (the native data engine's
    ``ioeng_sync``, whose fdatasync lives in C)."""
    t0 = time.perf_counter()
    sync_fn()
    _record(site, time.perf_counter() - t0, nbytes)


def note_wal_append(seconds: float, nbytes: int = 0) -> None:
    """One WAL record written+flushed (store/kv.FileDB.submit):
    attributed to the current txn when one is active."""
    tmr = current_timer()
    if tmr is not None:
        tmr.add("wal_append", seconds)
    else:
        tel = telemetry()
        tel.perf.tinc("txn_wal_append", seconds)
        tel.perf.hinc("txn_wal_append_us", seconds * 1e6)


_module_lock = threading.Lock()
_telemetry: StoreTelemetry | None = None


def telemetry() -> StoreTelemetry:
    global _telemetry
    with _module_lock:
        if _telemetry is None:
            _telemetry = StoreTelemetry()
        return _telemetry


def telemetry_if_exists() -> StoreTelemetry | None:
    """The registry only if someone already created it (diagnostic
    consumers — autopsies — must not allocate one)."""
    with _module_lock:
        return _telemetry


def register_asok(asok) -> None:
    """``dump_store`` on every daemon that owns a store."""
    asok.register_command(
        "dump_store", lambda a: telemetry().snapshot(),
        "commit-path telemetry: txn sub-stage decomposition, fsync "
        "call sites, group-commit + objecter what-if ledgers")
