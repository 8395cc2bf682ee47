"""Typed, schema-driven configuration — the Option/ConfigProxy role.

Reference: src/common/options.cc (1,434 ``Option(`` declarations with
typed defaults, levels, descriptions, see_also) and src/common/config.cc /
config_proxy.h (``g_conf()``). Reproduced: a declarative Option schema, a
layered ConfigProxy (compiled defaults < config file < mon/central <
environment < runtime ``injectargs``-style set), type coercion with
validation, and change observers (md_config_obs_t role) so subsystems get
callbacks when their keys change (the reference's runtime injectargs is at
OSD.cc:6133-6146).
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

LEVELS = ("basic", "advanced", "dev")


class ConfigError(Exception):
    """A config file/layer failed validation as a whole."""

# source precedence, low -> high (config.cc layered sources)
SOURCES = ("default", "file", "mon", "env", "override")


@dataclass(frozen=True)
class Option:
    """One typed option schema entry (options.cc Option builder chain)."""

    name: str
    type: type           # int, float, bool, str
    default: Any
    level: str = "advanced"
    desc: str = ""
    see_also: tuple = ()
    min: Any = None
    max: Any = None
    enum_allowed: tuple = ()

    def coerce(self, value: Any) -> Any:
        if self.type is bool and isinstance(value, str):
            out = value.lower() in ("true", "yes", "1")
        else:
            try:
                out = self.type(value)
            except (TypeError, ValueError):
                raise ValueError(
                    f"option {self.name}: {value!r} is not a {self.type.__name__}")
        if self.min is not None and out < self.min:
            raise ValueError(f"option {self.name}: {out} < min {self.min}")
        if self.max is not None and out > self.max:
            raise ValueError(f"option {self.name}: {out} > max {self.max}")
        if self.enum_allowed and out not in self.enum_allowed:
            raise ValueError(
                f"option {self.name}: {out!r} not in {self.enum_allowed}")
        return out


class OptionSchema:
    def __init__(self) -> None:
        self._options: dict[str, Option] = {}

    def add(self, option: Option) -> Option:
        if option.name in self._options:
            raise ValueError(f"duplicate option {option.name}")
        # validate the default itself
        option.coerce(option.default)
        self._options[option.name] = option
        return option

    def get(self, name: str) -> Option:
        try:
            return self._options[name]
        except KeyError:
            raise KeyError(f"unknown option {name!r}")

    def __contains__(self, name: str) -> bool:
        return name in self._options

    def names(self) -> list[str]:
        return sorted(self._options)


#: the global schema, populated below and by subsystems at import
SCHEMA = OptionSchema()


class ConfigProxy:
    """Layered typed config with observers (config_proxy.h / g_conf())."""

    def __init__(self, schema: OptionSchema = SCHEMA) -> None:
        self.schema = schema
        self._lock = threading.RLock()
        self._values: dict[str, dict[str, Any]] = {s: {} for s in SOURCES}
        self._observers: dict[str, list[Callable[[str, Any], None]]] = {}

    def get(self, name: str) -> Any:
        opt = self.schema.get(name)
        with self._lock:
            for source in reversed(SOURCES):
                if name in self._values[source]:
                    return self._values[source][name]
        return opt.default

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def set(self, name: str, value: Any, source: str = "override") -> None:
        opt = self.schema.get(name)
        if source not in SOURCES:
            raise ValueError(f"unknown config source {source!r}")
        coerced = opt.coerce(value)
        with self._lock:
            old = self.get(name)
            self._values[source][name] = coerced
            new = self.get(name)
            observers = list(self._observers.get(name, ()))
        if new != old:
            for fn in observers:
                fn(name, new)

    def inject_args(self, args: dict[str, Any]) -> None:
        """Runtime overrides (the injectargs path, OSD.cc:6133)."""
        for name, value in args.items():
            self.set(name, value, "override")

    def load_file(self, path: str) -> None:
        """Load a json config file into the 'file' layer.

        All entries are validated (known name, coercible value) before
        any is applied, so a bad entry cannot leave the layer
        half-loaded with observers already fired."""
        with open(path) as f:
            data = json.load(f)
        errors = []
        for name, value in data.items():
            try:
                self.schema.get(name).coerce(value)
            except (KeyError, ValueError, TypeError) as exc:
                errors.append(f"{name}: {exc}")
        if errors:
            raise ConfigError(f"invalid config file {path}: "
                              + "; ".join(errors))
        for name, value in data.items():
            self.set(name, value, "file")

    def load_env(self, prefix: str = "CEPH_TPU_") -> None:
        """Environment layer: CEPH_TPU_<OPTION_NAME>."""
        for name in self.schema.names():
            env = prefix + name.upper()
            if env in os.environ:
                self.set(name, os.environ[env], "env")

    def set_mon_layer(self, values: dict[str, Any]) -> None:
        """Replace the 'mon' source layer wholesale (the MConfig push
        from the ConfigMonitor role): additions, changes AND removals
        land in one swap; observers fire for every effective change.
        Unknown names / uncoercible values are skipped (version skew
        between mon and daemon must not poison the whole push)."""
        coerced: dict[str, Any] = {}
        for name, value in values.items():
            try:
                coerced[name] = self.schema.get(name).coerce(value)
            except (KeyError, ValueError):
                continue
        with self._lock:
            touched = set(self._values["mon"]) | set(coerced)
            old = {n: self.get(n) for n in touched}
            self._values["mon"] = coerced
            fire = []
            for n in touched:
                new = self.get(n)
                if new != old[n]:
                    fire.extend((fn, n, new) for fn in
                                self._observers.get(n, ()))
        for fn, n, new in fire:
            fn(n, new)

    def add_observer(self, name: str,
                     fn: Callable[[str, Any], None]) -> None:
        self.schema.get(name)
        with self._lock:
            self._observers.setdefault(name, []).append(fn)

    def remove_observer(self, name: str,
                        fn: Callable[[str, Any], None]) -> None:
        """Detach an observer (daemons that stop must not leave dead
        callbacks firing into freed engines — the tuner pushes knob
        writes for the process lifetime)."""
        with self._lock:
            obs = self._observers.get(name)
            if obs and fn in obs:
                obs.remove(fn)

    def source_of(self, name: str) -> str:
        """The layer whose value wins for ``name`` ("default" when no
        layer holds it). The tuner uses this to recognize operator
        pins: an 'env' or 'override' value outranks its 'mon'-layer
        pushes, so stepping that knob would be a silent no-op."""
        self.schema.get(name)
        with self._lock:
            for source in reversed(SOURCES):
                if name in self._values[source]:
                    return source
        return "default"

    def dump(self) -> dict[str, Any]:
        return {name: self.get(name) for name in self.schema.names()}

    def diff(self) -> dict[str, Any]:
        """Only values differing from compiled defaults."""
        out = {}
        for name in self.schema.names():
            val = self.get(name)
            if val != self.schema.get(name).default:
                out[name] = val
        return out


# ---------------------------------------------------------------------------
# Core option declarations (the subset of options.cc this framework uses;
# reference defaults preserved where the option mirrors one there)
# ---------------------------------------------------------------------------

for _o in [
    Option("osd_pool_erasure_code_stripe_unit", int, 4096, "advanced",
           "EC stripe unit bytes per chunk per stripe (options.cc:2150-2157)"),
    Option("osd_erasure_code_plugins", str, "jerasure isa shec lrc clay",
           "advanced", "plugins to preload (options.cc:2197)"),
    Option("erasure_code_backend", str, "auto", "advanced",
           "kernel backend: auto|cuda|torch|numpy (cuda: the hand-"
           "written kernels on the card; torch: their plain versions "
           "on the codec's device; numpy: the host GF tables)",
           enum_allowed=("auto", "cuda", "torch", "numpy")),
    Option("bluestore_csum_type", str, "crc32c", "advanced",
           "checksum algorithm (BlueStore.h:1925)",
           enum_allowed=("none", "crc32c", "crc32c_16", "crc32c_8",
                         "xxhash32", "xxhash64")),
    Option("bluestore_csum_block_size", int, 4096, "advanced",
           "checksum granularity"),
    Option("bluestore_compression_algorithm", str, "none", "advanced",
           "blob compression (options.cc bluestore_compression_algorithm)",
           enum_allowed=("none", "zlib", "zstd", "bz2", "lzma",
                         "lz4", "lz4block", "snappy")),
    Option("bluestore_compression_min_blob_size", int, 4096, "advanced",
           "blobs below this are stored raw"),
    Option("bluestore_compression_required_ratio", float, 0.875,
           "advanced",
           "store compressed only if size <= raw * ratio "
           "(options.cc bluestore_compression_required_ratio)"),
    Option("bluestore_debug_inject_read_err", bool, False, "dev",
           "EIO injection on read (options.cc:4343)"),
    Option("bluestore_debug_inject_csum_err_probability", float, 0.0, "dev",
           "random csum corruption probability (options.cc:4375)",
           min=0.0, max=1.0),
    Option("ms_inject_socket_failures", int, 0, "dev",
           "messenger: inject a failure every N messages (qa msgr yamls)"),
    Option("ms_crc_data", bool, True, "advanced",
           "checksum message payloads (Messenger crcflags)"),
    Option("ms_dispatch_throttle_bytes", int, 100 << 20, "advanced",
           "max in-dispatch message bytes before backpressure "
           "(Messenger policy throttler)"),
    Option("osd_op_num_shards", int, 4, "advanced",
           "worker shards of the OSD op queue (op_shardedwq role)"),
    Option("osd_client_op_priority", int, 63, "advanced",
           "WPQ weight of client ops in the sharded op queue "
           "(options.cc osd_client_op_priority)"),
    Option("osd_recovery_op_priority", int, 3, "advanced",
           "WPQ weight of recovery work in the sharded op queue "
           "(options.cc osd_recovery_op_priority — what keeps "
           "recovery from starving client I/O)"),
    Option("osd_scrub_priority", int, 1, "advanced",
           "WPQ weight of scrub/repair work "
           "(options.cc osd_scrub_priority)"),
    Option("osd_recovery_max_single_start", int, 4, "advanced",
           "objects pushed per recovery queue item before yielding "
           "the wq shard back to client ops (options.cc "
           "osd_recovery_max_single_start role)"),
    Option("objecter_resend_interval", float, 2.0, "advanced",
           "client op resend period over the lossy messenger"),
    Option("objecter_resend_max", float, 8.0, "advanced",
           "resend backoff ceiling: per-op delay doubles from "
           "objecter_resend_interval up to this (jittered) — a dead "
           "primary must not be hammered at RTT rate by every parked "
           "client (ISSUE 8)"),
    Option("objecter_stream", bool, True, "advanced",
           "streaming submission seam (ROADMAP 1b): coalesce "
           "concurrent in-flight plain writes per (pool, PG) into "
           "batched MOSDOp frames with one reply sweep; off = every "
           "op frames its own MOSDOp (the pre-15 client leg)"),
    Option("objecter_stream_max_ops", int, 32, "advanced",
           "the streaming batch window: max writes coalesced into "
           "one MOSDOpBatch frame per (pool, PG); 1 disables "
           "coalescing. Tuner-managed (ISSUE 13 registry)",
           min=1, max=1024),
    Option("store_barrier_window_ms", float, 2.0, "advanced",
           "group-commit adjacency window: a HOT barrier leader "
           "(previous fsync round was shared) dwells this long "
           "collecting adjacent commits before syncing — the window "
           "the PR-14 what-if ledger priced; idle commits never pay "
           "it. 0 disables the dwell", min=0.0, max=50.0),
    Option("osd_ec_read_backoff_base", float, 0.02, "advanced",
           "EC shard-read retry ladder: first-retry backoff seconds "
           "(doubles per attempt, full jitter)"),
    Option("osd_ec_read_backoff_max", float, 0.5, "advanced",
           "EC shard-read retry ladder: backoff ceiling seconds"),
    Option("degraded_qos_p99_ms", float, 1500.0, "advanced",
           "the degraded-mode serving QoS bar: client p99 latency "
           "(ms) the load generator holds the cluster to while "
           "recovery makes progress (BASELINE.md 'Degraded-mode "
           "serving')"),
    Option("osd_heartbeat_interval", float, 1.0, "advanced",
           "seconds between peer pings (scaled down from the reference's 6)"),
    Option("osd_heartbeat_grace", float, 4.0, "advanced",
           "seconds before a silent peer is reported failed"),
    Option("osd_max_backfills", int, 2, "advanced",
           "max concurrent recovery/backfill rounds per OSD "
           "(recovery-reservation throttle; reference default 1, "
           "src/common/options.cc osd_max_backfills)"),
    Option("mon_commit_timeout", float, 10.0, "advanced",
           "fail a command whose commit gathers no majority ack "
           "within this many seconds"),
    Option("mon_election_timeout", float, 2.0, "advanced",
           "mon election timeout seconds"),
    Option("auth_rotation_period", float, 3600.0, "advanced",
           "service-key generation length, seconds (CephxKeyServer "
           "rotating-secrets role): tickets carry their generation "
           "and validate only while it is inside the 3-generation "
           "window {previous, current, next}"),
    Option("rbd_cache", bool, False, "advanced",
           "attach an ObjectCacher to opened rbd images "
           "(osdc/ObjectCacher + rbd_cache roles). Default off: the "
           "reference defaults on but pairs it with exclusive-lock "
           "ownership; enable per open(cache=True) or here when a "
           "single writer per image is guaranteed"),
    Option("rbd_cache_size", int, 32 << 20, "advanced",
           "ObjectCacher capacity per opened image, bytes"),
    Option("osd_op_queue", str, "wpq", "advanced",
           "op scheduler: wpq (weighted round-robin shares) or "
           "mclock_scheduler (dmclock reservation/weight/limit — "
           "src/dmclock + options.cc osd_op_queue)",
           enum_allowed=("wpq", "mclock_scheduler")),
    Option("osd_mclock_scheduler_client_res", float, 0.0, "advanced",
           "client reservation, ops/s (0 = none)"),
    Option("osd_mclock_scheduler_client_wgt", float, 63.0, "advanced",
           "client proportional weight"),
    Option("osd_mclock_scheduler_client_lim", float, 0.0, "advanced",
           "client limit, ops/s (0 = unlimited)"),
    Option("osd_mclock_scheduler_background_recovery_res", float,
           10.0, "advanced",
           "recovery reservation, ops/s — the GUARANTEE wpq shares "
           "cannot express (recovery proceeds at >= this rate under "
           "any client load)"),
    Option("osd_mclock_scheduler_background_recovery_wgt", float,
           3.0, "advanced", "recovery proportional weight"),
    Option("osd_mclock_scheduler_background_recovery_lim", float,
           0.0, "advanced", "recovery limit, ops/s (0 = unlimited)"),
    Option("osd_mclock_scheduler_background_best_effort_res", float,
           0.0, "advanced", "scrub/best-effort reservation, ops/s"),
    Option("osd_mclock_scheduler_background_best_effort_wgt", float,
           1.0, "advanced", "scrub/best-effort weight"),
    Option("osd_mclock_scheduler_background_best_effort_lim", float,
           0.0, "advanced", "scrub/best-effort limit, ops/s"),
    Option("crimson_smp", int, 3, "advanced",
           "crimson reactor count (seastar --smp role): shared-nothing "
           "event loops an OSD shards its PGs over; applies to OSDs "
           "started after a change",
           min=1, max=64),
    Option("crimson_flush_bytes", int, 1 << 20, "advanced",
           "crimson engine flush window: bytes staged across the "
           "reactors before an encode flush launches — the ONLY async "
           "boundary on the run-to-completion path, so this trades "
           "stripe-batch amortization directly against commit latency",
           min=64 << 10, max=256 << 20),
    Option("osd_tracing", bool, False, "advanced",
           "arm the 'osd' static-tracepoint provider at daemon start "
           "(TracepointProvider role, src/ceph_osd.cc:36)"),
    Option("oprequest_tracing", bool, False, "advanced",
           "arm the 'oprequest' tracepoint provider"),
    Option("objectstore_tracing", bool, False, "advanced",
           "arm the 'objectstore' tracepoint provider"),
    Option("mon_lease", float, 5.0, "advanced",
           "seconds a peon may serve reads from committed state after "
           "a leader heartbeat/commit grant (Paxos lease, "
           "src/mon/Paxos.h:174; reference default 5)"),
    Option("debug_default_level", int, 1, "advanced",
           "default per-subsystem log level", min=0, max=30),
    Option("log_ring_size", int, 10000, "advanced",
           "in-memory log ring entries kept for crash dump (Log.cc role)"),
    Option("osd_op_complaint_time", float, 30.0, "advanced",
           "seconds before an in-flight op is reported slow "
           "(options.cc osd_op_complaint_time)"),
    Option("op_history_size", int, 20, "advanced",
           "finished ops kept for dump_historic_ops"),
    Option("admin_socket_dir", str, "", "advanced",
           "directory for daemon .asok files (empty = per-daemon tmpdir)"),
    Option("trace_all", bool, False, "dev",
           "dataflow tracing keeps EVERY trace (blkin_trace_all "
           "role; overrides the tail sampler's keep/drop decision)"),
    Option("trace_enabled", bool, True, "advanced",
           "always-on tail-sampled dataflow tracing: every op opens "
           "a real span tree; the keep/drop decision runs at root "
           "completion (false = literal NOOP spans, zero allocations)"),
    Option("trace_sample_every", int, 64, "advanced",
           "head-sample keep rate: every Nth root trace is kept "
           "regardless of outcome (0 disables head sampling)", min=0),
    Option("trace_slow_factor", float, 3.0, "advanced",
           "slowness keep threshold multiplier over the per-op-type "
           "EWMA / dataplane-p99 baseline", min=1.0),
    Option("trace_slow_min_ms", float, 25.0, "advanced",
           "floor (ms) under the adaptive slowness keep threshold — "
           "sub-floor ops are never kept as slow", min=0.0),
    Option("trace_pending_traces", int, 1024, "advanced",
           "traces buffered awaiting their root's tail decision "
           "(fixed memory; overflow evicts oldest)", min=8),
    Option("trace_max_spans", int, 128, "advanced",
           "span cap per trace (pending buffer AND kept record)",
           min=8),
    Option("trace_keep_ring", int, 256, "advanced",
           "kept traces retained for dump/assembly (fixed memory)",
           min=4),
    Option("autopsy_ring_size", int, 32, "advanced",
           "slow-op autopsies retained (timeline + spans + counter "
           "window + fault events per entry)", min=1),
    Option("mgr_trace_archive", int, 512, "advanced",
           "kept traces the mgr trace module archives cluster-wide",
           min=8),
    Option("flight_recorder_enabled", bool, True, "advanced",
           "sample every PerfCounters dict into the counter flight "
           "recorder ring (off = zero overhead, nothing retained)"),
    Option("flight_recorder_interval", float, 1.0, "advanced",
           "seconds between flight-recorder samples", min=0.05),
    Option("flight_recorder_capacity", int, 600, "advanced",
           "flight-recorder ring entries (fixed memory)", min=2),
    Option("health_tick_period", float, 0.5, "advanced",
           "seconds between mgr health-engine evaluations", min=0.05),
    Option("health_slow_ops_warn", int, 1, "advanced",
           "SLOW_OPS raises when this many ops exceed "
           "osd_op_complaint_time", min=1),
    Option("health_recompile_warn", int, 1, "advanced",
           "DEVICE_RECOMPILE_STORM raises when recompiles grow by "
           "this much inside one health window", min=1),
    Option("health_cache_miss_warn", int, 8, "advanced",
           "COMPILE_CACHE_MISS_STORM raises when cold compile-cache "
           "misses grow by this much inside one health window", min=1),
    Option("health_window_seconds", float, 60.0, "advanced",
           "flight-recorder lookback the storm/stall checks derive "
           "their rates over", min=1.0),
    Option("health_history_size", int, 128, "advanced",
           "health-check transitions kept for 'health history' and "
           "the diagnostic bundle", min=1),
    Option("health_bundle_dir", str, "", "advanced",
           "directory for auto-emitted HEALTH_ERR diagnostic bundles "
           "(empty = keep in memory only, serve over the asok)"),
    Option("health_hbm_warn_bytes", int, 1 << 30, "advanced",
           "HBM_PRESSURE raises when the device engine's live buffer "
           "bytes (staged + in-window) reach this level (0 disables)",
           min=0),
    Option("mesh_flush_bytes", int, 1 << 20, "advanced",
           "engine flushes at least this big route through the "
           "default mesh's sharded encode/decode steps (the "
           "dense->mesh crossover, BASELINE.md 'Pod-scale sharded "
           "serving'; env CEPH_TPU_MESH_FLUSH_BYTES overrides — a "
           "registry-covered knob the ROADMAP-item-5 tuner can "
           "adjust)", min=0),
    Option("mesh_placement", bool, True, "advanced",
           "PG->chip placement: key engine staging by (signature, "
           "placement slot) and land each slot's flushes on its "
           "owning stripe row of the mesh (parallel/placement.py; "
           "env CEPH_TPU_MESH_PLACEMENT overrides)"),
    Option("mesh_compile_mode", str, "auto", "advanced",
           "mesh-step compile seam (parallel/mesh_compile.py); the "
           "values keep the reference's names: auto and shard_map "
           "take the per-slot body with explicit collectives, pjit "
           "raises (the port has no SPMD partitioner; env "
           "CEPH_TPU_MESH_COMPILE_MODE overrides)",
           enum_allowed=("auto", "pjit", "shard_map")),
    Option("profiler_hz", float, 50.0, "advanced",
           "stack-sampling profiler rate while running "
           "(profile start)", min=0.1, max=1000.0),
    Option("engine_window", int, 3, "advanced",
           "device engine launch-window depth: launched-not-retired "
           "encode batches kept in flight (1 = the serial engine; "
           "env CEPH_TPU_ENGINE_WINDOW pins it — a tuner-managed "
           "knob, adjusted at runtime through a config observer)",
           min=1, max=64),
    Option("engine_flush_bytes", int, 64 << 20, "advanced",
           "device engine flush threshold: staged payload bytes that "
           "force a launch (the batch-size cap bounding the device "
           "working set; env CEPH_TPU_ENGINE_FLUSH_BYTES pins it — "
           "tuner-managed)", min=64 << 10),
    Option("host_flush_bytes", int, 512 << 10, "advanced",
           "bulk-ingest bottom rung: flushes smaller than this take "
           "the host matvec instead of a device launch (0 disables; "
           "env CEPH_TPU_HOST_FLUSH_BYTES pins it — tuner-managed)",
           min=0),
    Option("tuner_enabled", bool, False, "advanced",
           "mgr closed-loop tuner: adjust the declared actuator "
           "knobs from the live dataplane (default OFF — a literal "
           "NOOP: zero threads, zero knob writes, zero counters; "
           "env CEPH_TPU_TUNER=1 enables)"),
    Option("tuner_tick_period", float, 0.5, "advanced",
           "seconds between tuner control-loop evaluations (the "
           "slow outer loop's cadence)", min=0.05),
    Option("tuner_cooldown_s", float, 3.0, "advanced",
           "seconds a stepped knob is held before its step is "
           "judged (confirm or revert) and before the next step "
           "anywhere — one actuation in flight at a time keeps "
           "regression attribution sound", min=0.1),
    Option("tuner_threshold_pct", float, 10.0, "advanced",
           "direction-aware regression threshold for "
           "revert-on-regression, percent (the bench_trend "
           "convention: latency regresses up, throughput down)",
           min=0.5),
    Option("tuner_hysteresis_ticks", int, 2, "advanced",
           "consecutive control ticks a rule must fire before its "
           "step is taken (a one-sample blip must not move a knob)",
           min=1),
    Option("tuner_baseline_window", int, 8, "advanced",
           "sensor samples in the rolling objective baseline a step "
           "is judged against", min=2),
    Option("tuner_history_size", int, 128, "advanced",
           "tuner decisions retained for 'tuner history' and the "
           "health diagnostics bundle", min=8),
    Option("tuner_placement_weighting", bool, True, "advanced",
           "when the tuner is active, weight PG->slot placement by "
           "the live per-slot staged-byte load (hash-uniform "
           "remains the default and the fallback)"),
    Option("profiler_max_stacks", int, 2048, "advanced",
           "distinct folded stacks the profiler holds (fixed "
           "memory; overflow aggregates under one sentinel key)",
           min=1),
    Option("objecter_read_affinity", bool, True, "advanced",
           "route reads to the placement-affine acting-set member "
           "(the slot owner under parallel/placement's CRUSH-stable "
           "hash) instead of pinning every read on the primary; "
           "servers serve affine reads from any acting member and "
           "the client falls back to primary routing on ESTALE"),
    Option("osd_read_set_spread", int, 1, "advanced",
           "any-k balanced reads: distinct rotated k-of-(k+m) shard "
           "read sets a hot object's reads spread across (1 = the "
           "primary-preferred set only; tuner-managed, stepped on "
           "measured per-object read skew)", min=1, max=16),
    Option("osd_hot_read_threshold", int, 8, "advanced",
           "reads of one object before the EC backend starts "
           "rotating its read set (cold objects keep the canonical "
           "set so their decode signatures stay shared)", min=1),
    Option("client_cache", bool, False, "advanced",
           "librados-level object cache tier: reads fill a "
           "client-side extent cache kept coherent by per-object "
           "inval watches (writers' acks are held until cached "
           "copies are invalidated — read-your-writes under "
           "concurrent writers). Default off: rbd/striper attach "
           "their own caches"),
    Option("client_cache_bytes", int, 32 << 20, "advanced",
           "librados object-cache capacity per client, bytes "
           "(tuner-managed: stepped on measured hit rate)",
           min=1 << 20),
    Option("osd_cache_inval_timeout_ms", int, 2000, "advanced",
           "how long a mutating op's reply may be held waiting for "
           "cache-invalidation acks from inval watchers before the "
           "laggards are written off as missed", min=50),
    Option("flows_enabled", bool, True, "advanced",
           "per-tenant flow attribution (utils/flow_telemetry): "
           "clients tag ops with a flow label and every daemon "
           "attributes its owned costs to the flow (false = literal "
           "NOOP: no registry, no TLS writes, no wire labels; env "
           "CEPH_TPU_FLOWS overrides)"),
    Option("flow_starvation_floor", float, 0.5, "advanced",
           "fairness-window service-ratio floor: a flow with queued "
           "demand served below this ratio scores the window "
           "starved", min=0.0, max=1.0),
    Option("flow_starvation_windows", int, 3, "advanced",
           "consecutive starved windows before FLOW_STARVATION "
           "raises for the flow", min=1),
    Option("flow_slo_error_budget", float, 0.01, "advanced",
           "default per-flow SLO error budget: tolerated fraction "
           "of completed ops over the flow's p99 target (burn rate "
           "= error rate / budget)", min=1e-9, max=1.0),
]:
    SCHEMA.add(_o)

_g_conf = ConfigProxy()


def g_conf() -> ConfigProxy:
    """The process-global config (the reference's g_conf())."""
    return _g_conf
