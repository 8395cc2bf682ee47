"""load_gen — degraded-mode serving load generator.

Drives rados client traffic against a MiniCluster through the canonical
degraded-serving phase ladder::

    healthy -> [fault fires] -> degraded -> [revive] -> recovering
            -> [wait_for_clean] -> recovered

while a seeded fault schedule (utils/faults) executes mid-run.
Per phase it reports throughput, nearest-rank p50/p99 client latency,
an error census, and the cluster-health brief — the regression oracle
the PR-5 health checks were built to be (no ENGINE_STALL / SLOW_OPS
storm allowed at target load).

Workload model ("Understanding System Characteristics of Online
Erasure Coding" is the motivation — EC pathologies are emergent under
*sustained degraded load*, not at-rest fault injection):

- **closed loop**: ``concurrency`` worker threads, each issuing the
  next op as soon as the last completes (the saturating client);
- **open loop**: the same workers paced so combined arrivals approach
  ``open_loop_rate`` ops/s (the latency-honest client — queueing
  delay is observed, not absorbed);
- **zipfian key popularity** over ``n_keys`` objects (exponent
  ``zipf_theta``; the YCSB-style skew real object stores see), with a
  configurable ``read_frac`` read/write mix.

Every write's payload is self-describing — a header naming (key,
token) plus a deterministic body derived from them — so every read is
verified byte-exact on the spot: a torn, stale-mixed, or corrupt read
is recorded as a corruption, never silently counted as throughput.
The final sweep asserts the two durability bars the acceptance
criteria name: zero lost acked writes, zero wrong bytes.

Determinism: op kinds and keys are hash-derived from (seed, op index)
— not shared-RNG — and fault actions fire at op-count/elapsed marks
recorded in the fault registry's event log, so the same seed + the
same schedule reproduces the same fault sequence (the registry's
contract, pinned in tests/test_faults.py).

CLI::

    python -m ceph_tpu_torch.bench.load_gen [--seconds 3] [--osds 4]
        [--keys 64] [--obj-kb 16] [--read-frac 0.5] [--seed 7]
        [--concurrency 4] [--rate OPS/S] [--backend cuda|torch|numpy]

The pool's backend defaults to ``cuda`` (the hand-written kernels on the
card); ``torch`` runs their plain versions on the CPU, ``numpy`` the
host GF tables.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from bisect import bisect_right
from dataclasses import dataclass, field

from ceph_tpu_torch.utils import checksum
from ceph_tpu_torch.utils import flow_telemetry as _flow_tel
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.dout import Dout

log = Dout("bench")

PHASES = ("healthy", "degraded", "recovering", "recovered")


# -- deterministic workload primitives ---------------------------------

def _hash01(seed: int, tag: str, n: int) -> float:
    """Deterministic uniform for op-index ``n`` — the registry's
    avalanche mixer keyed by the tag's crc, so the op-kind and key
    streams are independent and reproduce per (seed, n)."""
    from ceph_tpu_torch.utils import faults
    return faults._hash01(seed,
                          checksum.crc32c(tag.encode()) & 0x7FFFFFFF,
                          n)


class Zipf:
    """Zipfian sampler over ranks 0..n-1 (P(rank r) ~ 1/(r+1)^theta).
    Sampling is by inverse-CDF over precomputed cumulative weights, so
    a hash-derived uniform gives a deterministic key choice."""

    def __init__(self, n: int, theta: float = 0.99) -> None:
        weights = [1.0 / ((r + 1) ** theta) for r in range(n)]
        total = sum(weights)
        acc, cum = 0.0, []
        for w in weights:
            acc += w / total
            cum.append(acc)
        self._cum = cum

    def rank(self, u: float) -> int:
        return min(bisect_right(self._cum, u), len(self._cum) - 1)


def payload_for(key: str, token: int, size: int) -> bytes:
    """Self-describing object content: header (key, token) + a body
    that is a pure function of both — any mix of two writes' bytes or
    any corruption fails verification."""
    head = json.dumps({"k": key, "t": token}).encode() + b"\n"
    if size <= len(head):
        return head[:size]
    seed = checksum.crc32c(f"{key}:{token}".encode())
    unit = seed.to_bytes(4, "little") + key.encode()
    body = (unit * (1 + (size - len(head)) // len(unit)))
    return head + body[:size - len(head)]


def verify_payload(data: bytes) -> tuple[str, int]:
    """Returns (key, token) when ``data`` is a bit-exact payload;
    raises ValueError on any wrong byte."""
    nl = data.find(b"\n")
    if nl < 0:
        raise ValueError("payload missing header")
    head = json.loads(data[:nl])
    key, token = head["k"], head["t"]
    if payload_for(key, token, len(data)) != data:
        raise ValueError(f"payload body corrupt for {key} t={token}")
    return key, token


def percentile_ms(lats_s: list[float], pct: float) -> float:
    """Nearest-rank percentile in milliseconds (the same convention
    as rados_cli._bench)."""
    if not lats_s:
        return 0.0
    ordered = sorted(lats_s)
    idx = max(0, min(len(ordered) - 1,
                     int(round(pct / 100.0 * len(ordered) + 0.5)) - 1))
    return round(ordered[idx] * 1000.0, 6)


# -- spec / results -----------------------------------------------------

@dataclass
class LoadSpec:
    n_keys: int = 64
    obj_size: int = 16384
    read_frac: float = 0.5
    concurrency: int = 4
    #: combined target arrival rate (ops/s); None = closed loop
    open_loop_rate: float | None = None
    phase_seconds: float = 2.0
    seed: int = 0
    zipf_theta: float = 0.99
    #: client p99 bar (ms) for the degraded/recovering phases;
    #: None = read from config degraded_qos_p99_ms
    qos_p99_ms: float | None = None
    op_timeout: float = 30.0
    #: named tenant flows: every op is deterministically
    #: assigned one of these labels and submitted through a flow-
    #: tagged ioctx; () = untagged single-tenant traffic
    tenants: tuple = ()
    #: scripted hot tenant: this label's arrival share is
    #: ``hot_factor`` x each other tenant's — the skew that drives
    #: the multi_tenant_fairness bench row and FLOW_STARVATION
    hot_tenant: str | None = None
    hot_factor: float = 4.0
    #: fairness-window roll period (s) while tenants are configured
    window_seconds: float = 0.25
    #: per-tenant key namespaces: each tenant's zipfian stream runs
    #: over its OWN objects (``<tenant>_<rank>``), so a fault rule
    #: can target one tenant's keyspace — the scripted-starvation
    #: harness the multi_tenant_fairness bench row uses
    tenant_keyspaces: bool = False


@dataclass
class _State:
    """Cross-thread workload truth, all under one lock."""
    lock: threading.Lock = field(default_factory=threading.Lock)
    op_seq: int = 0
    ops_done: int = 0
    #: key -> sorted-insertion list of issued write tokens
    issued: dict = field(default_factory=dict)
    #: key -> acked write tokens (write_full returned)
    acked: dict = field(default_factory=dict)
    #: key -> tenant whose tagged ioctx acked the last write; the
    #: durability sweep reads back through the same tenant so the
    #: verify ops stay attributed (coverage bar)
    owner: dict = field(default_factory=dict)
    corruptions: list = field(default_factory=list)


class LoadGen:
    """One degraded-serving run against a live MiniCluster."""

    def __init__(self, cluster, pool: str,
                 spec: LoadSpec | None = None) -> None:
        self.cluster = cluster
        self.pool = pool
        self.spec = spec or LoadSpec()
        self.zipf = Zipf(self.spec.n_keys, self.spec.zipf_theta)
        self.io = cluster.client().open_ioctx(pool)
        self.io.op_timeout = self.spec.op_timeout
        # per-tenant ioctxs: one flow-tagged handle per
        # named tenant; weighted inverse-CDF pick per op index keeps
        # the tenant stream deterministic like the key/kind streams
        self._tenant_ios: dict[str, object] = {}
        self._tenant_cum: list[float] = []
        if self.spec.tenants:
            weights = [self.spec.hot_factor
                       if t == self.spec.hot_tenant else 1.0
                       for t in self.spec.tenants]
            total, acc = sum(weights), 0.0
            for t, w in zip(self.spec.tenants, weights):
                acc += w / total
                self._tenant_cum.append(acc)
                tio = cluster.client().open_ioctx(pool)
                tio.op_timeout = self.spec.op_timeout
                tio.set_flow(t)
                self._tenant_ios[t] = tio
        self.state = _State()
        self._next_token = [0]
        self._token_lock = threading.Lock()
        # ONE health engine across the run so windowed deltas span
        # phases (a fresh engine per phase would see delta=0 and could
        # false-raise ENGINE_STALL on a momentarily full window)
        from ceph_tpu_torch.mgr.health import HealthEngine
        self.health = HealthEngine(rec=None, publish_perf=False,
                                   bundle_on_err=False)
        self.t0 = time.monotonic()
        self.phase_reports: list[dict] = []

    # -- cluster status for the health engine -------------------------
    def _status(self) -> dict:
        mon = self.cluster.mon
        osds = mon.osdmap.osds if mon else {}
        dirty = self.cluster._dirty_pgs()
        return {"num_osds": len(osds),
                "num_up_osds": sum(1 for i in osds.values() if i.up),
                "pgmap": {"degraded_pgs": len(dirty),
                          "by_state": {}},
                "epoch": mon.osdmap.epoch if mon else 0}

    def health_brief(self) -> dict:
        rep = self.health.evaluate(self._status(),
                                   self.cluster.mon.osdmap)
        return {"status": rep["status"],
                "checks": {n: c["summary"]
                           for n, c in rep["checks"].items()}}

    # -- workload -----------------------------------------------------
    def _tenant_for(self, n: int) -> str:
        """Deterministic weighted tenant pick for op index ``n``
        ('' when no tenants are configured)."""
        if not self._tenant_cum:
            return ""
        u = _hash01(self.spec.seed, "tenant", n)
        idx = min(bisect_right(self._tenant_cum, u),
                  len(self._tenant_cum) - 1)
        return self.spec.tenants[idx]

    def preload(self) -> None:
        """Token-0 write of every key so reads always have a target
        (counts as acked writes for the durability sweep). With
        tenants configured the preload round-robins the tagged
        ioctxs, so attribution coverage includes these writes."""
        tenants = self.spec.tenants
        for r in range(self.spec.n_keys):
            for t in (tenants if self.spec.tenant_keyspaces and tenants
                      else (None,)):
                if t is None:
                    key = f"lg_{r:05d}"
                    owner = tenants[r % len(tenants)] if tenants else ""
                    io = self._tenant_ios[owner] if tenants else self.io
                else:
                    key = f"{t}_{r:05d}"
                    owner = t
                    io = self._tenant_ios[t]
                tok = self._take_token()
                with self.state.lock:
                    self.state.issued.setdefault(key, []).append(tok)
                io.write_full(key, payload_for(key, tok,
                                               self.spec.obj_size))
                with self.state.lock:
                    self.state.acked.setdefault(key, []).append(tok)
                    if owner:
                        self.state.owner[key] = owner

    def _take_token(self) -> int:
        with self._token_lock:
            self._next_token[0] += 1
            return self._next_token[0]

    def _one_op(self, n: int, lats: list, errors: list,
                tlats: dict | None = None) -> None:
        spec = self.spec
        rank = self.zipf.rank(_hash01(spec.seed, "key", n))
        is_read = _hash01(spec.seed, "rw", n) < spec.read_frac
        tenant = self._tenant_for(n)
        key = f"{tenant}_{rank:05d}" \
            if spec.tenant_keyspaces and tenant else f"lg_{rank:05d}"
        io = self._tenant_ios.get(tenant, self.io)
        t0 = time.monotonic()
        try:
            if is_read:
                data = io.read(key)
                try:
                    k, tok = verify_payload(data)
                    if k != key:
                        raise ValueError(f"read {key} returned {k}")
                    with self.state.lock:
                        if tok not in self.state.issued.get(key, []):
                            raise ValueError(
                                f"{key}: token {tok} never issued")
                except ValueError as exc:
                    with self.state.lock:
                        self.state.corruptions.append(str(exc))
            else:
                tok = self._take_token()
                with self.state.lock:
                    self.state.issued.setdefault(key, []).append(tok)
                io.write_full(
                    key, payload_for(key, tok, spec.obj_size))
                with self.state.lock:
                    self.state.acked.setdefault(key, []).append(tok)
                    if tenant:
                        self.state.owner[key] = tenant
        except Exception as exc:
            errors.append(f"{'read' if is_read else 'write'} {key}: "
                          f"{type(exc).__name__}")
        finally:
            dt = time.monotonic() - t0
            lats.append(dt)
            if tlats is not None and tenant:
                tlats.setdefault(tenant, []).append(dt)
            with self.state.lock:
                self.state.ops_done += 1

    def _run_phase(self, name: str, seconds: float,
                   on_action=None) -> dict:
        spec = self.spec
        lats: list[float] = []
        errors: list[str] = []
        tlats: dict[str, list[float]] = {}
        deadline = time.monotonic() + seconds
        stop = threading.Event()
        pace = (spec.concurrency / spec.open_loop_rate
                if spec.open_loop_rate else 0.0)

        def worker() -> None:
            while not stop.is_set() and time.monotonic() < deadline:
                t_start = time.monotonic()
                with self.state.lock:
                    n = self.state.op_seq
                    self.state.op_seq += 1
                self._one_op(n, lats, errors,
                             tlats if spec.tenants else None)
                if pace:
                    # open loop: hold this worker to its share of the
                    # arrival rate; a slow op eats its own slack first
                    rest = pace - (time.monotonic() - t_start)
                    if rest > 0:
                        stop.wait(rest)

        threads = [threading.Thread(target=worker,
                                    name=f"loadgen-{name}-{i}",
                                    daemon=True)
                   for i in range(spec.concurrency)]
        t_phase = time.monotonic()
        for t in threads:
            t.start()
        # fault-schedule pump: actions due by workload time/op count
        # fire mid-phase (the registry logs them; we execute them)
        next_roll = time.monotonic() + spec.window_seconds
        while time.monotonic() < deadline:
            time.sleep(0.05)
            # fairness windows roll on the pump, never implicitly —
            # starvation streaks advance at a deterministic cadence
            if spec.tenants and time.monotonic() >= next_roll:
                next_roll += spec.window_seconds
                ft = _flow_tel.telemetry_if_exists()
                if ft is not None:
                    ft.roll_window()
            if on_action is not None:
                with self.state.lock:
                    done = self.state.ops_done
                for act in self.cluster.faults.pop_due(
                        time.monotonic() - self.t0, done):
                    on_action(act)
        stop.set()
        for t in threads:
            t.join(timeout=max(10.0, spec.op_timeout + 5.0))
        wall = time.monotonic() - t_phase
        nbytes = len(lats) * spec.obj_size
        report = {
            "phase": name,
            "seconds": round(wall, 2),
            "ops": len(lats),
            "ops_per_s": round(len(lats) / max(wall, 1e-9), 1),
            "MBps": round(nbytes / max(wall, 1e-9) / 1e6, 2),
            "p50_ms": percentile_ms(lats, 50),
            "p99_ms": percentile_ms(lats, 99),
            "errors": len(errors),
            "error_kinds": sorted(set(errors))[:8],
            "mode": ("open@%.0f/s" % spec.open_loop_rate
                     if spec.open_loop_rate else
                     f"closed x{spec.concurrency}"),
            "health": self.health_brief(),
        }
        if spec.tenants:
            report["tenants"] = self._tenant_brief(tlats)
        self.phase_reports.append(report)
        log(1, f"load_gen phase {name}: {report['ops']} ops, "
            f"p99={report['p99_ms']}ms, "
            f"health={report['health']['status']}")
        return report

    def _tenant_brief(self, tlats: dict) -> dict:
        """Per-tenant phase metrics: the phase's own p50/
        p99 per tenant joined with the flow registry's cumulative
        served/demand shares + Jain's index."""
        fair = {"flows": {}, "jain_index": 1.0}
        ft = _flow_tel.telemetry_if_exists()
        if ft is not None:
            fair = ft.fairness()
        per = {}
        for t in self.spec.tenants:
            ls = tlats.get(t, [])
            frow = fair["flows"].get(t, {})
            per[t] = {"ops": len(ls),
                      "p50_ms": percentile_ms(ls, 50),
                      "p99_ms": percentile_ms(ls, 99),
                      "demand_share": frow.get("demand_share", 0.0),
                      "served_share": frow.get("served_share", 0.0),
                      "service_ratio": frow.get("service_ratio", 0.0),
                      "hot": t == self.spec.hot_tenant}
        return {"per_tenant": per,
                "jain_index": fair["jain_index"],
                "starved": sorted(ft.starved_flows())
                if ft is not None else []}

    def _exec_action(self, act: dict) -> None:
        if act["action"] == "kill_osd":
            if act["osd"] in self.cluster.osds:
                self.cluster.kill_osd(act["osd"])
        elif act["action"] == "revive_osd":
            if act["osd"] not in self.cluster.osds:
                self.cluster.revive_osd(act["osd"])
        else:
            log(1, f"load_gen: unknown scheduled action {act!r}")

    # -- the run ------------------------------------------------------
    def run(self, victim_osd: int | None = None,
            clean_timeout: float = 60.0) -> dict:
        """The full ladder. ``victim_osd`` (default: the highest OSD
        id) is killed between the healthy and degraded phases unless
        the fault schedule already contains kill/revive actions —
        scheduled actions always win."""
        spec = self.spec
        self.health.evaluate(self._status(),
                             self.cluster.mon.osdmap)   # arm deltas
        self.preload()
        scheduled = any(
            s["action"] in ("kill_osd", "revive_osd") and not s["done"]
            for s in self.cluster.faults.describe()["schedule"])
        if victim_osd is None:
            victim_osd = max(self.cluster.osds)
        self._run_phase("healthy", spec.phase_seconds,
                        on_action=self._exec_action)
        if not scheduled:
            self.cluster.kill_osd(victim_osd)
        self.cluster.wait_for_osd_down(victim_osd, timeout=30)
        self._run_phase("degraded", spec.phase_seconds,
                        on_action=self._exec_action)
        if victim_osd not in self.cluster.osds:
            self.cluster.revive_osd(victim_osd)
        self.cluster.wait_for_osds_up(timeout=15)
        # recovery runs UNDER live load: the recovery-vs-client QoS
        # window the whole scenario exists to exercise
        self._run_phase("recovering", spec.phase_seconds,
                        on_action=self._exec_action)
        self.cluster.wait_for_clean(timeout=clean_timeout)
        self._run_phase("recovered", spec.phase_seconds,
                        on_action=self._exec_action)
        return self.report()

    def run_healthy(self, seconds: float | None = None) -> dict:
        """Healthy-phase-only run (no fault ladder): the steady-state
        throughput probe the crimson-vs-threaded A/B uses. Same
        workload, same byte-exact verification, same durability
        sweep in :meth:`report`."""
        self.health.evaluate(self._status(),
                             self.cluster.mon.osdmap)   # arm deltas
        self.preload()
        self._run_phase("healthy",
                        seconds if seconds is not None
                        else self.spec.phase_seconds)
        return self.report()

    def final_verify(self) -> dict:
        """The durability sweep: every key with an acked write must
        read back bit-exact with an issued token (an unacked write
        may legitimately have won — its client timed out but the
        sub-writes landed — but NOTHING outside the issued set, and
        never a wrong byte)."""
        lost, wrong = [], []
        with self.state.lock:
            acked = {k: list(v) for k, v in self.state.acked.items()}
            issued = {k: list(v) for k, v in self.state.issued.items()}
            owner = dict(self.state.owner)
        for key, toks in acked.items():
            if not toks:
                continue
            try:
                # read back through the last-acking tenant's tagged
                # ioctx so the sweep's ops stay attributed
                io = self._tenant_ios.get(owner.get(key), self.io)
                data = io.read(key)
                k, tok = verify_payload(data)
                if k != key or tok not in issued.get(key, []):
                    wrong.append(f"{key}: read back ({k}, {tok})")
            except Exception as exc:
                lost.append(f"{key}: {type(exc).__name__}: {exc}")
        with self.state.lock:
            corruptions = list(self.state.corruptions)
        return {"acked_keys": len(acked), "lost_acked": lost,
                "wrong_bytes": wrong, "corruptions": corruptions}

    def report(self) -> dict:
        qos_bar = self.spec.qos_p99_ms
        if qos_bar is None:
            qos_bar = g_conf()["degraded_qos_p99_ms"]
        out = {
            "metric": "load_gen",
            "spec": {"n_keys": self.spec.n_keys,
                     "obj_size": self.spec.obj_size,
                     "read_frac": self.spec.read_frac,
                     "concurrency": self.spec.concurrency,
                     "open_loop_rate": self.spec.open_loop_rate,
                     "zipf_theta": self.spec.zipf_theta,
                     "seed": self.spec.seed},
            "phases": self.phase_reports,
            "qos": {"p99_bar_ms": qos_bar,
                    "p99_worst_degraded_ms": max(
                        [p["p99_ms"] for p in self.phase_reports
                         if p["phase"] in ("degraded", "recovering")]
                        or [0.0]),
                    },
            "verify": self.final_verify(),
            "fault_log": self.cluster.faults.fired(),
        }
        out["qos"]["within_bar"] = \
            out["qos"]["p99_worst_degraded_ms"] <= qos_bar
        # tail-sampled tracing is on by default: the report
        # says what the run kept — a fault-window or slow keep here is
        # the entry point into the autopsy of a degraded-phase outlier
        from ceph_tpu_torch.bench.cluster_bench import attach_trace_brief
        return attach_trace_brief(out)


def main(argv=None) -> int:
    from ceph_tpu_torch.qa.cluster import MiniCluster
    ap = argparse.ArgumentParser(prog="load_gen")
    ap.add_argument("--seconds", type=float, default=3.0,
                    help="per-phase seconds")
    ap.add_argument("--osds", type=int, default=4)
    ap.add_argument("--keys", type=int, default=64)
    ap.add_argument("--obj-kb", type=float, default=16.0)
    ap.add_argument("--read-frac", type=float, default=0.5)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop target ops/s (default closed loop)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--m", type=int, default=1)
    ap.add_argument("--backend", default="cuda",
                    help="EC profile backend: cuda (the card), torch "
                         "(the plain versions on the CPU) or numpy")
    ap.add_argument("--tenants", type=int, default=0,
                    help="run N named tenant flows (tn0..tnN-1) "
                         "with tn0 scripted hot")
    ap.add_argument("--hot-factor", type=float, default=4.0,
                    help="hot tenant's arrival-share multiplier")
    args = ap.parse_args(argv)
    conf = g_conf()
    conf.set("osd_heartbeat_interval", 0.25)
    conf.set("osd_heartbeat_grace", 1.0)
    with MiniCluster(n_osds=args.osds) as cluster:
        cluster.faults.reseed(args.seed)
        extra = {"backend": args.backend} if args.backend else {}
        cluster.create_ec_pool("lg", k=args.k, m=args.m, pg_num=8,
                               **extra)
        tenants = tuple(f"tn{i}" for i in range(args.tenants))
        spec = LoadSpec(n_keys=args.keys,
                        obj_size=int(args.obj_kb * 1024),
                        read_frac=args.read_frac,
                        concurrency=args.concurrency,
                        open_loop_rate=args.rate,
                        phase_seconds=args.seconds, seed=args.seed,
                        tenants=tenants,
                        hot_tenant=tenants[0] if tenants else None,
                        hot_factor=args.hot_factor)
        gen = LoadGen(cluster, "lg", spec)
        out = gen.run()
        print(json.dumps(out, default=str), flush=True)
        ok = (not out["verify"]["lost_acked"]
              and not out["verify"]["wrong_bytes"]
              and not out["verify"]["corruptions"]
              and out["qos"]["within_bar"])
        return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
