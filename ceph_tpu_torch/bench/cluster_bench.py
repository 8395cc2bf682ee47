"""Cluster-level EC write bench — BASELINE.json config[4]: a vstart
cluster with a k=8,m=3 EC pool driving 4 MiB ``rados bench`` writes,
host encode vs the device stripe-batch engine.

    python -m ceph_tpu_torch.bench.cluster_bench [--seconds N] [--osds N]
        [--backends numpy,cuda] [--obj-mb 4] [--threads N]

Prints one JSON line per backend with bandwidth, latency, and the
device engine's batching stats (launches / ops per launch) so the
record shows the device path actually carried the daemon's bytes
(reference seam: ObjBencher rados.cc:1030 + ECBackend.cc:1986-2048).
``cuda`` runs the hand-written kernels on the card, ``torch`` their
plain versions on the CPU, ``numpy`` the host GF tables.
"""

from __future__ import annotations

import argparse
import json
import time


def _quiet(fut) -> bool:
    try:
        fut.result()
        return True
    except Exception:
        return False


def attach_stage_breakdown(out: dict) -> dict:
    """Fold the data-plane stage decomposition into a metric line:
    per-stage share of the summed end-to-end latency +
    the coverage the gap report asserts. Degrades to {} so a
    telemetry fault can never cost a metric line. Mutates and
    returns ``out``."""
    try:
        from ceph_tpu_torch.utils.dataplane import dataplane
        out["stage_breakdown"] = dataplane().stage_breakdown()
    except Exception:
        out["stage_breakdown"] = {}
    # the commit-path brief: how many store txns/fsyncs
    # the run cost, so a metric line is one dump_store away from the
    # full X-ray; degrades to {} like the others
    try:
        from ceph_tpu_torch.utils.store_telemetry import telemetry
        out["store"] = telemetry().snapshot_brief()
    except Exception:
        out["store"] = {}
    return attach_trace_brief(out)


def attach_trace_brief(out: dict) -> dict:
    """Tail-sampled tracing rides every bench run by default: the
    metric line says how many traces the run kept/dropped so
    an outlier row is one ``trace ls`` away from its causes. Degrades
    to {} like the stage breakdown."""
    try:
        from ceph_tpu_torch.utils.tracing import tracer
        c = tracer().perf.dump()
        out["trace"] = {"enabled": tracer().enabled,
                        "kept": c["trace_kept"],
                        "dropped": c["trace_dropped"],
                        "kept_slow": c["trace_kept_slow"],
                        "kept_error": c["trace_kept_error"],
                        "autopsies": c["autopsies_recorded"]}
    except Exception:
        out["trace"] = {}
    return out


def run_one(backend: str, seconds: float, n_osds: int, obj_size: int,
            threads: int, k: int = 8, m: int = 3) -> dict:
    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.tools.rados_cli import _bench
    with MiniCluster(n_osds=n_osds) as cluster:
        cluster.create_ec_pool("bench", k=k, m=m, pg_num=16,
                               backend=backend)
        io = cluster.client().open_ioctx("bench")
        # warm the cluster before the timed run: the first device
        # flush builds and loads the kernels (nvcc, once per source),
        # and the engine's pinned buffers grow to the flush size.
        # Bursts of 1..threads ops walk the batch sizes until a FULL-
        # concurrency burst completes fast; timeouts during warmup are
        # retried (dup-op cache makes the resend safe).
        import concurrent.futures
        io.op_timeout = 240.0
        warm_deadline = time.monotonic() + 60
        payload = b"w" * obj_size
        bursts = [1, 2, max(threads // 2, 1), threads, threads]
        bi = 0
        while time.monotonic() < warm_deadline:
            burst = bursts[min(bi, len(bursts) - 1)]
            tb = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(burst) as pool:
                futs = [pool.submit(io.write_full, f"warm_{burst}_{i}",
                                    payload) for i in range(burst)]
                ok = all(_quiet(f) for f in futs)
            wall = time.monotonic() - tb
            if ok:
                bi += 1
                if bi >= len(bursts) and burst == threads and \
                        wall < 3.0:
                    break              # warm: full burst ran fast
        io.op_timeout = 60.0
        t0 = time.monotonic()
        out = _bench(io, seconds, "write", obj_size, threads)
        out["wall"] = round(time.monotonic() - t0, 2)
        out["backend"] = backend
        out["profile"] = f"k={k},m={m}"
        # dedupe by stats-dict identity: with the shared engine
        # service every OSD's handle reports the SAME engine — summing
        # per-OSD views would triple-count one pipeline
        stats = list({id(o._device_engine.stats):
                      dict(o._device_engine.stats)
                      for o in cluster.osds.values()
                      if o._device_engine is not None}.values())
        if stats:
            out["device_engine"] = {
                "launches": sum(s["flushes"] for s in stats),
                "ops": sum(s["ops"] for s in stats),
                "bytes": sum(s["bytes"] for s in stats),
                "max_batch_ops": max(s["max_batch_ops"]
                                     for s in stats),
                "errors": sum(s["errors"] for s in stats),
            }
        return attach_stage_breakdown(out)


def _engine_stats(cluster) -> dict:
    tot: dict = {}
    seen: set[int] = set()   # shared engine: one stats dict, N OSDs
    for o in cluster.osds.values():
        if o._device_engine is None or \
                id(o._device_engine.stats) in seen:
            continue
        seen.add(id(o._device_engine.stats))
        for name, v in o._device_engine.stats.items():
            tot[name] = tot.get(name, 0) + v
    return tot


def prewarm_fused(obj_size: int, max_ops: int = 16, k: int = 8,
                  m: int = 3, backend: str = "cuda") -> None:
    """Run the fused flush at every pow2 op count up to ``max_ops``
    before any daemon runs, so the kernels are built and loaded and
    the first timed flush pays neither. The kernel libraries are
    process-global, so one pass covers every in-process OSD. Prints
    each flush's wall."""
    import numpy as np

    from ceph_tpu_torch.models import registry as ec_registry
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.ec_backend import profile_device
    from ceph_tpu_torch.osd.ec_util import StripeInfo
    profile = {"plugin": "jerasure", "k": str(k), "m": str(m),
               "backend": backend}
    codec = ec_registry.instance().factory(
        "jerasure", profile, device=profile_device(profile))
    stripe_unit = 4096
    sinfo = StripeInfo(stripe_width=k * stripe_unit,
                       chunk_size=stripe_unit)
    sw = sinfo.stripe_width
    padded = obj_size + (-obj_size % sw)
    nops = 1
    while True:
        bufs = [np.zeros(padded, dtype=np.uint8)] * nops
        t0 = time.monotonic()
        ec_util._flush_device_fused_async(
            sinfo, codec, tuple(range(nops)), tuple(bufs))()
        print(json.dumps({"prewarm": {"nops": nops,
                                      "s": round(time.monotonic()
                                                 - t0, 1)}}),
              flush=True)
        if nops >= max_ops:
            break
        nops = min(nops * 2, max_ops)


def run_curve(seconds: float, n_osds: int, obj_size: int,
              thread_steps: list[int], k: int = 8, m: int = 3) -> list:
    """The amortization curve: ONE warm cluster on the card, the same
    write workload at increasing concurrency — MB/s vs launches vs
    MB/launch and the engine's busy time a launch."""
    import concurrent.futures

    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.tools.rados_cli import _bench
    # build the kernels and run every fused-flush op count BEFORE the
    # daemons exist: timed runs never pay the first build
    prewarm_fused(obj_size, max_ops=16, k=k, m=m)
    rows = []
    with MiniCluster(n_osds=n_osds) as cluster:
        cluster.create_ec_pool("bench", k=k, m=m, pg_num=16,
                               backend="cuda")
        io = cluster.client().open_ioctx("bench")
        io.op_timeout = 240.0   # a contended window must slow a timed
        # op, not fail the whole curve
        payload = b"w" * obj_size
        max_t = max(thread_steps)
        # short traffic warm (connections, stores, dup-op paths) —
        # the kernel signatures are already compiled
        for burst in (1, max_t):
            with concurrent.futures.ThreadPoolExecutor(burst) as pool:
                futs = [pool.submit(io.write_full,
                                    f"warm_{burst}_{i}", payload)
                        for i in range(burst)]
                [_quiet(f) for f in futs]
        for threads in thread_steps:
            before = _engine_stats(cluster)
            out = _bench(io, seconds, "write", obj_size, threads)
            after = _engine_stats(cluster)
            d = {name: after.get(name, 0) - before.get(name, 0)
                 for name in after}
            launches = max(d.get("flushes", 0), 1)
            row = {
                "threads": threads,
                "MBps": out.get("bandwidth_MBps"),
                "launches": launches,
                "ops": d.get("ops", 0),
                "MB_per_launch": round(
                    d.get("bytes", 0) / launches / 1e6, 2),
                "engine_busy_s": round(d.get("busy_s", 0.0), 2),
                "busy_ms_per_launch": round(
                    d.get("busy_s", 0.0) * 1000 / launches, 1),
            }
            attach_stage_breakdown(row)
            rows.append(row)
            print(json.dumps({"curve": row}, sort_keys=True),
                  flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cluster_bench")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--osds", type=int, default=12)
    ap.add_argument("--obj-mb", type=float, default=4.0)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--backends", default="numpy,cuda")
    ap.add_argument("--curve", action="store_true",
                    help="amortization curve: one cuda cluster, "
                         "increasing concurrency")
    ap.add_argument("--curve-threads", default="4,8,16")
    args = ap.parse_args(argv)
    obj_size = int(args.obj_mb * (1 << 20))
    if args.curve:
        run_curve(args.seconds, args.osds, obj_size,
                  [int(x) for x in args.curve_threads.split(",")])
        return 0
    for backend in args.backends.split(","):
        out = run_one(backend.strip(), args.seconds, args.osds,
                      obj_size, args.threads)
        print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
