"""gap_report — the daemon->engine gap, attributed to stages. Port of
``ceph_tpu/tools/gap_report.py``, with its flags, table and JSON line.

The engine's closed loop moves GB/s where the OSD daemons move MB/s.
This tool makes that gap a table: it runs the cluster bench
(``cluster_bench.run_one`` — real daemons, real messenger, the device
stripe-batch engine) and the engine closed-loop bench
(``bench/engine_loop``) back to back, then prints ONE attribution
table built from the per-op stage timelines (utils/stage_clock +
utils/dataplane): X% serialize/wire, Y% dispatch wait, Z% engine
queue, ... — shares of the measured end-to-end client-op latency,
whose stage sums account for the whole op (coverage_pct; the
acceptance bar is >= 90%).

Output: a human table plus one machine-readable JSON line
(``{"gap_report": {...}}``) a harness can parse.

    python -m ceph_tpu_torch.tools.gap_report              # on the card
    python -m ceph_tpu_torch.tools.gap_report --full       # 12 OSDs, k=8,m=3
    python -m ceph_tpu_torch.tools.gap_report --tenants    # tenant X-ray
    python -m ceph_tpu_torch.tools.gap_report --backend torch \
        --engine-gbps 80                                   # on the CPU

``--backend`` defaults to ``auto_device``, the card (it raises without
one); ``torch`` runs the kernels' plain versions on the CPU and ``native``
the host library. With the pool on the card, the engine side is measured
there (``bench/engine_loop``, ``engine_source: engine_loop``, the card's
name and power limit beside it); ``--engine-gbps`` gives it instead
(``cli``). Off the card with neither, the engine side is ``null``
(``engine_source: none``) and so is ``gap_x``: no figure from other
hardware stands in for it.

A device fault (a failed build or launch, EIO from the engine) reaches
the JSON: an arm or section that raises carries ``{"error": ...}``, and
engine errors in the cluster run or an arm set its ``error``.
"""

from __future__ import annotations

import argparse
import json
import time

#: stage -> short attribution label for the table
_LABELS = {
    "objecter_encode": "client encode/target",
    "send_queue_wait": "send-queue wait",
    "wire": "serialize + wire",
    "dispatch_queue_wait": "dispatch-queue wait",
    "pg_process": "PG lock/process",
    "engine_stage_wait": "engine staging queue",
    "device_window_wait": "device window wait",
    "device_finalize": "device compute+download",
    "commit_wait": "shard fan-out + commit",
    "commit_reply": "reply wire + wakeup",
}


def _engine_side(args) -> dict:
    """The engine half of the comparison: measured on the card when the
    pool is there or when asked, else given by ``--engine-gbps``, else
    none — always labelled with its provenance."""
    if args.engine_gbps is not None:
        return {"engine_GBps": float(args.engine_gbps),
                "engine_source": "cli"}
    if args.run_engine_loop or args.backend in ("cuda", "auto_device"):
        from ceph_tpu_torch.bench import engine_loop
        out = engine_loop.run(device="cuda")
        return {"engine_GBps": out["value"],
                "engine_source": "engine_loop",
                "engine_loop": out}
    return {"engine_GBps": None, "engine_source": "none"}


def _section(fn, *args) -> dict:
    """``fn(*args)``, or ``{"error": ...}`` when it raises: a fault shows
    in the JSON, never as an empty section."""
    try:
        return fn(*args)
    except Exception as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}


def _engine_errors(cluster) -> int:
    """Flush and decode errors of the engines serving ``cluster``'s
    OSDs, read while it runs (the process-wide shared engine, which
    crimson OSDs attach to through their reactors, counted once)."""
    from ceph_tpu_torch.osd import device_engine
    engines = [getattr(o, "_device_engine", None)
               for o in cluster.osds.values()]
    engines.append(device_engine._shared_engine)
    stats = {id(e.stats): e.stats for e in engines if e is not None}
    return sum(st.get("errors", 0) + st.get("decode_errors", 0)
               for st in stats.values())


def _check_engine(cluster) -> None:
    """Raise if the engines serving ``cluster`` faulted (an arm's
    ``_section`` turns it into the arm's ``error``)."""
    errors = _engine_errors(cluster)
    if errors:
        raise RuntimeError(f"device engine: {errors} flush/decode errors")


def _profile_section(prof, top_n: int = 10) -> dict:
    """The hot-frame join: per-stage top-N leaf frames from the
    sampled stacks, keyed by the same stage names as the attribution
    rows — the table finally bottoms out in function names."""
    dump = prof.dump()
    return {
        "hz": dump["hz"],
        "samples": dump["samples"],
        "cpu_samples": dump["cpu_samples"],
        "attributed_pct": dump["attributed_pct"],
        "sampler_overhead_pct":
            prof.status()["sampler_overhead_pct"],
        "by_stage": {stage: ent["samples"]
                     for stage, ent in dump["by_stage"].items()},
        "hot_frames": prof.top_frames(top_n),
    }


#: stages whose device work can route through the mesh — the rows the
#: table's ``mesh`` column annotates with the measured mesh share, so
#: multi-chip runs attribute the same stages as single-chip ones
_MESH_STAGES = ("engine_stage_wait", "device_window_wait",
                "device_finalize")


def _knob_section() -> dict:
    """The active actuator vector: every tuner-managed knob's
    effective value and winning config source, so an attribution
    table is never read without knowing which knob vector produced
    it. ``tuner_active`` says whether a live tuner is driving them."""
    from ceph_tpu_torch.mgr import tuner as tuner_mod
    from ceph_tpu_torch.utils.knobs import TUNER_KNOBS
    out = {"vector": TUNER_KNOBS.vector_detail(),
           "tuner_active": tuner_mod.active_tuner() is not None}
    tail = tuner_mod.decisions_tail_if_active(limit=5)
    if tail:
        out["recent_decisions"] = [
            {k: d.get(k) for k in ("kind", "knob", "from", "to", "rule")}
            for d in tail]
    return out


def _mesh_section() -> dict:
    """The multi-device share of this run's device work: how many
    engine flushes rode the mesh / a placement slot, read from the
    device telemetry counters. ``n_devices`` is the number of devices
    under the default mesh (``parallel/mesh.py``), else the cards the
    process sees, else 1 (the CPU). ``encode_share`` is the fraction
    the ``mesh`` column prints."""
    import torch

    from ceph_tpu_torch.parallel import mesh as mesh_mod
    from ceph_tpu_torch.utils.device_telemetry import telemetry
    c = telemetry().perf.dump()
    enc = c.get("mesh_flushes", 0)
    dec = c.get("mesh_decode_flushes", 0)
    # total encode flushes = the occupancy histogram's
    # observation count (one hinc per retired flush)
    occ = c.get("encode_batch_ops") or []
    flushes = sum(occ) if isinstance(occ, list) else 0
    msh = mesh_mod.get_default_mesh()
    if msh is not None:
        n_devices = len({str(slot.device)
                         for slot in msh.devices.reshape(-1)})
    else:
        n_devices = torch.cuda.device_count() or 1
    return {
        "n_devices": n_devices,
        "mesh_flushes": enc,
        "mesh_decode_flushes": dec,
        "mesh_scrub_batches": c.get("mesh_scrub_batches", 0),
        "placement_flushes": c.get("placement_flushes", 0),
        "placement_slots": c.get("placement_slots", 0),
        "encode_share": round(enc / flushes, 3) if flushes else 0.0,
    }


def _store_section() -> dict:
    """The commit-path store table: the txn sub-stage decomposition +
    per-site fsync accounting the store registry measured during THIS
    run."""
    from ceph_tpu_torch.utils.store_telemetry import telemetry
    tel = telemetry()
    return {"txn_breakdown": tel.txn_breakdown(),
            "fsync_sites": tel.fsync_sites(),
            "brief": tel.snapshot_brief()}


def _what_if(report: dict) -> dict:
    """The batching-opportunity ledger: what the measured txn/submit
    adjacency projects for group commit and a streaming objecter.
    First-order latency-scaling model: per-op savings subtract from
    the measured mean, throughput scales inversely — the honest
    'if the batching landed at THIS adjacency' number, not a promise."""
    from ceph_tpu_torch.utils.msgr_telemetry import telemetry as msgr_tel
    from ceph_tpu_torch.utils.store_telemetry import telemetry
    tel = telemetry()
    gc_windows = tel.group_commit_projection()
    obj = tel.objecter_adjacency()
    framing = msgr_tel().framing_brief()
    ops = report.get("ops") or 0
    mean_ms = report.get("mean_ms") or 0.0
    mbps = report.get("cluster_MBps") or 0.0
    # the middle window is THE projection (default 2 ms — inside
    # one commit round trip); the full sweep rides along
    pick = gc_windows[len(gc_windows) // 2] if gc_windows else {}
    saved_commit_ms = (pick.get("wall_saved_s", 0.0) * 1e3 / ops) \
        if ops else 0.0
    client_ms = sum(
        report.get("stages", {}).get(s, {}).get("mean_ms", 0.0)
        for s in ("objecter_encode", "send_queue_wait",
                  "commit_reply"))
    mean_batch = obj.get("mean_batch") or 1.0
    saved_stream_ms = client_ms * (1.0 - 1.0 / mean_batch) \
        if mean_batch > 1.0 else 0.0
    proj_mean = max(mean_ms - saved_commit_ms - saved_stream_ms,
                    mean_ms * 0.05, 1e-6)
    out = {
        "group_commit": gc_windows,
        "objecter_stream": obj,
        "wire_framing": framing,
        "window_ms": pick.get("window_ms"),
        "fsyncs_saved": pick.get("fsyncs_saved", 0.0),
        "fsync_model": pick.get("fsync_model", ""),
        "saved_commit_ms_per_op": round(saved_commit_ms, 4),
        "saved_stream_ms_per_op": round(saved_stream_ms, 4),
        "projected_MBps": round(mbps * mean_ms / proj_mean, 1)
        if mean_ms and mbps else 0.0,
        "model": "first-order latency scaling",
    }
    return out


#: commit-envelope stage -> dispatch-machinery kind: what each slice
#: of the residual commit_wait IS, in run-to-completion vocabulary — a
#: cross-thread hop, continuation run time, durability ship, or the
#: wakeup/ack sweep
_DISPATCH_KINDS = {
    "commit_handoff": "hop (continuation re-enqueue)",
    "commit_dispatch": "run (PG lock + fan-out build)",
    "commit_ship_wait": "ship (txn group + sub-writes)",
    "commit_ack_wait": "wakeup (ack sweep + completion)",
}


def _dispatch_section(report: dict) -> dict:
    """The dispatch X-ray: the residual commit_wait sliced into named
    hop/run/ship/wakeup sub-stages (the commit envelope, so coverage is
    inherited from the >= 90% commit-path bar), joined with the
    per-seam handoff spans, per-connection wakeup accounting, timed-lock
    waits, and the profiler's commit_wait sample share."""
    from ceph_tpu_torch.utils.dispatch_telemetry import SEAMS, telemetry
    tel = telemetry()
    commit = report.get("commit_path") or {}
    rows = {stage: dict(ent, kind=_DISPATCH_KINDS.get(stage, ""))
            for stage, ent in (commit.get("stages") or {}).items()}
    c = tel.perf.dump()
    chains = c.get("op_chains", 0)
    hops = sum(c.get(f"ophop_{s}", 0) for s in SEAMS)
    out = {
        "commit_wait_ms": commit.get("commit_wait_ms"),
        "coverage_pct": commit.get("coverage_pct", 0.0),
        "stages": rows,
        "op_chains": chains,
        "hops_per_op": round(hops / chains, 2) if chains else 0.0,
        "seams": tel.seam_table(),
        "wakeups": tel.wakeup_table(),
        "locks": tel.lock_table(),
    }
    prof = report.get("profiler") or {}
    by_stage = prof.get("by_stage") or {}
    total = sum(by_stage.values())
    if total:
        # the profiler join: what share of sampled wall the
        # dispatch-flavored stages own (commit_wait continuations
        # run tagged commit_wait; client_wait is completion park)
        out["profiler_share_pct"] = {
            s: round(100.0 * n / total, 1)
            for s, n in by_stage.items()
            if s in ("commit_wait", "client_wait", "idle")}
    return out


def run_report(seconds: float, n_osds: int, obj_size: int,
               threads: int, k: int, m: int, backend: str,
               args) -> dict:
    from ceph_tpu_torch.analysis import lock_witness as _lw
    from ceph_tpu_torch.bench import cluster_bench
    from ceph_tpu_torch.utils.dataplane import dataplane
    from ceph_tpu_torch.utils.dispatch_telemetry import telemetry as _dt
    from ceph_tpu_torch.utils.msgr_telemetry import telemetry as _mt
    from ceph_tpu_torch.utils.store_telemetry import telemetry as _st

    if backend == "auto_device":
        from ceph_tpu_torch.osd.ec_backend import resolve_auto_device
        backend = resolve_auto_device()
    # fresh registries: the table attributes THIS run, not whatever the
    # process did before (the stages, the store/commit-path registry and
    # the messenger's framing counters the what-if ledgers read, the
    # dispatch registry)
    dataplane().reset()
    _st().reset()
    _mt().reset()
    _dt().reset()
    # lock timing: armed BEFORE the cluster is built so every
    # make_lock/make_condition site constructed for this run is timed —
    # the dispatch table's lock-wait plane
    _lw.enable_timing()
    prof = None
    if getattr(args, "profile", False):
        from ceph_tpu_torch.utils.profiler import profiler
        prof = profiler()
        prof.reset()
        prof.start(hz=getattr(args, "profile_hz", None))
    try:
        cluster = cluster_bench.run_one(backend, seconds, n_osds,
                                        obj_size, threads, k=k, m=m)
    finally:
        _lw.disable_timing()
        if prof is not None:
            prof.stop()
    engine = _engine_side(args)
    breakdown = cluster.get("stage_breakdown") or \
        dataplane().stage_breakdown()

    cluster_mbps = cluster.get("bandwidth_MBps") or 0.0
    engine_gbps = engine["engine_GBps"]
    report = {
        "cluster_MBps": cluster_mbps,
        "cluster_p50_ms": cluster.get("p50_ms"),
        "cluster_p99_ms": cluster.get("p99_ms"),
        "engine_GBps": engine_gbps,
        "engine_source": engine["engine_source"],
        "gap_x": round(engine_gbps * 1e3 / cluster_mbps, 1)
        if cluster_mbps and engine_gbps is not None else None,
        "ops": breakdown.get("ops", 0),
        "mean_ms": breakdown.get("mean_ms"),
        "coverage_pct": breakdown.get("coverage_pct", 0.0),
        "stages": breakdown.get("stages", {}),
        "subops": breakdown.get("subops", {}),
        "profile": cluster.get("profile"),
        "backend": cluster.get("backend"),
        # the multi-device share of this run's device work — a mesh run
        # attributes the SAME stages; this section (and the table's mesh
        # column) says how much of them rode it
        "mesh": _section(_mesh_section),
        # the knob vector this attribution ran under
        "knobs": _section(_knob_section),
        # why commit waited (the sub-stage decomposition under
        # commit_wait) + what the store measured
        "commit_path": breakdown.get("commit_path", {}),
        "store": _section(_store_section),
    }
    if "engine_loop" in engine:
        report["engine_loop"] = engine["engine_loop"]
    errors = (cluster.get("device_engine") or {}).get("errors", 0)
    if errors:
        report["error"] = f"device engine: {errors} flush errors"
    # the batching-opportunity projection (needs the report's own
    # mean/stages, so assembled last)
    report["what_if"] = _section(_what_if, report)
    if prof is not None:
        report["profiler"] = _profile_section(prof)
    # the dispatch X-ray over the residual commit_wait + the
    # run-to-completion projection (needs commit_path/profiler)
    report["dispatch"] = _section(_dispatch_section, report)
    handoff = ((report.get("commit_path") or {}).get("stages", {})
               .get("commit_handoff") or {}).get("mean_ms")
    report["what_if"]["run_to_completion"] = _section(
        lambda: _dt().rtc_projection(
            report.get("ops") or 0, report.get("mean_ms") or 0.0,
            report.get("cluster_MBps") or 0.0, handoff_ms_per_op=handoff))
    # the measured crimson arm + the projection-honesty row. Runs LAST
    # (it resets the dispatch registry for its own attribution) and is
    # skippable for quick looks.
    if not getattr(args, "no_crimson", False):
        arm = _section(_crimson_arm, min(seconds, 2.0), n_osds, obj_size,
                       threads, k, m, backend)
        if "load_gen_MBps" in arm:
            whatif = report["what_if"]["run_to_completion"]
            arm["projection_honesty"] = projection_honesty(
                whatif.get("whatif_rtc_MBps") or 0.0,
                arm["load_gen_MBps"])
        report["crimson"] = arm
    # the read-path A/B — zipfian storm primary-pinned vs any-k
    # balanced, with the read_balance verdict row. Also LAST (fresh
    # clusters of its own) and skippable for quick looks.
    if not getattr(args, "no_read_balance", False):
        report["read_balance"] = _section(
            _read_balance_arm, min(seconds, 3.0), max(n_osds, k + m + 1),
            k, m, backend)
    # the tenant X-ray arm — per-flow attribution coverage on BOTH
    # flavors. Opt-in (--tenants); fresh clusters of its own.
    if getattr(args, "tenants", False):
        report["tenants"] = _tenants_section(
            min(seconds, 2.0), n_osds, obj_size, threads, k, m,
            backend)
    return report


def _tenants_arm(seconds: float, n_osds: int, obj_size: int,
                 threads: int, k: int, m: int, backend: str,
                 flavor: str) -> dict:
    """One tenant-attributed pass: a named-tenant traffic
    mix against a fresh ``flavor`` cluster with the flow registry
    reset first, so the attribution/coverage table scores THIS arm
    only. The acceptance bar: >= 95% of ops AND bytes carry a tenant
    label, on BOTH the threaded and crimson flavors."""
    from ceph_tpu_torch.bench.load_gen import LoadGen, LoadSpec
    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.utils import flow_telemetry as _flow_tel
    if not _flow_tel.enabled():
        return {"skipped": "flows_enabled=false"}
    tel = _flow_tel.telemetry_if_exists()
    if tel is not None:
        tel.reset()
    with MiniCluster(n_osds=n_osds, osd_flavor=flavor) as cluster:
        cluster.create_ec_pool("tx", k=k, m=m, pg_num=8,
                               backend=backend)
        tenants = ("acme", "globex", "initech")
        spec = LoadSpec(n_keys=32, obj_size=obj_size, read_frac=0.5,
                        concurrency=threads, phase_seconds=seconds,
                        seed=11, tenants=tenants,
                        hot_tenant=tenants[0], hot_factor=4.0)
        gen = LoadGen(cluster, "tx", spec)
        out = gen.run_healthy()
        _check_engine(cluster)
    tel = _flow_tel.telemetry_if_exists()
    if tel is None:
        return {"error": "no flow registry materialized"}
    attr = tel.attribution()
    healthy = out["phases"][0]
    return {
        "flavor": flavor,
        "ops": healthy.get("ops"),
        "MBps": healthy.get("MBps"),
        "tenants": healthy.get("tenants"),
        "attribution": attr,
        "coverage_ok": attr["ops_pct"] >= 95.0
        and attr["bytes_pct"] >= 95.0,
        "lost_acked": len(out["verify"]["lost_acked"]),
        "wrong_bytes": len(out["verify"]["wrong_bytes"]),
    }


def _tenants_section(seconds: float, n_osds: int, obj_size: int,
                     threads: int, k: int, m: int,
                     backend: str) -> dict:
    out = {}
    for flavor in ("threaded", "crimson"):
        out[flavor] = _section(_tenants_arm, seconds, n_osds, obj_size,
                               threads, k, m, backend, flavor)
    out["coverage_ok"] = all(
        arm.get("coverage_ok") for arm in out.values()
        if isinstance(arm, dict))
    return out


def _print_tenants(report: dict) -> None:
    sec = report.get("tenants")
    if not sec:
        return
    print()
    print("--- tenant X-ray (per-flow attribution, both flavors) ---")
    for flavor in ("threaded", "crimson"):
        arm = sec.get(flavor) or {}
        if "error" in arm:
            print(f"  {flavor}: arm failed: {arm['error']}")
            continue
        if "skipped" in arm:
            print(f"  {flavor}: skipped: {arm['skipped']}")
            continue
        attr = arm["attribution"]
        print(f"  {flavor}: ops {attr['ops_attributed']}/"
              f"{attr['ops_total']} ({attr['ops_pct']}%)   bytes "
              f"{attr['bytes_attributed']}/{attr['bytes_total']} "
              f"({attr['bytes_pct']}%)   "
              f"{'OK' if arm['coverage_ok'] else 'BELOW 95% BAR'}")
        for tenant, row in sorted(attr["by_flow"].items()):
            print(f"    {tenant or '(unlabelled)':<14}"
                  f"ops {row['ops']:>7} ({100 * row['ops_share']:.1f}%)"
                  f"   bytes {row['bytes']:>12} "
                  f"({100 * row['bytes_share']:.1f}%)")
    print(f"  coverage >= 95% both flavors: "
          f"{'yes' if sec.get('coverage_ok') else 'NO'}")


def _print_crimson(report: dict) -> None:
    arm = report.get("crimson")
    if not arm:
        return
    print()
    print("--- crimson (run-to-completion, measured) ---")
    if "error" in arm:
        print(f"  arm failed: {arm['error']}")
        return
    if "skipped" in arm:
        print(f"  arm skipped: {arm['skipped']}")
        return
    print(f"  load_gen:       {arm['load_gen_MBps']} MB/s   "
          f"p99 {arm['p99_ms']} ms   ops {arm['ops']}")
    print(f"  dispatch:       {arm['hops_per_op']} hops/op   "
          f"wq_continuation {arm['wq_continuation_hops']}   "
          f"wakeups/frame {arm['wakeups_per_frame']}")
    print(f"  verify:         lost_acked {arm['lost_acked']}   "
          f"wrong_bytes {arm['wrong_bytes']}")
    ph = arm.get("projection_honesty") or {}
    if ph:
        lo, hi = ph.get("bracket", [0.5, 2.0])
        print(f"  honesty:        measured/whatif = {ph['ratio']}  "
              f"(bracket [{lo}x, {hi}x])  -> {ph['verdict']}")


def print_table(report: dict) -> None:
    print()
    print("=== data-plane gap report ===")
    print(f"cluster (daemon path): {report['cluster_MBps']} MB/s   "
          f"p50 {report['cluster_p50_ms']} ms / "
          f"p99 {report['cluster_p99_ms']} ms   "
          f"[{report['backend']}, {report['profile']}]")
    card = (report.get("engine_loop") or {}).get("nvidia_smi")
    print(f"engine (closed loop):  {report['engine_GBps']} GB/s   "
          f"(source: {report['engine_source']}"
          + (f", {card})" if card else ")"))
    if report.get("error"):
        print(f"error: {report['error']}")
    if report["gap_x"]:
        print(f"gap: {report['gap_x']}x")
    knobs = (report.get("knobs") or {}).get("vector") or {}
    if knobs:
        active = "tuner ACTIVE" if report["knobs"].get(
            "tuner_active") else "tuner off"
        vec = "  ".join(
            f"{name}={ent['value']}"
            + ("*" if ent.get("pinned") else "")
            for name, ent in knobs.items())
        print(f"knobs ({active}, * = pinned): {vec}")
    print()
    prof = report.get("profiler") or {}
    hot = prof.get("hot_frames", {})
    mesh = report.get("mesh") or {}
    # the mesh column: device stages annotate the fraction of encode
    # flushes that rode the mesh route ("-" for host-side stages) —
    # a multi-chip run attributes the same stages, visibly
    mesh_share = mesh.get("encode_share", 0.0)
    mesh_mark = f"{100 * mesh_share:.0f}%" if mesh_share else "-"
    print(f"{'stage':<22}{'label':<26}{'mean_ms':>9}{'share':>8}"
          f"{'mesh':>7}")
    print("-" * 72)
    for stage, ent in report["stages"].items():
        col = mesh_mark if stage in _MESH_STAGES else "-"
        print(f"{stage:<22}{_LABELS.get(stage, ''):<26}"
              f"{ent['mean_ms']:>9.3f}{ent['share_pct']:>7.1f}%"
              f"{col:>7}")
        # --profile: the hot frames sampled while THIS stage owned
        # the thread, so each row bottoms out in function names
        for f in hot.get(stage, []):
            print(f"    ↳ {f['frame']:<48}"
                  f"{f['samples']:>6}{f['pct']:>7.1f}%")
    print("-" * 65)
    print(f"{'stage sum coverage of e2e latency':<48}"
          f"{report['coverage_pct']:>16.1f}%")
    for stage, ent in report.get("subops", {}).items():
        print(f"  (subop) {stage:<20}{ent['mean_ms']:>9.3f} ms")
    _print_commit_path(report)
    _print_dispatch(report)
    if prof:
        print(f"profiler: {prof['samples']} samples @ {prof['hz']} Hz"
              f", {prof['attributed_pct']}% stage-attributed, "
              f"sampler overhead {prof['sampler_overhead_pct']}%")
        extra = {s: n for s, n in prof.get("by_stage", {}).items()
                 if s not in report["stages"]}
        for stage in sorted(extra, key=lambda s: -extra[s])[:6]:
            frames = hot.get(stage, [])
            lead = frames[0]["frame"] if frames else ""
            print(f"  (off-table) {stage:<22}{extra[stage]:>6} "
                  f"samples  {lead}")
    print()


def _print_commit_path(report: dict) -> None:
    """The commit-path X-ray block: sub-stage shares under
    commit_wait, the store txn decomposition + fsync sites, and the
    what-if projection line."""
    commit = report.get("commit_path") or {}
    if commit.get("stages"):
        print()
        print(f"commit path (under commit_wait "
              f"{commit['commit_wait_ms']:.3f} ms, sub-stage "
              f"coverage {commit['coverage_pct']:.1f}%):")
        for stage, ent in commit["stages"].items():
            print(f"  {stage:<20}{ent['mean_ms']:>9.3f} ms"
                  f"{ent['share_of_commit_pct']:>7.1f}%")
    store = report.get("store") or {}
    txn = store.get("txn_breakdown") or {}
    if txn.get("stages"):
        parts = "  ".join(
            f"{s}={e['mean_us']:.0f}us({e['share_pct']:.0f}%)"
            for s, e in txn["stages"].items())
        print(f"store txns ({txn['txns']}): {parts}")
    sites = store.get("fsync_sites") or {}
    if sites:
        parts = "  ".join(
            f"{site}: n={e['count']} {e['seconds'] * 1e3:.1f}ms"
            for site, e in sorted(sites.items()))
        print(f"fsync sites: {parts}")
    wi = report.get("what_if") or {}
    if wi:
        obj = wi.get("objecter_stream") or {}
        print(f"what-if @{wi.get('window_ms')}ms: group-commit saves "
              f"{wi.get('fsyncs_saved')} fsyncs "
              f"({wi.get('fsync_model')}), streaming objecter "
              f"coalesces {obj.get('mean_batch')} ops/batch "
              f"(max {obj.get('max_batch')}) -> projected "
              f"{wi.get('projected_MBps')} MB/s")


def projection_honesty(whatif_mbps: float, measured_mbps: float,
                       lo: float = 0.5, hi: float = 2.0) -> dict:
    """The projection-honesty check: a what-if ledger is only worth
    keeping if reality lands inside its bracket. ``measured_mbps`` (the
    crimson arm) must fall within [lo x, hi x] of ``whatif_mbps`` (the
    run-to-completion projection off the threaded run) — otherwise the
    verdict says the MODEL needs correcting, loudly, instead of letting
    a flattering ledger ride along unexamined."""
    whatif = float(whatif_mbps or 0.0)
    measured = float(measured_mbps or 0.0)
    if whatif <= 0.0 or measured <= 0.0:
        return {"whatif_rtc_MBps": whatif,
                "measured_crimson_MBps": measured,
                "ratio": None, "bracket": [lo, hi],
                "within_bracket": False,
                "verdict": "no-data"}
    ratio = round(measured / whatif, 3)
    within = lo <= ratio <= hi
    return {"whatif_rtc_MBps": whatif,
            "measured_crimson_MBps": measured,
            "ratio": ratio, "bracket": [lo, hi],
            "within_bracket": within,
            "verdict": "honest" if within else "model-needs-fix"}


def _crimson_arm(seconds: float, n_osds: int, obj_size: int,
                 threads: int, k: int, m: int, backend: str) -> dict:
    """The measured crimson side of the A/B: the same zipfian
    workload against a shard-per-core cluster, with the dispatch
    registry reset first so hops/op and wakeups/frame attribute THIS
    arm only. Runs LAST — it must not clobber the threaded run's
    counters (the report reads them before this resets)."""
    from ceph_tpu_torch.bench.load_gen import LoadGen, LoadSpec
    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.utils.dispatch_telemetry import SEAMS
    from ceph_tpu_torch.utils.dispatch_telemetry import telemetry as _dt
    if n_osds < k + m:
        return {"skipped": f"n_osds {n_osds} < k+m {k + m}"}
    _dt().reset()
    with MiniCluster(n_osds=n_osds, osd_flavor="crimson") as cluster:
        cluster.create_ec_pool("cr", k=k, m=m, pg_num=8,
                               backend=backend)
        spec = LoadSpec(n_keys=32, obj_size=obj_size, read_frac=0.5,
                        concurrency=threads, phase_seconds=seconds,
                        seed=9)
        gen = LoadGen(cluster, "cr", spec)
        out = gen.run_healthy()
        _check_engine(cluster)
    healthy = out["phases"][0]
    c = _dt().perf.dump()
    chains = c.get("op_chains", 0)
    hops = sum(c.get(f"ophop_{s}", 0) for s in SEAMS)
    return {
        "load_gen_MBps": healthy.get("MBps", 0.0),
        "p99_ms": healthy.get("p99_ms"),
        "ops": healthy.get("ops"),
        "hops_per_op": round(hops / chains, 2) if chains else 0.0,
        "wq_continuation_hops": c.get("ophop_wq_continuation", 0),
        "wakeups_per_frame":
            _dt().wakeup_table().get("wakeups_per_frame"),
        "lost_acked": len(out["verify"]["lost_acked"]),
        "wrong_bytes": len(out["verify"]["wrong_bytes"]),
    }


def _read_storm(seconds: float, n_osds: int, k: int, m: int,
                backend: str, affinity: bool, spread: int,
                lat_ms: float) -> dict:
    """One zipfian read-storm pass: boot, write the hot set, inject
    ``lat_ms`` of store read latency (models a loaded store — the
    regime where serving capacity binds), storm, and return GB/s +
    per-OSD serve attribution. Byte-exact-checked throughout."""
    import concurrent.futures

    import numpy as np

    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.utils import read_heat
    from ceph_tpu_torch.utils.config import g_conf

    conf = g_conf()
    saved = {kk: conf.get(kk) for kk in
             ("objecter_read_affinity", "osd_read_set_spread",
              "osd_hot_read_threshold", "client_cache")}
    conf.set("objecter_read_affinity", affinity)
    conf.set("osd_read_set_spread", spread)
    conf.set("osd_hot_read_threshold", 8)
    conf.set("client_cache", False)
    read_heat.reset()
    n_objs, obj_kb, clients, threads = 8, 256, 2, 8
    payload = b"\x5a" * (obj_kb * 1024)
    keys = np.minimum(
        np.random.default_rng(21).zipf(1.6, size=40000) - 1,
        n_objs - 1)
    totals = [0] * (clients * threads)
    try:
        with MiniCluster(n_osds=n_osds) as c:
            c.create_ec_pool("rb", k=k, m=m, pg_num=8,
                             backend=backend, plugin="isa")
            ios = [c.client().open_ioctx("rb")
                   for _ in range(clients)]
            for i in range(n_objs):
                ios[0].write_full(f"h{i}", payload)
            rule = c.faults.add("store_latency", oid_prefix="h",
                                delay_s=lat_ms / 1000.0)
            stop = time.perf_counter() + seconds

            def worker(w: int) -> None:
                wio = ios[w % clients]
                i = w * 997
                while time.perf_counter() < stop:
                    oid = f"h{keys[i % len(keys)]}"
                    assert wio.read(oid) == payload, \
                        f"read-balance arm: {oid} not byte-exact"
                    totals[w] += len(payload)
                    i += 1

            t0 = time.perf_counter()
            try:
                with concurrent.futures.ThreadPoolExecutor(
                        clients * threads) as pool:
                    list(pool.map(worker, range(clients * threads)))
                elapsed = max(time.perf_counter() - t0, 1e-6)
            finally:
                rule.remove()
            per_osd = {o: osd.logger.get("op_r")
                       for o, osd in sorted(c.osds.items())}
            rotated = sum(osd.logger.get("anyk_rotated_reads")
                          for osd in c.osds.values())
            cache_hits = sum(osd.logger.get("hot_shard_cache_hits")
                             for osd in c.osds.values())
            _check_engine(c)
    finally:
        for kk, vv in saved.items():
            conf.set(kk, vv)
    serves = [v for v in per_osd.values() if v]
    mean = sum(serves) / len(serves) if serves else 0.0
    return {"GBps": round(sum(totals) / elapsed / 1e9, 4),
            "reads": int(sum(totals) // len(payload)),
            "per_osd_op_r": per_osd,
            "serve_imbalance": round(max(serves) / mean, 2)
            if serves else None,
            "anyk_rotated_reads": rotated,
            "hot_shard_cache_hits": cache_hits,
            "heat_skew": read_heat.snapshot_brief(top=3).get("skew")}


def _read_balance_arm(seconds: float, n_osds: int, k: int, m: int,
                      backend: str) -> dict:
    """The read-balance arm: the SAME zipfian read storm primary-
    pinned (affinity off, spread 1 — the pre-fix routing) vs any-k
    (affine routing + rotated read sets + the hot-shard cache), with
    store read latency injected so serving capacity — not the in-
    process client — is the binding constraint. The verdict row says
    whether balanced reads actually moved aggregate GB/s, not just
    the per-OSD serve histogram."""
    lat_ms = 25.0
    if n_osds < k + m + 1:
        return {"skipped": f"n_osds {n_osds} < k+m+1 {k + m + 1} "
                           "(rotation needs a spare position)"}
    primary = _read_storm(seconds, n_osds, k, m, backend,
                          affinity=False, spread=1, lat_ms=lat_ms)
    anyk = _read_storm(seconds, n_osds, k, m, backend,
                       affinity=True, spread=3, lat_ms=lat_ms)
    ratio = round(anyk["GBps"] / primary["GBps"], 2) \
        if primary["GBps"] else None
    flatter = (primary["serve_imbalance"] or 0) > \
        (anyk["serve_imbalance"] or 0)
    if ratio is not None and ratio >= 1.0 and flatter:
        verdict = "balanced"
    elif flatter:
        # serves spread but GB/s did not follow — the client side or
        # noise is binding at this scale
        verdict = "balanced-no-speedup"
    else:
        verdict = "primary-pinned"
    return {"primary": primary, "anyk": anyk,
            "win_x_vs_primary": ratio,
            "store_latency_ms": lat_ms,
            "verdict": verdict}


def _print_read_balance(report: dict) -> None:
    arm = report.get("read_balance")
    if not arm:
        return
    print()
    print("--- read balance (zipfian storm, primary vs any-k) ---")
    if "error" in arm:
        print(f"  arm failed: {arm['error']}")
        return
    if "skipped" in arm:
        print(f"  arm skipped: {arm['skipped']}")
        return
    p, a = arm["primary"], arm["anyk"]
    print(f"  primary-pinned: {p['GBps']} GB/s   "
          f"imbalance {p['serve_imbalance']}x   "
          f"op_r {p['per_osd_op_r']}")
    print(f"  any-k:          {a['GBps']} GB/s   "
          f"imbalance {a['serve_imbalance']}x   "
          f"op_r {a['per_osd_op_r']}")
    print(f"  any-k serves:   rotated {a['anyk_rotated_reads']}   "
          f"hot-shard cache hits {a['hot_shard_cache_hits']}   "
          f"heat skew {a['heat_skew']}")
    print(f"  verdict:        {arm['win_x_vs_primary']}x vs primary "
          f"(store_latency {arm['store_latency_ms']}ms)  -> "
          f"{arm['verdict']}")


def _print_dispatch(report: dict) -> None:
    """The dispatch X-ray block: residual commit_wait
    sliced by dispatch-machinery kind, the hop/wakeup/lock-wait
    annotations, and the run-to-completion what-if line."""
    dsp = report.get("dispatch") or {}
    if dsp.get("stages"):
        print()
        print(f"dispatch (under commit_wait "
              f"{dsp['commit_wait_ms']:.3f} ms, coverage "
              f"{dsp['coverage_pct']:.1f}%):")
        for stage, ent in dsp["stages"].items():
            print(f"  {stage:<18}{ent.get('kind', ''):<32}"
                  f"{ent['mean_ms']:>9.3f} ms"
                  f"{ent['share_of_commit_pct']:>7.1f}%")
        wk = dsp.get("wakeups") or {}
        locks = (dsp.get("locks") or {}).get("locks") or {}
        worst = next(iter(locks.items()), None)
        locknote = f"  top lock-wait: {worst[0]} " \
                   f"{worst[1]['wait_ms']:.2f}ms" if worst else ""
        print(f"  hops/op {dsp.get('hops_per_op', 0.0)}"
              f"  wakeups/frame {wk.get('wakeups_per_frame', 0.0)}"
              f" (mean wake {wk.get('mean_latency_us', 0.0):.0f}us)"
              f"{locknote}")
        shares = dsp.get("profiler_share_pct") or {}
        if shares:
            parts = "  ".join(f"{s}={p}%"
                              for s, p in sorted(shares.items()))
            print(f"  profiler sample shares: {parts}")
    rtc = (report.get("what_if") or {}).get("run_to_completion") or {}
    if rtc:
        print(f"what-if run-to-completion: saves "
              f"{rtc.get('continuation_hops_saved')} continuation "
              f"hops + {rtc.get('wakeups_saved')} wakeups "
              f"({rtc.get('saved_ms_per_op')} ms/op) -> projected "
              f"{rtc.get('whatif_rtc_MBps')} MB/s")
    _print_crimson(report)
    _print_read_balance(report)
    _print_tenants(report)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gap_report")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--osds", type=int, default=3)
    ap.add_argument("--obj-kb", type=float, default=64.0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--m", type=int, default=1)
    ap.add_argument("--backend", default="auto_device",
                    help="EC profile backend (default auto_device: the "
                         "card, or an error without one; cuda the same; "
                         "torch the plain versions on the CPU; native "
                         "the host library)")
    ap.add_argument("--full", action="store_true",
                    help="deployment-scale run: 12 osds, k=8 m=3, 4 MiB "
                         "objects, 20 s, on the card")
    ap.add_argument("--engine-gbps", type=float, default=None,
                    help="use this engine capacity instead of "
                         "measuring it on the card")
    ap.add_argument("--run-engine-loop", action="store_true",
                    help="measure the engine closed loop on the card "
                         "whatever the pool's backend")
    ap.add_argument("--profile", action="store_true",
                    help="run the cluster bench under the stack-"
                         "sampling profiler and append per-stage "
                         "top-10 hot frames to the table and the "
                         "JSON line")
    ap.add_argument("--profile-hz", type=float, default=50.0,
                    help="sampling rate for --profile")
    ap.add_argument("--no-crimson", action="store_true",
                    help="skip the measured crimson arm (and its "
                         "projection-honesty row)")
    ap.add_argument("--no-read-balance", action="store_true",
                    help="skip the primary-vs-any-k read storm "
                         "(and its read_balance verdict row)")
    ap.add_argument("--tenants", action="store_true",
                    help="run the tenant X-ray arm: a named-tenant "
                         "mix on BOTH flavors with the per-flow "
                         "attribution-coverage table (>= 95%% bar)")
    args = ap.parse_args(argv)
    if args.full:
        args.osds, args.k, args.m = 12, 8, 3
        args.obj_kb, args.seconds, args.threads = 4096, 20.0, 8
        args.backend = "cuda"
    report = run_report(args.seconds, args.osds,
                        int(args.obj_kb * 1024), args.threads,
                        args.k, args.m, args.backend, args)
    print_table(report)
    print(json.dumps({"gap_report": report}, sort_keys=True),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
