"""Phase 5c's fault sequence on either package, on the CPU.

A 12-OSD ``MiniCluster`` of ``ceph_tpu_torch`` (pool ``backend=torch``)
or ``ceph_tpu`` (``backend=numpy``) with an ISA ``reed_sol_van`` k=8,m=3
pool, ``pg_num`` 32, at Ceph's 20 s heartbeat grace: 512 objects of 64 KiB
written from 8 threads, OSDs 3 and 7 killed under the ``fast_death`` knobs
(0.25 s / 1 s) until both are marked down, the 512 read degraded, 32 more
written and read, both OSDs revived and ``wait_for_clean`` (240 s at
most). Prints one ``RESULT {json}`` line a run: the step walls, each
OSD's map epoch around the kill, the degraded reads' latency spread and
the OSDs' read-retry counters, every object whose shards disagree on the
version after the degraded writes and after recovery, and whether the
pool got clean. Each run is its own process (``--runs`` starts them one
after the other and prints a summary).

    JAX_PLATFORMS=cpu python tests/fault_sequence.py ceph_tpu_torch 1
    JAX_PLATFORMS=cpu python tests/fault_sequence.py --runs 10

``--serving`` runs phase 5f's load-generator ladder instead (host route,
512 keys of 64 KiB, 4 s phases; ``--device`` through the engine);
``--stale-missing`` the recovery livelock's smallest sequence on both
packages (:func:`stale_missing_run`: the reference keeps the stale
entries, the port clears them).
Not collected by pytest: a run takes 1-3 minutes.
"""

import argparse
import contextlib
import importlib
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
N_OBJ, EXTRA, OBJ_BYTES, KILLED = 512, 32, 64 << 10, (3, 7)
GRACE = {"osd_heartbeat_grace": 20.0}
FAST_DEATH = {"osd_heartbeat_interval": 0.25, "osd_heartbeat_grace": 1.0}
BACKEND = {"ceph_tpu_torch": "torch", "ceph_tpu": "numpy"}
COUNTERS = ("read_retries", "degraded_reads", "read_version_splits",
            "xor_fast_decodes")


def _threaded(fn, n, threads=8):
    errs = []

    def run(t):
        try:
            for i in range(t, n, threads):
                fn(i)
        except Exception as exc:      # reported in the RESULT line
            errs.append(repr(exc))

    ts = [threading.Thread(target=run, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    return time.perf_counter() - t0, errs[:3]


@contextlib.contextmanager
def _knobs(conf, knobs):
    old = {k: conf[k] for k in knobs}
    for k, v in knobs.items():
        conf.set(k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            conf.set(k, v)


def _split_versions(cluster, pg_cid, pool, names) -> dict:
    """Objects whose stored shards disagree on ``v`` (or lack it)."""
    osdmap = cluster.mon.osdmap
    out = {}
    for oid in names:
        ps = osdmap.object_to_pg(pool, oid)
        _, acting, _ = osdmap.pg_to_up_acting(pool, ps)
        vers = {}
        for pos, osd in enumerate(acting):
            store = cluster._stores.get(osd)
            if osd < 0 or store is None:
                continue
            try:
                attrs = store.getattrs(pg_cid(pool, ps, pos), oid)
                vers[pos] = int.from_bytes(attrs.get("v", b""), "little")
            except Exception:
                vers[pos] = None
        if None in vers.values() or len(set(vers.values())) > 1:
            out[oid] = {"ps": ps, "acting": list(acting), "v": vers}
    return out


def one_run(pkg: str, run: int) -> dict:
    sys.path.insert(0, str(REPO))
    cluster_cls = importlib.import_module(f"{pkg}.qa.cluster").MiniCluster
    g_conf = importlib.import_module(f"{pkg}.utils.config").g_conf
    pg_cid = importlib.import_module(f"{pkg}.osd.pg").pg_cid
    rng = np.random.default_rng(20261016 + 13 + run)
    data = rng.integers(0, 256, (N_OBJ + EXTRA) * OBJ_BYTES, dtype=np.uint8)
    pays = {f"obj{i}": data[i * OBJ_BYTES:(i + 1) * OBJ_BYTES].tobytes()
            for i in range(N_OBJ + EXTRA)}
    oids = [f"obj{i}" for i in range(N_OBJ)]
    late = [f"obj{i}" for i in range(N_OBJ, N_OBJ + EXTRA)]
    out = {"pkg": pkg, "run": run}
    t_run = time.perf_counter()
    with _knobs(g_conf(), GRACE), cluster_cls(n_osds=12) as c:
        c.create_ec_pool("rbd_ec", k=8, m=3, plugin="isa",
                         technique="reed_sol_van", pg_num=32,
                         backend=BACKEND[pkg])
        pool = c.mon.osdmap.pool_by_name["rbd_ec"]
        rados = c.client()
        io = rados.open_ioctx("rbd_ec")
        io.op_timeout = 120.0

        def epochs():
            return {i: o.osdmap.epoch if o.osdmap else None
                    for i, o in c.osds.items()}

        def counters():
            tot = {}
            for o in c.osds.values():
                for k in COUNTERS:
                    tot[k] = tot.get(k, 0) + o.logger.get(k)
            return tot

        lat = []

        def read(names, label, keep=False):
            def one(i):
                t0 = time.perf_counter()
                if io.read(names[i]) != pays[names[i]]:
                    raise AssertionError(f"{label} read of {names[i]}")
                if keep:
                    lat.append(time.perf_counter() - t0)
            return _threaded(one, len(names))

        out["write_s"], out["write_errs"] = _threaded(
            lambda i: io.write_full(oids[i], pays[oids[i]]), N_OBJ)
        epoch = c.epoch()
        out["epochs_before_kill"] = epochs()
        t0 = time.perf_counter()
        with _knobs(g_conf(), FAST_DEATH):
            for osd in KILLED:
                c.kill_osd(osd)
            for osd in KILLED:
                c.wait_for_osd_down(osd, timeout=60)
        out["down_s"] = time.perf_counter() - t0
        rados.wait_for_epoch(epoch + 1, timeout=30)
        out["epochs_after_kill"] = epochs()
        c0 = counters()
        out["degraded_read_s"], out["degraded_read_errs"] = read(
            oids, "degraded", keep=True)
        c1 = counters()
        out["degraded_counters"] = {k: c1[k] - c0[k] for k in COUNTERS}
        lat.sort()
        out["degraded_read_latency_s"] = {
            "p50": lat[len(lat) // 2], "p99": lat[int(len(lat) * .99)],
            "max": lat[-1], "over_1s": sum(x > 1 for x in lat)}
        out["degraded_write_s"], out["degraded_write_errs"] = _threaded(
            lambda i: io.write_full(late[i], pays[late[i]]), EXTRA)
        out["late_read_s"], out["late_read_errs"] = read(late, "late")
        out["split_after_degraded_writes"] = _split_versions(
            c, pg_cid, pool, late)
        t0 = time.perf_counter()
        for osd in KILLED:
            c.revive_osd(osd)
        c.wait_for_osds_up(timeout=60)
        try:
            c.wait_for_clean(timeout=240)
            out["clean"] = True
        except Exception as exc:      # the hang this script looks for
            out["clean"] = False
            out["clean_err"] = repr(exc)[:300]
            out["dirty"] = c._dirty_pgs()[:10]
        out["recovery_s"] = time.perf_counter() - t0
        out["split_after_recovery"] = _split_versions(
            c, pg_cid, pool, oids + late)
        if out["clean"]:
            _, out["final_read_errs"] = read(oids + late, "final")
    out["total_s"] = time.perf_counter() - t_run
    return out


def serving_run(pkg: str, run: int, n_keys: int = 512,
                obj_bytes: int = 64 << 10, phase_s: float = 4.0,
                device: bool = False) -> dict:
    """Phase 5f's sequence on ``pkg``'s host route (``device``: its device
    route through the engine, ``torch`` / ``jax``): the load generator's
    ladder (zipfian 0.99, half reads, 8 closed-loop clients, the highest
    OSD killed under the ``fast_death`` knobs and revived) on a 12-OSD
    ISA k=8,m=3 pool, ``pg_num`` 32, at Ceph's 20 s grace; the clean wait
    at most 120 s. Returns the phases' ops, whether the pool got clean,
    the dirty PGs if not, and the durability sweep."""
    sys.path.insert(0, str(REPO))
    cluster_cls = importlib.import_module(f"{pkg}.qa.cluster").MiniCluster
    g_conf = importlib.import_module(f"{pkg}.utils.config").g_conf
    lg = importlib.import_module(f"{pkg}.bench.load_gen")
    out = {"pkg": pkg, "run": run, "mode": "serving"}
    t0 = time.perf_counter()
    with _knobs(g_conf(), GRACE), cluster_cls(n_osds=12) as c:
        c.faults.reseed(20261016 + run)
        extra = {"backend": "torch" if pkg == "ceph_tpu_torch" else "jax"} \
            if device else {}
        c.create_ec_pool("rbd_ec", k=8, m=3, plugin="isa",
                         technique="reed_sol_van", pg_num=32, **extra)
        spec = lg.LoadSpec(n_keys=n_keys, obj_size=obj_bytes,
                           read_frac=0.5, concurrency=8,
                           phase_seconds=phase_s, seed=20261016 + run,
                           zipf_theta=0.99, op_timeout=300.0)
        gen = lg.LoadGen(c, "rbd_ec", spec)
        kill, wait_down = c.kill_osd, c.wait_for_osd_down
        old = {k: g_conf()[k] for k in FAST_DEATH}

        def kill_fast(osd_id):
            for k, v in FAST_DEATH.items():
                g_conf().set(k, v)
            kill(osd_id)

        def wait_down_then_restore(osd_id, timeout=30.0):
            try:
                wait_down(osd_id, timeout=60)
            finally:
                for k, v in old.items():
                    g_conf().set(k, v)

        c.kill_osd, c.wait_for_osd_down = kill_fast, wait_down_then_restore
        try:
            report = gen.run(clean_timeout=120.0)
            out["clean"] = True
            out["phases"] = [(p["phase"], p["ops"], p["p99_ms"])
                             for p in report["phases"]]
            out["verify"] = {k: report["verify"][k][:3] for k in
                             ("lost_acked", "wrong_bytes", "corruptions")}
        except TimeoutError as exc:       # the hang this mode looks for
            out["clean"] = False
            out["clean_err"] = repr(exc)[:400]
            out["phases"] = [(p["phase"], p["ops"], p["p99_ms"])
                             for p in gen.phase_reports]
        finally:
            c.kill_osd, c.wait_for_osd_down = kill, wait_down
    out["total_s"] = time.perf_counter() - t0
    return out


def stale_missing_run(pkg: str, rounds: int = 4) -> dict:
    """The recovery livelock on its smallest sequence: a 3-OSD k=2,m=1
    pool, one object written, then the primary's PG told that the two
    other positions miss the object's current version (which their
    shards hold: a stale ``peer_missing``), and ``rounds`` recovery
    rounds. ``ECBackend._read_shards`` reads around the positions listed
    as missing, so fewer than k remain and ``build_push`` fails; the
    rollback probe sees k shards at the wanted version and leaves it to
    the normal path. Returns whether the entries cleared."""
    sys.path.insert(0, str(REPO))
    cluster_cls = importlib.import_module(f"{pkg}.qa.cluster").MiniCluster
    with cluster_cls(n_osds=3) as c:
        c.create_ec_pool("p", k=2, m=1, pg_num=1)
        io = c.client().open_ioctx("p")
        io.write_full("obj", b"x" * 20000)
        pool = c.mon.osdmap.pool_by_name["p"]
        _, acting, primary = c.mon.osdmap.pg_to_up_acting(pool, 0)
        osd = c.osds[primary]
        pg = osd.pgs[(pool, 0)]
        with pg.lock:
            pg.peer_missing = {p: {"obj": pg.log.last_version}
                               for p in range(3) if acting[p] != primary}
        for _ in range(rounds):
            osd._recover(pg)
        left = {p: dict(m) for p, m in pg.peer_missing.items() if m}
    return {"pkg": pkg, "mode": "stale_missing", "rounds": rounds,
            "peer_missing_left": left, "cleared": not left}


def _summary(results: list) -> dict:
    by_pkg = {}
    for r in results:
        by_pkg.setdefault(r["pkg"], []).append(r)
    out = {}
    for pkg, rs in by_pkg.items():
        dr = [r["degraded_read_s"] for r in rs]
        dw = [r["degraded_write_s"] for r in rs]
        out[pkg] = {
            "runs": len(rs), "clean": sum(r["clean"] for r in rs),
            "degraded_read_s": [min(dr), statistics.median(dr), max(dr)],
            "degraded_write_s": [min(dw), statistics.median(dw), max(dw)],
            "degraded_writes_over_10s": sum(x > 10 for x in dw),
            "runs_with_split_after_recovery":
                sum(bool(r["split_after_recovery"]) for r in rs),
            "peering_retries": [r.get("peering_retries", 0) for r in rs]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fault_sequence")
    ap.add_argument("pkg", nargs="?", choices=sorted(BACKEND))
    ap.add_argument("run", nargs="?", type=int, default=1)
    ap.add_argument("--stale-missing", action="store_true",
                    help="the recovery livelock's smallest sequence, on "
                         "both packages")
    ap.add_argument("--serving", action="store_true",
                    help="phase 5f's load-generator ladder instead of "
                         "phase 5c's sequence (host route, 64 KiB keys)")
    ap.add_argument("--device", action="store_true",
                    help="with --serving: the device route (torch / jax "
                         "through the engine) instead of the host route")
    ap.add_argument("--runs", type=int, default=0,
                    help="run the sequence N times on each package, one "
                         "process a run, in turns")
    args = ap.parse_args(argv)
    if args.stale_missing:
        for pkg in ("ceph_tpu_torch", "ceph_tpu"):
            print("RESULT " + json.dumps(stale_missing_run(pkg)),
                  flush=True)
        return 0
    if not args.runs:
        if args.serving:
            res = serving_run(args.pkg, args.run, device=args.device)
        else:
            res = one_run(args.pkg, args.run)
        print("RESULT " + json.dumps(res), flush=True)
        return 0
    results = []
    for run in range(1, args.runs + 1):
        for pkg in ("ceph_tpu_torch", "ceph_tpu"):
            proc = subprocess.run(
                [sys.executable, __file__, pkg, str(run)]
                + (["--serving"] if args.serving else [])
                + (["--device"] if args.device else []),
                capture_output=True, text=True, timeout=900)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("RESULT ")]
            if proc.returncode or not lines:
                print(f"{pkg} run {run}: rc {proc.returncode}\n"
                      f"{proc.stderr[-2000:]}", flush=True)
                continue
            res = json.loads(lines[-1][7:])
            res["peering_retries"] = proc.stderr.count("retrying peering")
            results.append(res)
            keys = ("pkg", "run", "clean", "phases", "peering_retries") \
                if args.serving else (
                    "pkg", "run", "degraded_read_s", "degraded_write_s",
                    "recovery_s", "clean", "peering_retries")
            print(json.dumps({k: res.get(k) for k in keys}), flush=True)
    if args.serving:
        for pkg in ("ceph_tpu_torch", "ceph_tpu"):
            rs = [r for r in results if r["pkg"] == pkg]
            print("SUMMARY " + json.dumps({
                "pkg": pkg, "runs": len(rs),
                "hung": sum(not r["clean"] for r in rs)}), flush=True)
    else:
        print("SUMMARY " + json.dumps(_summary(results)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
