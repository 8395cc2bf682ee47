"""osdmaptool — inspect/test OSDMap placements (src/tools/osdmaptool role).

    python -m ceph_tpu_torch.tools.osdmaptool --createsimple N_OSDS \
        [--pool NAME --pg-num P --size S] [--ec k,m] --test-map-pgs
    python -m ceph_tpu_torch.tools.osdmaptool -m HOST:PORT --dump \
        [--test-map-pgs]

Offline mode builds a synthetic map (createsimple role); online mode
pulls the live map from a mon. ``--test-map-pgs`` replays
pg_to_up_acting for every PG of every pool and reports the per-OSD
primary/replica distribution.
"""

from __future__ import annotations

import argparse
import json
import sys

from ceph_tpu_torch.parallel import crush
from ceph_tpu_torch.parallel.osdmap import OSDMap


def build_simple(n_osds: int, pool: str, pg_num: int, size: int,
                 ec: str | None) -> OSDMap:
    m = OSDMap()
    m.crush = crush.build_flat_map(n_osds)
    for o in range(n_osds):
        info = m.add_osd(o, addr=f"127.0.0.1:{6800 + o}")
        info.up = True
    profile = None
    min_size = max(1, size - 1)
    if ec:
        k, mm = (int(x) for x in ec.split(","))
        profile = {"plugin": "jerasure", "k": str(k), "m": str(mm)}
        size, min_size = k + mm, k
    m.create_pool(pool, pg_num, "data", size, min_size,
                  ec_profile=profile)
    m.epoch = 1
    return m


def dump_map(m: OSDMap) -> dict:
    return {
        "epoch": m.epoch,
        "osds": {o: {"up": i.up, "in": i.in_cluster, "addr": i.addr}
                 for o, i in sorted(m.osds.items())},
        "pools": {p.name: {"id": pid, "pg_num": p.pg_num,
                           "size": p.size, "min_size": p.min_size,
                           "ec": bool(p.is_ec)}
                  for pid, p in sorted(m.pools.items())},
    }


def test_map_pgs(m: OSDMap) -> dict:
    primaries: dict[int, int] = {}
    replicas: dict[int, int] = {}
    bad = 0
    total = 0
    for pid, pool in m.pools.items():
        for ps in m.pgs_of_pool(pid):
            up, acting, primary = m.pg_to_up_acting(pid, ps)
            total += 1
            if primary < 0 or sum(1 for o in acting if o >= 0) < \
                    pool.min_size:
                bad += 1
            if primary >= 0:
                primaries[primary] = primaries.get(primary, 0) + 1
            for o in acting:
                if o >= 0:
                    replicas[o] = replicas.get(o, 0) + 1
    vals = list(replicas.values())
    mean = sum(vals) / len(vals) if vals else 0.0
    return {
        "pgs": total, "bad_mappings": bad,
        "primaries_per_osd": {str(k): v
                              for k, v in sorted(primaries.items())},
        "pgs_per_osd": {str(k): v for k, v in sorted(replicas.items())},
        "spread": {"mean": round(mean, 2),
                   "min": min(vals, default=0),
                   "max": max(vals, default=0)},
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="osdmaptool")
    ap.add_argument("--createsimple", type=int, metavar="N")
    ap.add_argument("--pool", default="data")
    ap.add_argument("--pg-num", type=int, default=64)
    ap.add_argument("--size", type=int, default=3)
    ap.add_argument("--ec", default=None, metavar="K,M")
    ap.add_argument("-m", dest="mon_addr")
    ap.add_argument("--dump", action="store_true")
    ap.add_argument("--test-map-pgs", action="store_true")
    args = ap.parse_args(argv)

    if args.createsimple is not None:
        m = build_simple(args.createsimple, args.pool, args.pg_num,
                         args.size, args.ec)
    elif args.mon_addr:
        from ceph_tpu_torch.client.rados import RadosClient
        client = RadosClient(args.mon_addr).connect()
        try:
            m = client.monc.osdmap
        finally:
            client.shutdown()
    else:
        print("need --createsimple or -m", file=sys.stderr)
        return 22
    if args.dump or not args.test_map_pgs:
        print(json.dumps(dump_map(m), indent=2))
    if args.test_map_pgs:
        rep = test_map_pgs(m)
        print(json.dumps(rep, indent=2))
        return 1 if rep["bad_mappings"] else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
