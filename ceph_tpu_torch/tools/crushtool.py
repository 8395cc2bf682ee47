"""crushtool — build/test CRUSH maps offline (src/tools/crushtool role).

    python -m ceph_tpu_torch.tools.crushtool --build N_OSDS [--per-host H] \
        [--out MAP.json]
    python -m ceph_tpu_torch.tools.crushtool --map MAP.json --test \
        [--rule data] [--num-rep R] [--min-x A --max-x B]
    python -m ceph_tpu_torch.tools.crushtool --map MAP.json --show

``--test`` replays CrushTester: runs the rule over the x range and
reports per-device utilization, bad (short) mappings, and the spread
statistics — how you validate placement before pushing a map.
"""

from __future__ import annotations

import argparse
import json
import sys

from ceph_tpu_torch.parallel import crush


def map_to_json(cm: crush.CrushMap) -> dict:
    def item_name(i: int):
        return i if i >= 0 else cm.buckets[i].name

    return {
        "buckets": [
            {"name": b.name, "type": b.type,
             "children": [item_name(i) for i in b.items],
             "weights": list(b.weights)}
            for b in cm.buckets.values()],
        "devices": {str(o): w for o, w in cm.device_weights.items()},
        "rules": {
            name: {"root": r.root, "failure_domain": r.failure_domain,
                   "mode": r.mode}
            for name, r in cm.rules.items()},
    }


def map_from_json(d: dict) -> crush.CrushMap:
    cm = crush.CrushMap()
    by_child: dict[str, str] = {}
    for b in d["buckets"]:
        for c in b["children"]:
            if isinstance(c, str):
                by_child[c] = b["name"]
    roots = [b for b in d["buckets"]
             if b["name"] not in by_child]
    # create parents before children
    created: set[str] = set()

    def create(bname: str) -> None:
        if bname in created:
            return
        b = next(x for x in d["buckets"] if x["name"] == bname)
        parent = by_child.get(bname)
        weight = 1.0
        if parent:
            create(parent)
            pb = next(x for x in d["buckets"] if x["name"] == parent)
            weight = pb["weights"][pb["children"].index(bname)]
        cm.add_bucket(bname, b["type"], parent=parent, weight=weight)
        created.add(bname)

    for b in d["buckets"]:
        create(b["name"])
    for b in d["buckets"]:
        for c, w in zip(b["children"], b["weights"]):
            if isinstance(c, int):
                cm.add_device(c, b["name"], weight=w)
    for osd, w in d.get("devices", {}).items():
        if int(osd) not in cm.device_weights:
            continue
        cm.reweight(int(osd), w)
    for name, r in d["rules"].items():
        cm.add_rule(crush.Rule(name, root=r["root"],
                               failure_domain=r["failure_domain"],
                               mode=r["mode"]))
    return cm


def test_map(cm: crush.CrushMap, rule: str, num_rep: int,
             min_x: int, max_x: int) -> dict:
    """CrushTester::test role: mapping quality over an input range."""
    util: dict[int, int] = {}
    bad = 0
    total = 0
    for x in range(min_x, max_x + 1):
        out = cm.do_rule(rule, x, num_rep)
        total += 1
        if len([o for o in out if o >= 0]) < num_rep:
            bad += 1
        for o in out:
            if o >= 0:
                util[o] = util.get(o, 0) + 1
    vals = list(util.values())
    mean = sum(vals) / len(vals) if vals else 0.0
    return {
        "rule": rule, "num_rep": num_rep,
        "inputs": total, "bad_mappings": bad,
        "device_utilization": {str(k): v for k, v in sorted(util.items())},
        "spread": {
            "mean": round(mean, 2),
            "min": min(vals, default=0),
            "max": max(vals, default=0),
            "stddev_pct": round(
                100.0 * (sum((v - mean) ** 2 for v in vals)
                         / len(vals)) ** 0.5 / mean, 2) if mean else 0.0,
        },
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="crushtool")
    ap.add_argument("--build", type=int, metavar="N_OSDS")
    ap.add_argument("--per-host", type=int, default=4)
    ap.add_argument("--out")
    ap.add_argument("--map", dest="map_path")
    ap.add_argument("--show", action="store_true")
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--rule", default="data")
    ap.add_argument("--num-rep", type=int, default=3)
    ap.add_argument("--min-x", type=int, default=0)
    ap.add_argument("--max-x", type=int, default=1023)
    args = ap.parse_args(argv)

    if args.build is not None:
        cm = crush.build_flat_map(args.build, args.per_host)
        doc = json.dumps(map_to_json(cm), indent=2, sort_keys=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(doc)
        else:
            print(doc)
        return 0
    if not args.map_path:
        print("need --build or --map", file=sys.stderr)
        return 22
    with open(args.map_path) as f:
        cm = map_from_json(json.load(f))
    if args.show:
        print(json.dumps(map_to_json(cm), indent=2, sort_keys=True))
    if args.test:
        rep = test_map(cm, args.rule, args.num_rep,
                       args.min_x, args.max_x)
        print(json.dumps(rep, indent=2))
        return 1 if rep["bad_mappings"] else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
