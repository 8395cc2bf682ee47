#!/usr/bin/env python
"""Static-analysis driver: run the seven AST lint families over the
``ceph_tpu_torch`` package and diff against the justified baseline.

    python -m ceph_tpu_torch.analysis        # same entry point
    python -m ceph_tpu_torch.tools.analyze [--json] [--no-baseline]
                                           [--update-baseline]

Exit status: 0 = clean (no findings outside analysis/baseline.json and
no stale baseline entries); 1 = new findings or stale entries, the
same verdict tests/test_torch_static_analysis.py gates.
"""

from __future__ import annotations

import argparse
import json

from ceph_tpu_torch.analysis import linters


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default=linters.PKG_ROOT,
                   help="package root to lint (default: ceph_tpu_torch/)")
    p.add_argument("--baseline", default=linters.BASELINE_PATH,
                   help="baseline/allowlist path")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignore the baseline")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report")
    p.add_argument("--update-baseline", action="store_true",
                   help="write current findings into the baseline "
                        "with TODO justifications (each one must be "
                        "filled in before the gate accepts it)")
    args = p.parse_args(argv)

    findings = linters.run_all(args.root)
    baseline = linters.load_baseline(args.baseline)

    if args.update_baseline:
        old = {e["key"]: e for e in baseline.get("lint", ())}
        entries = []
        for f in findings:
            prev = old.get(f.key)
            entries.append({
                "key": f.key,
                "justification": prev["justification"] if prev
                else "TODO: justify or fix",
            })
        baseline["lint"] = entries
        baseline.setdefault("witness", [])
        with open(args.baseline, "w") as fh:
            json.dump(baseline, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {len(entries)} baseline entries to "
              f"{args.baseline}")
        return 0

    if args.no_baseline:
        new, stale = findings, []
    else:
        new, stale = linters.diff_baseline(findings, baseline)

    if args.json:
        print(json.dumps({
            "total": len(findings),
            "new": [f.__dict__ for f in new],
            "stale_baseline": stale,
        }, indent=1))
    else:
        by_checker: dict[str, int] = {}
        for f in findings:
            by_checker[f.checker] = by_checker.get(f.checker, 0) + 1
        print(f"{len(findings)} finding(s) total "
              f"({', '.join(f'{k}={v}' for k, v in sorted(by_checker.items())) or 'none'}), "
              f"{len(findings) - len(new)} baselined, {len(new)} new, "
              f"{len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'}")
        for f in new:
            print("NEW  " + f.format())
        for e in stale:
            print(f"STALE baseline entry {e['key']}: violation no "
                  "longer exists; prune it")
    return 1 if (new or stale) else 0


if __name__ == "__main__":
    raise SystemExit(main())
