"""flame — render the profiler's folded stacks in a terminal.

The continuous profiler (utils/profiler.py) exports flamegraph
"folded" lines — ``stage;frame;frame;frame count`` — via ``profile
flame`` on any daemon's admin socket and ``/api/profile``. This tool
turns that text into something a terminal can read without external
flamegraph software:

    python -m ceph_tpu_torch.tools.flame dump.folded            # tree view
    python -m ceph_tpu_torch.tools.flame --top 20 dump.folded   # hot frames
    ... | python -m ceph_tpu_torch.tools.flame -                # from stdin
    python -m ceph_tpu_torch.tools.flame --stage commit_wait f  # one stage

The folded text itself is bit-compatible with Brendan Gregg's
``flamegraph.pl`` (the stage rides as the root frame), so a real SVG
is one pipe away where that tool exists.
"""

from __future__ import annotations

import argparse
import json
import sys

#: tree nodes below this share of total samples are pruned (noise)
_MIN_PCT = 0.5


def parse_folded(text: str) -> dict[tuple[str, ...], int]:
    """``stage;f1;f2 count`` lines -> {(stage, f1, f2): count}.
    Accepts the asok JSON payload (``{"folded": "..."}``) too."""
    text = text.strip()
    if text.startswith("{"):
        try:
            text = json.loads(text).get("folded", "")
        except ValueError:
            pass
    stacks: dict[tuple[str, ...], int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        body, _, count = line.rpartition(" ")
        if not body:
            continue
        try:
            n = int(count)
        except ValueError:
            continue
        key = tuple(body.split(";"))
        stacks[key] = stacks.get(key, 0) + n
    return stacks


def filter_stage(stacks: dict, stage: str) -> dict:
    return {k: v for k, v in stacks.items() if k and k[0] == stage}


def top_frames(stacks: dict, n: int = 20) -> list[tuple[str, int]]:
    """Self-sample (leaf frame) ranking — "where does the time
    actually burn"."""
    agg: dict[str, int] = {}
    for key, count in stacks.items():
        leaf = key[-1]
        agg[leaf] = agg.get(leaf, 0) + count
    return sorted(agg.items(), key=lambda kv: -kv[1])[:n]


class _Node:
    __slots__ = ("count", "children")

    def __init__(self) -> None:
        self.count = 0
        self.children: dict[str, _Node] = {}


def build_tree(stacks: dict) -> _Node:
    root = _Node()
    for key, count in stacks.items():
        root.count += count
        node = root
        for frame in key:
            node = node.children.setdefault(frame, _Node())
            node.count += count
    return root


def render_tree(root: _Node, min_pct: float = _MIN_PCT,
                width: int = 100) -> str:
    """Indented inclusive-sample tree, heaviest child first — the
    flamegraph, rotated 90 degrees for a terminal."""
    total = max(root.count, 1)
    lines: list[str] = []

    def walk(node: _Node, depth: int) -> None:
        for frame, child in sorted(node.children.items(),
                                   key=lambda kv: -kv[1].count):
            pct = 100.0 * child.count / total
            if pct < min_pct:
                continue
            bar = "#" * max(1, int(pct / 2))
            label = f"{'  ' * depth}{frame}"
            lines.append(f"{label[:width - 22]:<{width - 22}}"
                         f"{child.count:>7} {pct:>5.1f}% {bar}")
            walk(child, depth + 1)

    walk(root, 0)
    return "\n".join(lines)


def render_top(stacks: dict, n: int) -> str:
    total = max(sum(stacks.values()), 1)
    lines = [f"{'self':>7} {'share':>6}  frame"]
    for frame, count in top_frames(stacks, n):
        lines.append(f"{count:>7} {100.0 * count / total:>5.1f}%  "
                     f"{frame}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flame")
    ap.add_argument("path", help="folded-stacks file, a 'profile "
                                 "flame' JSON payload, or - for stdin")
    ap.add_argument("--top", type=int, default=0, metavar="N",
                    help="print the top-N hot frames (self samples) "
                         "instead of the tree")
    ap.add_argument("--stage", default="",
                    help="restrict to one stage root (e.g. "
                         "commit_wait)")
    ap.add_argument("--min-pct", type=float, default=_MIN_PCT,
                    help="prune tree nodes under this share")
    args = ap.parse_args(argv)
    text = sys.stdin.read() if args.path == "-" else \
        open(args.path).read()
    stacks = parse_folded(text)
    if args.stage:
        stacks = filter_stage(stacks, args.stage)
    if not stacks:
        print("no samples", file=sys.stderr)
        return 1
    if args.top:
        print(render_top(stacks, args.top))
    else:
        print(render_tree(build_tree(stacks), min_pct=args.min_pct))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
