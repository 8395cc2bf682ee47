"""trace_export — render traces and autopsies as Chrome-trace JSON.

Perfetto (ui.perfetto.dev) and chrome://tracing both load the Chrome
Trace Event format: ``{"traceEvents": [...]}`` with microsecond
timestamps. This tool maps the tail sampler's artifacts onto it:

- every **service** (client.x, osd.N, mgr) becomes a process row
  (``pid`` + a ``process_name`` metadata event), so one export shows
  the op crossing daemons;
- every **span** is a complete event (``ph: "X"``) whose ``tid`` is
  its depth in the span tree — nested spans stack like a flame;
- span **events** become instant events (``ph: "i"``) at their offset;
- **engine flush windows** (spans named ``engine_flush`` /
  ``kernel_dispatch``) additionally emit async begin/end pairs
  (``ph: "b"/"e"``, cat ``engine``) so the batching window reads as
  one horizontal bar across the ops that shared it;
- an **autopsy**'s stage timeline renders as a ``timeline`` process
  row: one X event per stage interval, wall-anchored with the
  ``wall_epoch`` field of each span.

Timestamps use each span's wall anchor (``wall``) so rows from
different daemons align on the epoch axis.

CLI (also via the repo-root shim ``tools/trace_export.py``)::

    python -m ceph_tpu_torch.tools.trace_export --input trace.json \
        [--output out.json]

``--input`` accepts any of: a kept-trace record (``{"spans": [...]}``,
the mgr ``trace dump``/archive shape), a bare span list (the asok
``dump_traces`` shape), an autopsy entry (``{"spans", "timeline",
...}`` from ``dump_autopsies``), or a dispatch snapshot
(``{"recent_chains": [...]}`` from ``dump_dispatch`` — one
track per logical thread of the data path, one slice per queue wait,
and a flow arrow per cross-thread hop, so an op's causal chain
``admission -> N hops -> commit reply`` reads as connected arrows in
Perfetto). ``-`` reads stdin.
"""

from __future__ import annotations

import argparse
import json
import sys

#: span names that also render as async engine-window bars
_ENGINE_SPANS = ("engine_flush", "kernel_dispatch")


def _pid_map(spans: list[dict]) -> dict[str, int]:
    """Stable service -> pid assignment (sorted, 1-based)."""
    return {svc: i + 1
            for i, svc in enumerate(
                sorted({s.get("service", "?") for s in spans}))}


def _depths(spans: list[dict]) -> dict[int, int]:
    """span_id -> depth via parent links (orphans are depth 0)."""
    parents = {s["span_id"]: s["parent_id"] for s in spans}
    depths: dict[int, int] = {}

    def depth(sid: int, hop: int = 0) -> int:
        if sid in depths:
            return depths[sid]
        parent = parents.get(sid, 0)
        if parent == 0 or parent not in parents or hop > 64:
            depths[sid] = 0
        else:
            depths[sid] = depth(parent, hop + 1) + 1
        return depths[sid]

    for sid in parents:
        depth(sid)
    return depths


def to_chrome_trace(spans: list[dict], title: str = "",
                    timeline: dict | None = None) -> dict:
    """Span dicts (tracing.Span.dump shape) -> Chrome-trace JSON.
    ``timeline`` (a StageClock dump) adds the stage rows."""
    pids = _pid_map(spans)
    depths = _depths(spans)
    events: list[dict] = []
    for svc, pid in pids.items():
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name",
                       "args": {"name": svc}})
    for s in spans:
        pid = pids.get(s.get("service", "?"), 0)
        tid = depths.get(s["span_id"], 0)
        ts = s.get("wall", 0.0) * 1e6
        dur = max(s.get("duration", 0.0), 0.0) * 1e6
        args = {"trace_id": s.get("trace_id", ""),
                "span_id": s["span_id"],
                "parent_id": s["parent_id"]}
        if s.get("error"):
            args["error"] = s["error"]
        events.append({"ph": "X", "name": s.get("name", "?"),
                       "cat": "span", "pid": pid, "tid": tid,
                       "ts": ts, "dur": dur, "args": args})
        for ev in s.get("events", ()):
            events.append({"ph": "i", "s": "t",
                           "name": ev.get("event", "?"),
                           "cat": "span", "pid": pid, "tid": tid,
                           "ts": ts + ev.get("t", 0.0) * 1e6})
        if any(s.get("name", "").startswith(n)
               for n in _ENGINE_SPANS):
            # the flush window as one async bar: ops sharing a flush
            # produce overlapping bars on the engine track
            ident = str(s["span_id"])
            base = {"cat": "engine", "name": s["name"], "pid": pid,
                    "id": ident,
                    "args": {"trace_id": s.get("trace_id", "")}}
            events.append(dict(base, ph="b", ts=ts))
            events.append(dict(base, ph="e", ts=ts + dur))
    if timeline:
        events.extend(_timeline_events(timeline,
                                       pid=len(pids) + 1))
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if title:
        out["otherData"] = {"title": title}
    return out


def _timeline_events(timeline: dict, pid: int) -> list[dict]:
    """A StageClock dump as one 'timeline' process row: each stage
    interval is an X event ending at its mark (the stage-names-the-
    interval-ending-at-it semantics of utils/stage_clock)."""
    wall0 = timeline.get("wall_epoch", 0.0) * 1e6
    events: list[dict] = [{"ph": "M", "pid": pid, "tid": 0,
                           "name": "process_name",
                           "args": {"name": "timeline"}}]

    def rows(stages, tid):
        for st in stages:
            dur = st.get("dur_us", 0.0)
            if dur <= 0:
                continue
            events.append({"ph": "X", "name": st["stage"],
                           "cat": "stage", "pid": pid, "tid": tid,
                           "ts": wall0 + st["t_us"] - dur,
                           "dur": dur})

    rows(timeline.get("stages", ()), 0)
    for i, (label, stages) in enumerate(
            sorted(timeline.get("children", {}).items())):
        events.append({"ph": "M", "pid": pid, "tid": i + 1,
                       "name": "thread_name",
                       "args": {"name": label}})
        rows(stages, i + 1)
    return events


def to_dispatch_trace(chains: list[dict]) -> dict:
    """Per-op causal handoff chains (the ``dump_dispatch``
    ``recent_chains`` ring) -> Chrome-trace JSON: one ``dispatch``
    process, one thread row per logical track, each hop an X slice of
    its queue wait on the DESTINATION track, plus a flow-event pair
    (``ph: "s"``/``"f"``) from the source track to the slice end so
    the cross-thread arrow renders in Perfetto."""
    events: list[dict] = [{"ph": "M", "pid": 1, "tid": 0,
                           "name": "process_name",
                           "args": {"name": "dispatch"}}]
    tids: dict[str, int] = {}

    def tid(track: str) -> int:
        if track not in tids:
            tids[track] = len(tids) + 1
            events.append({"ph": "M", "pid": 1, "tid": tids[track],
                           "name": "thread_name",
                           "args": {"name": track}})
        return tids[track]

    flow = 0
    for ci, chain in enumerate(chains):
        wall0 = chain.get("wall_epoch", 0.0) * 1e6
        for hop in chain.get("hops", ()):
            flow += 1
            src = tid(hop.get("src", "?"))
            dst = tid(hop.get("dst", "?"))
            wait = max(hop.get("wait_us", 0.0), 0.0)
            end = wall0 + hop.get("t_us", 0.0)
            start = end - wait
            name = hop.get("seam") or hop.get("stage") or "hop"
            base = {"name": name, "cat": "handoff", "pid": 1}
            events.append(dict(base, ph="X", tid=dst, ts=start,
                               dur=wait,
                               args={"stage": hop.get("stage", ""),
                                     "chain": ci}))
            events.append(dict(base, ph="s", tid=src, ts=start,
                               id=flow))
            events.append(dict(base, ph="f", bp="e", tid=dst, ts=end,
                               id=flow))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export(doc) -> dict:
    """Accept any supported input shape (see module docstring)."""
    if isinstance(doc, list):
        if doc and isinstance(doc[0], dict) and "hops" in doc[0]:
            return to_dispatch_trace(doc)    # bare chain ring
        return to_chrome_trace(doc)
    if isinstance(doc, dict) and "recent_chains" in doc:
        return to_dispatch_trace(doc["recent_chains"])
    if isinstance(doc, dict) and "spans" in doc:
        return to_chrome_trace(
            doc["spans"], title=doc.get("root", ""),
            timeline=doc.get("timeline"))
    if isinstance(doc, dict) and "traceEvents" in doc:
        return doc        # already exported
    raise ValueError(
        "unrecognized input: expected a span list, a kept-trace "
        "record, an autopsy entry, or a dispatch snapshot")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render a kept trace or autopsy as Chrome-trace/"
                    "Perfetto JSON")
    ap.add_argument("--input", "-i", required=True,
                    help="JSON file (or '-' for stdin): span list, "
                         "kept-trace record, or autopsy entry")
    ap.add_argument("--output", "-o", default="-",
                    help="output file (default stdout)")
    args = ap.parse_args(argv)
    if args.input == "-":
        doc = json.load(sys.stdin)
    else:
        with open(args.input) as f:
            doc = json.load(f)
    out = export(doc)
    text = json.dumps(out, indent=1)
    if args.output == "-":
        print(text)
    else:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"wrote {len(out['traceEvents'])} events to "
              f"{args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
