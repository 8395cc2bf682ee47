"""trace — the mgr's cluster-wide trace assembly module.

The tail sampler (utils/tracing) keeps interesting traces in a
bounded per-process ring. This module is the MMgrReport-style leg
that makes them an OPERATOR surface: each tick it pulls newly kept
traces over the tracer's ``kept_after`` cursor (daemons share the
process here, so one pull covers client, primary, shard OSDs and the
engine; a multi-process port would push the same records in the mgr
report), archives them in a bounded map, and serves:

- ``trace ls``               one row per archived trace (id, reason,
                             root op, duration, services touched)
- ``trace dump <trace_id>``  ONE merged span tree spanning every
                             daemon the op crossed
- ``trace export <trace_id>`` the same trace as Chrome-trace/Perfetto
                             JSON (tools/trace_export)
- ``trace status``           cursor + archive occupancy + tracer
                             keep/drop counters

driven through the mgr command seam (``ceph_tpu_torch.tools.ceph_cli daemon
<mgr.asok> trace dump trace_id=...``).
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict

from ceph_tpu_torch.mgr.mgr_module import MgrModule
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.utils.tracing import build_tree, tracer

log = Dout("mgr")


class TraceArchive:
    """Bounded trace_id -> kept-trace record map, insertion-ordered
    (eviction drops the oldest). Locked: the mgr tick and the asok
    command thread both touch it."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._lock = threading.Lock()
        self._records: "OrderedDict[str, dict]" = OrderedDict()

    def add(self, rec: dict) -> None:
        tid = rec["trace_id"]
        with self._lock:
            if tid in self._records:
                self._records.pop(tid)
            while len(self._records) >= self.capacity:
                self._records.popitem(last=False)
            self._records[tid] = rec

    def get(self, trace_id: str) -> dict | None:
        with self._lock:
            return self._records.get(trace_id)

    def rows(self) -> list[dict]:
        with self._lock:
            records = list(self._records.values())
        return [{"trace_id": r["trace_id"], "reason": r["reason"],
                 "root": r["root"], "op_type": r.get("op_type", ""),
                 "duration_ms": round(r["duration_s"] * 1e3, 3),
                 "wall": r["wall"],
                 "services": sorted({s["service"]
                                     for s in r["spans"]}),
                 "num_spans": len(r["spans"])}
                for r in records]

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)


def assemble(rec: dict) -> dict:
    """One kept-trace record as the merged cross-daemon tree."""
    spans = rec["spans"]
    return {"trace_id": rec["trace_id"], "reason": rec["reason"],
            "root": rec["root"], "op_type": rec.get("op_type", ""),
            "duration_ms": round(rec["duration_s"] * 1e3, 3),
            "wall": rec["wall"], "error": rec.get("error", ""),
            "num_spans": len(spans),
            "services": sorted({s["service"] for s in spans}),
            "tree": build_tree(spans)}


class Module(MgrModule):
    NAME = "trace"
    TICK_PERIOD = 0.25

    COMMANDS = ("status", "ls", "dump", "export")

    def __init__(self, mgr) -> None:
        super().__init__(mgr)
        self.archive = TraceArchive(g_conf()["mgr_trace_archive"])
        self._cursor = 0
        self._pulled = 0

    def tick(self) -> None:
        self._cursor, new = tracer().kept_after(self._cursor)
        for rec in new:
            self.archive.add(rec)
        self._pulled += len(new)

    def pull_now(self) -> int:
        """Synchronous pull (tests and the export CLI need not wait
        for a tick)."""
        before = self._pulled
        self.tick()
        return self._pulled - before

    def handle_command(self, cmd: dict) -> tuple[int, str, bytes]:
        sub = cmd.get("prefix", "status")
        if sub == "status":
            return 0, "", json.dumps(
                {"archived": len(self.archive),
                 "cursor": self._cursor, "pulled": self._pulled,
                 "tracer": tracer().stats()}).encode()
        if sub == "ls":
            self.pull_now()     # serve what the tracer has NOW
            return 0, "", json.dumps(self.archive.rows()).encode()
        if sub in ("dump", "export"):
            self.pull_now()
            tid = cmd.get("trace_id", "")
            rec = self.archive.get(tid)
            if rec is None:
                return -2, f"trace {tid!r} not archived (kept " \
                    "traces only; see 'trace ls')", b""
            if sub == "dump":
                return 0, "", json.dumps(assemble(rec)).encode()
            from ceph_tpu_torch.tools.trace_export import to_chrome_trace
            return 0, "", json.dumps(
                to_chrome_trace(rec["spans"],
                                title=rec["root"])).encode()
        return super().handle_command(cmd)
