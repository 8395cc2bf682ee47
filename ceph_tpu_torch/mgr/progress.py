"""progress — long-running recovery events with completion ratios.

Reference: src/pybind/mgr/progress/module.py: watches PG state changes
and surfaces "Rebalancing after osd.N marked out"-style events with a
progress bar. Here the module samples the mon's status (degraded object
counts per pool come from PG stats) and tracks each degraded episode
from first sight to drain.
"""

from __future__ import annotations

import json
import time

from ceph_tpu_torch.mgr.mgr_module import MgrModule


class Module(MgrModule):
    NAME = "progress"
    TICK_PERIOD = 1.0

    COMMANDS = ("ls", "show", "clear")

    def __init__(self, mgr) -> None:
        super().__init__(mgr)
        self.events: dict[str, dict] = {}       # id -> event
        self.completed: list[dict] = []

    @staticmethod
    def _degraded(status: dict) -> int:
        pgs = status.get("pgmap", {})
        if isinstance(pgs, dict):
            return int(pgs.get("degraded_pgs", 0) or 0)
        return 0

    def tick(self) -> None:
        try:
            status = self.get_status()
        except Exception:
            return
        degraded = self._degraded(status)
        ev = self.events.get("recovery")
        if degraded > 0:
            if ev is None:
                self.events["recovery"] = {
                    "id": "recovery",
                    "message": "Recovering degraded objects",
                    "started_at": time.time(),
                    "baseline": degraded,
                    "remaining": degraded,
                    "progress": 0.0,
                }
            else:
                ev["baseline"] = max(ev["baseline"], degraded)
                ev["remaining"] = degraded
                ev["progress"] = 1.0 - degraded / ev["baseline"]
        elif ev is not None:
            ev["progress"] = 1.0
            ev["remaining"] = 0
            ev["finished_at"] = time.time()
            self.completed.append(ev)
            del self.events["recovery"]
            if len(self.completed) > 50:
                self.completed = self.completed[-50:]

    def handle_command(self, cmd: dict) -> tuple[int, str, bytes]:
        sub = cmd.get("prefix", "ls")
        if sub in ("ls", "show"):
            return 0, "", json.dumps(
                {"events": list(self.events.values()),
                 "completed": self.completed}).encode()
        if sub == "clear":
            self.completed.clear()
            return 0, "cleared", b""
        return super().handle_command(cmd)
