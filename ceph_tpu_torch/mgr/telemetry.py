"""telemetry — the anonymized cluster report.

Reference: src/pybind/mgr/telemetry/module.py: collects an opt-in,
anonymized report (cluster shape, pool configs, version) for the
upstream project; off by default, ``telemetry show`` previews the
report without sending. There is no phone-home here — ``show`` builds
the same shape of report from live cluster state; ``send`` records it
locally (the reference's REST POST seam, stubbed for zero egress).
"""

from __future__ import annotations

import hashlib
import json
import time

from ceph_tpu_torch.mgr.mgr_module import MgrModule


class Module(MgrModule):
    NAME = "telemetry"

    COMMANDS = ("status", "on", "off", "show", "send")

    def __init__(self, mgr) -> None:
        super().__init__(mgr)
        self.enabled = False
        self.last_report: dict | None = None
        self.last_sent: float = 0.0

    def compile_report(self) -> dict:
        osdmap = self.get_osdmap()
        status = self.get_status()
        # anonymized cluster id: hash of the mon address, not the name
        cid = hashlib.sha256(
            self.mgr.mon_addr.encode()).hexdigest()[:16]
        report = {
            "report_version": 1,
            "report_timestamp": time.time(),
            "cluster_id": cid,
            "osd": {
                "count": len(osdmap.osds),
                "up": sum(1 for i in osdmap.osds.values() if i.up),
                "in": sum(1 for i in osdmap.osds.values()
                          if i.in_cluster),
            },
            "pools": [
                {"pool": pid, "pg_num": p.pg_num, "size": p.size,
                 "type": "erasure" if p.is_ec else "replicated",
                 **({"ec_k": p.ec_profile.get("k"),
                     "ec_m": p.ec_profile.get("m"),
                     "ec_plugin": p.ec_profile.get("plugin")}
                    if p.is_ec else {})}
                for pid, p in sorted(osdmap.pools.items())],
            "balancer_upmaps": len(osdmap.pg_upmap_items),
            "health": status.get("health", "unknown"),
        }
        self.last_report = report
        return report

    def handle_command(self, cmd: dict) -> tuple[int, str, bytes]:
        sub = cmd.get("prefix", "status")
        if sub == "status":
            return 0, "", json.dumps(
                {"enabled": self.enabled,
                 "last_sent": self.last_sent}).encode()
        if sub == "on":
            self.enabled = True
            return 0, "telemetry on", b""
        if sub == "off":
            self.enabled = False
            return 0, "telemetry off", b""
        if sub == "show":
            return 0, "", json.dumps(self.compile_report()).encode()
        if sub == "send":
            if not self.enabled:
                return -1, "telemetry is off (run 'telemetry on')", b""
            self.compile_report()
            self.last_sent = time.time()
            return 0, "report recorded", b""
        return super().handle_command(cmd)
