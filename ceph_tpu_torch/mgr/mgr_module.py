"""MgrModule — the module API of the reference's mgr_module.py.

Reference: src/pybind/mgr/mgr_module.py (class MgrModule): modules get
cluster state accessors (``get("osd_map")``-style), a command table, and
a ``serve``-loop; the C++ mgr (src/mgr/) feeds them aggregated daemon
state. Here the Mgr daemon calls ``tick()`` periodically and routes
``<module> <cmd>`` admin-socket/CLI commands to ``handle_command``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ceph_tpu_torch.mgr.mgr import Mgr
    from ceph_tpu_torch.parallel.osdmap import OSDMap


class MgrModule:
    NAME = "module"
    #: seconds between tick() calls (0 = no ticking)
    TICK_PERIOD: float = 0.0

    def __init__(self, mgr: "Mgr") -> None:
        self.mgr = mgr

    # -- cluster state accessors (mgr_module.get() role) ---------------
    def get_osdmap(self) -> "OSDMap":
        return self.mgr.get_osdmap()

    def get_status(self) -> dict:
        return self.mgr.get_status()

    def mon_command(self, **cmd) -> tuple[int, str, bytes]:
        return self.mgr.mon_command(**cmd)

    # -- module surface -------------------------------------------------
    def tick(self) -> None:
        """Periodic work; called from the mgr tick thread."""

    def shutdown(self) -> None:
        """Called by Mgr.stop(); modules release servers/threads."""

    def handle_command(self, cmd: dict) -> tuple[int, str, bytes]:
        """CLI/asok commands addressed to this module. ``cmd["prefix"]``
        is the sub-command (e.g. "status" for ``balancer status``)."""
        return -22, f"unknown command for module {self.NAME}", b""
