"""mgr — the metrics/orchestration plane (src/mgr/ + src/pybind/mgr/).

The reference's ceph-mgr hosts Python modules (balancer, progress,
telemetry, prometheus, ...) with a ``mgr_module.py`` API over aggregated
cluster state. Here the Mgr daemon (``mgr/mgr.py``) holds a
RadosClient session to the mon, ticks its modules, and exposes each
module's commands over its admin socket. The port has the health module
(``mgr/health.py``); the others, and the per-daemon prometheus export,
are ROADMAP A.6.
"""

from ceph_tpu_torch.mgr.mgr import Mgr
from ceph_tpu_torch.mgr.mgr_module import MgrModule

__all__ = ["Mgr", "MgrModule"]
