"""mgr — the metrics/orchestration plane (src/mgr/ + src/pybind/mgr/).

The reference's ceph-mgr hosts Python modules (balancer, progress,
telemetry, prometheus, ...) with a ``mgr_module.py`` API over aggregated
cluster state. Here the Mgr daemon (``mgr/mgr.py``) holds a
RadosClient session to the mon, ticks its modules, and exposes each
module's commands over its admin socket: the reference's default set
(``mgr.DEFAULT_MODULES``: balancer, progress, telemetry, dashboard,
health, trace, tuner). Per-daemon prometheus export lives in
``utils/prometheus.py`` (the mgr prometheus-module role).
"""

from ceph_tpu_torch.mgr.mgr import Mgr
from ceph_tpu_torch.mgr.mgr_module import MgrModule

__all__ = ["Mgr", "MgrModule"]
