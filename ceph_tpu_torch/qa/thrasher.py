"""Thrasher — random OSD kill/revive under load (qa/tasks/ceph_manager.py
``Thrasher`` role: kill_osd :196, revive_osd :380).

Runs in a thread against a MiniCluster: every ``interval`` seconds it
either kills a random live OSD or revives a random dead one, never
taking the cluster below ``min_live``. ``stop()`` revives everything.
The workload keeps running through it; the invariant checked afterward
is the reference's: no acknowledged write is ever lost.
"""

from __future__ import annotations

import random
import threading

from ceph_tpu_torch.qa.cluster import MiniCluster
from ceph_tpu_torch.utils.dout import Dout

log = Dout("qa")


class Thrasher:
    def __init__(self, cluster: MiniCluster, min_live: int,
                 interval: float = 1.5, seed: int = 0) -> None:
        self.cluster = cluster
        self.min_live = min_live
        self.interval = interval
        self.rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="thrasher", daemon=True)
        self.kills = 0
        self.revives = 0

    def start(self) -> "Thrasher":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop thrashing and revive every dead OSD."""
        self._stop.set()
        self._thread.join(timeout=30)
        for osd_id in range(self.cluster.n_osds):
            if osd_id not in self.cluster.osds:
                self.cluster.revive_osd(osd_id)
                self.revives += 1
        self.cluster.wait_for_osds_up(timeout=30)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            live = sorted(self.cluster.osds)
            dead = [o for o in range(self.cluster.n_osds)
                    if o not in self.cluster.osds]
            try:
                if dead and (len(live) <= self.min_live
                             or self.rng.random() < 0.5):
                    victim = self.rng.choice(dead)
                    self.cluster.revive_osd(victim)
                    self.revives += 1
                elif len(live) > self.min_live:
                    victim = self.rng.choice(live)
                    self.cluster.kill_osd(victim)
                    self.kills += 1
                    self.cluster.wait_for_osd_down(victim, timeout=30)
            except Exception as exc:   # pragma: no cover - log and go on
                log(0, f"thrasher action failed: {exc!r}")
