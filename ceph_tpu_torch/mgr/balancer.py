"""balancer — PG-distribution balancer in upmap mode.

Reference: src/pybind/mgr/balancer/module.py (upmap mode) +
OSDMap::calc_pg_upmaps. The goal: even out the number of PG slots each
(up, in) OSD serves, by installing per-PG ``pg_upmap_items`` exceptions
((from, to) swaps applied to the CRUSH up set) through mon commands —
data then migrates by ordinary backfill exactly as after any map change.

The plan respects the pool's CRUSH failure domain: a replacement OSD
must not land in a failure-domain bucket already represented in the
PG's up set (the reference enforces this inside calc_pg_upmaps via
try_pg_upmap/crush re-checks).

Commands (``ceph_tpu_torch.tools.ceph_cli daemon <mgr.asok> balancer ...``):
status | eval | optimize (compute plan) | execute (apply via mon).
"""

from __future__ import annotations

import json
import threading

from ceph_tpu_torch.mgr.mgr_module import MgrModule
from ceph_tpu_torch.utils.dout import Dout

log = Dout("mgr")

#: stop once max-min PG-slot spread is within this
DEFAULT_MAX_DEVIATION = 1
#: at most this many new upmaps per optimize round (balancer upmap_max)
DEFAULT_MAX_OPTIMIZATIONS = 10


class Module(MgrModule):
    NAME = "balancer"
    TICK_PERIOD = 30.0

    COMMANDS = ("status", "on", "off", "eval", "optimize", "execute")

    def __init__(self, mgr) -> None:
        super().__init__(mgr)
        self.active = False           # 'ceph balancer on' role
        self.lock = threading.Lock()
        self.last_plan: list[dict] = []

    # -- analysis ------------------------------------------------------

    @staticmethod
    def _slot_counts(osdmap) -> dict[int, int]:
        """PG slots served per (up, in) OSD across all pools."""
        counts = {o: 0 for o, i in osdmap.osds.items()
                  if i.up and i.in_cluster}
        for pid, pool in osdmap.pools.items():
            for ps in range(pool.pg_num):
                up, _, _ = osdmap.pg_to_up_acting(pid, ps)
                for o in up:
                    if o in counts:
                        counts[o] += 1
        return counts

    @staticmethod
    def _domain_of(osdmap, osd: int, domain_type: str,
                   parent: dict | None = None) -> int | None:
        """The failure-domain ancestor bucket of ``osd`` (e.g. its host
        bucket when the rule spreads across hosts) — full hierarchy
        walk, so a 'rack' domain above the direct parent works too."""
        from ceph_tpu_torch.parallel import crush
        if domain_type == "osd":
            return osd       # every device is its own domain
        if parent is None:
            parent = osdmap.crush._parent_index()
        dom = osdmap.crush._domain_of(osd, domain_type, parent)
        return None if dom == crush.NONE else dom

    def eval(self) -> dict:
        counts = self._slot_counts(self.get_osdmap())
        if not counts:
            return {"osds": 0, "spread": 0, "counts": {}}
        vals = list(counts.values())
        return {"osds": len(counts), "min": min(vals), "max": max(vals),
                "spread": max(vals) - min(vals),
                "counts": {str(o): c for o, c in sorted(counts.items())}}

    # -- planning ------------------------------------------------------

    def optimize(self, max_deviation: int = DEFAULT_MAX_DEVIATION,
                 max_optimizations: int = DEFAULT_MAX_OPTIMIZATIONS
                 ) -> list[dict]:
        """Greedy upmap planning (calc_pg_upmaps role): repeatedly move
        one PG slot from the fullest OSD to the emptiest legal OSD."""
        osdmap = self.get_osdmap()
        counts = self._slot_counts(osdmap)
        plan: list[dict] = []
        if len(counts) < 2:
            return plan
        # (pool, ps) -> up set, recomputed against pending plan entries
        pending: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for _ in range(max_optimizations):
            hi = max(counts, key=lambda o: (counts[o], o))
            lo = min(counts, key=lambda o: (counts[o], -o))
            if counts[hi] - counts[lo] <= max_deviation:
                break
            move = self._find_move(osdmap, pending, hi, lo, counts)
            if move is None:
                break
            plan.append(move)
        with self.lock:
            self.last_plan = plan
        return plan

    def _find_move(self, osdmap, pending, hi: int, lo: int,
                   counts) -> dict | None:
        """One PG currently on ``hi`` that can legally move to ``lo``.

        ``pending[(pid, ps)]`` holds the FULL desired pair list for a
        PG this round (seeded from the installed items on first touch),
        applied over the RAW CRUSH up set — the same semantics the mon
        validates against."""
        parent = osdmap.crush._parent_index()
        down = osdmap.down_set()
        for pid, pool in sorted(osdmap.pools.items()):
            domain = osdmap.crush.rules[pool.rule].failure_domain
            lo_dom = self._domain_of(osdmap, lo, domain, parent)
            for ps in range(pool.pg_num):
                raw_up = osdmap.pg_to_raw_up(pid, ps, down=down)
                items = pending.get((pid, ps))
                if items is None:
                    # seed from the installed list, PRUNING pairs the
                    # mapping ignores (down target, or endpoints no
                    # longer in the raw up set): carrying a dead pair
                    # forward would make every future plan for this PG
                    # fail validation — the stale pair would never heal
                    items = [
                        (f, t) for f, t in
                        osdmap.pg_upmap_items.get((pid, ps), [])
                        if t not in down and t not in raw_up
                        and f in raw_up]
                # the MAP's remap semantics, not a naive dict(items):
                # pairs with a down target are ignored by the mapping
                # and must be ignored here too
                up = osdmap.apply_upmap(raw_up, items, down)
                if hi not in up or lo in up:
                    continue
                # failure-domain check: lo's bucket must not already be
                # represented by the remaining members
                others = [o for o in up if o != hi]
                if lo_dom is not None and any(
                        self._domain_of(osdmap, o, domain, parent)
                        == lo_dom for o in others):
                    continue
                # collapse chains: if hi itself was a 'to' of an earlier
                # pair, rewrite that pair instead of chaining
                rewritten = False
                new_items = []
                for f, t in items:
                    if t == hi:
                        new_items.append((f, lo))
                        rewritten = True
                    else:
                        new_items.append((f, t))
                if not rewritten:
                    new_items.append((hi, lo))
                # never emit a plan the mon would reject — same
                # validator the command handler runs (down/raw_up
                # passed through: no second CRUSH evaluation)
                if osdmap.validate_upmap_items(pid, ps, new_items,
                                               down=down,
                                               raw_up=raw_up):
                    continue
                pending[(pid, ps)] = new_items
                counts[hi] -= 1
                counts[lo] += 1
                return {"pool": pid, "ps": ps,
                        "items": [list(p) for p in new_items]}
        return None

    # -- execution -----------------------------------------------------

    def execute(self, plan: list[dict] | None = None) -> tuple[int, str]:
        with self.lock:
            plan = self.last_plan if plan is None else plan
        applied = 0
        for move in plan:
            code, msg, _ = self.mon_command(
                prefix="osd pg-upmap-items", pool=str(move["pool"]),
                ps=str(move["ps"]), items=json.dumps(move["items"]))
            if code != 0:
                return code, (f"applied {applied}/{len(plan)}, then: "
                              f"{msg}")
            applied += 1
        with self.lock:
            self.last_plan = []
        return 0, f"applied {applied} upmaps"

    # -- module surface ------------------------------------------------

    def tick(self) -> None:
        if not self.active:
            return
        plan = self.optimize()
        if plan:
            code, msg = self.execute(plan)
            log(1, f"balancer: auto-applied plan: {msg} (code {code})")

    def handle_command(self, cmd: dict) -> tuple[int, str, bytes]:
        sub = cmd.get("prefix", "status")
        if sub == "status":
            return 0, "", json.dumps(
                {"active": self.active, "mode": "upmap",
                 "plan_len": len(self.last_plan)}).encode()
        if sub == "on":
            self.active = True
            return 0, "balancer on (upmap)", b""
        if sub == "off":
            self.active = False
            return 0, "balancer off", b""
        if sub == "eval":
            return 0, "", json.dumps(self.eval()).encode()
        if sub == "optimize":
            plan = self.optimize(
                max_optimizations=int(cmd.get("max", 10)))
            return 0, "", json.dumps(plan).encode()
        if sub == "execute":
            code, msg = self.execute()
            return code, msg, b""
        return super().handle_command(cmd)
