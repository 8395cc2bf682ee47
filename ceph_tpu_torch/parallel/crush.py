"""CRUSH — deterministic pseudo-random placement (the reference's crush/).

Role of src/crush/mapper.c (crush_do_rule :900, straw2 bucket choose),
src/crush/hash.c (rjenkins1), and the CrushWrapper map-building surface
(src/crush/CrushWrapper.h). Placement is computed, not looked up: any
client with the map derives object -> PG -> OSD set with no directory
service, and a weight change moves only the proportional share of PGs
(straw2's independence property).

This is a from-scratch implementation of the published algorithms
(Jenkins 96-bit integer mix; straw2 = max over items of ln(u)/w with u
drawn per (input, item, trial)). It is deterministic within this
framework; it does not aim for bit-compatibility with Ceph's maps.

Two selection modes mirror the reference's (mapper.c firstn vs indep):
  - ``firstn``  — replication: result list shrinks past failures.
  - ``indep``   — erasure coding: positions are significant; a slot that
    cannot be filled stays ``NONE`` so shard k keeps meaning shard k
    (doc/dev/osd_internals/erasure_coding/ecbackend.rst:49-76).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from math import log

NONE = -1  # CRUSH_ITEM_NONE: an unfillable indep slot

_U32 = 0xFFFFFFFF
_HASH_SEED = 1315423911  # golden-ratio-ish seed, as in crush/hash.c


def _mix(a: int, b: int, c: int) -> tuple[int, int, int]:
    """Robert Jenkins' public-domain 96-bit integer mix (crush/hash.c)."""
    a = (a - b - c) & _U32; a ^= c >> 13
    b = (b - c - a) & _U32; b ^= (a << 8) & _U32
    c = (c - a - b) & _U32; c ^= b >> 13
    a = (a - b - c) & _U32; a ^= c >> 12
    b = (b - c - a) & _U32; b ^= (a << 16) & _U32
    c = (c - a - b) & _U32; c ^= b >> 5
    a = (a - b - c) & _U32; a ^= c >> 3
    b = (b - c - a) & _U32; b ^= (a << 10) & _U32
    c = (c - a - b) & _U32; c ^= b >> 15
    return a, b, c


def hash2(x: int, y: int) -> int:
    a, b, c = _HASH_SEED ^ 2, x & _U32, y & _U32
    b, c, a = _mix(b, c, a)
    return _mix(x & _U32, a, c)[2]


def hash3(x: int, y: int, z: int) -> int:
    a, b, c = _HASH_SEED ^ 3, x & _U32, y & _U32
    b, c, a = _mix(b, c, a)
    a, b, c = (z & _U32), a, c
    return _mix(a, b, c)[2]


def hash_name(name: str) -> int:
    """Object-name hash (rjenkins role of ceph_str_hash_rjenkins)."""
    h = _HASH_SEED
    for byte in name.encode():
        h = hash2(h, byte)
    return h


def stable_mod(x: int, b: int, bmask: int) -> int:
    """ceph_stable_mod (include/types.h): pg count growth splits PGs
    stably — a pg maps to itself or its direct split child."""
    return x & bmask if (x & bmask) < b else x & (bmask >> 1)


@dataclass
class Bucket:
    """A straw2 internal node: children are item ids (>=0 devices,
    <0 nested buckets), each with a weight."""

    id: int                      # negative
    name: str
    type: str                    # e.g. "root", "host", "osd-domain"
    items: list[int] = field(default_factory=list)
    weights: list[float] = field(default_factory=list)

    def choose(self, x: int, r: int) -> int:
        """straw2: draw u ~ (0,1] per item from hash(x, item, r); the
        item maximizing ln(u)/weight wins (mapper.c bucket_straw2_choose).
        Weight-0 items never win unless nothing has weight."""
        best, best_draw = NONE, -float("inf")
        for item, w in zip(self.items, self.weights):
            if w <= 0.0:
                continue
            u = (hash3(x, item & _U32, r) & 0xFFFF) + 1  # (0, 65536]
            draw = log(u / 65536.0) / w
            if draw > best_draw:
                best, best_draw = item, draw
        return best


@dataclass
class Rule:
    """A placement rule: take <root>, choose(leaf) across a failure
    domain, emit. Mirrors the shape CrushWrapper::add_simple_rule
    builds (CrushWrapper.cc:1800; EC uses indep, ErasureCode.cc:53-72)."""

    name: str
    root: str
    failure_domain: str          # bucket type to spread across ("osd" = leaf)
    mode: str = "indep"          # "firstn" | "indep"


class CrushMap:
    """Bucket hierarchy + devices + rules; the CrushWrapper role."""

    TOTAL_TRIES = 51             # choose_total_tries default (mapper.c)

    def __init__(self) -> None:
        self.buckets: dict[int, Bucket] = {}
        self.by_name: dict[str, int] = {}
        self.device_weights: dict[int, float] = {}   # reweight, 0..1
        self.rules: dict[str, Rule] = {}
        self._next_bucket_id = -1

    # -- map building -------------------------------------------------
    def add_bucket(self, name: str, type: str, parent: str | None = None,
                   weight: float = 1.0) -> int:
        bid = self._next_bucket_id
        self._next_bucket_id -= 1
        self.buckets[bid] = Bucket(bid, name, type)
        self.by_name[name] = bid
        if parent is not None:
            pb = self.buckets[self.by_name[parent]]
            pb.items.append(bid)
            pb.weights.append(weight)
        return bid

    def add_device(self, osd_id: int, host: str, weight: float = 1.0) -> None:
        hb = self.buckets[self.by_name[host]]
        hb.items.append(osd_id)
        hb.weights.append(weight)
        self.device_weights[osd_id] = 1.0

    def add_rule(self, rule: Rule) -> None:
        self.rules[rule.name] = rule

    def reweight(self, osd_id: int, w: float) -> None:
        """Post-selection acceptance weight (the osdmap reweight knob):
        1.0 = always accept, 0.0 = always reject (device drained)."""
        self.device_weights[osd_id] = w

    def set_crush_weight(self, osd_id: int, w: float) -> None:
        """Adjust a device's CRUSH weight in its parent bucket AND
        propagate the delta up every ancestor's subtree weight — the
        straw2 draw weight (CrushWrapper::adjust_item_weight role,
        which updates ancestor weight sums the same way), distinct
        from reweight()'s post-selection acceptance knob. Without the
        propagation, upweighting the sole device of a one-device host
        bucket (the mon's boot-time topology) would be a placement
        no-op: the root-level draw over hosts would never see it.
        straw2 then moves only the proportional share of placements
        (tests/test_crush_quality.py quantifies it)."""
        item, delta = osd_id, None
        while True:
            holder = None
            for b in self.buckets.values():
                for i, it in enumerate(b.items):
                    if it == item:
                        holder, idx = b, i
                        break
                if holder is not None:
                    break
            if holder is None:
                if delta is None:
                    raise KeyError(f"no device {osd_id} in any bucket")
                return                  # reached an un-parented root
            if delta is None:
                delta = w - holder.weights[idx]
                holder.weights[idx] = w
            else:
                holder.weights[idx] += delta
            item = holder.id            # continue up from this bucket

    def bucket_of(self, name: str) -> Bucket:
        return self.buckets[self.by_name[name]]

    # -- selection ----------------------------------------------------
    def _leaf_accepted(self, osd: int, x: int, out: set[int]) -> bool:
        if osd in out:
            return False
        w = self.device_weights.get(osd, 0.0)
        if w >= 1.0:
            return True
        if w <= 0.0:
            return False
        return (hash2(x, osd) & 0xFFFF) < int(w * 0x10000)

    def _descend(self, bucket: Bucket, x: int, r: int, domain: str,
                 out: set[int], taken: set[int]) -> int:
        """Walk down from ``bucket`` to one device, re-drawing on
        rejection; returns NONE if tries exhaust. ``taken`` holds
        failure-domain bucket ids already used by other slots, so no two
        slots land in the same domain (rack/host separation)."""
        for attempt in range(self.TOTAL_TRIES):
            rr = r + attempt * 17
            node: Bucket | None = bucket
            dom: Bucket | None = None
            while node is not None:
                if node.type == domain:
                    dom = node
                    break
                child = node.choose(x, rr)
                if child == NONE:
                    node = None
                elif child >= 0:
                    # reached a device: only valid if devices themselves
                    # are the failure domain
                    if domain == "osd" and self._leaf_accepted(child, x, out):
                        return child
                    node = None
                else:
                    node = self.buckets[child]
            if dom is None or dom.id in taken:
                continue
            leaf = self._choose_leaf_in(dom, x, rr, out)
            if leaf != NONE:
                taken.add(dom.id)
                return leaf
        return NONE

    def _choose_leaf_in(self, bucket: Bucket, x: int, r: int,
                        out: set[int]) -> int:
        for attempt in range(self.TOTAL_TRIES):
            node = bucket
            rr = r + attempt * 131
            while node.id < 0:
                child = node.choose(x, rr)
                if child == NONE:
                    node = None
                    break
                if child >= 0:
                    if self._leaf_accepted(child, x, out):
                        return child
                    node = None
                    break
                node = self.buckets[child]
            if node is None:
                continue
        return NONE

    def _parent_index(self) -> dict[int, int]:
        """child (device or bucket id) -> parent bucket id."""
        parent: dict[int, int] = {}
        for b in self.buckets.values():
            for item in b.items:
                parent[item] = b.id
        return parent

    def _domain_of(self, osd: int, domain: str,
                   parent: dict[int, int]) -> int:
        """Ancestor bucket id of ``osd`` with type ``domain`` (NONE if
        no such ancestor)."""
        node = parent.get(osd)
        while node is not None:
            bucket = self.buckets[node]
            if bucket.type == domain:
                return bucket.id
            node = parent.get(node)
        return NONE

    def do_rule(self, rule_name: str, x: int, size: int,
                down: set[int] | None = None) -> list[int]:
        """crush_do_rule: map input x to ``size`` devices under rule.

        firstn (replication): ``down`` devices are rejected inline, so
        the result fills past failures (later slots shift up).

        indep (EC): position stability is the contract
        (crush_choose_indep semantics, mapper.c) — pass 1 computes the
        layout as if nothing were down, so healthy slots NEVER move
        when a peer fails; pass 2 redraws only the failed slots,
        excluding every kept device (and its failure domain). A slot
        that cannot be refilled stays NONE so shard k keeps meaning
        shard k."""
        rule = self.rules[rule_name]
        root = self.bucket_of(rule.root)
        down = set(down or ())
        if rule.mode != "indep":
            out: set[int] = set(down)
            result: list[int] = []
            taken: set[int] = set()
            for slot in range(size):
                osd = self._descend(root, x, slot, rule.failure_domain,
                                    out, taken)
                if osd != NONE:
                    out.add(osd)
                    result.append(osd)
            return result

        # pass 1: stable layout, failures ignored
        out = set()
        taken = set()
        result = []
        for slot in range(size):
            osd = self._descend(root, x, slot, rule.failure_domain,
                                out, taken)
            result.append(osd)
            if osd != NONE:
                out.add(osd)
        if not down.intersection(result):
            return result
        # pass 2: redraw only the failed slots
        kept = {o for o in result if o != NONE and o not in down}
        taken2: set[int] = set()
        if rule.failure_domain != "osd":
            parent = self._parent_index()
            for o in kept:
                dom = self._domain_of(o, rule.failure_domain, parent)
                if dom != NONE:
                    taken2.add(dom)
        out2 = set(kept) | down
        for slot, osd in enumerate(result):
            if osd == NONE or osd not in down:
                continue
            repl = self._descend(root, x, slot, rule.failure_domain,
                                 out2, taken2)
            result[slot] = repl
            if repl != NONE:
                out2.add(repl)
        return result


def build_flat_map(n_osds: int, osds_per_host: int = 4,
                   rule_mode: str = "indep",
                   failure_domain: str | None = None) -> CrushMap:
    """Convenience: root -> hosts -> osds, one rule ("data").

    The vstart-style default topology. failure_domain defaults to
    "osd" (single-host dev clusters can't separate by host for typical
    k+m widths); pass "host" explicitly for host separation."""
    m = CrushMap()
    m.add_bucket("default", "root")
    n_hosts = max(1, (n_osds + osds_per_host - 1) // osds_per_host)
    if failure_domain is None:
        failure_domain = "osd"
    for h in range(n_hosts):
        m.add_bucket(f"host{h}", "host", parent="default",
                     weight=float(min(osds_per_host, n_osds - h * osds_per_host)))
        for o in range(h * osds_per_host, min((h + 1) * osds_per_host, n_osds)):
            m.add_device(o, f"host{h}")
    m.add_rule(Rule("data", root="default", failure_domain=failure_domain,
                    mode=rule_mode))
    return m
