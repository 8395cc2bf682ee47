"""OSDMap — epoch-versioned cluster state + object->PG->OSD mapping.

Role of src/osd/OSDMap.{h,cc}: which OSDs exist / are up / are in,
the pool table (pg_num, EC profile, crush rule), pg_temp overrides, and
the mapping pipeline ``object -> ps -> pgid -> up/acting set`` via
CRUSH (OSDMap::pg_to_up_acting_osds). Every daemon and client holds a
copy; an op is only valid against the epoch it was targeted with.

Mapping pipeline (as in the reference):
  ps    = stable_mod(hash_name(object), pg_num, pg_num_mask)
  x     = hash2(ps, pool_id)          # per-pool decorrelation
  up    = crush.do_rule(rule, x, size, down=not-up osds)
  acting= pg_temp override if present else up; primary = first non-NONE
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ceph_tpu_torch.parallel import crush
from ceph_tpu_torch.utils.encoding import Decoder, Encoder


def pg_num_mask(pg_num: int) -> int:
    m = 1
    while m < pg_num:
        m <<= 1
    return m - 1


@dataclass
class PoolInfo:
    pool_id: int
    name: str
    pg_num: int
    rule: str
    size: int                      # replicas, or k+m for EC
    min_size: int                  # floor to serve I/O (k for EC)
    ec_profile: dict = field(default_factory=dict)  # empty = replicated
    stripe_unit: int = 4096        # see osd_pool_erasure_code_stripe_unit
    #: pool snapshots (pg_pool_t snap_seq/snaps roles): monotonically
    #: increasing snap ids; removing a snap deletes its entry — OSD
    #: snap trimmers reclaim clones whose snaps no longer exist
    snap_seq: int = 0
    snaps: dict = field(default_factory=dict)       # snapid -> name
    #: SELF-MANAGED snapshot mode (pg_pool_t is_unmanaged_snaps_mode
    #: + removed_snaps roles): the application allocates snapids from
    #: snap_seq and supplies its own SnapContext per write (what
    #: CephFS realms and librbd do in the reference); a snapid is
    #: live while <= snap_seq and not in removed_snaps. The two modes
    #: never mix in one pool (the reference refuses likewise).
    selfmanaged: bool = False
    removed_snaps: list = field(default_factory=list)
    #: cache tiering (pg_pool_t tier_of/read_tier/write_tier/
    #: cache_mode roles, src/osd/osd_types.h): a CACHE pool records
    #: its base pool in ``tier_of``; the BASE pool records the
    #: overlay in read_tier/write_tier so clients redirect to it
    tier_of: int = -1
    read_tier: int = -1
    write_tier: int = -1
    cache_mode: str = "none"
    target_max_objects: int = 0
    target_max_bytes: int = 0
    #: hit-set / promotion-recency knobs (pg_pool_t hit_set_period /
    #: hit_set_count / min_read_recency_for_promote roles,
    #: src/osd/HitSet.h:33): period 0 disables hit sets — every miss
    #: promotes (the pre-r5 behavior). With hit sets on, a READ miss
    #: promotes only when the object appears in >= min_read_recency
    #: of the tracked windows; colder reads are PROXIED to the base
    #: pool without promotion (do_proxy_read,
    #: src/osd/PrimaryLogPG.cc:2445) so scans cannot thrash the tier.
    hit_set_period: float = 0.0
    hit_set_count: int = 4
    min_read_recency_for_promote: int = 1

    @property
    def is_cache_tier(self) -> bool:
        return self.tier_of >= 0 and self.cache_mode != "none"

    @property
    def is_ec(self) -> bool:
        return bool(self.ec_profile)

    def snap_context(self) -> tuple[int, list[int]]:
        """(seq, existing snap ids newest-first) — what write ops
        carry (the SnapContext of librados)."""
        return self.snap_seq, sorted(self.snaps, reverse=True)

    def snap_is_live(self, snapid: int) -> bool:
        """Whether clones covering ``snapid`` may still be trimmed
        away — the single liveness rule the OSD snap trimmer uses
        for both snapshot modes."""
        if self.selfmanaged:
            return snapid <= self.snap_seq and \
                snapid not in self.removed_snaps
        return snapid in self.snaps


@dataclass
class OSDInfo:
    osd_id: int
    up: bool = False
    in_cluster: bool = True
    addr: str = ""                 # "host:port" of the OSD messenger


class OSDMap:
    """Full map at one epoch. Mutations happen only on the mon
    (OSDMonitor role), which bumps the epoch per change batch."""

    def __init__(self) -> None:
        self.epoch = 0
        self.osds: dict[int, OSDInfo] = {}
        self.pools: dict[int, PoolInfo] = {}
        self.pool_by_name: dict[str, int] = {}
        self.crush = crush.CrushMap()
        self.pg_temp: dict[tuple[int, int], list[int]] = {}
        # balancer overrides (OSDMap::pg_upmap_items role): per-PG list of
        # (from_osd, to_osd) swaps applied to the CRUSH up set before
        # pg_temp — how the mgr balancer moves individual PGs
        self.pg_upmap_items: dict[tuple[int, int],
                                  list[tuple[int, int]]] = {}
        #: the cluster's fencing primitive (OSDMap blacklist role,
        #: src/osd/OSDMap.h:561): client instance id -> expiry unix
        #: time (0.0 = no expiry). Epoch-carried like every other map
        #: field; OSDs reject ops from listed clients at admission.
        #: An entry may also be a BARE entity name ("mds.a"), which
        #: fences every instance "mds.a:<nonce>" — the reference's
        #: whole-addr (any nonce) blocklist variant.
        self.blocklist: dict[str, float] = {}
        self._next_pool_id = 1

    # -- mutation (mon side) ------------------------------------------
    def add_osd(self, osd_id: int, addr: str = "") -> OSDInfo:
        info = OSDInfo(osd_id, addr=addr)
        self.osds[osd_id] = info
        return info

    def mark_up(self, osd_id: int, addr: str) -> None:
        self.osds[osd_id].up = True
        self.osds[osd_id].addr = addr

    def mark_down(self, osd_id: int) -> None:
        if osd_id in self.osds:
            self.osds[osd_id].up = False

    def mark_out(self, osd_id: int) -> None:
        self.osds[osd_id].in_cluster = False
        self.crush.reweight(osd_id, 0.0)

    def create_pool(self, name: str, pg_num: int, rule: str, size: int,
                    min_size: int, ec_profile: dict | None = None,
                    stripe_unit: int | None = None) -> PoolInfo:
        if stripe_unit is None:
            from ceph_tpu_torch.utils.config import g_conf
            stripe_unit = g_conf()["osd_pool_erasure_code_stripe_unit"]
        pid = self._next_pool_id
        self._next_pool_id += 1
        pool = PoolInfo(pid, name, pg_num, rule, size, min_size,
                        dict(ec_profile or {}), stripe_unit)
        self.pools[pid] = pool
        self.pool_by_name[name] = pid
        return pool

    def blocklist_add(self, entity: str, until: float = 0.0) -> None:
        """Fence ``entity`` (an instance id "name:nonce" or a bare
        name fencing all its instances) until unix time ``until``
        (0 = until removed)."""
        self.blocklist[entity] = until

    def blocklist_rm(self, entity: str) -> bool:
        return self.blocklist.pop(entity, None) is not None

    def is_blocklisted(self, entity: str,
                       now: float | None = None) -> bool:
        """Op-admission fence check (OSDMap::is_blacklisted role).
        Matches the exact instance id and the bare entity name before
        the nonce separator."""
        if not self.blocklist or not entity:
            return False
        if now is None:
            import time
            now = time.time()
        for key in (entity, entity.split(":", 1)[0]):
            until = self.blocklist.get(key)
            if until is not None and (until == 0.0 or until > now):
                return True
        return False

    # -- queries ------------------------------------------------------
    def down_set(self) -> set[int]:
        return {o for o, i in self.osds.items()
                if not i.up or not i.in_cluster}

    def object_to_pg(self, pool_id: int, name: str) -> int:
        pool = self.pools[pool_id]
        ps = crush.hash_name(name)
        return crush.stable_mod(ps, pool.pg_num, pg_num_mask(pool.pg_num))

    def pg_to_raw_up(self, pool_id: int, ps: int,
                     down: set[int] | None = None) -> list[int]:
        """The CRUSH up set BEFORE pg_upmap_items — what upmap pairs
        are defined against (OSDMap::pg_to_raw_up role)."""
        pool = self.pools[pool_id]
        x = crush.hash2(ps, pool_id)
        if down is None:
            down = self.down_set()
        return self.crush.do_rule(pool.rule, x, pool.size, down=down)

    @staticmethod
    def apply_upmap(raw_up: list[int],
                    items: list[tuple[int, int]] | None,
                    down: set[int]) -> list[int]:
        """Apply pg_upmap_items pairs to a raw up set — the single
        definition of the remap semantics (pairs whose target is down
        or already a raw member are ignored). The mon validator and the
        balancer planner both call this so they can never diverge from
        the mapping."""
        if not items:
            return raw_up
        remap = {f: t for f, t in items
                 if t not in down and t not in raw_up}
        return [remap.get(o, o) for o in raw_up]

    def pg_to_up_acting(self, pool_id: int, ps: int
                        ) -> tuple[list[int], list[int], int]:
        """Returns (up, acting, primary). primary = first non-NONE of
        acting, or NONE when the PG is entirely unserviceable."""
        down = self.down_set()
        raw = self.pg_to_raw_up(pool_id, ps, down=down)
        up = self.apply_upmap(
            raw, self.pg_upmap_items.get((pool_id, ps)), down)
        acting = self.pg_temp.get((pool_id, ps), up)
        primary = next((o for o in acting if o != crush.NONE), crush.NONE)
        return up, acting, primary

    def validate_upmap_items(self, pool_id: int, ps: int,
                             pairs: list[tuple[int, int]],
                             down: set[int] | None = None,
                             raw_up: list[int] | None = None
                             ) -> tuple[int, str] | None:
        """Why ``pairs`` cannot be installed for the PG — a (errno,
        message) tuple, or None when legal. Shared by the mon command
        (authoritative) and the mgr balancer planner (so plans are
        rejected at plan time, never at execute time). Callers that
        already computed ``down``/``raw_up`` pass them in (the balancer
        scan runs this per candidate)."""
        if down is None:
            down = self.down_set()
        up = (self.pg_to_raw_up(pool_id, ps, down=down)
              if raw_up is None else raw_up)
        froms = [f for f, _ in pairs]
        tos = [t for _, t in pairs]
        if len(set(froms)) != len(froms):
            return -22, f"duplicate 'from' osds in {pairs}"
        if len(set(tos)) != len(tos):
            return -22, f"duplicate 'to' osds in {pairs}"
        for f, t in pairs:
            if f == t:
                return -22, f"osd.{f} mapped to itself"
            if t not in self.osds:
                return -2, f"no osd.{t}"
            if t in down:
                return -22, f"osd.{t} is down/out"
            if f not in up:
                return -22, f"osd.{f} not in raw up set {up}"
            if t in up or t in froms:
                return -22, f"osd.{t} already in up set {up}"
        mapped = self.apply_upmap(up, pairs, down)
        if len(set(mapped)) != len(mapped):
            return -22, f"upmap {pairs} collapses up set {up}"
        return None

    def object_locator(self, pool_id: int, name: str
                       ) -> tuple[int, list[int], int]:
        """(ps, acting, primary) for an object — the Objecter's
        _calc_target essentials (osdc/Objecter.cc:2795)."""
        ps = self.object_to_pg(pool_id, name)
        _, acting, primary = self.pg_to_up_acting(pool_id, ps)
        return ps, acting, primary

    def pgs_of_pool(self, pool_id: int) -> list[int]:
        return list(range(self.pools[pool_id].pg_num))

    # -- wire encoding ------------------------------------------------
    def encode(self) -> bytes:
        e = Encoder()
        body = Encoder()
        body.u32(self.epoch)
        body.map(self.osds, Encoder.i32, lambda en, o: (
            en.bool(o.up), en.bool(o.in_cluster), en.str(o.addr)))
        body.map(self.pools, Encoder.i32, lambda en, p: (
            en.str(p.name), en.u32(p.pg_num), en.str(p.rule),
            en.u32(p.size), en.u32(p.min_size), en.str_map(p.ec_profile),
            en.u32(p.stripe_unit)))
        body.u32(self._next_pool_id)
        # crush map
        body.map(self.crush.buckets, Encoder.i32, lambda en, b: (
            en.str(b.name), en.str(b.type),
            en.list(b.items, Encoder.i32),
            en.list(b.weights, Encoder.f64)))
        body.map(self.crush.device_weights, Encoder.i32, Encoder.f64)
        body.map(self.crush.rules, Encoder.str, lambda en, r: (
            en.str(r.root), en.str(r.failure_domain), en.str(r.mode)))
        body.map(self.pg_temp,
                 lambda en, k: (en.i32(k[0]), en.u32(k[1])),
                 lambda en, v: en.list(v, Encoder.i32))
        # v2: balancer upmap overrides (appended; v1 decoders skip)
        body.map(self.pg_upmap_items,
                 lambda en, k: (en.i32(k[0]), en.u32(k[1])),
                 lambda en, v: en.list(
                     v, lambda en2, p: (en2.i32(p[0]), en2.i32(p[1]))))
        # v3: pool snapshots (appended)
        body.map({pid: p for pid, p in self.pools.items()},
                 Encoder.i32,
                 lambda en, p: (en.u64(p.snap_seq),
                                en.map(p.snaps, Encoder.u64,
                                       Encoder.str)))
        # v4: cache tiering (appended)
        body.map({pid: p for pid, p in self.pools.items()},
                 Encoder.i32,
                 lambda en, p: (en.i64(p.tier_of), en.i64(p.read_tier),
                                en.i64(p.write_tier),
                                en.str(p.cache_mode),
                                en.u64(p.target_max_objects),
                                en.u64(p.target_max_bytes)))
        # v5: blocklist (appended)
        body.map(self.blocklist, Encoder.str, Encoder.f64)
        # v6: self-managed snapshot mode + hit-set knobs (appended)
        body.map({pid: p for pid, p in self.pools.items()},
                 Encoder.i32,
                 lambda en, p: (en.bool(p.selfmanaged),
                                en.list(p.removed_snaps, Encoder.u64),
                                en.f64(p.hit_set_period),
                                en.u32(p.hit_set_count),
                                en.u32(p.min_read_recency_for_promote)))
        e.section(6, body)
        return e.getvalue()

    # -- chunked encoding (per-value Paxos log / share_state role) ----
    # The mon's delta replication diffs states at CHUNK granularity:
    # one chunk per OSD, per pool, plus crush and a small meta chunk —
    # an osd flap or pool create touches one tiny chunk, so a commit's
    # wire cost scales with the CHANGE, not the map. Keep these in
    # step with encode()/decode() above when fields are added.
    def to_chunks(self) -> dict[str, bytes]:
        from dataclasses import asdict
        ch: dict[str, bytes] = {}
        for oid, info in self.osds.items():
            ch[f"osd/{oid}"] = json.dumps(asdict(info),
                                          sort_keys=True).encode()
        for pid, p in self.pools.items():
            ch[f"pool/{pid}"] = json.dumps(asdict(p),
                                           sort_keys=True).encode()
        ch["crush"] = json.dumps({
            "buckets": {str(b.id): [b.name, b.type, b.items,
                                           b.weights]
                        for b in self.crush.buckets.values()},
            "devices": {str(k): v
                        for k, v in self.crush.device_weights.items()},
            "rules": {n: [r.root, r.failure_domain, r.mode]
                      for n, r in self.crush.rules.items()},
        }, sort_keys=True).encode()
        ch["meta"] = json.dumps({
            "epoch": self.epoch,
            "next_pool_id": self._next_pool_id,
            "pg_temp": {f"{k[0]}.{k[1]}": v
                        for k, v in self.pg_temp.items()},
            "upmap": {f"{k[0]}.{k[1]}": v
                      for k, v in self.pg_upmap_items.items()},
            "blocklist": self.blocklist,
        }, sort_keys=True).encode()
        return ch

    @classmethod
    def from_chunks(cls, ch: dict[str, bytes]) -> "OSDMap":
        m = cls()
        meta = json.loads(ch["meta"])
        m.epoch = meta["epoch"]
        m._next_pool_id = meta["next_pool_id"]
        m.pg_temp = {tuple(int(x) for x in k.split(".")): v
                     for k, v in meta["pg_temp"].items()}
        m.pg_upmap_items = {
            tuple(int(x) for x in k.split(".")):
                [tuple(p) for p in v]
            for k, v in meta["upmap"].items()}
        m.blocklist = dict(meta.get("blocklist", {}))
        cr = json.loads(ch["crush"])
        for bid_s, (name, btype, items, weights) in \
                cr["buckets"].items():
            bid = int(bid_s)
            m.crush.buckets[bid] = crush.Bucket(bid, name, btype,
                                                items, weights)
            m.crush.by_name[name] = bid
            m.crush._next_bucket_id = min(m.crush._next_bucket_id,
                                          bid - 1)
        m.crush.device_weights = {int(k): v
                                  for k, v in cr["devices"].items()}
        for n, (root, fd, mode) in cr["rules"].items():
            m.crush.rules[n] = crush.Rule(n, root, fd, mode)
        for name, raw in ch.items():
            if name.startswith("osd/"):
                d = json.loads(raw)
                m.osds[int(name[4:])] = OSDInfo(**d)
            elif name.startswith("pool/"):
                d = json.loads(raw)
                d["snaps"] = {int(k): v
                              for k, v in d["snaps"].items()}
                m.pools[int(name[5:])] = PoolInfo(**d)
        for pid, p in m.pools.items():
            m.pool_by_name[p.name] = pid
        return m

    @classmethod
    def decode(cls, buf: bytes) -> "OSDMap":
        version, d = Decoder(buf).section(6)
        m = cls()
        m.epoch = d.u32()

        def dec_osd(dd: Decoder):
            return (dd.bool(), dd.bool(), dd.str())

        for oid, (up, inc, addr) in d.map(Decoder.i32, dec_osd).items():
            m.osds[oid] = OSDInfo(oid, up, inc, addr)

        def dec_pool(dd: Decoder):
            return (dd.str(), dd.u32(), dd.str(), dd.u32(), dd.u32(),
                    dd.str_map(), dd.u32())

        for pid, (name, pg_num, rule, size, min_size, prof, su) in \
                d.map(Decoder.i32, dec_pool).items():
            m.pools[pid] = PoolInfo(pid, name, pg_num, rule, size,
                                    min_size, prof, su)
            m.pool_by_name[name] = pid
        m._next_pool_id = d.u32()

        def dec_bucket(dd: Decoder):
            return (dd.str(), dd.str(), dd.list(Decoder.i32),
                    dd.list(Decoder.f64))

        for bid, (name, btype, items, weights) in \
                d.map(Decoder.i32, dec_bucket).items():
            m.crush.buckets[bid] = crush.Bucket(bid, name, btype,
                                                items, weights)
            m.crush.by_name[name] = bid
            m.crush._next_bucket_id = min(m.crush._next_bucket_id, bid - 1)
        m.crush.device_weights = d.map(Decoder.i32, Decoder.f64)
        for rname, (root, fd, mode) in d.map(
                Decoder.str,
                lambda dd: (dd.str(), dd.str(), dd.str())).items():
            m.crush.rules[rname] = crush.Rule(rname, root, fd, mode)
        m.pg_temp = d.map(lambda dd: (dd.i32(), dd.u32()),
                          lambda dd: dd.list(Decoder.i32))
        if version >= 2:
            m.pg_upmap_items = d.map(
                lambda dd: (dd.i32(), dd.u32()),
                lambda dd: dd.list(lambda d2: (d2.i32(), d2.i32())))
        if version >= 3:
            snapinfo = d.map(
                Decoder.i32,
                lambda dd: (dd.u64(), dd.map(Decoder.u64, Decoder.str)))
            for pid, (seq, snaps) in snapinfo.items():
                if pid in m.pools:
                    m.pools[pid].snap_seq = seq
                    m.pools[pid].snaps = dict(snaps)
        if version >= 4:
            tierinfo = d.map(
                Decoder.i32,
                lambda dd: (dd.i64(), dd.i64(), dd.i64(), dd.str(),
                            dd.u64(), dd.u64()))
            for pid, (tof, rt, wt, mode, tmo, tmb) in tierinfo.items():
                if pid in m.pools:
                    p = m.pools[pid]
                    p.tier_of, p.read_tier, p.write_tier = tof, rt, wt
                    p.cache_mode = mode
                    p.target_max_objects = tmo
                    p.target_max_bytes = tmb
        if version >= 5:
            m.blocklist = d.map(Decoder.str, Decoder.f64)
        if version >= 6:
            sminfo = d.map(
                Decoder.i32,
                lambda dd: (dd.bool(), dd.list(Decoder.u64),
                            dd.f64(), dd.u32(), dd.u32()))
            for pid, (sm, removed, hsp, hsc, recency) in \
                    sminfo.items():
                if pid in m.pools:
                    p = m.pools[pid]
                    p.selfmanaged = sm
                    p.removed_snaps = list(removed)
                    p.hit_set_period = hsp
                    p.hit_set_count = hsc
                    p.min_read_recency_for_promote = recency
        return m
