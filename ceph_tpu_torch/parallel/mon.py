"""Monitor — the consensus/control plane (src/mon/ role).

Reference: ``Monitor`` + ``Paxos`` (src/mon/Paxos.h:174) + the
PaxosService subclasses, chiefly OSDMonitor (osdmap epochs, EC profile
commands) and ConfigMonitor. Collapsed here to one daemon class with:

  - a persisted commit log (MonitorDBStore role, backed by store/kv):
    every map change is a numbered committed value, replayed on
    restart — the Paxos log discipline.
  - Paxos (src/mon/Paxos.{h,cc} collect/begin/accept/commit) when
    started with a monmap of peers. Election (Elector role): mons
    exchange liveness/progress beacons and derive the leader as the
    most-advanced lowest-ranked live peer. A new leader then runs the
    COLLECT phase (phase 1): it picks a proposal number above every
    pn it has seen, gathers promises from a quorum, catches up to the
    most advanced committed state revealed, and COMPLETES any
    predecessor's accepted-but-uncommitted value (Paxos.cc collect/
    handle_last). Mutations run on a SCRATCH copy of the state and
    fan out as a BEGIN (phase 2): peers that promised no higher pn
    persist the value as pending and ack; on a quorum of accepts the
    leader commits (durable + visible + published) and replicates the
    commit. A minority or deposed leader can never commit: its begin
    is fenced by higher promised pns (or simply starves of acks) and
    the proposal times out with -110, leaving state untouched.
    Command replies for committed mutations ride IN the replicated
    state (the (client, tid) -> reply dedup survives leader
    failover, so a client retry attaches to the original execution).
    Remaining reduction vs the reference: values are full-state
    snapshots (no per-value log transfer; catch-up and commit are
    the same message). Reads are LEASE-bounded (Paxos.h:174 lease
    fields, Paxos.cc extend_lease role): the leader's heartbeats and
    commit replications grant peons a mon_lease window during which
    they may answer read-only commands from committed state; an
    expired lease (partitioned peon, deposed-but-unaware leader)
    answers EAGAIN instead of unboundedly stale state, and clients
    rotate to a mon that can serve.
  - OSDMonitor logic: MOSDBoot marks OSDs up (new epoch), failure
    reports and beacon-timeout mark them down (OSDMap epochs move
    forward only), pool/EC-profile commands validated by actually
    instantiating the codec — the reference validates profiles on the
    mon via the same plugin registry the OSDs use
    (OSDMonitor::prepare_command pattern, SURVEY §3.5).
  - map publication: subscribers (MMonSubscribe) get an MOSDMap push
    on every commit.
  - health: HEALTH_OK / HEALTH_WARN from up/in accounting.
"""

from __future__ import annotations

import json
import threading

from ceph_tpu_torch.analysis.lock_witness import make_rlock
import time

from ceph_tpu_torch.models import registry as ec_registry
from ceph_tpu_torch.osd.ec_backend import profile_device
from ceph_tpu_torch.parallel import crush
from ceph_tpu_torch.parallel import messages as M
from ceph_tpu_torch.parallel.messenger import Connection, Messenger
from ceph_tpu_torch.parallel.osdmap import OSDMap
from ceph_tpu_torch.store.kv import KeyValueDB, MemDB, WriteBatch
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.dout import Dout

log = Dout("mon")


#: command prefixes that never mutate state — answered straight from
#: committed state, bypassing the proposal pipeline
_READONLY_COMMANDS = frozenset({
    "osd erasure-code-profile ls", "osd erasure-code-profile get",
    "osd pool ls", "osd pool lssnap", "osd tree", "osd dump",
    "status", "health", "health detail", "config dump",
    "osd blocklist ls",
})

#: seconds after which a pushed mgr health report stops being merged
#: into status/health answers (a dead mgr must not pin stale checks)
MGR_HEALTH_STALE = 30.0


class Monitor:
    """A single monitor daemon ("mon.a")."""

    def __init__(self, name: str = "a", db: KeyValueDB | None = None,
                 keyring=None) -> None:
        self.name = name
        self.db = db or MemDB()
        self.auth_service = None
        if keyring is not None:
            from ceph_tpu_torch.parallel import auth as A
            self.auth_service = A.AuthService(keyring)
        self.osdmap = OSDMap()
        self.ec_profiles: dict[str, dict] = {}
        self.msgr = Messenger(f"mon.{name}")
        self.msgr.set_dispatcher(self._dispatch)
        self.addr = ""
        # quorum state (single-mon default: rank 0, no peers, leader)
        self.rank = 0
        self.monmap: dict[int, str] = {}      # rank -> addr (peers+self)
        self._peer_seen: dict[int, tuple[float, int]] = {}
        self._leader_rank = 0
        self._lock = make_rlock("mon.state")
        self._subscribers: dict[str, Connection] = {}  # peer entity -> conn
        self._last_beacon: dict[int, float] = {}
        # osd -> (monotonic ts, [pg stat dicts]) — pgmap soft state
        # (the mgr's aggregation role)
        self._pg_stats: dict[int, tuple[float, list]] = {}
        # latest mgr health-engine report (monotonic ts, checks dict)
        # — soft state like pg stats, merged into status/health
        self._mgr_health: tuple[float, dict] | None = None
        self._failure_reports: dict[int, dict[int, float]] = {}
        # epoch at which each osd last booted (up_from role): failure
        # reports carrying an older epoch were formed before the boot
        # and must not count against the reborn daemon
        self._up_epoch: dict[int, int] = {}
        from ceph_tpu_torch.utils.admin_socket import AdminSocket
        self.asok = AdminSocket(
            f"mon.{name}", g_conf()["admin_socket_dir"] or None)
        self._tick_stop = threading.Event()
        self._tick_thread: threading.Thread | None = None
        # -- paxos machine state (Paxos.h:174 roles) --
        #: the pn this mon leads with (0 = not established; set by a
        #: completed collect phase)
        self._leader_pn = 0
        #: in-flight phase-1: {"pn", "ts", "replies": {rank: (lc,
        #: state, (pending_pn, pending_v, pending_state))}}
        self._collect: dict | None = None
        #: in-flight phase-2: {"pn", "version", "state", "scratch",
        #: "entries", "acks", "ts"} — one proposal at a time
        self._proposal: dict | None = None
        #: queued mutations [{"fn", "done", "ts"}] folded into the
        #: next proposal (PaxosService pending role)
        self._mut_queue: list[dict] = []
        #: scratch-dirty marker set by _commit() during mutation runs
        self._dirty = False
        #: dedup for the tick's beacon-timeout mutation: while a
        #: proposal stalls, every tick would otherwise queue another
        #: identical osdmap scan
        self._beacon_check_queued = False
        #: same dedup for the blocklist-expiry prune mutation
        self._blocklist_prune_queued = False
        # "client|tid" -> [code, outs, data_hex]: REPLICATED command
        # dedup — part of the committed state, so a retry after leader
        # failover attaches to the original execution instead of
        # re-running the mutation (the reference's session dedup,
        # made durable)
        self._cmd_replies: dict[str, list] = {}
        # centralized config (ConfigMonitor role, src/mon/
        # ConfigMonitor.cc): replicated name->value map pushed to
        # subscribed daemons as MConfig on every commit; daemons apply
        # it into their 'mon' config source layer
        self._central_config: dict[str, str] = {}
        # in-memory dedup for commands still awaiting their proposal
        # (holds the waiting connections) + completed-reply LRU
        from ceph_tpu_torch.utils.lru import BoundedLRU
        self._cmd_dedup: BoundedLRU = BoundedLRU(1024)
        #: monotonic deadline until which this PEON may serve reads
        #: from committed state (granted by leader HBs/commits —
        #: Paxos lease role; the leader's own lease is quorum
        #: visibility, see _lease_valid)
        self._lease_until = 0.0
        #: COMMITTED state as a chunk table (per-value log transfer:
        #: deltas are diffs of this table; see _state_chunks_of)
        self._chunks: dict[str, bytes] = {}
        #: wire accounting for the share_state discipline (tests
        #: assert catch-up rides deltas, not snapshots)
        self.paxos_stats = {"delta_sent": 0, "full_sent": 0,
                            "delta_applied": 0, "full_applied": 0}
        # -- elector state (src/mon/Elector.cc roles) --
        #: active candidacy: {"epoch", "ts", "defers": set} while WE
        #: stand in an election round
        self._election: dict | None = None
        #: sticky deferral for the current epoch: {"epoch", "rank",
        #: "key"} — re-defer within an epoch only to a strictly
        #: better candidate, so two majorities can never form
        self._deferred: dict | None = None
        #: the quorum the last victory announced (introspection)
        self._quorum: list[int] = []
        self._replay()
        self._chunks = self._state_chunks_of(
            self.osdmap, self.ec_profiles, self._cmd_replies,
            self._central_config)

    # -- lifecycle ----------------------------------------------------
    def prebind(self, host: str = "127.0.0.1", port: int = 0) -> str:
        """Bind the messenger before the monmap is known (multi-mon
        bootstrap: all mons bind, then everyone learns every addr)."""
        if not self.addr:
            addr = self.msgr.bind(host, port)
            with self._lock:
                self.addr = addr
        return self.addr

    def set_monmap(self, monmap: dict[int, str], rank: int) -> None:
        # under the lock: the messenger is already dispatching once
        # prebind bound it, so a peer's HB can race the map install
        with self._lock:
            self.monmap = dict(monmap)
            self.rank = rank
            # multi-mon: leadership is EARNED through an election
            # round (propose/defer/victory), never assumed at boot
            self._leader_rank = rank if len(self.monmap) <= 1 else -1

    def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        # the grace countdown for every replayed-up osd starts now: a
        # dead one that never re-beacons must still time out
        now = time.monotonic()
        for osd, info in self.osdmap.osds.items():
            if info.up:
                self._last_beacon.setdefault(osd, now)
        if self.auth_service is not None:
            from ceph_tpu_torch.parallel import auth as A
            A.daemon_auth(self.msgr, self.auth_service.keyring,
                          f"mon.{self.name}")
        from ceph_tpu_torch.utils.admin_socket import register_common_commands
        register_common_commands(self.asok)
        self.asok.register_command(
            "mon_status",
            lambda a: {"name": self.name, "addr": self.addr,
                       "epoch": self.osdmap.epoch,
                       "osds": {o: {"up": i.up, "in": i.in_cluster,
                                    "addr": i.addr}
                                for o, i in self.osdmap.osds.items()}},
            "monitor + osdmap summary")
        self.asok.register_command(
            "quorum_status",
            lambda a: {"rank": self.rank, "leader": self._leader_rank,
                       "is_leader": self.is_leader(),
                       "monmap": {str(r): a_ for r, a_ in
                                  self.monmap.items()},
                       "last_committed": self._last_committed(),
                       "state_bytes": getattr(self,
                                              "_last_state_bytes", 0)},
            "election/quorum state (Elector role)")
        self.asok.start()
        self.prebind(host, port)
        with self._lock:
            if not self.monmap:
                self.monmap = {self.rank: self.addr}
        self._tick_thread = threading.Thread(
            target=self._tick_loop, name=f"mon.{self.name}-tick",
            daemon=True)
        self._tick_thread.start()
        log(1, f"mon.{self.name} up at {self.addr}, "
            f"epoch {self.osdmap.epoch}")
        return self.addr

    def stop(self) -> None:
        self._tick_stop.set()
        if self._tick_thread:
            self._tick_thread.join(timeout=5)
        self.msgr.shutdown()
        self.asok.stop()
        self.db.close()

    # -- paxos durable state (Paxos.h:174) ----------------------------
    def _last_committed(self) -> int:
        raw = self.db.get("paxos/last_committed")
        return int(raw.decode()) if raw else 0

    def _accepted_pn(self) -> int:
        """Highest proposal number this mon has promised (persisted —
        the promise must survive restart or a deposed leader could be
        re-accepted)."""
        raw = self.db.get("paxos/accepted_pn")
        return int(raw.decode()) if raw else 0

    def _promise(self, pn: int) -> None:
        batch = WriteBatch()
        batch.put("paxos/accepted_pn", str(pn).encode())
        self.db.submit(batch, sync=True)

    def _pending(self) -> tuple[int, int, bytes] | None:
        """The durably ACCEPTED but uncommitted value (pn, version,
        state) — what a new leader's collect phase recovers."""
        raw = self.db.get("paxos/pending")
        if not raw:
            return None
        from ceph_tpu_torch.utils.encoding import Decoder
        d = Decoder(raw)
        return d.u64(), d.u64(), d.bytes()

    def _set_pending(self, pn: int, version: int, state: bytes) -> None:
        """Durably accept a value (peon side of begin; leader
        self-accept). MUST hit disk before the accept ack goes out —
        that durability is exactly what collect recovery relies on."""
        from ceph_tpu_torch.utils.encoding import Encoder
        e = Encoder()
        e.u64(pn)
        e.u64(version)
        e.bytes(state)
        batch = WriteBatch()
        batch.put("paxos/pending", e.getvalue())
        batch.put("paxos/accepted_pn", str(pn).encode())
        self.db.submit(batch, sync=True)

    def _commit(self) -> None:
        """Called by command/boot/failure handlers after mutating the
        map. Under real Paxos those handlers run against a SCRATCH
        copy inside _pump_proposals; this merely advances the epoch
        and marks the scratch dirty — visibility and durability happen
        in _commit_proposal once a quorum accepts (the reference's
        PaxosService::propose_pending seam)."""
        self.osdmap.epoch += 1
        self._dirty = True

    # -- quorum (Paxos/Elector roles) ---------------------------------
    def is_leader(self) -> bool:
        return self._leader_rank == self.rank

    def _lease_valid(self, now: float) -> bool:
        """May this mon answer reads from its committed state? (the
        Paxos lease contract, src/mon/Paxos.h:174 / Paxos.cc
        extend_lease): a single mon always may; the leader may while
        it can see a quorum (a partitioned minority 'leader' goes
        read-dark within mon_election_timeout); a peon may while the
        leader's heartbeat/commit lease grant is unexpired."""
        if len(self.monmap) <= 1:
            return True
        if self.is_leader():
            return len(self._alive_ranks(now)) >= self._majority()
        return now < self._lease_until

    def leader_addr(self) -> str:
        return self.monmap.get(self._leader_rank, self.addr)

    def _alive_ranks(self, now: float) -> dict[int, int]:
        """rank -> last_committed for every mon considered alive."""
        grace = g_conf()["mon_election_timeout"]
        alive = {self.rank: self._last_committed()}
        for rank, (ts, lc) in self._peer_seen.items():
            if now - ts <= grace and rank in self.monmap:
                alive[rank] = lc
        return alive

    # -- elector (src/mon/Elector.cc propose/defer/victory) -----------
    def _election_epoch(self) -> int:
        raw = self.db.get("paxos/election_epoch")
        return int(raw.decode()) if raw else 0

    def _set_election_epoch(self, ep: int) -> None:
        if ep <= self._election_epoch():
            return
        batch = WriteBatch()
        batch.put("paxos/election_epoch", str(ep).encode())
        self.db.submit(batch, sync=True)

    def _cand_key(self) -> tuple:
        """Candidate ordering: most-advanced commit log first (a stale
        rejoiner can never win), lowest rank breaking ties."""
        return (self._last_committed(), -self.rank)

    def _start_election(self, now: float) -> None:
        ep = self._election_epoch()
        ep = ep + 1 if ep % 2 == 0 else ep + 2   # next ODD epoch
        self._set_election_epoch(ep)
        self._election = {"epoch": ep, "ts": now,
                          "defers": {self.rank}}
        self._deferred = None
        log(1, f"mon.{self.name}: proposing election epoch {ep}")
        for rank, addr in self.monmap.items():
            if rank != self.rank:
                self.msgr.send_message(M.MMonElection(
                    op=M.ELECTION_PROPOSE, epoch=ep, rank=self.rank,
                    last_committed=self._last_committed()), addr)

    def _handle_election(self, msg: M.MMonElection,
                         now: float) -> None:
        if msg.op == M.ELECTION_PROPOSE:
            my_ep = self._election_epoch()
            if msg.epoch < my_ep:
                # stale candidate: educate it. A sitting leader
                # re-asserts its victory; a mon that is itself mid-
                # election answers with its candidacy at the current
                # height; a settled peon stays quiet (the rejoiner
                # converges via the HB election-epoch sync)
                addr = self.monmap.get(msg.rank)
                if addr is None:
                    return
                if self.is_leader():
                    self.msgr.send_message(M.MMonElection(
                        op=M.ELECTION_VICTORY, epoch=my_ep,
                        rank=self.rank, quorum=self._quorum), addr)
                elif self._election is not None:
                    self.msgr.send_message(M.MMonElection(
                        op=M.ELECTION_PROPOSE,
                        epoch=self._election["epoch"],
                        rank=self.rank,
                        last_committed=self._last_committed()), addr)
                return
            self._set_election_epoch(msg.epoch)
            theirs = (msg.last_committed, -msg.rank)
            mine = self._cand_key()
            if theirs > mine:
                # defer — STICKY within the epoch (re-defer only to a
                # strictly better candidate, so no two candidates can
                # both assemble a majority)
                d = self._deferred
                if d is not None and d["epoch"] == msg.epoch and \
                        d["key"] >= theirs:
                    return
                self._deferred = {"epoch": msg.epoch,
                                  "rank": msg.rank, "key": theirs,
                                  "ts": now}
                if self._election is not None and \
                        self._election["epoch"] <= msg.epoch:
                    self._election = None      # stand down
                addr = self.monmap.get(msg.rank)
                if addr:
                    self.msgr.send_message(M.MMonElection(
                        op=M.ELECTION_DEFER, epoch=msg.epoch,
                        rank=self.rank,
                        last_committed=self._last_committed()), addr)
            else:
                # we are the better candidate: contest this epoch.
                # BROADCAST the candidacy (answering only the proposer
                # would strand our defers at 1 while worse candidates
                # keep churning epochs — the boot-race livelock)
                if self._election is None or \
                        self._election["epoch"] < msg.epoch:
                    self._election = {"epoch": msg.epoch, "ts": now,
                                      "defers": {self.rank}}
                    for rank, addr in self.monmap.items():
                        if rank != self.rank:
                            self.msgr.send_message(M.MMonElection(
                                op=M.ELECTION_PROPOSE,
                                epoch=self._election["epoch"],
                                rank=self.rank,
                                last_committed=self._last_committed()),
                                addr)
                else:
                    addr = self.monmap.get(msg.rank)
                    if addr:
                        self.msgr.send_message(M.MMonElection(
                            op=M.ELECTION_PROPOSE,
                            epoch=self._election["epoch"],
                            rank=self.rank,
                            last_committed=self._last_committed()),
                            addr)
        elif msg.op == M.ELECTION_DEFER:
            el = self._election
            if el is None or msg.epoch != el["epoch"]:
                return
            el["defers"].add(msg.rank)
            self._maybe_win(now)
        elif msg.op == M.ELECTION_VICTORY:
            if msg.epoch < self._election_epoch():
                return
            if msg.epoch == self._election_epoch() and \
                    self._leader_rank >= 0 and \
                    msg.rank > self._leader_rank:
                # equal-epoch victory collision (possible under an
                # asymmetric partition where a mon deferred to two
                # candidates): the LOWER-ranked winner prevails
                # deterministically on every mon — the higher-ranked
                # one deposes itself when it hears the lower victory,
                # never the cross-deposition livelock
                return
            self._set_election_epoch(msg.epoch)
            self._election = None
            self._deferred = None
            self._quorum = list(msg.quorum)
            old = self._leader_rank
            self._leader_rank = msg.rank
            if old == self.rank and msg.rank != self.rank:
                # deposed: any in-flight proposal cannot be OUR commit
                # any more (the successor may still complete it via
                # collect; the replicated dedup answers retries)
                log(1, f"mon.{self.name}: deposed by election epoch "
                    f"{msg.epoch} (leader rank {msg.rank})")
                self._fail_proposal()
                self._leader_pn = 0
                self._collect = None

    def _maybe_win(self, now: float) -> None:
        """Win once every mon we can SEE has deferred (dead mons are
        excused; a live better candidate never defers, so it blocks
        us exactly as it should). The election-timeout fallback in
        _election_tick covers a wrong liveness view."""
        el = self._election
        if el is None or len(el["defers"]) < self._majority():
            return
        alive = set(self._alive_ranks(now))
        if alive <= el["defers"]:
            self._declare_victory(now)

    def _declare_victory(self, now: float) -> None:
        el = self._election
        ep = el["epoch"] + 1                     # even: stable
        self._set_election_epoch(ep)
        self._election = None
        self._deferred = None
        self._quorum = sorted(el["defers"])
        log(1, f"mon.{self.name}: election epoch {ep} won "
            f"(quorum {self._quorum})")
        for rank, addr in self.monmap.items():
            if rank != self.rank:
                self.msgr.send_message(M.MMonElection(
                    op=M.ELECTION_VICTORY, epoch=ep, rank=self.rank,
                    quorum=self._quorum), addr)
        was_leader = self._leader_rank == self.rank
        self._leader_rank = self.rank
        if not was_leader:
            # taking over: (a) every up OSD gets a fresh beacon grace
            # window — as a peon we forwarded beacons instead of
            # recording them; (b) push our state to every peer so a
            # healed split-brain twin at an EQUAL version adopts the
            # elected leader's truth; (c) run the collect phase to
            # establish a pn and recover the predecessor's in-flight
            # proposal (Paxos leader takeover)
            for osd, info in self.osdmap.osds.items():
                if info.up:
                    self._last_beacon[osd] = time.monotonic()
            state = self._encode_state()
            for rank, addr in self.monmap.items():
                if rank != self.rank:
                    self.paxos_stats["full_sent"] += 1
                    self.msgr.send_message(M.MPaxosCommit(
                        version=self._last_committed(),
                        state=state, rank=self.rank), addr)
        self._leader_pn = 0
        self._start_collect(now)

    def _election_tick(self, now: float) -> None:
        """Election upkeep + catch-up pull (runs from tick)."""
        el = self._election
        if el is not None:
            # a mon that fell out of the alive view since our last
            # defer may unblock the everyone-alive-deferred fast path
            self._maybe_win(now)
        el = self._election
        if el is not None and \
                now - el["ts"] > g_conf()["mon_election_timeout"]:
            if len(el["defers"]) >= self._majority():
                # window closed with a majority deferring and no
                # better candidate surfaced: win (the equal-epoch
                # tie-break above resolves the rare dual victory)
                self._declare_victory(now)
            else:
                self._election = None        # round died: try again
        alive = self._alive_ranks(now)
        if self._election is None:
            leader = self._leader_rank
            no_leader = leader < 0 or (
                leader != self.rank and leader not in alive)
            # deferred recently: hold off — OUR candidate's round is
            # in flight; re-proposing every tick would reset its
            # election window forever (the boot-race livelock)
            d = self._deferred
            deferred_fresh = d is not None and \
                now - d.get("ts", 0.0) < g_conf()["mon_election_timeout"]
            if no_leader and not deferred_fresh and \
                    len(alive) >= self._majority():
                self._start_election(now)
        # lagging behind a live peer: pull the missing values
        best = max(alive.values())
        if best > self._last_committed():
            ahead = min(r for r, lc in alive.items() if lc == best)
            if ahead != self.rank:
                self.msgr.send_message(
                    M.MPaxosPull(rank=self.rank,
                                 from_version=self._last_committed()),
                    self.monmap[ahead])

    # -- phase 1: collect (Paxos::collect / handle_collect) -----------
    def _next_pn(self) -> int:
        """A pn above everything seen, unique per mon (counter<<8 |
        rank — the reference's get_new_proposal_number shape)."""
        base = max(self._accepted_pn(), self._leader_pn) >> 8
        return ((base + 1) << 8) | (self.rank & 0xFF)

    def _start_collect(self, now: float) -> None:
        pn = self._next_pn()
        self._promise(pn)          # self-promise
        self._leader_pn = 0
        mine = self._pending() or (0, 0, b"")
        self._collect = {
            "pn": pn, "ts": now,
            "replies": {self.rank: (self._last_committed(), b"", mine)}}
        log(1, f"mon.{self.name}: collect phase, pn {pn}")
        for rank, addr in self.monmap.items():
            if rank != self.rank:
                self.msgr.send_message(M.MPaxosCollect(
                    pn=pn, rank=self.rank,
                    last_committed=self._last_committed()), addr)
        self._maybe_finish_collect()

    def _handle_collect(self, msg: M.MPaxosCollect) -> None:
        ok = msg.pn > self._accepted_pn()
        if ok:
            self._promise(msg.pn)
            # a higher pn is live: any proposal WE lead is fenced now
            self._leader_pn = 0
        lc = self._last_committed()
        state = self._encode_state() if lc > msg.last_committed else b""
        pend = self._pending() or (0, 0, b"")
        addr = self.monmap.get(msg.rank)
        if addr:
            self.msgr.send_message(M.MPaxosCollectReply(
                ok=ok, pn=msg.pn, accepted_pn=self._accepted_pn(),
                rank=self.rank, last_committed=lc, state=state,
                pending_pn=pend[0], pending_version=pend[1],
                pending_state=pend[2]), addr)

    def _handle_collect_reply(self, msg: M.MPaxosCollectReply) -> None:
        col = self._collect
        if col is None or msg.pn != col["pn"]:
            return
        if not msg.ok:
            # someone promised higher: stand down; election + a later
            # collect with a fresh pn sort it out
            log(1, f"mon.{self.name}: collect pn {col['pn']} refused "
                f"by rank {msg.rank} (accepted_pn {msg.accepted_pn})")
            self._collect = None
            return
        col["replies"][msg.rank] = (
            msg.last_committed, msg.state,
            (msg.pending_pn, msg.pending_version, msg.pending_state))
        self._maybe_finish_collect()

    def _maybe_finish_collect(self) -> None:
        col = self._collect
        if col is None or len(col["replies"]) < self._majority():
            return
        self._collect = None
        # catch up to the most advanced committed state a peer revealed
        best_lc, best_state = self._last_committed(), b""
        for lc, state, _pend in col["replies"].values():
            if lc > best_lc and state:
                best_lc, best_state = lc, state
        if best_state:
            self._adopt_state(best_lc, best_state)
        self._leader_pn = col["pn"]
        log(1, f"mon.{self.name}: leading with pn {col['pn']} "
            f"at v{self._last_committed()}")
        # complete the predecessor's in-flight value, if one survives:
        # among uncommitted accepted values, highest pn wins (the
        # Paxos recovery rule, Paxos.cc handle_last)
        cand = None
        for _lc, _state, pend in col["replies"].values():
            if pend[2] and pend[1] > self._last_committed():
                if cand is None or pend[0] > cand[0]:
                    cand = pend
        if cand is not None:
            log(1, f"mon.{self.name}: completing predecessor's "
                f"uncommitted proposal v{cand[1]} (pn {cand[0]})")
            scratch = self._decode_state(cand[2])
            self._begin(cand[2], max(cand[1],
                                     self._last_committed() + 1),
                        scratch, [])
        else:
            self._pump_proposals(time.monotonic())

    # -- phase 2: begin/accept (Paxos::begin / handle_begin) ----------
    def _pump_proposals(self, now: float) -> None:
        """Fold every queued mutation into one proposal (one in flight
        at a time — the single-decree pipeline). Mutations run on a
        SCRATCH copy: nothing becomes visible or durable unless a
        quorum accepts. Caller holds the lock."""
        if self._proposal is not None or not self._mut_queue or \
                not self.is_leader():
            return
        if self._leader_pn == 0 or \
                self._leader_pn < self._accepted_pn():
            # pn not established (or fenced by a higher promise):
            # phase 1 first
            if self._collect is None:
                self._start_collect(now)
            return
        entries = self._mut_queue
        self._mut_queue = []
        committed = (self.osdmap, self.ec_profiles,
                     self._cmd_replies, self._central_config)
        self.osdmap = OSDMap.decode(self.osdmap.encode())
        self.ec_profiles = json.loads(json.dumps(self.ec_profiles))
        self._cmd_replies = dict(self._cmd_replies)
        self._central_config = dict(self._central_config)
        batch_dirty = False
        for ent in entries:
            self._dirty = False     # per-mutation marker (dedup needs
            try:                    # to know if THIS one mutated)
                ent["fn"]()
            except Exception as exc:
                log(0, f"mon.{self.name}: mutation failed: {exc!r}")
            batch_dirty |= self._dirty
        scratch = (self.osdmap, self.ec_profiles, self._cmd_replies,
                   self._central_config)
        (self.osdmap, self.ec_profiles, self._cmd_replies,
         self._central_config) = committed
        dones = [ent.get("done") for ent in entries]
        if not batch_dirty:
            # nothing to commit (read-only/error commands): answer now
            for done in dones:
                if done is not None:
                    done(True)
            self._pump_proposals(now)
            return
        chunks = self._state_chunks_of(*scratch)
        self._begin(self._encode_chunks(chunks),
                    self._last_committed() + 1, scratch, dones,
                    chunks=chunks)

    def _begin(self, state: bytes, version: int, scratch,
               entries: list, chunks=None) -> None:
        pn = self._leader_pn
        self._set_pending(pn, version, state)    # leader self-accept
        # the VALUE travels as a delta against the committed chunk
        # table (share_state discipline): quorum peons sit at our
        # last_committed, reconstruct the full value locally, and the
        # wire cost scales with the change, not the map
        new_chunks = chunks if chunks is not None \
            else self._decode_chunks(state)
        delta = self._chunks_delta(new_chunks)
        self._proposal = {"pn": pn, "version": version, "state": state,
                          "chunks": new_chunks, "delta": delta,
                          "scratch": scratch, "entries": entries,
                          "acks": {self.rank}, "ts": time.monotonic()}
        if len(self._proposal["acks"]) >= self._majority():
            self._commit_proposal()              # single-mon fast path
            return
        base = self._last_committed()
        for rank, addr in self.monmap.items():
            if rank != self.rank:
                self.paxos_stats["delta_sent"] += 1
                self.msgr.send_message(M.MPaxosBegin(
                    pn=pn, version=version, state=b"",
                    rank=self.rank, base=base, delta=delta), addr)

    def _handle_begin(self, msg: M.MPaxosBegin) -> None:
        state = msg.state
        if not state and msg.delta:
            if msg.base == self._last_committed():
                self.paxos_stats["delta_applied"] += 1
                state = self._encode_chunks(
                    self._apply_delta_to(self._chunks, msg.delta))
            # else: we lag the leader's base — cannot materialize the
            # value; NAK below and catch up via pull
        ok = bool(state) and msg.pn >= self._accepted_pn() and \
            msg.version > self._last_committed()
        if ok:
            self._set_pending(msg.pn, msg.version, state)
        addr = self.monmap.get(msg.rank)
        if addr:
            self.msgr.send_message(M.MPaxosAccept(
                ok=ok, pn=msg.pn, version=msg.version, rank=self.rank,
                accepted_pn=self._accepted_pn()), addr)

    def _handle_accept(self, msg: M.MPaxosAccept) -> None:
        prop = self._proposal
        if prop is None or msg.pn != prop["pn"] or \
                msg.version != prop["version"]:
            return
        if not msg.ok:
            if msg.accepted_pn > prop["pn"]:
                # fenced: a newer leader's pn is promised out there —
                # this proposal can never reach quorum (dueling-leader
                # safety; the value may still be completed by the NEW
                # leader's collect, in which case the replicated dedup
                # answers the client's retry)
                log(1, f"mon.{self.name}: proposal v{prop['version']} "
                    f"fenced by pn {msg.accepted_pn}; standing down")
                self._fail_proposal()
                self._leader_pn = 0
            return
        prop["acks"].add(msg.rank)
        if len(prop["acks"]) >= self._majority():
            self._commit_proposal()

    def _commit_proposal(self) -> None:
        """Quorum accepted: make the value durable + visible, publish,
        replicate the commit (Paxos::commit). Caller holds the lock."""
        prop = self._proposal
        self._proposal = None
        version, state = prop["version"], prop["state"]
        base = self._last_committed()
        (self.osdmap, self.ec_profiles, self._cmd_replies,
         self._central_config) = prop["scratch"]
        delta = prop.get("delta") or self._chunks_delta(
            prop.get("chunks") or self._decode_chunks(state))
        batch = WriteBatch()
        batch.put(f"paxos/{version:016d}", state)
        batch.put(f"paxos/delta/{version:016d}", delta)
        batch.put("paxos/last_committed", str(version).encode())
        batch.delete("paxos/pending")
        self.db.submit(batch, sync=True)
        self._chunks = prop.get("chunks") or \
            self._decode_chunks(state)
        self._trim_values(version)
        log(10, f"committed version {version} "
            f"(epoch {self.osdmap.epoch})")
        self._publish()
        for rank, addr in self.monmap.items():
            if rank != self.rank:
                # the commit is DELTA-sized: quorum peons hold the
                # full value as pending (from the begin) or sit at
                # base and apply the delta; stragglers pull
                self.paxos_stats["delta_sent"] += 1
                self.msgr.send_message(M.MPaxosCommit(
                    version=version, state=b"", rank=self.rank,
                    base=base, delta=delta, pn=prop["pn"]), addr)
        for done in prop["entries"]:
            if done is not None:
                done(True)
        self._pump_proposals(time.monotonic())

    def _fail_proposal(self) -> None:
        """Drop the in-flight proposal WITHOUT committing: the scratch
        evaporates, state stays untouched (what -110 promises the
        client). The self-accepted pending value intentionally stays
        on disk — a successor's collect may still complete it."""
        prop = self._proposal
        self._proposal = None
        if prop is None:
            return
        for done in prop["entries"]:
            if done is not None:
                done(False)

    def _apply_remote_commit(self, msg: M.MPaxosCommit) -> None:
        """Adopt a commit from a more advanced mon. The common case is
        DELTA-sized (share_state): our pending value from the begin
        phase IS the full value, or the delta applies to our chunk
        table at ``base``. Full snapshots heal everything else. An
        EQUAL version from the mon we recognize as leader also applies
        — that heals a split-brain where both sides committed the same
        version number with different states."""
        if msg.version < self._last_committed():
            return
        if msg.rank == self._leader_rank and msg.rank != self.rank:
            # a commit from the leader is also a lease grant: after
            # applying it we hold exactly the leader's state
            self._lease_until = time.monotonic() + g_conf()["mon_lease"]
        if msg.version == self._last_committed() and (
                self.is_leader() or msg.rank != self._leader_rank):
            return
        state = msg.state
        if not state:
            pend = self._pending()
            if pend is not None and pend[1] == msg.version and \
                    msg.pn and pend[0] == msg.pn:
                # we durably accepted this exact PROPOSAL (version AND
                # pn match) in the begin phase: commit what we hold —
                # a deposed leader's own same-version pending never
                # matches the majority's pn and falls through.
                # (_handle_begin already counted the delta apply)
                state = pend[2]
            elif msg.delta and msg.base == self._last_committed():
                state = self._encode_chunks(
                    self._apply_delta_to(self._chunks, msg.delta))
                self.paxos_stats["delta_applied"] += 1
            else:
                # can't materialize the value: we lag — pull a
                # catch-up chain from the committer
                addr = self.monmap.get(msg.rank)
                if addr:
                    self.msgr.send_message(M.MPaxosPull(
                        rank=self.rank,
                        from_version=self._last_committed()), addr)
                return
        else:
            self.paxos_stats["full_applied"] += 1
        # (an equal-version split-brain heal can only arrive as a full
        # state — equal-version deltas don't exist)
        self._adopt_state(msg.version, state)

    def _adopt_state(self, version: int, state: bytes) -> None:
        """Install a committed value (remote commit / catch-up /
        collect recovery). Caller holds the lock."""
        new_chunks = self._decode_chunks(state)
        batch = WriteBatch()
        batch.put(f"paxos/{version:016d}", state)
        if version == self._last_committed() + 1:
            # contiguous: record the per-value delta so WE can serve
            # delta catch-up chains to mons behind us
            batch.put(f"paxos/delta/{version:016d}",
                      self._chunks_delta(new_chunks))
        else:
            # equal-version heal or snapshot jump: any delta we
            # recorded for this version described a DIFFERENT history
            # — serving it to a puller would fork the quorum's state
            batch.delete(f"paxos/delta/{version:016d}")
            # and everything below is unservable as a chain anyway
            # (we never held the intermediate deltas): advance the
            # trim floor so _trim_values stays O(actual log)
            if version > self._trim_floor():
                batch.put("paxos/trimmed_to", str(version).encode())
        batch.put("paxos/last_committed", str(version).encode())
        pend = self._pending()
        if pend is not None and pend[1] <= version:
            batch.delete("paxos/pending")    # superseded
        self.db.submit(batch, sync=True)
        (self.osdmap, self.ec_profiles, self._cmd_replies,
         self._central_config) = self._state_from_chunks(new_chunks)
        self._chunks = new_chunks
        self._trim_values(version)
        log(10, f"mon.{self.name}: adopted commit v{version} "
            f"(epoch {self.osdmap.epoch})")
        self._publish()

    def _encode_state(self) -> bytes:
        raw = self._encode_state_of(self.osdmap, self.ec_profiles,
                                    self._cmd_replies,
                                    self._central_config)
        self._last_state_bytes = len(raw)
        return raw

    # -- chunked state + per-value deltas (Paxos.cc share_state role) -
    # The replicated state is a CHUNK TABLE (osdmap chunks per osd /
    # pool / crush / meta, plus profiles, config, and one chunk per
    # dedup reply). A committed value's wire form is the DELTA —
    # chunks changed/removed since the previous version — so commit
    # replication and catch-up cost scale with the change, not the
    # map. Full snapshots (the encoded chunk table) remain the
    # bootstrap / trimmed-log fallback.

    @staticmethod
    def _state_chunks_of(osdmap, ec_profiles, cmd_replies,
                         central_config) -> dict[str, bytes]:
        chunks = {f"map/{k}": v
                  for k, v in osdmap.to_chunks().items()}
        chunks["profiles"] = json.dumps(ec_profiles,
                                        sort_keys=True).encode()
        chunks["config"] = json.dumps(central_config,
                                      sort_keys=True).encode()
        for k, v in cmd_replies.items():
            chunks[f"reply/{k}"] = json.dumps(
                v, sort_keys=True).encode()
        return chunks

    @staticmethod
    def _state_from_chunks(chunks: dict[str, bytes]):
        osdmap = OSDMap.from_chunks(
            {k[4:]: v for k, v in chunks.items()
             if k.startswith("map/")})
        profiles = json.loads(chunks.get("profiles", b"{}"))
        config = json.loads(chunks.get("config", b"{}"))
        replies = {k[6:]: json.loads(v) for k, v in chunks.items()
                   if k.startswith("reply/")}
        return osdmap, profiles, replies, config

    @classmethod
    def _encode_state_of(cls, osdmap, ec_profiles, cmd_replies,
                         central_config) -> bytes:
        return cls._encode_chunks(cls._state_chunks_of(
            osdmap, ec_profiles, cmd_replies, central_config))

    @classmethod
    def _decode_state(cls, raw: bytes):
        return cls._state_from_chunks(cls._decode_chunks(raw))

    @staticmethod
    def _encode_chunks(chunks: dict[str, bytes]) -> bytes:
        from ceph_tpu_torch.utils.encoding import Encoder
        e = Encoder()
        e.map(chunks, Encoder.str, Encoder.bytes)
        return e.getvalue()

    @staticmethod
    def _decode_chunks(raw: bytes) -> dict[str, bytes]:
        from ceph_tpu_torch.utils.encoding import Decoder
        return Decoder(raw).map(Decoder.str, Decoder.bytes)

    @staticmethod
    def _encode_delta(changed: dict[str, bytes],
                      removed: list[str]) -> bytes:
        from ceph_tpu_torch.utils.encoding import Encoder
        e = Encoder()
        e.map(changed, Encoder.str, Encoder.bytes)
        e.list(sorted(removed), Encoder.str)
        return e.getvalue()

    @staticmethod
    def _decode_delta(raw: bytes) -> tuple[dict[str, bytes],
                                           list[str]]:
        from ceph_tpu_torch.utils.encoding import Decoder
        d = Decoder(raw)
        return d.map(Decoder.str, Decoder.bytes), d.list(Decoder.str)

    def _chunks_delta(self, new_chunks: dict[str, bytes]) -> bytes:
        """Delta from the committed chunk table to ``new_chunks``."""
        old = self._chunks
        changed = {k: v for k, v in new_chunks.items()
                   if old.get(k) != v}
        removed = [k for k in old if k not in new_chunks]
        return self._encode_delta(changed, removed)

    def _apply_delta_to(self, chunks: dict[str, bytes],
                        delta: bytes) -> dict[str, bytes]:
        changed, removed = self._decode_delta(delta)
        out = dict(chunks)
        out.update(changed)
        for k in removed:
            out.pop(k, None)
        return out

    #: per-value log length (mon_max_log_epochs role): catch-up below
    #: the floor falls back to a full snapshot
    PAXOS_KEEP = 512

    def _trim_floor(self) -> int:
        raw = self.db.get("paxos/trimmed_to")
        return int(raw.decode()) if raw else 0

    def _trim_values(self, version: int) -> None:
        """Drop values/deltas older than PAXOS_KEEP (Paxos::trim):
        the log stays bounded; deep catch-up uses a snapshot."""
        floor = self._trim_floor()
        new_floor = version - self.PAXOS_KEEP
        if new_floor <= floor:
            return
        batch = WriteBatch()
        for v in range(floor, new_floor):
            batch.delete(f"paxos/{v:016d}")
            batch.delete(f"paxos/delta/{v:016d}")
        batch.put("paxos/trimmed_to", str(new_floor).encode())
        self.db.submit(batch)

    def _send_catchup(self, peer: str, from_version: int) -> None:
        """share_state: send the missing committed values as a chain
        of per-value deltas (each tiny); a gap (trimmed / adopted
        non-contiguously) falls back to ONE full snapshot."""
        lc = self._last_committed()
        deltas = []
        for v in range(from_version + 1, lc + 1):
            d = self.db.get(f"paxos/delta/{v:016d}")
            if d is None:
                deltas = None
                break
            deltas.append((v, d))
        if deltas is None:
            self.paxos_stats["full_sent"] += 1
            self.msgr.send_message(M.MPaxosCommit(
                version=lc, state=self._encode_state(),
                rank=self.rank), peer)
            return
        for v, d in deltas:
            self.paxos_stats["delta_sent"] += 1
            self.msgr.send_message(M.MPaxosCommit(
                version=v, state=b"", rank=self.rank,
                base=v - 1, delta=d), peer)

    def _replay(self) -> None:
        last = self._last_committed()
        if last == 0:
            return
        raw = self.db.get(f"paxos/{last:016d}")
        (self.osdmap, self.ec_profiles, self._cmd_replies,
         self._central_config) = self._decode_state(raw)
        # a restarted mon can't know which osds are still alive; they
        # re-boot or get timed out by the beacon grace
        log(1, f"mon.{self.name} replayed to version {last}, "
            f"epoch {self.osdmap.epoch}")

    def _publish(self) -> None:
        msg = M.MOSDMap(epoch=self.osdmap.epoch,
                        map_bytes=self.osdmap.encode())
        cfg = M.MConfig(config=dict(self._central_config))
        for name, conn in list(self._subscribers.items()):
            if conn.closed:
                del self._subscribers[name]   # dead clients drop out
                continue
            conn.send_message(msg)
            conn.send_message(cfg)

    # -- dispatch -----------------------------------------------------
    def _dedup_put(self, key, ent: dict) -> None:
        """Bounded insert that only evicts COMPLETED entries: evicting
        a still-deferred command would let a client retry re-run the
        mutation — the exact thing the dedup exists to prevent."""
        self._cmd_dedup[key] = ent
        self._cmd_dedup.move_to_end(key)
        while len(self._cmd_dedup) > self._cmd_dedup.maxsize:
            victim = next((k for k, v in self._cmd_dedup.items()
                           if v.get("state") == "done"), None)
            if victim is None:
                break          # all pending: overflow beats re-running
            del self._cmd_dedup[victim]

    def _majority(self) -> int:
        return len(self.monmap) // 2 + 1

    def _dispatch(self, msg: M.Message, conn: Connection) -> None:
        with self._lock:
            if isinstance(msg, M.MMonHB):
                now = time.monotonic()
                self._peer_seen[msg.rank] = (now, msg.last_committed)
                if msg.addr:     # revived mons rebind to a new port
                    self.monmap[msg.rank] = msg.addr
                if msg.election_epoch > self._election_epoch():
                    # the cluster elected past us (healed partition /
                    # long sleep): adopt the newer epoch's view; a
                    # stale "leader" deposes itself here
                    self._set_election_epoch(msg.election_epoch)
                    self._election = None
                    self._deferred = None
                    new_leader = msg.leader_p1 - 1
                    if new_leader >= 0:
                        old = self._leader_rank
                        self._leader_rank = new_leader
                        if old == self.rank and \
                                new_leader != self.rank:
                            log(1, f"mon.{self.name}: deposed (saw "
                                f"election epoch {msg.election_epoch})")
                            self._fail_proposal()
                            self._leader_pn = 0
                            self._collect = None
                if msg.rank == self._leader_rank and \
                        msg.rank != self.rank and msg.lease > 0 and \
                        msg.last_committed <= self._last_committed():
                    # lease grant/extension (Paxos.cc extend_lease
                    # role): the leader is at least as advanced as us
                    # AND itself quorum-visible (lease > 0 — a deposed
                    # minority leader keeps heartbeating but grants
                    # nothing, so our lease expires). A leader ahead
                    # of us grants nothing either (we are stale; the
                    # elect pump pulls its commit first).
                    self._lease_until = now + msg.lease
                return
            if isinstance(msg, M.MMonElection):
                self._handle_election(msg, time.monotonic())
                return
            if isinstance(msg, M.MPaxosCommit):
                # the committer provably has this version: advance our
                # view of it NOW, or the window between applying its
                # commit and its next HB makes us think we're the most
                # advanced mon and flap into competing leadership
                self._peer_seen[msg.rank] = (time.monotonic(),
                                             msg.version)
                self._apply_remote_commit(msg)
                return
            if isinstance(msg, M.MPaxosCollect):
                self._handle_collect(msg)
                return
            if isinstance(msg, M.MPaxosCollectReply):
                self._handle_collect_reply(msg)
                return
            if isinstance(msg, M.MPaxosBegin):
                self._handle_begin(msg)
                return
            if isinstance(msg, M.MPaxosAccept):
                self._handle_accept(msg)
                return
            if isinstance(msg, M.MPaxosPull):
                peer = self.monmap.get(msg.rank)
                if peer and self._last_committed() > msg.from_version:
                    self._send_catchup(peer, msg.from_version)
                return
            if isinstance(msg, M.MAuth):
                self._handle_auth(msg, conn)
            elif isinstance(msg, M.MAuthRotating):
                # rotating service-key fetch (KeyServer role): reply
                # sealed with the entity's own key; an entity outside
                # the keyring (revoked) gets EACCES — its cached
                # window ages out and fences it
                if self.auth_service is None:
                    conn.send_message(M.MAuthRotatingReply(
                        tid=msg.tid, code=0, sealed=b""))
                else:
                    sealed = self.auth_service.handle_rotating(
                        msg.entity, msg.nonce)
                    if sealed is None:
                        log(1, "auth: rotating-key fetch denied for "
                            f"{msg.entity!r}")
                        conn.send_message(M.MAuthRotatingReply(
                            tid=msg.tid, code=-13, sealed=b""))
                    else:
                        conn.send_message(M.MAuthRotatingReply(
                            tid=msg.tid, code=0, sealed=sealed))
            elif isinstance(msg, M.MPGStats):
                # soft state: every mon keeps what it hears AND relays
                # to the leader (whose status answers commands)
                try:
                    stats = json.loads(msg.stats)
                except ValueError:
                    stats = []
                self._pg_stats[msg.osd_id] = (time.monotonic(), stats)
                if not self.is_leader():
                    self.msgr.send_message(msg, self.leader_addr())
            elif isinstance(msg, M.MMgrHealthReport):
                # soft state like pg stats: keep what we hear AND
                # relay to the leader (whose status answers commands)
                try:
                    report = json.loads(msg.report)
                except ValueError:
                    report = {}
                if isinstance(report, dict):
                    self._mgr_health = (time.monotonic(), report)
                if not self.is_leader():
                    self.msgr.send_message(msg, self.leader_addr())
            elif isinstance(msg, (M.MOSDBoot, M.MOSDFailure,
                                  M.MOSDAlive)) and not self.is_leader():
                # only the leader mutates cluster state; relay the
                # report to it (the reference forwards to the leader).
                # No leader yet (election in flight): DROP — relaying
                # to leader_addr's self-fallback would loop the
                # message back to us forever; daemons re-send
                if self._leader_rank >= 0:
                    self.msgr.send_message(msg, self.leader_addr())
            elif isinstance(msg, M.MOSDBoot):
                self._enqueue_mutation(
                    lambda: self._handle_boot(msg, conn))
            elif isinstance(msg, M.MOSDAlive):
                self._last_beacon[msg.osd_id] = time.monotonic()
            elif isinstance(msg, M.MOSDFailure):
                self._enqueue_mutation(
                    lambda: self._handle_failure(msg))
            elif isinstance(msg, M.MMonSubscribe):
                self._subscribers[conn.peer_name] = conn
                conn.send_message(M.MOSDMap(
                    epoch=self.osdmap.epoch,
                    map_bytes=self.osdmap.encode()))
                conn.send_message(M.MConfig(
                    config=dict(self._central_config)))
            elif isinstance(msg, M.MMonCommand):
                if msg.cmd.get("prefix", "") in _READONLY_COMMANDS:
                    # reads serve from committed state on ANY mon —
                    # but only under a valid lease (Paxos lease role):
                    # a partitioned peon or quorum-less leader answers
                    # EAGAIN instead of unboundedly stale state
                    now = time.monotonic()
                    if self._lease_valid(now):
                        code, outs, data = self._handle_command(
                            dict(msg.cmd))
                        conn.send_message(M.MMonCommandReply(
                            tid=msg.tid, code=code, outs=outs,
                            data=data))
                    else:
                        conn.send_message(M.MMonCommandReply(
                            tid=msg.tid, code=-11,
                            outs="EAGAIN read lease expired "
                                 "(no reachable quorum/leader)",
                            data=b""))
                    return
                if not self.is_leader():
                    if self._leader_rank < 0:
                        # election in flight: a NOTLEADER pointing at
                        # OURSELVES would hot-loop the client; EAGAIN
                        # makes it back off and rotate instead
                        conn.send_message(M.MMonCommandReply(
                            tid=msg.tid, code=-11,
                            outs="EAGAIN no leader "
                                 "(election in progress)",
                            data=b""))
                        return
                    # clients re-target on this redirect
                    conn.send_message(M.MMonCommandReply(
                        tid=msg.tid, code=-11,
                        outs=f"NOTLEADER {self.leader_addr()}",
                        data=b""))
                    return
                self._handle_mon_command(msg, conn)

    def _handle_mon_command(self, msg: M.MMonCommand,
                            conn: Connection) -> None:
        """Leader command path: dedup, then queue the execution as a
        mutation folded into the next proposal. The reply defers until
        the proposal commits (quorum accepted) — the Paxos contract
        that a minority leader can never ack. Caller holds the lock."""
        # (read-only commands never reach here: _dispatch serves them
        # lease-gated from committed state on any mon)
        key = f"{conn.peer_name}|{msg.tid}"
        rep = self._cmd_replies.get(key)
        if rep is not None:
            # REPLICATED dedup: the original execution committed
            # (possibly under a previous leader) — a retry attaches
            # to it instead of re-running the mutation
            conn.send_message(M.MMonCommandReply(
                tid=msg.tid, code=rep[0], outs=rep[1],
                data=bytes.fromhex(rep[2])))
            return
        ent = self._cmd_dedup.get(key)
        if ent is not None:
            if ent["state"] == "done":
                code, outs, data = ent["reply"]
                conn.send_message(M.MMonCommandReply(
                    tid=msg.tid, code=code, outs=outs, data=data))
            else:              # still awaiting its proposal: attach
                ent["conns"].append((conn, msg.tid))
            return
        ent = {"state": "pending", "reply": None,
               "conns": [(conn, msg.tid)]}
        self._dedup_put(key, ent)

        def mutate(ent=ent, key=key, cmd=dict(msg.cmd)):
            # runs on the proposal's scratch state; _dirty was reset
            # by the pump so it reflects THIS command only
            try:
                code, outs, data = self._handle_command(cmd)
            except Exception as exc:
                # anything _handle_command's own guards miss must
                # still produce a reply — a None reply would crash
                # done() and wedge the command (and its retries, via
                # the pending dedup entry) forever
                code, outs, data = -22, f"internal error: {exc!r}", b""
            ent["reply"] = (code, outs, data)
            if self._dirty:
                # fold the reply into the replicated state itself: if
                # this proposal commits anywhere, the dedup travels
                # with it (survives leader failover — the reference's
                # session dedup made durable)
                replies = self._cmd_replies
                replies[key] = [code, outs, data.hex()]
                while len(replies) > 256:
                    replies.pop(next(iter(replies)))

        def done(acked: bool, ent=ent, key=key):
            if not acked:
                ent["reply"] = (
                    -110, "proposal not accepted by a monitor "
                    "majority", b"")
            elif ent["reply"] is None:     # mutation never ran/failed
                ent["reply"] = (-22, "command execution failed", b"")
            ent["state"] = "done"
            code, outs, data = ent["reply"]
            for c, t in ent.pop("conns", []):
                c.send_message(M.MMonCommandReply(
                    tid=t, code=code, outs=outs, data=data))
            ent["conns"] = []
            if not acked:
                # nothing committed: a retry must be free to re-run
                # (caching -110 would wedge the command forever)
                if self._cmd_dedup.get(key) is ent:
                    del self._cmd_dedup[key]

        self._mut_queue.append({"fn": mutate, "done": done,
                                "ts": time.monotonic()})
        self._pump_proposals(time.monotonic())

    def _enqueue_mutation(self, fn, done=None) -> None:
        """Queue an internal (no-reply) state mutation — osd boots,
        failure reports, beacon timeouts. ``done(ok)`` fires if the
        entry expires unproposed (mutations that guard a re-arm flag
        must clear it, or the state machine wedges). Caller holds the
        lock."""
        self._mut_queue.append({"fn": fn, "done": done,
                                "ts": time.monotonic()})
        self._pump_proposals(time.monotonic())

    def _handle_auth(self, msg: M.MAuth, conn: Connection) -> None:
        """AuthMonitor role: grant a ticket. An auth-disabled mon
        answers success with an empty ticket (client stays unsigned)."""
        if self.auth_service is None:
            conn.send_message(M.MAuthReply(
                code=0, ticket=b"", sealed_session_key=b"",
                tid=msg.tid))
            return
        got = self.auth_service.handle_request(msg.entity, msg.nonce)
        if got is None:
            log(1, f"auth: denied unknown entity {msg.entity!r}")
            conn.send_message(M.MAuthReply(
                code=-13, ticket=b"", sealed_session_key=b"",
                tid=msg.tid))
            return
        ticket, sealed = got
        conn.send_message(M.MAuthReply(
            code=0, ticket=ticket, sealed_session_key=sealed,
            tid=msg.tid))

    def _handle_boot(self, msg: M.MOSDBoot, conn: Connection) -> None:
        osd = msg.osd_id
        if osd not in self.osdmap.osds:
            self.osdmap.add_osd(osd, msg.addr)
        # crush self-registration (the reference's osd crush location
        # update on boot): root -> per-osd host bucket -> device, plus
        # the default "data" rule
        cm = self.osdmap.crush
        if "default" not in cm.by_name:
            cm.add_bucket("default", "root")
        if "data" not in cm.rules:
            cm.add_rule(crush.Rule("data", root="default",
                                   failure_domain="osd", mode="indep"))
        host = f"host-{osd}"
        if host not in cm.by_name:
            cm.add_bucket(host, "host", parent="default", weight=1.0)
        if osd not in cm.device_weights:
            cm.add_device(osd, host)
        self.osdmap.mark_up(osd, msg.addr)
        self._last_beacon[osd] = time.monotonic()
        self._failure_reports.pop(osd, None)
        log(1, f"osd.{osd} booted at {msg.addr}")
        self._commit()
        self._up_epoch[osd] = self.osdmap.epoch

    def _handle_failure(self, msg: M.MOSDFailure) -> None:
        target = msg.target_osd
        info = self.osdmap.osds.get(target)
        if info is None or not info.up:
            return
        if msg.epoch < self._up_epoch.get(target, 0):
            # report predates the target's boot (heartbeat reports
            # resend every tick; in-flight ones can land after the
            # revival map) — a stale opinion of the PREVIOUS daemon
            log(10, f"ignoring stale failure report for osd.{target} "
                f"(epoch {msg.epoch} < up_epoch "
                f"{self._up_epoch.get(target, 0)})")
            return
        now = time.monotonic()
        reporters = self._failure_reports.setdefault(target, {})
        reporters[msg.reporter] = now
        # stale reports age out (mon_osd_report_timeout role) so two
        # spurious reports hours apart can't combine against a live osd
        expiry = 2 * g_conf()["osd_heartbeat_grace"]
        for rep, ts in list(reporters.items()):
            if now - ts > expiry:
                del reporters[rep]
        # the reference requires mon_osd_min_down_reporters (default 2);
        # scaled to our small clusters: 1 reporter + beacon silence, or
        # 2 fresh reporters outright
        silent = (now - self._last_beacon.get(target, 0.0)) > \
            g_conf()["osd_heartbeat_grace"]
        if len(reporters) >= 2 or silent:
            log(1, f"osd.{target} marked down "
                f"({len(reporters)} reporters, silent={silent})")
            self.osdmap.mark_down(target)
            self._failure_reports.pop(target, None)
            self._commit()

    # -- beacon timeout backstop --------------------------------------
    def _tick_loop(self) -> None:
        interval = g_conf()["osd_heartbeat_interval"]
        while not self._tick_stop.wait(interval):
            self.tick()

    def tick(self) -> None:
        grace = g_conf()["osd_heartbeat_grace"] * 2  # mon backstop
        now = time.monotonic()
        with self._lock:
            # quorum upkeep: beacon peers, re-derive the leader. Only
            # a quorum-visible leader grants read leases with its HBs.
            grant = g_conf()["mon_lease"] \
                if self.is_leader() and self._lease_valid(now) else 0.0
            for rank, addr in self.monmap.items():
                if rank != self.rank:
                    self.msgr.send_message(M.MMonHB(
                        rank=self.rank, name=self.name,
                        last_committed=self._last_committed(),
                        addr=self.addr, lease=grant,
                        election_epoch=self._election_epoch(),
                        leader_p1=self._leader_rank + 1), addr)
            if len(self.monmap) > 1:
                self._election_tick(now)
            # paxos upkeep: a proposal that cannot gather a quorum
            # (minority leader, fenced pn) times out WITHOUT touching
            # state; a stalled collect retries; queued mutations that
            # never got proposed expire
            timeout = g_conf()["mon_commit_timeout"]
            if self._proposal is not None and \
                    now - self._proposal["ts"] > timeout:
                log(1, f"mon.{self.name}: proposal "
                    f"v{self._proposal['version']} gathered "
                    f"{len(self._proposal['acks'])}/{self._majority()}"
                    f" accepts in {timeout}s; failing it")
                self._fail_proposal()
            if self._collect is not None and \
                    now - self._collect["ts"] > \
                    g_conf()["mon_election_timeout"]:
                self._collect = None     # retried by the pump
            keep = []
            for ent in self._mut_queue:
                if now - ent["ts"] > timeout:
                    if ent["done"] is not None:
                        ent["done"](False)
                else:
                    keep.append(ent)
            self._mut_queue = keep
            if not self.is_leader():
                return   # peons never mutate (beacon state flows to
                # the leader via forwarding)
            self._pump_proposals(now)

            def check_beacons():
                self._beacon_check_queued = False
                changed = False
                for osd, info in self.osdmap.osds.items():
                    if info.up and now - self._last_beacon.get(
                            osd, now) > grace:
                        log(1, f"osd.{osd} beacon timeout, "
                            "marking down")
                        self.osdmap.mark_down(osd)
                        changed = True
                if changed:
                    self._commit()

            stale = [osd for osd, info in self.osdmap.osds.items()
                     if info.up and
                     now - self._last_beacon.get(osd, now) > grace]
            if stale and not self._beacon_check_queued:
                self._beacon_check_queued = True

                def rearm(ok: bool) -> None:
                    # the queued check can expire unproposed (stalled
                    # proposal window on a minority leader); without
                    # this the flag stays set forever and beacon
                    # mark-down is permanently disabled on this mon
                    self._beacon_check_queued = False

                self._enqueue_mutation(check_beacons, done=rearm)
            # prune lapsed blocklist entries (the reference's osdmap
            # blacklist expiry): enforcement is already lazy in
            # is_blocklisted, but without this the map grows with
            # every failover/lock-break forever and 'osd blocklist
            # ls' reports long-dead fences
            wall = time.time()
            lapsed = [ent for ent, until in self.osdmap.blocklist.items()
                      if until and until <= wall]
            if lapsed and not self._blocklist_prune_queued:
                self._blocklist_prune_queued = True

                def prune_blocklist():
                    self._blocklist_prune_queued = False
                    w = time.time()
                    dead = [ent for ent, until in
                            self.osdmap.blocklist.items()
                            if until and until <= w]
                    for ent in dead:
                        del self.osdmap.blocklist[ent]
                    if dead:
                        self._commit()

                def rearm_prune(ok: bool) -> None:
                    self._blocklist_prune_queued = False

                self._enqueue_mutation(prune_blocklist,
                                       done=rearm_prune)

    # -- command handling (OSDMonitor::prepare_command role) ----------
    def _handle_command(self, cmd: dict) -> tuple[int, str, bytes]:
        prefix = cmd.get("prefix", "")
        try:
            if prefix == "osd erasure-code-profile set":
                return self._cmd_profile_set(cmd)
            if prefix == "osd erasure-code-profile ls":
                return 0, "", json.dumps(
                    sorted(self.ec_profiles)).encode()
            if prefix == "osd erasure-code-profile get":
                name = cmd["name"]
                if name not in self.ec_profiles:
                    return -2, f"profile {name!r} not found", b""
                return 0, "", json.dumps(self.ec_profiles[name]).encode()
            if prefix == "osd pool create":
                return self._cmd_pool_create(cmd)
            if prefix == "osd pool ls":
                return 0, "", json.dumps(
                    sorted(self.osdmap.pool_by_name)).encode()
            if prefix == "osd pool mksnap":
                pid = self._resolve_pool(cmd["pool"])
                pool = self.osdmap.pools[pid]
                name = cmd["snap"]
                if pool.selfmanaged:
                    # the two snapshot modes never mix in one pool
                    # (pg_pool_t is_unmanaged_snaps_mode refusal)
                    return -22, "pool is in self-managed snap " \
                        "mode", b""
                if name in pool.snaps.values():
                    return -17, f"snap {name!r} exists", b""
                pool.snap_seq += 1
                pool.snaps[pool.snap_seq] = name
                self._commit()
                return (0, f"created pool snap {name!r}",
                        json.dumps({"snapid": pool.snap_seq}).encode())
            if prefix == "osd pool selfmanaged-snap create":
                # rados_ioctx_selfmanaged_snap_create role: allocate
                # a snapid from the pool's sequence; the APP supplies
                # SnapContexts per write (CephFS realms, rbd)
                pid = self._resolve_pool(cmd["pool"])
                pool = self.osdmap.pools[pid]
                if pool.snaps:
                    return -22, "pool has pool snapshots", b""
                pool.selfmanaged = True
                pool.snap_seq += 1
                self._commit()
                return (0, "allocated selfmanaged snap",
                        json.dumps({"snapid": pool.snap_seq,
                                    "epoch": self.osdmap.epoch
                                    }).encode())
            if prefix == "osd pool selfmanaged-snap rm":
                pid = self._resolve_pool(cmd["pool"])
                pool = self.osdmap.pools[pid]
                snapid = int(cmd["snapid"])
                if not pool.selfmanaged or snapid > pool.snap_seq:
                    return -2, f"no selfmanaged snap {snapid}", b""
                if snapid not in pool.removed_snaps:
                    pool.removed_snaps.append(snapid)
                    self._commit()   # OSD trimmers react to the map
                return (0, f"removed selfmanaged snap {snapid}",
                        json.dumps({"epoch": self.osdmap.epoch
                                    }).encode())
            if prefix == "osd pool rmsnap":
                pid = self._resolve_pool(cmd["pool"])
                pool = self.osdmap.pools[pid]
                sid = next((i for i, n in pool.snaps.items()
                            if n == cmd["snap"]), None)
                if sid is None:
                    return -2, f"no snap {cmd['snap']!r}", b""
                del pool.snaps[sid]
                self._commit()   # OSD trimmers react to the new map
                return 0, f"removed pool snap {cmd['snap']!r}", b""
            if prefix == "osd tier add":
                # cache tiering plumbing (OSDMonitor "osd tier *"
                # command family, src/mon/OSDMonitor.cc)
                base = self._resolve_pool(cmd["pool"])
                tier = self._resolve_pool(cmd["tierpool"])
                tp = self.osdmap.pools[tier]
                if base == tier:
                    return -22, "pool cannot tier itself", b""
                if tp.is_ec:
                    return -22, "an EC pool cannot be a cache tier", \
                        b""
                if tp.tier_of >= 0:
                    return -17, f"{cmd['tierpool']} is already a " \
                        "tier", b""
                if self.osdmap.pools[base].tier_of >= 0:
                    return -22, "base pool is itself a tier", b""
                if not cmd.get("force_nonempty"):
                    # pre-existing objects in the tier pool would
                    # SHADOW base objects once the overlay lands (and
                    # the agent would flush them over the real base
                    # copies) — the reference mon refuses the same
                    # way without --force-nonempty
                    seen: set[str] = set()
                    objs = 0
                    for _osd, (_ts, stats) in self._pg_stats.items():
                        for s in stats:
                            if s["pgid"] in seen:
                                continue
                            seen.add(s["pgid"])
                            if s["pgid"].startswith(f"{tier}."):
                                objs += s.get("objects", 0)
                    if objs:
                        return -39, "tier pool is non-empty (pass " \
                            "force_nonempty to override)", b""
                tp.tier_of = base
                self._commit()
                return 0, f"pool {cmd['tierpool']!r} is now (or " \
                    f"already was) a tier of {cmd['pool']!r}", b""
            if prefix == "osd tier cache-mode":
                tier = self._resolve_pool(cmd["pool"])
                mode = cmd["mode"]
                if mode not in ("none", "writeback"):
                    return -22, f"unsupported cache mode {mode!r}", b""
                tp = self.osdmap.pools[tier]
                if tp.tier_of < 0:
                    return -22, f"{cmd['pool']!r} is not a tier", b""
                bp = self.osdmap.pools.get(tp.tier_of)
                if mode == "none" and bp is not None and \
                        (bp.read_tier == tier or bp.write_tier == tier):
                    # clients still redirect here; turning the OSD
                    # machinery off now would serve whiteouts as
                    # empty objects and orphan dirty data
                    return -16, "remove the overlay first", b""
                tp.cache_mode = mode
                self._commit()
                return 0, f"set cache-mode of {cmd['pool']!r} to " \
                    f"{mode}", b""
            if prefix == "osd tier set-overlay":
                base = self._resolve_pool(cmd["pool"])
                tier = self._resolve_pool(cmd["overlaypool"])
                tp = self.osdmap.pools[tier]
                if tp.tier_of != base:
                    return -22, f"{cmd['overlaypool']!r} is not a " \
                        f"tier of {cmd['pool']!r}", b""
                bp = self.osdmap.pools[base]
                bp.read_tier = bp.write_tier = tier
                self._commit()
                return 0, f"overlay for {cmd['pool']!r} is now " \
                    f"{cmd['overlaypool']!r}", b""
            if prefix == "osd tier remove-overlay":
                base = self._resolve_pool(cmd["pool"])
                bp = self.osdmap.pools[base]
                bp.read_tier = bp.write_tier = -1
                self._commit()
                return 0, f"removed overlay for {cmd['pool']!r}", b""
            if prefix == "osd tier remove":
                base = self._resolve_pool(cmd["pool"])
                tier = self._resolve_pool(cmd["tierpool"])
                tp = self.osdmap.pools[tier]
                bp = self.osdmap.pools[base]
                if tp.tier_of != base:
                    return -22, f"{cmd['tierpool']!r} is not a tier " \
                        f"of {cmd['pool']!r}", b""
                if bp.read_tier == tier or bp.write_tier == tier:
                    return -16, "remove the overlay first", b""
                tp.tier_of = -1
                tp.cache_mode = "none"
                self._commit()
                return 0, f"pool {cmd['tierpool']!r} is no longer a " \
                    f"tier of {cmd['pool']!r}", b""
            if prefix == "osd pool set":
                pid = self._resolve_pool(cmd["pool"])
                pool = self.osdmap.pools[pid]
                var, val = cmd["var"], cmd["val"]
                if var == "target_max_objects":
                    pool.target_max_objects = int(val)
                elif var == "target_max_bytes":
                    pool.target_max_bytes = int(val)
                elif var == "hit_set_period":
                    pool.hit_set_period = float(val)
                elif var == "hit_set_count":
                    pool.hit_set_count = max(1, int(val))
                elif var == "min_read_recency_for_promote":
                    pool.min_read_recency_for_promote = int(val)
                else:
                    return -22, f"unsettable pool var {var!r}", b""
                self._commit()
                return 0, f"set pool {cmd['pool']!r} {var} = {val}", \
                    b""
            if prefix == "config set":
                from ceph_tpu_torch.utils.config import SCHEMA
                name, value = cmd["name"], cmd["value"]
                try:
                    SCHEMA.get(name).coerce(value)
                except (KeyError, ValueError) as exc:
                    return -22, f"config set: {exc}", b""
                self._central_config[name] = str(value)
                self._commit()
                return 0, f"set {name} = {value}", b""
            if prefix == "config rm":
                if self._central_config.pop(cmd["name"], None) is None:
                    return -2, f"no central config {cmd['name']!r}", b""
                self._commit()
                return 0, f"removed {cmd['name']}", b""
            if prefix == "config dump":
                return 0, "", json.dumps(self._central_config,
                                         sort_keys=True).encode()
            if prefix == "osd pool lssnap":
                pid = self._resolve_pool(cmd["pool"])
                return 0, "", json.dumps(
                    {str(i): n for i, n in
                     self.osdmap.pools[pid].snaps.items()}).encode()
            if prefix == "osd tree":
                return 0, "", json.dumps(self._osd_tree()).encode()
            if prefix == "osd out":
                osd = int(cmd["id"])
                if osd not in self.osdmap.osds:
                    return -2, f"no osd.{osd}", b""
                self.osdmap.mark_out(osd)
                self._commit()
                return 0, f"marked out osd.{osd}", b""
            if prefix == "osd in":
                osd = int(cmd["id"])
                if osd not in self.osdmap.osds:
                    return -2, f"no osd.{osd}", b""
                self.osdmap.osds[osd].in_cluster = True
                self.osdmap.crush.reweight(osd, 1.0)
                self._commit()
                return 0, f"marked in osd.{osd}", b""
            if prefix == "osd blocklist":
                # the fencing primitive (OSDMonitor "osd blacklist"
                # command, src/mon/OSDMonitor.cc; map field
                # src/osd/OSDMap.h:561). addr is a client instance id
                # ("mds.a:3fb2c9d1") or a bare entity name fencing
                # every instance. The reply data carries the new map
                # epoch so the caller can wait for the fence to be
                # in force (MDSMonitor::fail_mds waits for the
                # osdmon the same way, src/mon/MDSMonitor.cc:729-741).
                op = cmd["blocklistop"]
                entity = cmd.get("addr", "")
                if op == "add":
                    if not entity:
                        return -22, "missing addr", b""
                    expire = float(cmd.get("expire", 3600.0))
                    until = time.time() + expire if expire > 0 else 0.0
                    self.osdmap.blocklist_add(entity, until)
                    self._commit()
                    return (0, f"blocklisting {entity}",
                            json.dumps(
                                {"epoch": self.osdmap.epoch}).encode())
                if op == "rm":
                    if not self.osdmap.blocklist_rm(entity):
                        return -2, f"{entity} is not blocklisted", b""
                    self._commit()
                    return (0, f"un-blocklisting {entity}",
                            json.dumps(
                                {"epoch": self.osdmap.epoch}).encode())
                return -22, f"unknown blocklistop {op!r}", b""
            if prefix == "osd blocklist ls":
                return 0, "", json.dumps(
                    self.osdmap.blocklist, sort_keys=True).encode()
            if prefix == "osd pg-upmap-items":
                return self._cmd_pg_upmap_items(cmd)
            if prefix == "osd rm-pg-upmap-items":
                pool_id = self._resolve_pool(cmd["pool"])
                ps = int(cmd["ps"])
                if self.osdmap.pg_upmap_items.pop((pool_id, ps), None) \
                        is not None:
                    self._commit()
                return 0, f"rm upmap for {pool_id}.{ps}", b""
            if prefix == "osd dump":
                return 0, "", json.dumps(self._osd_dump()).encode()
            if prefix == "status":
                return 0, "", json.dumps(self._status()).encode()
            if prefix == "health":
                return 0, self._health(), b""
            if prefix == "health detail":
                return 0, self._health(), json.dumps(
                    self._health_detail()).encode()
            return -22, f"unknown command {prefix!r}", b""
        except KeyError as exc:
            return -22, f"missing argument: {exc}", b""
        except (ValueError, TypeError) as exc:
            # bad ints, malformed JSON, wrong shapes — the client must
            # get a reply, not a timeout
            return -22, f"invalid argument: {exc}", b""

    def _cmd_profile_set(self, cmd: dict) -> tuple[int, str, bytes]:
        name = cmd["name"]
        # command maps are str->str on the wire; the profile itself
        # travels as a JSON string value
        raw = cmd.get("profile", "{}")
        parsed = json.loads(raw)
        if not isinstance(parsed, dict):
            raise ValueError(f"profile must be a JSON object, got "
                             f"{type(parsed).__name__}")
        profile = {k: str(v) for k, v in parsed.items()}
        profile.setdefault("plugin", "jerasure")
        # validate by instantiating the codec — exactly what the
        # reference's mon does before accepting a profile — on the
        # device the profile's backend names (the CPU for host
        # backends, so those pools need no card)
        try:
            ec_registry.instance().factory(
                profile["plugin"], profile,
                device=profile_device(profile))
        except Exception as exc:
            return -22, f"invalid profile: {exc}", b""
        self.ec_profiles[name] = profile
        self._commit()
        return 0, f"profile {name} set", b""

    def _resolve_pool(self, pool) -> int:
        """Accept a pool id or name (commands take either)."""
        try:
            pid = int(pool)
        except (TypeError, ValueError):
            pid = self.osdmap.pool_by_name.get(str(pool), -1)
        if pid not in self.osdmap.pools:
            raise ValueError(f"no pool {pool!r}")
        return pid

    def _cmd_pg_upmap_items(self, cmd: dict) -> tuple[int, str, bytes]:
        """``osd pg-upmap-items`` (OSDMonitor::prepare_command upmap
        role): install per-PG (from,to) up-set remaps — the mgr
        balancer's mechanism. Validates each target exists, is up+in,
        and is not already a member of the PG's up set."""
        pool_id = self._resolve_pool(cmd["pool"])
        ps = int(cmd["ps"])
        pool = self.osdmap.pools[pool_id]
        if not 0 <= ps < pool.pg_num:
            return -22, f"ps {ps} out of range for pool {pool_id}", b""
        raw_items = json.loads(cmd["items"])
        if not isinstance(raw_items, list) or not all(
                isinstance(p, (list, tuple)) and len(p) == 2
                for p in raw_items):
            return -22, f"items must be [[from,to],...]: {raw_items}", b""
        pairs = [(int(f), int(t)) for f, t in raw_items]
        # validated against the RAW CRUSH up set: the command replaces
        # the PG's whole pair list, so re-sent already-applied pairs
        # must validate too (checking the post-upmap set would reject
        # every second balancer round)
        err = self.osdmap.validate_upmap_items(pool_id, ps, pairs)
        if err is not None:
            return err[0], err[1], b""
        self.osdmap.pg_upmap_items[(pool_id, ps)] = pairs
        self._commit()
        return 0, f"upmap {pool_id}.{ps} {pairs}", b""

    def _osd_dump(self) -> dict:
        """Map details the balancer needs (``osd dump`` role)."""
        return {
            "epoch": self.osdmap.epoch,
            "pools": {str(pid): {"name": p.name, "pg_num": p.pg_num,
                                 "size": p.size, "rule": p.rule,
                                 "ec": p.is_ec}
                      for pid, p in self.osdmap.pools.items()},
            "pg_upmap_items": [
                {"pool": pid, "ps": ps,
                 "items": [list(pair) for pair in pairs]}
                for (pid, ps), pairs in
                sorted(self.osdmap.pg_upmap_items.items())],
        }

    def _cmd_pool_create(self, cmd: dict) -> tuple[int, str, bytes]:
        name = cmd["pool"]
        if name in self.osdmap.pool_by_name:
            return -17, f"pool {name!r} already exists", b""
        pg_num = int(cmd.get("pg_num", 8))
        rule = cmd.get("rule", "data")
        if rule not in self.osdmap.crush.rules:
            return -2, f"no crush rule {rule!r} (boot an osd first)", b""
        profile_name = cmd.get("erasure_code_profile", "")
        if profile_name:
            if profile_name not in self.ec_profiles:
                return -2, f"no profile {profile_name!r}", b""
            profile = self.ec_profiles[profile_name]
            codec = ec_registry.instance().factory(
                profile.get("plugin", "jerasure"), profile,
                device=profile_device(profile))
            k = codec.get_data_chunk_count()
            size = codec.get_chunk_count()
            self.osdmap.create_pool(
                name, pg_num, rule, size=size, min_size=k,
                ec_profile=dict(profile))
        else:
            size = int(cmd.get("size", 3))
            self.osdmap.create_pool(
                name, pg_num, rule, size=size,
                min_size=max(1, size - 1))
        self._commit()
        return 0, f"pool {name!r} created", b""

    def _osd_tree(self) -> dict:
        return {
            "buckets": [
                {"id": b.id, "name": b.name, "type": b.type,
                 "children": b.items}
                for b in self.osdmap.crush.buckets.values()],
            "osds": [
                {"id": o.osd_id, "up": o.up, "in": o.in_cluster,
                 "addr": o.addr}
                for o in self.osdmap.osds.values()],
        }

    def _pgmap(self) -> dict:
        """Aggregate reported PG stats (the mgr pgmap in 'ceph -s')."""
        now = time.monotonic()
        stale_after = 10 * g_conf()["osd_heartbeat_interval"]
        by_state: dict[str, int] = {}
        degraded = 0
        objects = 0
        seen: set[str] = set()
        for osd, (ts, stats) in self._pg_stats.items():
            if now - ts > stale_after:
                continue
            for s in stats:
                if s["pgid"] in seen:
                    continue
                seen.add(s["pgid"])
                by_state[s["state"]] = by_state.get(s["state"], 0) + 1
                if s["missing"]:
                    degraded += 1
                objects += s.get("objects", 0)
        return {"num_pgs": len(seen), "by_state": by_state,
                "degraded_pgs": degraded, "num_objects": objects}

    def _status(self) -> dict:
        up = sum(1 for o in self.osdmap.osds.values() if o.up)
        inc = sum(1 for o in self.osdmap.osds.values() if o.in_cluster)
        checks = self._health_checks()
        return {
            "health": self._health(checks),
            "health_checks": checks,
            "epoch": self.osdmap.epoch,
            "num_osds": len(self.osdmap.osds),
            "num_up_osds": up,
            "num_in_osds": inc,
            "pools": sorted(self.osdmap.pool_by_name),
            "pgmap": self._pgmap(),
            "quorum": {"rank": self.rank,
                       "leader": self._leader_rank,
                       "mons": len(self.monmap)},
        }

    @staticmethod
    def _worst_severity(checks: dict) -> str:
        rank = {"HEALTH_OK": 0, "HEALTH_WARN": 1, "HEALTH_ERR": 2}
        out = "HEALTH_OK"
        for c in checks.values():
            if rank.get(c.get("severity"), 0) > rank[out]:
                out = c["severity"]
        return out

    def _health_checks(self) -> dict:
        """Structured named checks (health_check_map_t role): the
        mon's own up/in + pg accounting, merged with the latest
        mgr health-engine report (mgr/health.py) when fresh. The
        mon's own accounting wins on name collisions — it is
        authoritative for map-derived state."""
        checks: dict[str, dict] = {}
        down = [o.osd_id for o in self.osdmap.osds.values()
                if not o.up]
        if down:
            up = len(self.osdmap.osds) - len(down)
            checks["OSD_DOWN"] = {
                "severity": "HEALTH_ERR" if up == 0
                else "HEALTH_WARN",
                "summary": f"{len(down)} osds down: {down}",
                "detail": [f"osd.{o} is down" for o in sorted(down)]}
        pgmap = self._pgmap()
        if pgmap["degraded_pgs"]:
            checks["PG_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{pgmap['degraded_pgs']} pgs degraded",
                "detail": []}
        notactive = sum(n for st, n in pgmap["by_state"].items()
                        if st != "active")
        if notactive:
            checks["PG_NOT_ACTIVE"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{notactive} pgs not active",
                "detail": [f"{n} pgs {st}" for st, n in
                           sorted(pgmap["by_state"].items())
                           if st != "active"]}
        rep = self._mgr_health
        if rep is not None and \
                time.monotonic() - rep[0] <= MGR_HEALTH_STALE:
            for name, chk in rep[1].get("checks", {}).items():
                if isinstance(chk, dict) and name not in checks:
                    checks[name] = chk
        return checks

    def _health_detail(self) -> dict:
        """The ``health detail`` answer: overall status + every named
        check with severity/summary/detail."""
        checks = self._health_checks()
        rep = self._mgr_health
        age = None
        if rep is not None:
            age = round(time.monotonic() - rep[0], 3)
        return {"status": self._worst_severity(checks),
                "checks": checks,
                "mgr_report_age_s": age}

    def _health(self, checks: dict | None = None) -> str:
        """The one-line answer, derived from the structured checks
        (summaries joined, worst severity as the prefix)."""
        if checks is None:
            checks = self._health_checks()
        if not checks:
            return "HEALTH_OK"
        status = self._worst_severity(checks)
        return status + ": " + "; ".join(
            c["summary"] for c in checks.values())
