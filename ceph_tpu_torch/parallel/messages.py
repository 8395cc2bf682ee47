"""Typed messages — the src/messages/ role (~170 headers there; the
subset this framework's daemons speak, most importantly the EC sub-op
messages MOSDECSubOpWrite/Read and their replies,
src/messages/MOSDECSubOpWrite.h:21, carried structs at
src/osd/ECMsgTypes.h:23-89).

Each message declares FIELDS = [(name, kind), ...]; encode/decode are
generated from that schema over the versioned-section Encoder, so
every message is forward-compatible (new fields append; old readers
skip them) like the reference's versioned message encodings.
"""

from __future__ import annotations

from ceph_tpu_torch.utils.encoding import Decoder, Encoder

_ENC = {
    "u8": Encoder.u8, "u16": Encoder.u16, "u32": Encoder.u32,
    "u64": Encoder.u64, "i32": Encoder.i32, "i64": Encoder.i64,
    "f64": Encoder.f64, "bool": Encoder.bool, "str": Encoder.str,
    "bytes": Encoder.bytes,
    "str_map": Encoder.str_map,
    "bytes_map": lambda e, v: e.map(v, Encoder.str, Encoder.bytes),
    "i32_list": lambda e, v: e.list(v, Encoder.i32),
    "u64_list": lambda e, v: e.list(v, Encoder.u64),
    "str_list": lambda e, v: e.list(v, Encoder.str),
    "bytes_list": lambda e, v: e.list(v, Encoder.bytes),
}
_DEC = {
    "u8": Decoder.u8, "u16": Decoder.u16, "u32": Decoder.u32,
    "u64": Decoder.u64, "i32": Decoder.i32, "i64": Decoder.i64,
    "f64": Decoder.f64, "bool": Decoder.bool, "str": Decoder.str,
    "bytes": Decoder.bytes,
    "str_map": Decoder.str_map,
    "bytes_map": lambda d: d.map(Decoder.str, Decoder.bytes),
    "i32_list": lambda d: d.list(Decoder.i32),
    "u64_list": lambda d: d.list(Decoder.u64),
    "str_list": lambda d: d.list(Decoder.str),
    "bytes_list": lambda d: d.list(Decoder.bytes),
}

_DEFAULTS = {
    "u8": 0, "u16": 0, "u32": 0, "u64": 0, "i32": 0, "i64": 0,
    "f64": 0.0, "bool": False, "str": "", "bytes": b"",
}

_REGISTRY: dict[int, type] = {}


class Message:
    MSG_TYPE = 0
    FIELDS: list[tuple[str, str]] = []
    #: name of a ``bytes_list`` field whose payloads dominate the
    #: frame (bulk batch messages): ``encode_payload_parts`` passes
    #: them through by reference instead of re-copying into one blob
    #: (scatter-gather serialize, ROADMAP 1c)
    BULK_FIELD: str | None = None

    def __init__(self, **kw) -> None:
        self.seq = 0
        for name, kind in self.FIELDS:
            if name in kw:
                setattr(self, name, kw.pop(name))
            else:
                default = _DEFAULTS.get(kind)
                setattr(self, name,
                        default if default is not None
                        else ({} if kind.endswith("map") else []))
        if kw:
            raise TypeError(
                f"{type(self).__name__}: unknown fields {sorted(kw)}")

    def __init_subclass__(cls) -> None:
        if cls.MSG_TYPE:
            existing = _REGISTRY.get(cls.MSG_TYPE)
            if existing is not None and existing is not cls:
                raise TypeError(
                    f"MSG_TYPE {cls.MSG_TYPE} already used by "
                    f"{existing.__name__}")
            _REGISTRY[cls.MSG_TYPE] = cls

    def encode_payload(self) -> bytes:
        body = Encoder()
        for name, kind in self.FIELDS:
            _ENC[kind](body, getattr(self, name))
        e = Encoder()
        e.section(1, body)
        return e.getvalue()

    def encode_payload_parts(self) -> list[bytes]:
        """Scatter-gather serialization: the payload as a buffer
        list whose concatenation == ``encode_payload()`` byte for
        byte (pinned in tests/test_messenger.py), with the
        ``BULK_FIELD`` payloads passed through by reference — no
        re-copy of chunk data into one contiguous blob. The
        messenger writes the parts and crc-chains across them; only
        messages that declare a bulk field pay the parts machinery."""
        bulk = self.BULK_FIELD
        if not bulk:
            return [self.encode_payload()]
        body = Encoder()
        for name, kind in self.FIELDS:
            if name == bulk:
                vals = getattr(self, name)
                body.u32(len(vals))
                for v in vals:
                    body.u32(len(v))
                    body.raw(v)
            else:
                _ENC[kind](body, getattr(self, name))
        # ENCODE_START framing over the uncopied body (the byte-
        # identical twin of Encoder.section)
        hdr = Encoder()
        hdr.u8(1)
        hdr.u8(1)
        hdr.u32(body.nbytes())
        return hdr.getparts() + body.getparts()

    @classmethod
    def decode_payload(cls, buf: bytes) -> "Message":
        _, d = Decoder(buf).section(1)
        msg = cls()
        for name, kind in cls.FIELDS:
            if d.eof():
                break      # older peer: trailing fields keep defaults
            setattr(msg, name, _DEC[kind](d))
        return msg

    def __repr__(self) -> str:
        fields = ", ".join(
            f"{n}={getattr(self, n)!r}" for n, _ in self.FIELDS[:4])
        return f"{type(self).__name__}({fields})"


def decode_message(mtype: int, payload: bytes) -> Message:
    cls = _REGISTRY.get(mtype)
    if cls is None:
        raise ValueError(f"unknown message type {mtype}")
    return cls.decode_payload(payload)


# -- heartbeat (MOSDPing role, osd/OSD.cc handle_osd_ping) -------------

class MPing(Message):
    MSG_TYPE = 1
    FIELDS = [("osd_id", "i32"), ("epoch", "u32"), ("stamp", "f64")]


class MPingReply(Message):
    MSG_TYPE = 2
    FIELDS = [("osd_id", "i32"), ("epoch", "u32"), ("stamp", "f64")]


# -- mon plane ---------------------------------------------------------

class MMonCommand(Message):
    """Admin command (mon/Monitor handle_command role): e.g.
    {"prefix": "osd pool create", ...}."""
    MSG_TYPE = 10
    FIELDS = [("tid", "u64"), ("cmd", "str_map")]


class MMonCommandReply(Message):
    MSG_TYPE = 11
    FIELDS = [("tid", "u64"), ("code", "i32"), ("outs", "str"),
              ("data", "bytes")]


class MMonSubscribe(Message):
    """Subscribe to map updates (MMonSubscribe role)."""
    MSG_TYPE = 12
    FIELDS = [("what", "str"), ("start_epoch", "u32")]


class MOSDBoot(Message):
    MSG_TYPE = 13
    FIELDS = [("osd_id", "i32"), ("addr", "str")]


class MOSDFailure(Message):
    """Failure report, osd -> mon (MOSDFailure role)."""
    MSG_TYPE = 14
    FIELDS = [("target_osd", "i32"), ("reporter", "i32"),
              ("epoch", "u32"), ("failed_for", "f64")]


class MOSDMap(Message):
    """Full map push (the reference sends incrementals + fulls; we send
    fulls — maps here are small)."""
    MSG_TYPE = 15
    FIELDS = [("epoch", "u32"), ("map_bytes", "bytes")]


class MOSDAlive(Message):
    MSG_TYPE = 16
    FIELDS = [("osd_id", "i32"), ("epoch", "u32")]


# -- client I/O (MOSDOp/MOSDOpReply role) ------------------------------

OSD_OP_WRITE_FULL = 1
OSD_OP_READ = 2
OSD_OP_REMOVE = 3
OSD_OP_STAT = 4
OSD_OP_WRITE = 5       # offset write (EC: RMW over the full object)
OSD_OP_APPEND = 6
OSD_OP_LIST = 7        # list objects of one PG (PGLS role)
OSD_OP_CALL = 8        # in-OSD object class method (CEPH_OSD_OP_CALL)
# client-visible xattr/omap surface (the do_osd_ops op families of
# src/osd/PrimaryLogPG.cc:5664 — CEPH_OSD_OP_{GETXATTR,SETXATTR,
# RMXATTR,GETXATTRS,CMPXATTR,OMAPGETVALS,OMAPSETVALS,OMAPRMKEYS,
# OMAPGETKEYS,CREATE}):
OSD_OP_GETXATTR = 9    # xname -> value in reply data
OSD_OP_SETXATTR = 10   # xname, value in data
OSD_OP_RMXATTR = 11    # xname
OSD_OP_GETXATTRS = 12  # reply data = json {name: value_hex}
OSD_OP_CMPXATTR = 13   # xname, xop, operand in data; -ECANCELED on miss
OSD_OP_OMAPGET = 14    # data = json [keys] ([] = all) -> {k: v_hex}
OSD_OP_OMAPSET = 15    # data = json {k: v_hex}
OSD_OP_OMAPRMKEYS = 16  # data = json [keys]
OSD_OP_OMAPGETKEYS = 17  # reply data = json [keys]
OSD_OP_CREATE = 18     # xop=1: exclusive (-EEXIST if present)
OSD_OP_TRUNCATE = 19   # offset = new size (grow fills zeros)
OSD_OP_ZERO = 20       # zero [offset, offset+length)
# round-4 widening toward do_osd_ops (PrimaryLogPG.cc:5664):
OSD_OP_ROLLBACK = 21       # snapid: restore head from covering clone
OSD_OP_SPARSE_READ = 22    # reply json {extents: [[off,len]..], data}
OSD_OP_WRITESAME = 23      # tile data over [offset, offset+length)
OSD_OP_OMAPGETHEADER = 24  # reply = header bytes ("" when unset)
OSD_OP_OMAPSETHEADER = 25  # data = new header bytes
OSD_OP_LIST_SNAPS = 26     # reply json snapset (seq/clones/head)
OSD_OP_OMAPCMP = 27        # xname=omap key, xop, operand in data

#: gflags bit: the gname/gop/gval guard compares an OMAP value
#: instead of an xattr (CEPH_OSD_OP_OMAP_CMP as a guard)
GUARD_OMAP = 1

# cmpxattr / guard comparison modes (CEPH_OSD_CMPXATTR_OP_*,
# src/include/rados.h): EQ..LTE compare the stored value against the
# operand — bytes for EQ/NE, u64 (decimal operand) for the orderings
CMPXATTR_EQ = 1
CMPXATTR_NE = 2
CMPXATTR_GT = 3
CMPXATTR_GTE = 4
CMPXATTR_LT = 5
CMPXATTR_LTE = 6


class MOSDOp(Message):
    """``trace`` carries the dataflow-trace context (Message.h:264
    ZTracer role); empty when tracing is off."""
    MSG_TYPE = 20
    FIELDS = [("tid", "u64"), ("client", "str"), ("epoch", "u32"),
              ("pool", "i32"), ("ps", "u32"), ("oid", "str"),
              ("op", "u8"), ("offset", "u64"), ("length", "u64"),
              ("data", "bytes"), ("trace", "str"),
              ("cls", "str"), ("method", "str"),
              # snapshot context (appended; old readers skip):
              # writes carry the pool snapc (seq + existing snap ids,
              # newest first — PrimaryLogPG make_writeable inputs);
              # reads carry the wanted snapid (0 = head)
              ("snap_seq", "u64"), ("snaps", "u64_list"),
              ("snapid", "u64"),
              # xattr/omap surface (appended): xname/xop parameterize
              # the op itself; gname/gop/gval are an OPTIONAL xattr
              # guard evaluated atomically (under pg.lock) before ANY
              # op executes — the single-guard reduction of the
              # reference's multi-op transaction vectors, where a
              # failed CMPXATTR aborts the ops after it
              ("xname", "str"), ("xop", "u8"),
              ("gname", "str"), ("gop", "u8"), ("gval", "bytes"),
              # appended round 4 (old readers skip): guard flags
              # (GUARD_OMAP selects the omap namespace for the guard)
              ("gflags", "u8"),
              # appended round 11: the op's StageClock marks so far
              # (utils/stage_clock wire form, "" = untimed) — the
              # per-op data-plane timeline the OSD continues
              ("stages", "str"),
              # appended round 24: the tenant/flow label the client
              # stamped (utils/flow_telemetry; "" = unattributed) —
              # every daemon attributes its owned costs to it
              ("flow", "str")]


class MOSDOpReply(Message):
    MSG_TYPE = 21
    FIELDS = [("tid", "u64"), ("code", "i32"), ("epoch", "u32"),
              ("data", "bytes"), ("version", "u64"),
              # appended round 11: the merged stage timeline (client
              # marks + primary marks + shard children) coming home
              ("stages", "str")]


class MOSDOpBatch(Message):
    """Client -> primary: every in-flight plain write the streaming
    objecter coalesced for ONE (pool, PG), in one frame (ROADMAP 1b:
    one client saturates a primary the way peers saturate each other
    since the bulk-ingest fan-out). Entries are parallel lists —
    entry i is the write (tids[i], oids[i], ops[i], offsets[i],
    lengths[i], datas[i], traces[i], stages[i]); ``stages`` stays
    per-entry because each op owns its client-side timeline (unlike
    MECSubWriteBatch, whose entries are born on one shared clock).
    Restricted by the sender to plain data writes and (round 19)
    plain head reads — guarded, snap-context and cls ops ride
    singleton MOSDOps. Read frames target the placement-affine acting
    member instead of the primary (same-slot reads coalesce; ROADMAP
    3). Each entry is individually resendable as a singleton (the
    OSD's (client, tid) dup-op cache dedups mutations; reads are
    idempotent), so the reliability machinery is unchanged."""
    MSG_TYPE = 69
    FIELDS = [("tid", "u64"), ("client", "str"), ("epoch", "u32"),
              ("pool", "i32"), ("ps", "u32"),
              ("tids", "u64_list"), ("oids", "str_list"),
              ("ops", "i32_list"), ("offsets", "u64_list"),
              ("lengths", "u64_list"), ("datas", "bytes_list"),
              ("traces", "str_list"), ("stages", "str_list"),
              # appended round 24: PER-ENTRY flow labels — a batched
              # frame coalesces many tenants' writes, and attribution
              # must never be lost to batching (ISSUE 20)
              ("flows", "str_list")]

    #: scatter-gather framing (ROADMAP 1c): ship ``datas`` payloads
    #: as their own frame parts instead of re-copying into one blob
    BULK_FIELD = "datas"


class MOSDOpReplyBatch(Message):
    """One ack for every op an MOSDOpBatch carried: entry i answers
    tids[i] with codes[i]/versions[i]/datas[i] and its merged stage
    timeline — exactly a singleton MOSDOpReply per entry, in one
    frame with one client-side wakeup sweep."""
    MSG_TYPE = 70
    FIELDS = [("tid", "u64"), ("tids", "u64_list"),
              ("codes", "i32_list"), ("epochs", "u64_list"),
              ("versions", "u64_list"), ("datas", "bytes_list"),
              ("stages", "str_list")]


class MPGStats(Message):
    """OSD -> mon: periodic per-PG stat report (the MgrClient report
    protocol's role, mgr collapsed into the mon). ``stats`` is a json
    list of {pgid, state, missing, objects}."""
    MSG_TYPE = 43
    FIELDS = [("osd_id", "i32"), ("epoch", "u32"), ("stats", "bytes")]


# -- mon quorum (Paxos/Elector role, src/mon/Paxos.{h,cc}) -------------

class MMonHB(Message):
    """Mon <-> mon liveness + progress beacon (Elector probe role):
    each mon advertises its rank and how far its commit log got;
    every mon independently derives the leader as the most-advanced,
    lowest-ranked live peer."""
    MSG_TYPE = 40
    FIELDS = [("rank", "i32"), ("name", "str"),
              ("last_committed", "u64"), ("addr", "str"),
              # lease grant seconds (appended; 0 = no grant): only a
              # leader that itself sees a quorum hands these out — a
              # deposed-but-unaware minority leader must not keep its
              # peons' read leases alive (Paxos.cc extend_lease role)
              ("lease", "f64"),
              # appended (Elector epochs): the sender's election
              # epoch and who it believes leads (rank+1; 0 =
              # unknown) — a healed split-brain leader at an OLDER
              # epoch learns it was deposed from the first HB
              ("election_epoch", "u32"), ("leader_p1", "i32")]


class MPaxosCommit(Message):
    """Leader -> peons on every commit: the full committed state at
    ``version`` (our states are small full snapshots, so replication
    and catch-up are the same message — the Paxos commit phase with
    the reference's incremental machinery collapsed). ``rank`` lets a
    peon adopt the CURRENT leader's state even at an equal version
    (split-brain heal)."""
    MSG_TYPE = 41
    FIELDS = [("version", "u64"), ("state", "bytes"), ("rank", "i32"),
              # appended (share_state role): when ``delta`` is
              # non-empty the message carries only the chunks that
              # CHANGED since ``base`` — a peon at base applies the
              # delta; anyone else falls back to ``state`` or a pull
              ("base", "u64"), ("delta", "bytes"),
              # pn of the proposal being committed (0 = catch-up
              # chain): a peon may commit its PENDING value only when
              # both version AND pn match — a deposed leader's own
              # pending at the same version must never slip in
              ("pn", "u64")]


class MPaxosPull(Message):
    """A lagging mon asks a more advanced peer for its latest commit."""
    MSG_TYPE = 42
    FIELDS = [("rank", "i32"), ("from_version", "u64")]


class MConfig(Message):
    """Mon -> subscribed daemons: the full centralized config map
    (src/mon/ConfigMonitor.cc MConfig role). Daemons REPLACE their
    'mon' config source layer with it — removals propagate as absent
    keys."""
    MSG_TYPE = 49
    FIELDS = [("config", "str_map")]


class MPaxosCollect(Message):
    """New leader -> peers: phase-1 prepare (Paxos::collect,
    src/mon/Paxos.cc). ``pn`` is the proposal number the leader will
    lead with; peers that promise it reveal their commit progress and
    any durably ACCEPTED-but-uncommitted value so the leader can
    complete its predecessor's in-flight proposal."""
    MSG_TYPE = 45
    FIELDS = [("pn", "u64"), ("rank", "i32"), ("last_committed", "u64")]


class MPaxosCollectReply(Message):
    """Peer -> collecting leader (Paxos::handle_collect). ``ok`` = the
    peer promised ``pn`` (it had no higher accepted_pn). ``state``
    carries the peer's latest committed snapshot when it is ahead of
    the collector (leader catch-up); ``pending_*`` carry the peer's
    uncommitted accepted value, if any."""
    MSG_TYPE = 46
    FIELDS = [("ok", "bool"), ("pn", "u64"), ("accepted_pn", "u64"),
              ("rank", "i32"), ("last_committed", "u64"),
              ("state", "bytes"), ("pending_pn", "u64"),
              ("pending_version", "u64"), ("pending_state", "bytes")]


class MPaxosBegin(Message):
    """Leader -> peers: phase-2 accept request (Paxos::begin). The
    value (a full-state snapshot at ``version``) must be persisted as
    PENDING before the peer acks — that durability is what lets a new
    leader's collect recover it."""
    MSG_TYPE = 47
    FIELDS = [("pn", "u64"), ("version", "u64"), ("state", "bytes"),
              ("rank", "i32"),
              # appended (share_state role): delta vs ``base``; a
              # peon at base reconstructs the full value locally
              ("base", "u64"), ("delta", "bytes")]


class MPaxosAccept(Message):
    """Peer -> leader: phase-2 accept ack (Paxos::handle_accept), or a
    refusal (``ok``=False) when the peer promised a HIGHER pn — the
    fence that stops a deposed/minority leader from committing."""
    MSG_TYPE = 48
    FIELDS = [("ok", "bool"), ("pn", "u64"), ("version", "u64"),
              ("rank", "i32"), ("accepted_pn", "u64")]


# -- auth (MAuth / cephx ticket grant, src/auth role) ------------------

class MAuth(Message):
    """Client -> mon: request a ticket. ``nonce`` (hex) seals the
    session key in the reply so only the secret holder can use it."""
    MSG_TYPE = 38
    FIELDS = [("entity", "str"), ("nonce", "str"), ("tid", "u64")]


class MAuthReply(Message):
    MSG_TYPE = 39
    FIELDS = [("code", "i32"), ("ticket", "bytes"),
              ("sealed_session_key", "bytes"), ("tid", "u64")]


# -- EC sub-ops (ECMsgTypes.h ECSubWrite/ECSubRead + replies) ----------

class MECSubWrite(Message):
    """Primary -> shard: apply this shard-local transaction for (pgid,
    version). Carries a store Transaction (ECSubWrite carries shard
    ObjectStore txns + log entries, ECMsgTypes.h:23-89)."""
    MSG_TYPE = 30
    FIELDS = [("tid", "u64"), ("pool", "i32"), ("ps", "u32"),
              ("shard", "u8"), ("epoch", "u32"), ("oid", "str"),
              ("version", "u64"), ("txn_bytes", "bytes"),
              ("trace", "str"),
              # appended round 11: the sub-op's child StageClock
              # (anchor = handed to the messenger on the primary)
              ("stages", "str"),
              # appended round 24: the client op's flow label, so the
              # shard attributes its store txn + fsync share too
              ("flow", "str")]


class MECSubWriteReply(Message):
    MSG_TYPE = 31
    FIELDS = [("tid", "u64"), ("pool", "i32"), ("ps", "u32"),
              ("shard", "u8"), ("committed", "bool"), ("version", "u64"),
              # appended round 11: the shard's completed sub-op
              # timeline, merged into the primary op's children
              ("stages", "str")]


class MECSubWriteBatch(Message):
    """Primary -> one shard OSD: EVERY sub-write of one engine flush
    destined for that peer, in one frame (the bulk-ingest data plane,
    ROADMAP item 1). Entries are parallel lists — entry i is the
    sub-write (tids[i], pools[i], pss[i], shards[i], oids[i],
    versions[i], txns[i], traces[i]). One serialize, one dispatch
    per (peer, flush) instead of one MECSubWrite per (op, shard); the
    receiver applies each contained PG's txns as ONE queued txn group
    and acks every tid in one MECSubWriteBatchReply. ``stages`` is the
    batch's shared wire timeline (every entry rode the same frame, so
    send/wire/dispatch marks are genuinely shared; the receiver forks
    a child clock per entry)."""
    MSG_TYPE = 67
    FIELDS = [("tid", "u64"), ("epoch", "u32"),
              ("tids", "u64_list"), ("pools", "i32_list"),
              ("pss", "u64_list"), ("shards", "u64_list"),
              ("oids", "str_list"), ("versions", "u64_list"),
              ("txns", "bytes_list"), ("traces", "str_list"),
              ("stages", "str"),
              # appended round 24: PER-ENTRY flow labels — one flush
              # batches many tenants' sub-writes; the receiving shard
              # attributes each entry's txn bytes to its own flow
              ("flows", "str_list")]

    #: scatter-gather framing (ROADMAP 1c): the shard txns ship as
    #: their own frame parts — no re-copy into one contiguous payload
    BULK_FIELD = "txns"


class MECSubWriteBatchReply(Message):
    """One ack for every sub-write the batch carried: entry i commits
    (tids[i], shards[i]) at versions[i]; ``stages[i]`` is that
    entry's completed child timeline (merged under the client op by
    the primary, exactly like a singleton MECSubWriteReply)."""
    MSG_TYPE = 68
    FIELDS = [("tid", "u64"), ("committed", "bool"),
              ("tids", "u64_list"), ("pools", "i32_list"),
              ("pss", "u64_list"), ("shards", "u64_list"),
              ("versions", "u64_list"), ("stages", "str_list")]


class MECSubRead(Message):
    """Primary -> shard: read shard chunk(s) (ECSubRead: offsets +
    subchunk lists; attrs on request). ``offsets``/``lengths`` carry a
    fragmented multi-range read (clay sub-chunk repair,
    ECBackend.cc:978-1002); the reply concatenates the fragments.
    ``raw`` skips the serving OSD's hinfo crc gate: deep scrub wants
    the raw observation (it hashes on the device itself), not a
    pre-judged -EIO."""
    MSG_TYPE = 32
    FIELDS = [("tid", "u64"), ("pool", "i32"), ("ps", "u32"),
              ("shard", "u8"), ("oid", "str"), ("offset", "u64"),
              ("length", "u64"), ("want_attrs", "bool"),
              ("csum_only", "bool"), ("offsets", "u64_list"),
              ("lengths", "u64_list"), ("raw", "bool")]


class MECSubReadReply(Message):
    """``version`` is the shard's object version ("v" attr): the
    primary only combines chunks that agree on it (a shard whose write
    has not committed yet answers with the old version and the read
    retries — the pipeline-ordering seat of ECBackend check_ops)."""
    MSG_TYPE = 33
    FIELDS = [("tid", "u64"), ("pool", "i32"), ("ps", "u32"),
              ("shard", "u8"), ("oid", "str"), ("code", "i32"),
              ("data", "bytes"), ("attrs", "bytes_map"),
              ("version", "u64"), ("crc", "u32"),
              # object omap for replicated-pool pulls (appended;
              # served only on want_attrs full-object reads)
              ("omap", "bytes_map")]


# -- recovery (MOSDPGPush role) ----------------------------------------

class MPGPush(Message):
    """Primary -> shard during recovery: reconstructed chunk + attrs,
    or a delete (``remove``) when the shard missed a removal. The
    shard's pgmeta/log is NOT touched by a push; the primary ships a
    separate log-sync txn once every push of the batch is acked (so a
    lost push can never leave a shard that *looks* caught up)."""
    MSG_TYPE = 34
    FIELDS = [("pool", "i32"), ("ps", "u32"), ("shard", "u8"),
              ("oid", "str"), ("version", "u64"), ("data", "bytes"),
              ("attrs", "bytes_map"), ("remove", "bool"),
              ("tid", "u64"),
              # client omap rides replicated-pool pushes (appended;
              # EC pools reject omap, matching the reference)
              ("omap", "bytes_map")]


class MPGPushReply(Message):
    MSG_TYPE = 35
    FIELDS = [("pool", "i32"), ("ps", "u32"), ("shard", "u8"),
              ("oid", "str"), ("committed", "bool"), ("tid", "u64")]


# -- peering-lite (MOSDPGQuery/MOSDPGNotify role) ----------------------

class MPGQuery(Message):
    """Primary asks a shard holder what it has for a PG."""
    MSG_TYPE = 36
    FIELDS = [("pool", "i32"), ("ps", "u32"), ("shard", "u8"),
              ("epoch", "u32"), ("tid", "u64")]


class MPGNotify(Message):
    """Shard's answer: objects it holds and their versions, how far
    its pgmeta log got (``last_version``), and its log entries
    (``log_*`` parallel lists). The primary MERGES every survivor's
    log and judges each object by the latest merged entry — deletes
    need explicit REMOVE evidence; a bare listing difference never
    deletes (the log-vs-backfill discipline of the reference's
    peering, doc/dev/osd_internals/pg.rst)."""
    MSG_TYPE = 37
    FIELDS = [("pool", "i32"), ("ps", "u32"), ("shard", "u8"),
              ("epoch", "u32"), ("objects", "str_list"),
              ("versions", "u64_list"), ("last_version", "u64"),
              ("tid", "u64"), ("log_versions", "u64_list"),
              ("log_ops", "i32_list"), ("log_oids", "str_list")]


# -- watch/notify (librados rados_watch/rados_notify roles) ------------

class MWatch(Message):
    """Client -> primary OSD: (un)register a watch on an object
    (Objecter::linger_register / CEPH_OSD_OP_WATCH role). The OSD
    keeps the watcher on the RECEIVING connection; a peering change
    drops it and the client re-watches on the map epoch bump (the
    documented lite of the reference's persisted watch state)."""
    MSG_TYPE = 50
    FIELDS = [("tid", "u64"), ("pool", "i32"), ("ps", "u32"),
              ("oid", "str"), ("cookie", "u64"), ("watch", "bool"),
              # client INSTANCE id ("name:nonce") — what the osdmap
              # blocklist fences; admission checks it (r5) — and the
              # client's map epoch so a stale-map OSD parks the
              # registration instead of missing a fresh fence
              ("client", "str"), ("epoch", "u32"),
              # appended round 19 (old readers skip): an INVAL watch —
              # the client caches this object and wants mutating ops'
              # replies held until it acknowledged the invalidation
              # notify (the librados cache tier's coherence channel)
              ("inval", "bool")]


class MWatchAck(Message):
    MSG_TYPE = 51
    FIELDS = [("tid", "u64"), ("code", "i32")]


class MNotify(Message):
    """Client -> primary OSD: deliver ``payload`` to every watcher of
    ``oid`` and reply once all acked (or timeout_ms passed)."""
    MSG_TYPE = 52
    FIELDS = [("tid", "u64"), ("pool", "i32"), ("ps", "u32"),
              ("oid", "str"), ("payload", "bytes"),
              ("timeout_ms", "u32")]


class MNotifyComplete(Message):
    """OSD -> notifier: watchers that acked / that timed out."""
    MSG_TYPE = 53
    FIELDS = [("tid", "u64"), ("code", "i32"), ("acked", "u32"),
              ("missed", "u32")]


class MWatchNotify(Message):
    """OSD -> watcher: a notify fired on an object you watch; reply
    with MWatchNotifyAck (rados_notify_ack role)."""
    MSG_TYPE = 54
    FIELDS = [("notify_id", "u64"), ("pool", "i32"), ("oid", "str"),
              ("cookie", "u64"), ("payload", "bytes")]


class MWatchNotifyAck(Message):
    MSG_TYPE = 55
    FIELDS = [("notify_id", "u64"), ("cookie", "u64")]


# -- MDS protocol (src/messages/MClientRequest.h, MClientReply.h,
#    MClientCaps.h roles) ------------------------------------------------

class MMDSOp(Message):
    """Client -> MDS: one metadata request. ``op`` selects the handler
    (mkdir/create/rename/cap_acquire/...), ``args`` is a json blob —
    the MClientRequest role with the reference's ~40 typed request
    structs collapsed onto one json surface. ``client`` + ``tid``
    identify the request for the MDS's completed-request dedup
    (src/mds/SessionMap.h trim_completed_requests role)."""
    MSG_TYPE = 60
    FIELDS = [("tid", "u64"), ("client", "str"), ("op", "str"),
              ("args", "bytes")]


class MMDSOpReply(Message):
    """MDS -> client (MClientReply role): negative errno in ``code``,
    json result in ``data``."""
    MSG_TYPE = 61
    FIELDS = [("tid", "u64"), ("code", "i32"), ("data", "bytes")]


class MMDSCapRevoke(Message):
    """MDS -> client (MClientCaps CAP_OP_REVOKE role): give back your
    cap on ``ino`` (flush dirty state first); ``keep`` is the strongest
    cap type the client may retain ("" = none, "shared")."""
    MSG_TYPE = 62
    FIELDS = [("ino", "u64"), ("keep", "str"), ("epoch", "u32")]


class MAuthRotating(Message):
    """Daemon -> mon: fetch the rotating service-key window
    (CephxKeyServer get_rotating_secrets role). Reply is sealed with
    the entity's own key, so only a keyring member can read it."""
    MSG_TYPE = 63
    FIELDS = [("entity", "str"), ("nonce", "str"), ("tid", "u64")]


class MAuthRotatingReply(Message):
    MSG_TYPE = 64
    FIELDS = [("tid", "u64"), ("code", "i32"), ("sealed", "bytes")]


class MMonElection(Message):
    """Mon election rounds (src/mon/Elector.cc): op 1 = PROPOSE (a
    candidate stands, advertising its commit progress), 2 = DEFER
    (acknowledge a better candidate), 3 = VICTORY (the winner
    announces the quorum; its epoch is the new even election epoch).
    Candidates order by (last_committed, -rank): most-advanced first,
    lowest rank breaking ties — a stale rejoiner can never win."""
    MSG_TYPE = 65
    FIELDS = [("op", "u8"), ("epoch", "u32"), ("rank", "i32"),
              ("last_committed", "u64"), ("quorum", "i32_list")]


ELECTION_PROPOSE = 1
ELECTION_DEFER = 2
ELECTION_VICTORY = 3


class MMgrHealthReport(Message):
    """Mgr -> mon: the health engine's structured check report (the
    MMonMgrReport health_checks payload role). ``report`` is the
    JSON-encoded {"status", "checks": {name: {severity, summary,
    detail}}} map; soft state on the mon, merged into ``status`` /
    ``health detail`` answers."""
    MSG_TYPE = 66
    FIELDS = [("entity", "str"), ("report", "bytes")]
