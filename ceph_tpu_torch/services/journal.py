"""journal — append-only event journal on RADOS (src/journal/ role).

Reference: src/journal/ (Journaler, JournalMetadata, ObjectRecorder):
librbd journaling appends every image mutation to a journal backed by
RADOS objects before applying it; rbd-mirror tails that journal from a
per-client commit position and replays onto the peer. This lite
version keeps the object model: entries are length-prefixed records
appended to chunk objects (``<name>.<chunk>``, SPLAY entries per chunk
— the object-set rotation of the reference), per-client commit
positions are tracked, and trim removes chunks every client has fully
committed.

Single-writer by default (the image holds the exclusive lock in the
reference; our writer is the opened primary image). The journal's
CONTROL PLANE — client registry, per-client commit positions, trim
floor — lives in the in-OSD ``journal`` object class on the
``<name>.cls`` metadata object (src/cls/journal/cls_journal.cc: the
client-side Journaler drives cls_journal, the reference's layering),
so registrations/commits/floor advances from any number of clients
mutate atomically under the PG lock; the writer's header ({entries})
stays a separate object, so appends never read-modify-write reader
state.

``multi_writer=True`` (the cephfs mdslog: several mounts journal
dirops concurrently) replaces the header read-modify-write with an
ATOMIC position allocator (cls numops counter — the in-OSD method
runs under the PG lock) plus the OSD's atomic byte-append into the
chunk object; records carry their own position, so interleaved
appends within a chunk need no ordering. A writer that dies between
allocating a position and appending its record leaves a HOLE, which
readers skip (an intent that was never durably journaled has, by
definition, not executed any step yet — there is nothing to replay).
"""

from __future__ import annotations

import json

from ceph_tpu_torch.utils.encoding import Decoder, Encoder

#: entries per chunk object (object-set rotation granularity)
SPLAY = 64


class JournalError(Exception):
    pass


class JournalTrimmedError(JournalError):
    """The requested position was trimmed away — the events are gone
    for good (distinct from a transient read failure, which a reader
    must NOT treat as end-of-journal)."""


class Journaler:
    def __init__(self, ioctx, name: str,
                 multi_writer: bool = False) -> None:
        self.io = ioctx
        self.name = name
        self.multi_writer = multi_writer
        self.header_oid = f"journal.{name}"
        # per-instance caches (each client id is single-writer for its
        # own position, so commit() need not re-read the registry and
        # position objects on every call — three round trips saved per
        # image mutation)
        self._registered: set[str] = set()
        self._commit_cache: dict[str, int] = {}
        self._seq_seeded = False
        #: legacy-format probe runs at most once per instance
        self._legacy_checked = False
        from ceph_tpu_torch.analysis.lock_witness import make_lock
        self._append_lock = make_lock("journal.append")

    # -- header --------------------------------------------------------
    def _load(self) -> dict:
        try:
            return json.loads(self.io.read(self.header_oid))
        except Exception:
            raise JournalError(f"no journal {self.name!r}") from None

    def _save(self, h: dict) -> None:
        self.io.write_full(self.header_oid,
                           json.dumps(h, sort_keys=True).encode())

    @property
    def _meta_oid(self) -> str:
        """The cls_journal metadata object (client registry + commit
        positions + trim floor, all mutated by in-OSD ``journal``
        class methods — the reference's Journaler/cls_journal
        layering, src/cls/journal/cls_journal.cc)."""
        return f"{self.header_oid}.cls"

    def _cls_meta(self) -> dict:
        """{"clients": {id: pos}, "minimum": n} from cls_journal.
        First touch of a journal written by the PREVIOUS format
        (registry log + per-client position objects + trim-floor
        object) migrates that state into the cls meta object — a
        replayer must resume from its real position, not restart at 0
        below an already-trimmed floor."""
        from ceph_tpu_torch.client.rados import RadosError
        try:
            out = self.io.execute(self._meta_oid, "journal",
                                  "client_list", b"")
            meta = json.loads(out)
        except RadosError:
            meta = {"clients": {}, "minimum": 0}
        if not self._legacy_checked and not meta["clients"] and \
                not meta.get("minimum"):
            self._legacy_checked = True    # probe once per instance
            legacy = self._migrate_legacy()
            if legacy is not None:
                return legacy
        return meta

    def _migrate_legacy(self) -> dict | None:
        """One-shot import of pre-cls journal control state; returns
        the migrated view, or None when there is nothing legacy.
        ONLY a definitive -ENOENT counts as absent — a transient read
        error must surface rather than silently commit position 0 and
        delete the real one (the read_from contract)."""
        from ceph_tpu_torch.client.rados import RadosError
        legacy_reg = f"{self.header_oid}.clients"
        legacy_trim = f"{self.header_oid}.trimmed"

        def read_or_absent(fn):
            try:
                return fn()
            except RadosError as exc:
                if exc.code == -2:
                    return None
                raise

        raw = read_or_absent(
            lambda: self.io.execute(legacy_reg, "log", "list", b""))
        entries = json.loads(raw) if raw else []
        raw = read_or_absent(lambda: self.io.read(legacy_trim))
        floor = int.from_bytes(raw, "little") if raw else 0
        if not entries and not floor:
            return None
        seen, retired = [], set()
        for entry in entries:
            cid = entry.get("data", "") if isinstance(entry, dict) \
                else str(entry)
            if cid.startswith("retired/"):
                retired.add(cid[len("retired/"):])
            elif cid and cid not in seen:
                seen.append(cid)
        clients = {}
        for cid in seen:
            if cid in retired:
                continue
            raw = read_or_absent(lambda c=cid: self.io.read(
                f"{self.header_oid}.client.{c}"))
            clients[cid] = int.from_bytes(raw, "little") if raw else 0

        def register(cid):
            # a concurrent migrator may have won (and possibly
            # already retired the id): -EEXIST means its view stands
            try:
                self.io.execute(self._meta_oid, "journal",
                                "client_register",
                                json.dumps({"id": cid}).encode())
                return True
            except RadosError as exc:
                if exc.code == -17:
                    return False
                raise

        for cid, pos in clients.items():
            if register(cid) and pos:
                self.io.execute(self._meta_oid, "journal",
                                "client_commit",
                                json.dumps({"id": cid,
                                            "pos": pos}).encode())
        for cid in retired:
            if register(cid):
                self.io.execute(self._meta_oid, "journal",
                                "client_unregister",
                                json.dumps({"id": cid}).encode())
        if floor:
            self.io.execute(self._meta_oid, "journal", "set_minimum",
                            json.dumps({"pos": floor}).encode())
        # retire the legacy objects so the migration never re-runs
        for oid in [legacy_reg, legacy_trim] + \
                [f"{self.header_oid}.client.{c}" for c in seen]:
            try:
                self.io.remove(oid)
            except Exception:
                pass
        return {"clients": clients, "minimum": floor}

    def _trimmed_to(self) -> int:
        return int(self._cls_meta().get("minimum", 0))

    def trim_floor(self) -> int:
        """Lowest position still readable (positions below were
        reclaimed): the replay start for a reader with no committed
        position of its own."""
        return self._trimmed_to()

    def create(self) -> None:
        self._save({"entries": 0})

    def exists(self) -> bool:
        try:
            self._load()
            return True
        except JournalError:
            return False

    def remove(self) -> None:
        self._load()
        end = self.end_position()
        for chunk in range(self._trimmed_to() // SPLAY,
                           -(-end // SPLAY) + 1):
            try:
                self.io.remove(self._chunk_oid(chunk))
            except Exception:
                pass
        for oid in (self._meta_oid, self._seq_oid,
                    f"{self.header_oid}.clients",
                    f"{self.header_oid}.trimmed"):
            try:
                self.io.remove(oid)
            except Exception:
                pass
        self.io.remove(self.header_oid)

    def _chunk_oid(self, chunk: int) -> str:
        return f"{self.header_oid}.{chunk:08x}"

    @property
    def _seq_oid(self) -> str:
        return f"{self.header_oid}.seq"

    # -- writer --------------------------------------------------------
    def append(self, payload: bytes) -> int:
        """Append one entry; returns its position.

        Single-writer mode: the entry is durable (RADOS-committed)
        before the header advances, so a reader never sees a position
        without its entry; serialized per INSTANCE (the header advance
        is a read-modify-write; concurrent in-process writers — dirops
        run from many threads — would assign the same position and
        lose entries).

        Multi-writer mode: position from the atomic cls counter, then
        an OSD-atomic append; safe from any number of mounts."""
        if self.multi_writer:
            pos = self._alloc_pos()
            e = Encoder()
            e.u64(pos)
            e.bytes(payload)
            self.io.append(self._chunk_oid(pos // SPLAY), e.getvalue())
            return pos
        with self._append_lock:
            h = self._load()
            pos = h["entries"]
            e = Encoder()
            e.u64(pos)
            e.bytes(payload)
            self.io.append(self._chunk_oid(pos // SPLAY), e.getvalue())
            h["entries"] = pos + 1
            self._save(h)
            return pos

    def _alloc_pos(self) -> int:
        """Atomically allocate the next multi-writer position. A
        journal UPGRADED from single-writer mode has entries 0..N-1
        under the header counter and no seq object yet: the first
        allocation seeds the seq PAST the header count (value=N+1 in
        one atomic add), so new positions can never collide with
        legacy records. Two mounts racing the seed both add N+1 —
        that leaves a hole (tolerated), never a collision."""
        bump = 1
        if not self._seq_seeded:
            try:
                json.loads(self.io.read(self._seq_oid))
                self._seq_seeded = True
            except Exception:
                try:
                    bump = self._load()["entries"] + 1
                except JournalError:
                    bump = 1
        out = self.io.execute(
            self._seq_oid, "numops", "add",
            json.dumps({"key": "seq", "value": bump}).encode())
        self._seq_seeded = True
        return int(json.loads(out)["seq"]) - 1

    def end_position(self) -> int:
        if self.multi_writer:
            try:
                st = json.loads(self.io.read(self._seq_oid))
                return int(st.get("seq", 0))
            except Exception:
                # pre-upgrade journal: no seq object yet — the legacy
                # header count still bounds the replayable entries
                try:
                    return self._load()["entries"]
                except JournalError:
                    return 0
        return self._load()["entries"]

    # -- readers -------------------------------------------------------
    def read_from(self, pos: int):
        """Yield (position, payload) for every entry >= pos, in order.

        Raises JournalTrimmedError when ``pos`` is below the trim
        floor, and JournalError when a chunk below ``end`` cannot be
        read — a transient failure must surface, not silently end the
        stream (a replayer that mistook it for end-of-journal would
        advance its commit position past events it never applied)."""
        self._load()                       # journal-exists check
        end = self.end_position()
        floor = self._trimmed_to()
        if pos < floor:
            raise JournalTrimmedError(
                f"position {pos} already trimmed (floor {floor})")
        chunk = pos // SPLAY
        while chunk * SPLAY < end:
            try:
                raw = self.io.read(self._chunk_oid(chunk))
            except Exception as exc:
                if self.multi_writer and \
                        getattr(exc, "code", None) == -2:
                    # hole chunk: a writer allocated into it but died
                    # before appending — nothing journaled, nothing
                    # to replay
                    chunk += 1
                    continue
                raise JournalError(
                    f"journal chunk {chunk} unreadable: {exc}") \
                    from exc
            entries = []
            d = Decoder(raw)
            while not d.eof():
                epos = d.u64()
                payload = d.bytes()
                if pos <= epos < end:
                    entries.append((epos, payload))
            # multi-writer appends land in allocation order only
            # per-writer; replay order must be global position order
            yield from sorted(entries)
            chunk += 1

    # -- commit positions / trim ---------------------------------------
    def commit(self, client: str, pos: int) -> None:
        """Advance (monotonically) this client's commit position via
        cls_journal — the register + commit run as in-OSD methods
        under the PG lock (client_register once per client, then
        client_commit per advance; the server enforces monotonicity
        too)."""
        from ceph_tpu_torch.client.rados import RadosError
        if client not in self._registered:
            # a journal whose FIRST control-plane touch is a commit
            # must still import legacy-format state before the
            # register seeds the cls meta (or the old positions and
            # trim floor would be silently abandoned)
            if not self._legacy_checked:
                self._cls_meta()
            try:
                self.io.execute(
                    self._meta_oid, "journal", "client_register",
                    json.dumps({"id": client}).encode())
            except RadosError as exc:
                if exc.code != -17:
                    raise               # -EEXIST = retired tombstone:
                # a resurrected id must not re-pin trim — surface it
                raise JournalError(
                    f"journal client {client!r} was retired") from None
            self._registered.add(client)
        prev = self._commit_cache.get(client)
        if prev is not None and pos <= prev:
            return                      # the server would no-op too
        try:
            self.io.execute(self._meta_oid, "journal",
                            "client_commit",
                            json.dumps({"id": client,
                                        "pos": pos}).encode())
        except RadosError as exc:
            if exc.code == -2:
                # retired out from under our local register cache
                self._registered.discard(client)
                raise JournalError(
                    f"journal client {client!r} was retired") from None
            raise
        self._commit_cache[client] = max(pos, prev or 0)

    def retire(self, client: str) -> None:
        """Deregister a client for good (clean unmount / session
        eviction role): its position no longer pins trim(). The
        tombstone lives in the cls metadata, so a concurrent
        registration cannot resurrect it."""
        from ceph_tpu_torch.client.rados import RadosError
        try:
            self.io.execute(self._meta_oid, "journal",
                            "client_unregister",
                            json.dumps({"id": client}).encode())
        except RadosError:
            pass                        # unknown id: nothing pins
        self._registered.discard(client)
        self._commit_cache.pop(client, None)

    def committed(self, client: str) -> int:
        return int(self._cls_meta()["clients"].get(client, 0))

    def clients(self) -> dict[str, int]:
        return {c: int(p)
                for c, p in self._cls_meta()["clients"].items()}

    def trim(self) -> int:
        """Remove chunk objects every registered client has fully
        consumed; returns the new floor position. The floor advance is
        a cls_journal set_minimum (monotonic in-OSD). Single trimmer
        by design (the mirror daemon)."""
        meta = self._cls_meta()
        clients = meta["clients"]
        trimmed = int(meta.get("minimum", 0))
        if not clients:
            return trimmed
        floor = min(int(p) for p in clients.values())
        new_floor_chunk = floor // SPLAY
        for chunk in range(trimmed // SPLAY, new_floor_chunk):
            try:
                self.io.remove(self._chunk_oid(chunk))
            except Exception:
                pass
        new_floor = new_floor_chunk * SPLAY
        if new_floor > trimmed:
            self.io.execute(self._meta_oid, "journal", "set_minimum",
                            json.dumps({"pos": new_floor}).encode())
        return max(new_floor, trimmed)
