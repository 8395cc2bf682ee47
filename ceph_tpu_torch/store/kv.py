"""KeyValueDB — the src/kv/ role (KeyValueDB.h over RocksDB).

Minimal ordered string->bytes store with atomic write batches, prefix
iteration, and durability via a crc-protected write-ahead log plus
snapshot compaction. ``MemDB`` is the test twin (src/kv/MemDB),
``FileDB`` the durable one (RocksDBStore role; same WAL-then-apply
commit discipline, no LSM tree — our metadata volumes don't need one).

Used by BlockStore for object metadata and by the monitor's store
(MonitorDBStore role).
"""

from __future__ import annotations

import os
import struct
import time

from ceph_tpu_torch.utils import checksum, store_telemetry
from ceph_tpu_torch.utils.encoding import DecodeError, Decoder, Encoder


class WriteBatch:
    """Atomic mutation batch (KeyValueDB::Transaction role)."""

    def __init__(self) -> None:
        self.ops: list[tuple[int, str, bytes]] = []  # (1=put|0=del, k, v)

    def put(self, key: str, value: bytes) -> "WriteBatch":
        self.ops.append((1, key, bytes(value))); return self

    def delete(self, key: str) -> "WriteBatch":
        self.ops.append((0, key, b"")); return self

    def encode(self) -> bytes:
        e = Encoder()
        e.list(self.ops, lambda en, op: (
            en.u8(op[0]), en.str(op[1]), en.bytes(op[2])))
        return e.getvalue()

    @classmethod
    def decode(cls, buf: bytes) -> "WriteBatch":
        b = cls()
        d = Decoder(buf)
        b.ops = [(op[0], op[1], op[2]) for op in d.list(
            lambda dd: (dd.u8(), dd.str(), dd.bytes()))]
        return b


class KeyValueDB:
    def submit(self, batch: WriteBatch, sync: bool = True) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        """Deferred-barrier seam (group commit, ROADMAP 1a): make
        every ``submit(sync=False)`` so far durable with ONE barrier.
        No-op for stores with no durability (MemDB)."""

    def get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def iterate(self, prefix: str = ""):
        """Yield (key, value) sorted by key for keys with prefix."""
        raise NotImplementedError

    def close(self) -> None: ...


class MemDB(KeyValueDB):
    def __init__(self) -> None:
        self._data: dict[str, bytes] = {}

    def submit(self, batch: WriteBatch, sync: bool = True) -> None:
        for op, k, v in batch.ops:
            if op:
                self._data[k] = v
            else:
                self._data.pop(k, None)

    def get(self, key: str) -> bytes | None:
        return self._data.get(key)

    def iterate(self, prefix: str = ""):
        for k in sorted(self._data):
            if k.startswith(prefix):
                yield k, self._data[k]


class FileDB(KeyValueDB):
    """Snapshot + WAL. Commit = append crc-framed batch record to the
    WAL and (optionally) fsync; mount = load snapshot, replay WAL;
    compact = rewrite snapshot, truncate WAL."""

    _REC_HDR = struct.Struct("<II")    # length, crc32c(payload)

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._data: dict[str, bytes] = {}
        self._snap = os.path.join(path, "snapshot")
        self._walp = os.path.join(path, "wal")
        valid_end = self._load()
        # a torn tail record must not remain ahead of future appends —
        # anything written after it would be unreachable on the next
        # replay (replay stops at the first bad record)
        if os.path.exists(self._walp) and \
                os.path.getsize(self._walp) > valid_end:
            with open(self._walp, "r+b") as f:
                f.truncate(valid_end)
        self._wal = open(self._walp, "ab")
        self._wal_records = 0
        self._unsynced = 0     # bytes appended since the last barrier

    # -- recovery -----------------------------------------------------
    def _load(self) -> int:
        """Load snapshot + replay WAL; returns the WAL offset after the
        last valid record (the truncation point for torn tails)."""
        if os.path.exists(self._snap):
            with open(self._snap, "rb") as f:
                raw = f.read()
            d = Decoder(raw)
            self._data = d.map(Decoder.str, Decoder.bytes)
        off = 0
        if os.path.exists(self._walp):
            with open(self._walp, "rb") as f:
                raw = f.read()
            while off + self._REC_HDR.size <= len(raw):
                ln, crc = self._REC_HDR.unpack_from(raw, off)
                payload = raw[off + self._REC_HDR.size:
                              off + self._REC_HDR.size + ln]
                if len(payload) < ln or checksum.crc32c(payload) != crc:
                    break  # torn tail record: stop replay (normal crash)
                try:
                    batch = WriteBatch.decode(payload)
                except DecodeError:
                    break
                self._apply(batch)
                off += self._REC_HDR.size + ln
        return off

    def _apply(self, batch: WriteBatch) -> None:
        for op, k, v in batch.ops:
            if op:
                self._data[k] = v
            else:
                self._data.pop(k, None)

    # -- commits ------------------------------------------------------
    def submit(self, batch: WriteBatch, sync: bool = True) -> None:
        # commit-path decomposition (ISSUE 14): the record build +
        # write + flush is the wal_append sub-stage, the fsync its
        # own — both attributed to the enclosing store txn when one
        # is active (store_telemetry.current_timer)
        t0 = time.perf_counter()
        payload = batch.encode()
        rec = self._REC_HDR.pack(len(payload),
                                 checksum.crc32c(payload)) + payload
        self._wal.write(rec)
        self._wal.flush()
        store_telemetry.note_wal_append(time.perf_counter() - t0,
                                        nbytes=len(rec))
        if sync:
            store_telemetry.timed_fsync(self._wal.fileno(),
                                        site="kv.wal",
                                        nbytes=len(rec))
        else:
            self._unsynced += len(rec)
        self._apply(batch)
        self._wal_records += 1
        if self._wal_records >= 10000:
            self.compact()

    def sync(self) -> None:
        """One WAL fsync covering every unsynced append so far (the
        shared barrier a txn group pays once). A compaction racing in
        from another txn swaps the WAL file object; its own fsyncs
        already made everything durable, so a stale-fd error here is
        a satisfied barrier, not a failure."""
        nbytes, self._unsynced = self._unsynced, 0
        try:
            store_telemetry.timed_fsync(self._wal.fileno(),
                                        site="kv.wal",
                                        nbytes=nbytes)
        except (OSError, ValueError):
            pass

    def get(self, key: str) -> bytes | None:
        return self._data.get(key)

    def iterate(self, prefix: str = ""):
        for k in sorted(self._data):
            if k.startswith(prefix):
                yield k, self._data[k]

    def compact(self) -> None:
        e = Encoder()
        e.map(self._data, Encoder.str, Encoder.bytes)
        tmp = self._snap + ".tmp"
        with open(tmp, "wb") as f:
            f.write(e.getvalue())
            f.flush()
            store_telemetry.timed_fsync(f.fileno(),
                                        site="kv.compact.snapshot")
        os.replace(tmp, self._snap)
        self._wal.close()
        self._wal = open(self._walp, "wb")
        store_telemetry.timed_fsync(self._wal.fileno(),
                                    site="kv.compact.wal")
        self._wal_records = 0
        self._unsynced = 0     # the snapshot made everything durable

    def close(self) -> None:
        self.compact()
        self._wal.close()
