"""rbd-mirror-lite — journal-based image replication.

Reference: src/tools/rbd_mirror (ImageReplayer, PoolReplayer) over
librbd journaling: the daemon bootstraps each mirror-enabled image
(initial full sync), then tails the source journal from its per-client
commit position, replays events onto the target image, advances the
commit position, and trims. Promote/demote flips which side accepts
writes (the target stays non-primary and rejects client mutations).

Pool-level enablement lives in a ``rbd_mirroring`` object on the
source pool (the reference's mirroring pool metadata).
"""

from __future__ import annotations

import json
import threading
import time

from ceph_tpu_torch.services.journal import JournalError, Journaler
from ceph_tpu_torch.services.rbd import RBD, Image, RBDError
from ceph_tpu_torch.utils.dout import Dout

log = Dout("rbd-mirror")

MIRRORING_OID = "rbd_mirroring"


def mirror_image_enable(ioctx, name: str) -> None:
    """Mark a journaled image for mirroring (``rbd mirror image
    enable`` role)."""
    img = Image(ioctx, name)
    if img.journal is None:
        raise RBDError(f"image {name!r} has no journaling feature")
    try:
        d = json.loads(ioctx.read(MIRRORING_OID))
    except Exception:
        d = {"images": []}
    if name not in d["images"]:
        d["images"].append(name)
        ioctx.write_full(MIRRORING_OID,
                         json.dumps(d, sort_keys=True).encode())


def mirror_image_disable(ioctx, name: str) -> None:
    try:
        d = json.loads(ioctx.read(MIRRORING_OID))
    except Exception:
        return
    if name in d["images"]:
        d["images"].remove(name)
        ioctx.write_full(MIRRORING_OID,
                         json.dumps(d, sort_keys=True).encode())


def mirror_images(ioctx) -> list[str]:
    try:
        return list(json.loads(ioctx.read(MIRRORING_OID))["images"])
    except Exception:
        return []


class ImageReplayer:
    """Tail one image's journal and replay onto the peer pool
    (rbd_mirror ImageReplayer role)."""

    def __init__(self, src_io, dst_io, name: str,
                 client_id: str = "mirror") -> None:
        self.src_io = src_io
        self.dst_io = dst_io
        self.name = name
        self.client_id = client_id
        self.journal = Journaler(src_io, f"rbd.{name}")

    def bootstrap(self) -> None:
        """Initial sync: record the journal end, copy current content,
        commit at the recorded position. Events from before the copy
        may replay again — every event is idempotent against content
        that already includes it (writes/resizes rewrite the same
        bytes, snap events check existence)."""
        # pos0 FIRST: any mutation after this position replays; the
        # header/content copied below may already include some of
        # those events (replay is idempotent), but an event between a
        # header load and a later pos0 would be lost on both sides
        pos0 = self.journal.end_position()
        src = Image(self.src_io, self.name)
        rbd_dst = RBD(self.dst_io)
        if self.name not in rbd_dst.list():
            rbd_dst.create(self.name, src.size(),
                           layout=src._data.layout,
                           journaling=False, primary=False)
        dst = Image(self.dst_io, self.name)
        content = src._data.read()
        if content:
            dst._data.write(content)
        dst._header["size"] = src.size()
        dst._header["primary"] = False
        # copy the SOURCE snapshots' point-in-time content (resolved
        # through the COW chain), not a re-snapshot of current dst
        # data: a later replayed snap_rollback must restore the same
        # bytes on both sides. Chain order is preserved.
        order = list(src._header.get("snap_order", []))
        order += [s for s in sorted(src._header["snaps"])
                  if s not in order]
        for snap in order:
            meta = src._header["snaps"][snap]
            dst._snap_ingest(snap, src.snap_read(snap), meta["size"])
        dst._save_header()
        self.journal.commit(self.client_id, pos0)
        log(1, f"rbd-mirror: bootstrapped {self.name} at pos {pos0}")

    def replay_once(self) -> int:
        """Apply everything past the commit position; returns the
        number of events applied."""
        if not self.journal.exists():
            return 0
        start = self.journal.committed(self.client_id)
        dst = Image(self.dst_io, self.name)
        applied = 0
        last = start - 1
        try:
            for pos, payload in self.journal.read_from(start):
                kind, offset, data, arg = Image.decode_event(payload)
                dst._apply_event(kind, offset, data, arg)
                last = pos
                applied += 1
        except JournalError as exc:
            # commit only the applied prefix; the rest replays next
            # pass (advancing past unread events would skip them on
            # the target forever)
            log(1, f"rbd-mirror: replay of {self.name} stopped "
                f"early: {exc}")
        if applied:
            self.journal.commit(self.client_id, last + 1)
            self.journal.trim()
        return applied

    def sync(self) -> int:
        """Bootstrap if needed, then replay to the journal tip."""
        rbd_dst = RBD(self.dst_io)
        if self.name not in rbd_dst.list():
            self.bootstrap()
        return self.replay_once()


class MirrorDaemon:
    """PoolReplayer role: replicate every mirror-enabled image of a
    source pool onto a destination pool, continuously or one-shot."""

    def __init__(self, src_io, dst_io,
                 client_id: str = "mirror",
                 interval: float = 0.5) -> None:
        self.src_io = src_io
        self.dst_io = dst_io
        self.client_id = client_id
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def sync_once(self) -> dict[str, int]:
        out = {}
        for name in mirror_images(self.src_io):
            try:
                out[name] = ImageReplayer(
                    self.src_io, self.dst_io, name,
                    self.client_id).sync()
            except (RBDError, JournalError) as exc:
                if "no such image" in str(exc) or \
                        "no journal" in str(exc):
                    # source image removed while still registered:
                    # prune, or every pass fails for it forever
                    log(1, f"rbd-mirror: pruning removed {name!r}")
                    mirror_image_disable(self.src_io, name)
                    out[name] = -1
                    continue
                log(1, f"rbd-mirror: {name}: {exc!r}")
                out[name] = -1
            except Exception as exc:
                log(1, f"rbd-mirror: {name}: {exc!r}")
                out[name] = -1
        return out

    def start(self) -> "MirrorDaemon":
        self._thread = threading.Thread(
            target=self._run, name="rbd-mirror", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.sync_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def promote(ioctx, name: str) -> None:
    """Make the local side primary (failover: ``rbd mirror image
    promote``)."""
    Image(ioctx, name).promote()


def demote(ioctx, name: str) -> None:
    Image(ioctx, name).demote()
