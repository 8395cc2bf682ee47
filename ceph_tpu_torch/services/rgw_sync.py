"""rgw multisite-lite — zone replication (src/rgw/rgw_sync.cc +
rgw_data_sync.cc roles, reduced).

The reference replicates between zones with a two-phase protocol:
FULL SYNC (enumerate and copy everything once) then INCREMENTAL
(tail the source zone's per-bucket log and apply deltas). This lite
keeps exactly that shape over two :class:`RGWGateway` instances:

- the SOURCE gateway runs with ``zone_log=True``: every object
  mutation appends a SEQUENCED entry to ``.rgwlog.<bucket>`` (atomic
  cls-counter seq + omap key — O(1) appends, paged tailing);
- :class:`RGWSyncAgent` is the pull-based sync worker (the radosgw
  sync-thread role): per bucket it keeps a durable SEQ MARKER in the
  DESTINATION zone (``.rgwsync.<bucket>`` — restart-safe; applying
  is idempotent, so a crash between apply and marker save merely
  re-applies), tails the log in bounded pages, and carries the
  SOURCE etag (multipart 'md5-N' etags survive replication);
- ``trim_applied()`` drops log entries at or below the destination
  marker — safe because markers are seqs, not positions (with
  multiple destination zones, run it at the minimum marker).

BIDIRECTIONAL (active-active) multisite: run one agent per direction.
Log entries carry their ORIGIN zone (echo suppression: an agent skips
entries that originated at its destination) and, for unversioned
objects, a per-object (epoch, zone) version PAIR — a Lamport pair
whose lexicographic comparison makes conflict resolution symmetric:
both zones deterministically keep the same winner for concurrent
writes, and tombstone pairs stop a stale remote put from resurrecting
a deleted key. Versioned buckets converge on the generation SET
(version ids are globally unique), with per-zone current-pointer
arrival order as the documented reduction.

Deliberate cuts vs the 130 kLoC reference sync machinery: no shard
fan-out of the data log, no metadata sync beyond bucket existence +
versioning state.
"""

from __future__ import annotations

import json

from ceph_tpu_torch.services.rgw import RGWError, RGWGateway

#: log entries tailed per page (bounded wire transfer per pass)
PAGE = 1000


class RGWSyncAgent:
    def __init__(self, src: RGWGateway, dst: RGWGateway) -> None:
        self.src = src
        self.dst = dst

    # -- durable per-bucket seq marker (in the DESTINATION zone) ------
    def _marker(self, bucket: str) -> int | None:
        """Last applied seq, or None when this bucket has never been
        synced. Only a definitive ENOENT means 'never synced' — a
        transient read error must surface, not trigger a wholesale
        full-sync re-copy."""
        from ceph_tpu_torch.client.rados import RadosError
        try:
            return json.loads(
                self.dst.io.read(f".rgwsync.{bucket}"))["applied"]
        except RadosError as exc:
            if exc.code == -2:
                return None
            raise
        except (KeyError, ValueError):
            return None            # corrupt marker: re-bootstrap

    def _save_marker(self, bucket: str, applied_seq: int) -> None:
        self.dst.io.write_full(
            f".rgwsync.{bucket}",
            json.dumps({"applied": applied_seq}).encode())

    def _log_page(self, bucket: str, after_seq: int) -> list[tuple]:
        """[(seq, entry), ...] after ``after_seq``, one bounded page,
        ascending."""
        from ceph_tpu_torch.client.rados import RadosError
        try:
            page = self.src.io.omap_get(
                f".rgwlog.{bucket}", start_after=f"{after_seq:016d}",
                max_return=PAGE)
        except RadosError as exc:
            if exc.code == -2:
                return []          # no log yet
            raise
        return sorted((int(k), json.loads(v))
                      for k, v in page.items())

    def _log_head_seq(self, bucket: str) -> int:
        """Highest assigned seq (the cls counter), 0 when no log."""
        from ceph_tpu_torch.client.rados import RadosError
        try:
            raw = self.src.io.read(f".rgwlog.{bucket}")
            return int(json.loads(raw).get("seq", 0))
        except (RadosError, ValueError):
            return 0

    # -- sync ---------------------------------------------------------
    def _apply(self, bucket: str, ent: dict) -> bool:
        """Returns True when the destination was actually mutated
        (echo-skips and conflict losses return False, so callers can
        detect quiescence)."""
        if ent.get("zone") and ent["zone"] == self.dst.zone and \
                self.dst.zone != self.src.zone:
            # echo suppression (the reference's zone short-id check
            # in rgw_data_sync): this entry ORIGINATED at the
            # destination and came back around a bidirectional (or
            # ring) topology — applying it would loop forever. Only
            # meaningful when the deployment actually names distinct
            # zones (legacy one-way setups leave both at "default").
            return False
        vid = ent.get("vid")
        pair = ent.get("pair")
        origin = ent.get("zone")
        if ent["op"] == "put":
            try:
                data, meta = self.src.get_object(
                    bucket, ent["key"], version_id=vid)
            except RGWError:
                return False    # superseded by a later delete: the
                # delete entry follows in the log and converges
            # version ids REPLICATE (the reference carries the source
            # instance id through data sync): dst mints nothing.
            # put_object returns None when the entry LOST a
            # bidirectional conflict (destination holds a newer pair)
            return self.dst.put_object(
                bucket, ent["key"], data,
                etag=meta.get("etag") or None,
                version_id=vid, pair=pair,
                origin=origin,
                oseq=ent.get("oseq") or meta.get("oseq")) is not None
        elif ent["op"] == "del":
            try:
                self.dst.delete_object(bucket, ent["key"],
                                       pair=pair, origin=origin)
            except RGWError:
                return False    # absent (idempotent) or conflict
                # loss (RemoteStale) — either way nothing mutated
        elif ent["op"] == "dm":
            try:
                self.dst.delete_object(bucket, ent["key"],
                                       _marker_vid=vid,
                                       origin=origin,
                                       oseq=ent.get("oseq"))
            except RGWError:
                return False
        elif ent["op"] == "delver":
            try:
                self.dst.delete_object(bucket, ent["key"],
                                       version_id=vid,
                                       origin=origin)
            except RGWError:
                return False    # that generation never made it here
        return True

    def _full_sync(self, bucket: str) -> None:
        """Bootstrap: copy the source bucket wholesale (the FULL SYNC
        phase), carrying each object's source etag. Versioned buckets
        copy every generation oldest-first so the destination's
        current-version resolution (arrival order) lands on the same
        generation the source shows."""
        if self.src.get_versioning(bucket) is not None:
            gens = sorted(self.src.list_versions(bucket),
                          key=lambda e: e["seq"])
            for ent in gens:
                if ent.get("dm"):
                    self.dst.delete_object(bucket, ent["key"],
                                           _marker_vid=ent["vid"],
                                           _log=False,
                                           oseq=ent.get("oseq"))
                    continue
                try:
                    data, meta = self.src.get_object(
                        bucket, ent["key"], version_id=ent["vid"])
                except RGWError:
                    continue    # reaped mid-enumeration
                self.dst.put_object(bucket, ent["key"], data,
                                    etag=meta.get("etag") or None,
                                    version_id=ent["vid"],
                                    oseq=ent.get("oseq"))
            return
        marker = ""
        while True:
            page = self.src.list_objects(bucket, max_keys=1000,
                                         marker=marker)
            if not page:
                return
            for key in sorted(page):
                try:
                    data, meta = self.src.get_object(bucket, key)
                except RGWError:
                    continue    # deleted mid-enumeration
                # bootstrap carries the source's CURRENT pair so a
                # bidirectional peer resolves conflicts against it
                pair = self.src._get_pair(bucket, key) \
                    if self.src.zone_log else [0, ""]
                self.dst.put_object(
                    bucket, key, data,
                    etag=meta.get("etag") or None,
                    pair=pair if pair[0] else None,
                    origin=self.src.zone if pair[0] else None)
            marker = max(page)

    def sync_once(self) -> dict:
        """One sync pass; returns per-bucket applied-entry counts."""
        report: dict[str, int] = {}
        dst_buckets = set(self.dst.list_buckets())
        for bucket in self.src.list_buckets():
            if bucket not in dst_buckets:
                self.dst.create_bucket(bucket)
                dst_buckets.add(bucket)
            # metadata sync: mirror the versioning state (a versioned
            # source must replicate into a versioned destination or
            # generation ids are lost)
            sv = self.src.get_versioning(bucket)
            if sv is not None and self.dst.get_versioning(bucket) != sv:
                try:
                    self.dst.set_versioning(bucket, sv)
                except RGWError:
                    # destination bucket rides a cls (EC-pool) index:
                    # no versions omap there. Degrade to replicating
                    # current data only rather than wedging the whole
                    # zone's sync pass.
                    pass
            marker = self._marker(bucket)
            if marker is None:
                # FULL SYNC: snapshot the head seq FIRST — entries
                # logged during the copy re-apply incrementally
                # (idempotent), never skip
                head = self._log_head_seq(bucket)
                self._full_sync(bucket)
                self._save_marker(bucket, head)
                report[bucket] = 0
                continue
            applied = 0
            while True:
                page = self._log_page(bucket, marker)
                if not page:
                    break
                for seq, ent in page:
                    if self._apply(bucket, ent):
                        applied += 1
                    marker = seq
                    self._save_marker(bucket, marker)
            report[bucket] = applied
        return report

    def trim_applied(self) -> int:
        """Drop source-log entries at or below the destination marker
        (the log-trim role; with several destination zones run at the
        min marker). Returns entries removed."""
        removed = 0
        for bucket in self.src.list_buckets():
            marker = self._marker(bucket)
            if not marker:
                continue
            while True:
                page = self._log_page(bucket, 0)
                stale = [f"{seq:016d}" for seq, _ in page
                         if seq <= marker]
                if not stale:
                    break
                self.src.io.omap_rm_keys(f".rgwlog.{bucket}", stale)
                removed += len(stale)
                if len(page) < PAGE:
                    break
        return removed
