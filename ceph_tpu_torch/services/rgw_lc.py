"""rgw lifecycle processor (src/rgw/rgw_lc.cc RGWLC role).

The reference runs lifecycle as a radosgw background worker: RGWLC
shards buckets-with-rules into lc.N omap objects and ``RGWLC::process``
(rgw_lc.cc:679) walks one shard per pass, expiring current versions
(laying delete markers on versioned buckets), reaping noncurrent
generations past their age, and removing delete markers left with no
generations under them.

This processor keeps the same pass semantics over :class:`RGWGateway`:
``process()`` walks every bucket that has rules and applies each
Enabled rule by prefix. ``day_seconds`` compresses a "day" for tests —
the reference's ``rgw_lc_debug_interval`` does exactly this.

The processor is an internal system actor: it calls gateway methods
directly and is not subject to ACLs (like the reference's lc worker
running as the system user).
"""

from __future__ import annotations

import threading
import time

from ceph_tpu_torch.services.rgw import RGWError, RGWGateway


class LifecycleProcessor:
    def __init__(self, gw: RGWGateway,
                 day_seconds: float = 86400.0) -> None:
        self.gw = gw
        self.day_seconds = day_seconds

    # -- one pass (RGWLC::process role) -------------------------------
    def process(self, now: float | None = None) -> dict:
        """Apply every bucket's enabled rules once, then run the
        deferred-GC reaper (orphaned striped tails from a gateway
        crash mid-delete — RGWGC::process, src/rgw/rgw_gc.cc:257);
        returns {"expired": n, "noncurrent_reaped": n,
        "markers_cleaned": n, "gc_entries": n, "gc_objects": n}."""
        now = time.time() if now is None else now
        stats = {"expired": 0, "noncurrent_reaped": 0,
                 "markers_cleaned": 0}
        for bucket in self.gw.list_buckets():
            try:
                rules = self.gw.bucket_meta(bucket).get("lifecycle")
            except RGWError:
                continue
            for rule in rules or []:
                if rule.get("status", "Enabled") != "Enabled":
                    continue
                self._apply_rule(bucket, rule, now, stats)
        gc = self.gw.gc_process()
        stats["gc_entries"] = gc["entries"]
        stats["gc_objects"] = gc["objects"]
        return stats

    def _apply_rule(self, bucket: str, rule: dict, now: float,
                    stats: dict) -> None:
        prefix = rule.get("prefix", "")
        days = rule.get("days")
        nc_days = rule.get("noncurrent_days")
        if days:
            self._expire_current(bucket, prefix,
                                 now - days * self.day_seconds, stats)
        if nc_days:
            self._reap_noncurrent(
                bucket, prefix, now - nc_days * self.day_seconds,
                stats)
        self._clean_orphan_markers(bucket, prefix, stats)

    def _expire_current(self, bucket: str, prefix: str,
                        cutoff: float, stats: dict) -> None:
        """Expire current objects older than ``cutoff``: versioned
        buckets get a delete marker (data retained for the noncurrent
        rule), unversioned buckets lose the object for good — the
        reference's RGWLC::handle_multipart/obj expiration split."""
        marker = ""
        while True:
            page = self.gw.list_objects(bucket, prefix=prefix,
                                        max_keys=1000, marker=marker)
            if not page:
                return
            for key in sorted(page):
                ent = page[key]
                if float(ent.get("mtime", now_inf())) < cutoff:
                    try:
                        self.gw.delete_object(bucket, key)
                        stats["expired"] += 1
                    except RGWError:
                        pass
            marker = max(page)

    def _reap_noncurrent(self, bucket: str, prefix: str,
                         cutoff: float, stats: dict) -> None:
        """Permanently remove noncurrent generations older than
        ``cutoff`` (NoncurrentVersionExpiration role)."""
        for ent in self.gw.list_versions(bucket, prefix=prefix):
            if ent["is_current"] or ent.get("dm"):
                continue
            if float(ent.get("mtime", now_inf())) < cutoff:
                try:
                    self.gw.delete_object(bucket, ent["key"],
                                          version_id=ent["vid"])
                    stats["noncurrent_reaped"] += 1
                except RGWError:
                    pass

    def _clean_orphan_markers(self, bucket: str, prefix: str,
                              stats: dict) -> None:
        """Remove delete markers that are the ONLY generation left of
        their key (the reference's ExpiredObjectDeleteMarker)."""
        by_key: dict[str, list] = {}
        for ent in self.gw.list_versions(bucket, prefix=prefix):
            by_key.setdefault(ent["key"], []).append(ent)
        for key, ents in by_key.items():
            if len(ents) == 1 and ents[0].get("dm"):
                try:
                    self.gw.delete_object(bucket, key,
                                          version_id=ents[0]["vid"])
                    stats["markers_cleaned"] += 1
                except RGWError:
                    pass


def now_inf() -> float:
    """Missing mtime (legacy cls-index entry) never expires."""
    return float("inf")


class LifecycleThread:
    """Background worker wrapper (the radosgw lc thread role)."""

    def __init__(self, gw: RGWGateway, interval: float = 60.0,
                 day_seconds: float = 86400.0) -> None:
        self.proc = LifecycleProcessor(gw, day_seconds=day_seconds)
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="rgw-lc", daemon=True)

    def start(self) -> "LifecycleThread":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.proc.process()
            except Exception:
                pass
