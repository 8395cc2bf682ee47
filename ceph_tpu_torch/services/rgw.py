"""rgw-lite — object gateway over RADOS (src/rgw role, reduced).

Reference: radosgw serves S3/Swift over HTTP; every bucket has an
index object whose entries are maintained ATOMICALLY by in-OSD
``cls_rgw`` methods, and object data lives in RADOS (striped when
large). This lite gateway keeps exactly that object model:

- ``.buckets``            — bucket directory (json)
- ``.bucket.<name>``      — per-bucket index, mutated ONLY via the
                            ``rgw`` object class (cls/__init__.py), so
                            concurrent gateways never race the index
- ``<bucket>/<key>``      — object data through the striper

The HTTP front end is S3-path-shaped (PUT/GET/DELETE /bucket and
/bucket/key, GET /bucket lists with ?prefix=) and answers S3 XML
(ListAllMyBucketsResult / ListBucketResult / Error documents). With
``RGWServer(..., auth={access_key: secret})`` every request must carry
an AWS Signature Version 4 Authorization header; ``sign_request``
below is the matching client-side signer (the shape boto3 emits for
path-style requests).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ceph_tpu_torch.client.striper import FileLayout, StripedObject

BUCKETS_OID = ".buckets"

#: canned ACLs (src/rgw/rgw_acl_s3.cc rgw_canned_acl role)
CANNED_ACLS = ("private", "public-read", "public-read-write",
               "authenticated-read")

#: requester sentinel for unauthenticated requests
ANONYMOUS = None


class RGWError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status


class RGWGateway:
    """Gateway core (the librados-facing half of radosgw).

    The bucket index lives in the index object's OMAP — one key per
    object entry — exactly as the reference's cls_rgw keeps it
    (src/cls/rgw/ over omap), so concurrent puts never contend on a
    serialized blob, and listings page server-side. The format is
    decided ONCE at bucket creation and recorded as the index
    object's "fmt" xattr: buckets created before the omap index (no
    attr) keep their cls-blob index forever, and EC index pools —
    where omap is rejected, reference parity — record "cls". Every
    gateway then routes per bucket, so mixed-era buckets and
    gateways can never split one index across two formats."""

    def __init__(self, ioctx, zone_log: bool = False,
                 zone_name: str = "default") -> None:
        self.io = ioctx
        #: this gateway's zone (rgw_zone role). Multisite conflict
        #: resolution and echo suppression key on it: log entries
        #: carry their ORIGIN zone and a per-object (epoch, zone)
        #: version pair (a Lamport pair — lexicographic comparison is
        #: symmetric, so concurrently-writing zones converge on the
        #: same winner, the reference's rgw_data_sync mtime+squash
        #: resolution made deterministic).
        self.zone = zone_name
        self._layout = FileLayout(stripe_unit=1 << 20, stripe_count=1,
                                  object_size=1 << 20)
        self._fmt_cache: dict[str, str] = {}
        #: version id assigned by the most recent put_object/
        #: delete_object on THIS THREAD (x-amz-version-id) — thread
        #: local because ThreadingHTTPServer handlers share one
        #: gateway and must not read each other's ids
        import threading as _th
        self._tls = _th.local()
        #: multisite source role (src/rgw/rgw_sync.cc, reduced):
        #: every mutation appends a replication-log entry (cls log,
        #: atomic in-OSD) that RGWSyncAgent tails into another zone
        self.zone_log = zone_log

    @property
    def last_version_id(self) -> str | None:
        return getattr(self._tls, "vid", None)

    @last_version_id.setter
    def last_version_id(self, vid: str | None) -> None:
        self._tls.vid = vid

    # -- per-object version pairs (multisite conflict state) -----------
    def _pair_oid(self, bucket: str) -> str:
        return f".rgwver2.{bucket}"

    def _get_pair(self, bucket: str, key: str) -> list:
        """Current [epoch, zone] of the key (covers live AND deleted
        keys — the tombstone state that stops a stale remote put from
        resurrecting a deleted object)."""
        from ceph_tpu_torch.client.rados import RadosError
        try:
            out = self.io.execute(self._pair_oid(bucket), "rgw",
                                  "pair_get",
                                  json.dumps({"key": key}).encode())
        except RadosError as exc:
            if exc.code == -2:
                return [0, ""]
            raise
        return json.loads(out)["pair"]

    @staticmethod
    def _pair_wins(new: list, cur: list) -> bool:
        return (int(new[0]), str(new[1])) > (int(cur[0]), str(cur[1]))

    def _advance_pair(self, bucket: str, key: str,
                      pair: list | None) -> list | None:
        """Local mutation: mint the next pair. Remote apply (``pair``
        given): advance only if it beats the current pair; returns
        None when the remote mutation LOST the conflict (the caller
        skips it — both zones keep the same winner). The advance runs
        as an in-OSD cls method under the PG lock: a client-side
        read-modify-write would let two concurrent local puts mint
        identical pairs and diverge the zones permanently."""
        if not self.zone_log:
            return None            # not a multisite zone: no pairs
        from ceph_tpu_torch.client.rados import RadosError
        try:
            out = self.io.execute(
                self._pair_oid(bucket), "rgw", "pair_advance",
                json.dumps({"key": key, "zone": self.zone,
                            "pair": pair}).encode())
        except RadosError as exc:
            if exc.code == -125:
                return None        # lost the conflict
            raise
        return json.loads(out)["pair"]

    def _log_mutation(self, bucket: str, op: str, key: str,
                      etag: str = "", vid: str | None = None,
                      pair: list | None = None,
                      origin: str | None = None,
                      oseq: list | None = None) -> None:
        """Append one SEQUENCED replication-log entry: an atomic cls
        numops counter assigns the seq, the entry rides an omap key
        (zero-padded seq) — O(1) appends, PAGED tailing, and markers
        keyed by seq survive trims (a positional index would not).
        zone_log therefore needs an omap-capable (replicated) pool,
        like the reference's log pools."""
        if not self.zone_log:
            return
        oid = f".rgwlog.{bucket}"
        out = self.io.execute(oid, "numops", "add",
                              json.dumps({"key": "seq",
                                          "value": 1}).encode())
        seq = int(json.loads(out)["seq"])
        ent = {"op": op, "key": key, "etag": etag,
               "zone": origin or self.zone}
        if oseq is not None:
            ent["oseq"] = [int(oseq[0]), str(oseq[1])]
        if vid is not None:
            ent["vid"] = vid
        if pair is not None:
            ent["pair"] = pair
        self.io.omap_set(oid, {f"{seq:016d}": json.dumps(ent).encode()})

    # -- bucket index (cls_rgw bucket-index role) ----------------------
    def _pool_omap(self) -> bool:
        m = self.io.client.monc.osdmap
        pool = m.pools.get(self.io.pool_id) if m else None
        return pool is not None and not pool.is_ec

    def _bucket_fmt(self, bucket: str) -> str:
        fmt = self._fmt_cache.get(bucket)
        if fmt is None:
            try:
                fmt = self.io.getxattr(f".bucket.{bucket}",
                                       "fmt").decode()
            except Exception:
                fmt = "cls"            # legacy bucket: blob index
            self._fmt_cache[bucket] = fmt
        return fmt

    def _index_add(self, bucket: str, key: str, size: int,
                   etag: str, **extra) -> None:
        """``extra`` carries optional per-object metadata (mtime, acl,
        owner, version id) — omap-format entries are json and
        extensible; the cls blob path (EC pools) keeps the classic
        size/etag/mtime triple (versioning requires omap, see
        set_versioning)."""
        if self._bucket_fmt(bucket) == "omap":
            import time as _t
            ent = {"size": size, "etag": etag,
                   "mtime": extra.pop("mtime", None) or _t.time()}
            ent.update({k: v for k, v in extra.items()
                        if v is not None})
            self.io.omap_set(
                f".bucket.{bucket}", {key: json.dumps(ent).encode()})
        else:
            self.io.execute(f".bucket.{bucket}", "rgw", "bucket_add",
                            json.dumps({"key": key, "size": size,
                                        "etag": etag}).encode())

    def _index_rm(self, bucket: str, key: str) -> None:
        """Raises RGWError 404 when the key is not in the index."""
        from ceph_tpu_torch.client.rados import RadosError
        if self._bucket_fmt(bucket) == "omap":
            oid = f".bucket.{bucket}"
            if not self.io.omap_get(oid, [key]):
                raise RGWError(404, "NoSuchKey")
            self.io.omap_rm_keys(oid, [key])
            return
        try:
            self.io.execute(f".bucket.{bucket}", "rgw", "bucket_rm",
                            json.dumps({"key": key}).encode())
        except RadosError as exc:
            if exc.code == -2:
                raise RGWError(404, "NoSuchKey") from None
            raise

    def _index_list(self, bucket: str, prefix: str, max_keys: int,
                    marker: str) -> dict:
        if self._bucket_fmt(bucket) == "omap":
            # server-side page: transfer is proportional to max_keys,
            # not the bucket size (omap-get-vals paging)
            page = self.io.omap_get(f".bucket.{bucket}",
                                    prefix=prefix, start_after=marker,
                                    max_return=max_keys)
            return {k: json.loads(v) for k, v in page.items()}
        out = self.io.execute(
            f".bucket.{bucket}", "rgw", "bucket_list",
            json.dumps({"prefix": prefix, "max_keys": max_keys,
                        "marker": marker}).encode())
        return json.loads(out or b"{}")

    def container_stats(self, bucket: str) -> tuple[int, int]:
        """(object_count, bytes_used) — ACCURATE, by paging the whole
        index in bounded pages (no silent 10k cap; each page's wire
        transfer stays bounded)."""
        self._check_bucket(bucket)
        count = total = 0
        marker = ""
        while True:
            page = self._index_list(bucket, "", 10000, marker)
            if not page:
                return count, total
            count += len(page)
            total += sum(e["size"] for e in page.values())
            marker = max(page)

    # -- buckets -------------------------------------------------------
    def _buckets(self) -> dict:
        try:
            return json.loads(self.io.read(BUCKETS_OID))
        except Exception:
            return {}

    def list_buckets(self) -> list[str]:
        return sorted(self._buckets())

    def bucket_meta(self, name: str) -> dict:
        """Bucket metadata record (owner/acl/versioning/lifecycle —
        the RGWBucketInfo role)."""
        b = self._buckets()
        if name not in b:
            raise RGWError(404, "NoSuchBucket")
        return b[name] or {}

    def _update_bucket_meta(self, name: str, **fields) -> None:
        b = self._buckets()
        if name not in b:
            raise RGWError(404, "NoSuchBucket")
        meta = b[name] or {}
        meta.update(fields)
        b[name] = meta
        self.io.write_full(BUCKETS_OID, json.dumps(b).encode())

    def create_bucket(self, name: str, owner: str = "",
                      acl: str = "private") -> None:
        if not name or "/" in name or name.startswith("."):
            raise RGWError(400, f"invalid bucket name {name!r}")
        if acl not in CANNED_ACLS:
            raise RGWError(400, "InvalidArgument")
        b = self._buckets()
        if name in b:
            return                     # S3 PUT bucket is idempotent
        b[name] = {"owner": owner, "acl": acl}
        self.io.write_full(BUCKETS_OID, json.dumps(b).encode())
        self.io.write_full(f".bucket.{name}", b"{}")
        fmt = "omap" if self._pool_omap() else "cls"
        self.io.setxattr(f".bucket.{name}", "fmt", fmt.encode())
        self._fmt_cache[name] = fmt

    def delete_bucket(self, name: str) -> None:
        b = self._buckets()
        if name not in b:
            raise RGWError(404, "NoSuchBucket")
        if self.list_objects(name):
            raise RGWError(409, "BucketNotEmpty")
        if (b[name] or {}).get("versioning") and \
                self.list_versions(name):
            # S3: hidden generations (incl. delete markers) also
            # block bucket deletion
            raise RGWError(409, "BucketNotEmpty")
        del b[name]
        self.io.write_full(BUCKETS_OID, json.dumps(b).encode())
        for oid in (f".bucket.{name}", self._ver_oid(name)):
            try:
                self.io.remove(oid)
            except Exception:
                pass

    def _check_bucket(self, bucket: str) -> None:
        if bucket not in self._buckets():
            raise RGWError(404, "NoSuchBucket")

    # -- ACLs (src/rgw/rgw_acl_s3.cc canned-ACL role) ------------------
    # Canned ACLs enforced per request at the REST layer (the
    # reference's RGWOp::verify_permission seat). Internal actors
    # (sync agent, lifecycle processor) call gateway methods directly
    # and bypass ACLs, exactly as the reference's system user does.

    def check_access(self, bucket: str, requester: str | None,
                     want: str, key: str = "") -> None:
        """Raise 403 unless ``requester`` (an access key, or None for
        anonymous) may perform ``want`` ('read' | 'write' | 'owner')
        on the bucket (or on ``key``, whose own ACL — when set —
        overrides the bucket ACL for object reads)."""
        meta = self.bucket_meta(bucket)
        owner = meta.get("owner", "")
        if not owner:
            # legacy/ownerless bucket (pre-ACL, or created through
            # the library API): ANY authenticated principal has full
            # access — exactly the pre-ACL authed-server behavior —
            # but anonymous stays out
            if requester is not None:
                return
            raise RGWError(403, "AccessDenied")
        if requester is not None and requester == owner:
            return
        acl = meta.get("acl", "private")
        if want == "read" and key:
            oacl = self._object_acl(bucket, key)
            if oacl is not None:
                acl = oacl
        if want == "owner":
            raise RGWError(403, "AccessDenied")
        if want == "write":
            if acl == "public-read-write":
                return
            raise RGWError(403, "AccessDenied")
        # want == "read"
        if acl in ("public-read", "public-read-write"):
            return
        if acl == "authenticated-read" and requester is not None:
            return
        raise RGWError(403, "AccessDenied")

    def _object_acl(self, bucket: str, key: str) -> str | None:
        try:
            ent = self.list_objects(bucket, prefix=key).get(key)
        except RGWError:
            return None
        return (ent or {}).get("acl")

    def set_object_acl(self, bucket: str, key: str, acl: str) -> None:
        if acl not in CANNED_ACLS:
            raise RGWError(400, "InvalidArgument")
        if self._bucket_fmt(bucket) != "omap":
            raise RGWError(501, "NotImplemented")
        ent = self.list_objects(bucket, prefix=key).get(key)
        if ent is None:
            raise RGWError(404, "NoSuchKey")
        ent["acl"] = acl
        self.io.omap_set(f".bucket.{bucket}",
                         {key: json.dumps(ent).encode()})
        if ent.get("vid"):
            # keep the generation record in step, so reindexing after
            # a by-id delete restores this ACL
            gen = self._ver_entries(bucket, key).get(ent["vid"])
            if gen is not None:
                gen["acl"] = acl
                self._ver_put_entry(bucket, key, gen)

    def set_bucket_acl(self, bucket: str, acl: str) -> None:
        if acl not in CANNED_ACLS:
            raise RGWError(400, "InvalidArgument")
        self._update_bucket_meta(bucket, acl=acl)

    # -- versioning (src/rgw/rgw_op.cc versioned-object role) ----------
    # A versioned bucket keeps every object generation: the CURRENT
    # generation stays in the main index (so plain GET/list see it),
    # and every generation (including delete markers) lives in the
    # bucket's versions omap, keyed "<key>\0<vid>". Version data
    # objects are "<bucket>/<key>\0<vid>"; the pre-versioning
    # generation of a key keeps its plain oid and appears as vid
    # "null" (S3's null-version semantics).

    def set_versioning(self, bucket: str, status: str) -> None:
        if status not in ("Enabled", "Suspended"):
            raise RGWError(400, "IllegalVersioningConfiguration")
        if self._bucket_fmt(bucket) != "omap":
            # EC-pool cls-blob indexes have no versions omap; the
            # reference keeps bucket indexes on replicated pools and
            # so never hits this (documented reduction)
            raise RGWError(501, "NotImplemented")
        self._update_bucket_meta(bucket, versioning=status)

    def get_versioning(self, bucket: str) -> str | None:
        return self.bucket_meta(bucket).get("versioning")

    def _ver_oid(self, bucket: str) -> str:
        return f".versions.{bucket}"

    def _ver_data_oid(self, bucket: str, key: str, vid: str) -> str:
        return f"{bucket}/{key}" if vid == "null" \
            else f"{bucket}/{key}\x00{vid}"

    # -- deferred GC (src/rgw/rgw_gc.cc:257 RGWGC::process role) ------
    #: omap object holding {soid: enroll_stamp} for striped objects
    #: being deleted — enrolled BEFORE the inline tail removal,
    #: cleared after it completes. A gateway crash mid-delete leaves
    #: the enrollment; the lifecycle worker's gc pass reaps the
    #: orphaned tails later (the reference defers tails to cls_gc
    #: the same way instead of trusting the inline delete).
    GC_OID = ".rgwgc"
    #: seconds an enrollment must age before the reaper touches it
    #: (grace for the inline delete still running)
    GC_DEFER = 2.0

    def _gc_enroll(self, soid: str, tag: str | None = None) -> None:
        """Record the pending delete WITH the doomed generation's tag
        (read from the stripe meta): the reaper only touches pieces
        carrying this tag, so a crash-orphaned enrollment can never
        eat a concurrently re-uploaded object's live pieces (the
        reference keys gc chains to per-write tail tags the same way,
        rgw_gc)."""
        import time as _t
        try:
            self.io.omap_set(self.GC_OID, {soid: json.dumps(
                {"t": _t.time(), "tag": tag}).encode()})
        except Exception:
            pass                  # GC is belt-and-braces; the inline
            # delete still runs

    def _gc_done(self, soid: str) -> None:
        try:
            self.io.omap_rm_keys(self.GC_OID, [soid])
        except Exception:
            pass

    def _remove_striped(self, soid: str) -> None:
        """Crash-safe striped-object removal: enroll (tagged) ->
        inline remove -> de-enroll. Tails orphaned by a crash between
        the steps are reaped by the gc pass."""
        so = StripedObject(self.io, soid)
        self._gc_enroll(soid, so.tag)
        so.remove()
        self._gc_done(soid)

    def _gc_pending(self) -> dict[str, tuple[float, str | None]]:
        """{soid: (stamp, generation tag)} — tag None for legacy
        (pre-tagging) enrollments, which keep the old prefix-reap."""
        from ceph_tpu_torch.client.rados import RadosError
        try:
            raw = self.io.omap_get(self.GC_OID)
        except RadosError:
            return {}
        out: dict[str, tuple[float, str | None]] = {}
        for k, v in raw.items():
            try:
                ent = json.loads(v)
                out[k] = (float(ent["t"]), ent.get("tag"))
            except Exception:
                try:
                    out[k] = (float(v), None)   # legacy plain stamp
                except Exception:
                    pass
        return out

    def gc_list(self) -> dict[str, float]:
        """Pending gc enrollments {soid: stamp} (radosgw-admin gc
        list role)."""
        return {soid: stamp
                for soid, (stamp, _tag) in self._gc_pending().items()}

    def _gc_tag_matches(self, name: str, soid: str, tag: str) -> bool:
        """Whether piece/meta ``name`` belongs to the enrolled
        generation ``tag``. Unattributable objects (missing tag, read
        fault) are NOT reaped — a leaked tail is recoverable, a
        deleted live piece is not."""
        try:
            if name == soid + StripedObject.META_SUFFIX:
                return json.loads(self.io.read(name)).get("tag") == tag
            return self.io.getxattr(name, "gc_tag").decode() == tag
        except Exception:
            return False

    def gc_process(self, grace: float | None = None) -> dict:
        """Reap aged enrollments: remove every surviving piece OF THE
        ENROLLED GENERATION (meta + data pieces found by prefix
        listing, then filtered by generation tag), then drop the
        entry. Returns {"entries": n, "objects": n}
        (RGWGC::process, src/rgw/rgw_gc.cc:257)."""
        import time as _t
        grace = self.GC_DEFER if grace is None else grace
        now = _t.time()
        stats = {"entries": 0, "objects": 0}
        pending = self._gc_pending()
        if not pending:
            return stats
        names = None
        for soid, (stamp, tag) in pending.items():
            if now - stamp < grace:
                continue
            if names is None:       # one listing serves the pass
                names = self.io.list_objects()
            doomed = [n for n in names
                      if n == soid + StripedObject.META_SUFFIX
                      or (n.startswith(soid + ".")
                          and n[len(soid) + 1:].isalnum())]
            for n in doomed:
                if tag is not None and \
                        not self._gc_tag_matches(n, soid, tag):
                    continue        # another generation's live piece
                try:
                    self.io.remove(n)
                    stats["objects"] += 1
                except Exception:
                    pass
            self._gc_done(soid)
            stats["entries"] += 1
        return stats

    def _alloc_vseq(self, bucket: str) -> int:
        out = self.io.execute(self._ver_oid(bucket), "numops", "add",
                              json.dumps({"key": "seq",
                                          "value": 1}).encode())
        return int(json.loads(out)["seq"])

    def _bump_vseq(self, bucket: str, floor: int) -> None:
        """Lamport receive: applying a remote generation with origin
        seq ``floor`` raises the local allocator past it, so the next
        LOCAL mutation deterministically orders after everything this
        zone has seen (the OLH epoch monotonicity of set_olh,
        src/rgw/rgw_rados.h:3287)."""
        self.io.execute(self._ver_oid(bucket), "numops", "max",
                        json.dumps({"key": "seq",
                                    "value": floor}).encode())

    @staticmethod
    def _gen_order(ent: dict) -> tuple:
        """Deterministic cross-zone TOTAL order on generations — the
        OLH 'which generation is current' resolution
        (src/rgw/rgw_rados.h:3287 set_olh): (origin seq, origin zone)
        pairs compare identically at every zone, unlike the local
        apply-order seq. Legacy entries fall back to (seq, ""). The
        vid is the final tie-breaker: two generations with an equal
        (seq, zone) pair (legacy no-oseq entries, or zone_log-off
        zones minting equal seqs) must still order the same way
        everywhere, or max() picks by iteration order and the OLH
        repoint becomes load-order-dependent."""
        o = ent.get("oseq")
        if o:
            return (int(o[0]), str(o[1]), str(ent.get("vid", "")))
        return (int(ent.get("seq", 0)), "", str(ent.get("vid", "")))

    def _ver_omap(self, bucket: str, prefix: str) -> dict:
        from ceph_tpu_torch.client.rados import RadosError
        try:
            return self.io.omap_get(self._ver_oid(bucket),
                                    prefix=prefix)
        except RadosError as exc:
            if exc.code == -2:
                return {}              # never versioned: no omap yet
            raise

    def _ver_entries(self, bucket: str, key: str) -> dict[str, dict]:
        """{vid: meta} for every recorded generation of ``key``."""
        page = self._ver_omap(bucket, f"{key}\x00")
        return {json.loads(v)["vid"]: json.loads(v)
                for v in page.values()}

    def _ver_put_entry(self, bucket: str, key: str,
                       meta: dict) -> None:
        self.io.omap_set(
            self._ver_oid(bucket),
            {f"{key}\x00{meta['vid']}": json.dumps(meta).encode()})

    def _ver_rm_entry(self, bucket: str, key: str, vid: str) -> None:
        self.io.omap_rm_keys(self._ver_oid(bucket), [f"{key}\x00{vid}"])

    def _preserve_null_version(self, bucket: str, key: str) -> None:
        """First versioned mutation of a pre-versioning key: record
        its existing generation as the 'null' version so it survives
        (S3: enabling versioning never destroys data)."""
        ent = self.list_objects(bucket, prefix=key).get(key)
        if ent is None or ent.get("vid"):
            return
        if "null" in self._ver_entries(bucket, key):
            return
        import time as _t
        self._ver_put_entry(bucket, key, {
            "vid": "null", "seq": 0, "size": ent["size"],
            "etag": ent["etag"],
            # a legacy entry without mtime gets preserved-at time:
            # stamping 0.0 would let the first noncurrent-expiry
            # lifecycle pass reap the very data this preserves
            "mtime": ent.get("mtime") or _t.time(),
            "dm": False})

    # -- objects -------------------------------------------------------
    def put_object(self, bucket: str, key: str, data: bytes,
                   etag: str | None = None, _log: bool = True,
                   acl: str | None = None, owner: str | None = None,
                   version_id: str | None = None,
                   pair: list | None = None,
                   origin: str | None = None,
                   oseq: list | None = None) -> str | None:
        """``etag`` overrides the computed md5 (replication must
        carry the SOURCE etag — multipart objects have 'md5-N' etags
        a re-hash cannot reproduce); ``_log=False`` suppresses the
        replication-log entry for internal writes that log once
        themselves (multipart complete). On a versioning-enabled
        bucket every put mints a new version (``version_id``
        overrides the minted id — the sync agent preserves source
        ids); on a suspended bucket puts overwrite the 'null'
        version. Returns the etag; the assigned version id is left in
        ``self.last_version_id``."""
        self._check_bucket(bucket)
        if acl is not None and acl not in CANNED_ACLS:
            raise RGWError(400, "InvalidArgument")
        status = self.get_versioning(bucket)
        self.last_version_id = None
        if etag is None:
            etag = hashlib.md5(data).hexdigest()
        applied_pair = None
        if self.zone_log and status is None:
            # multisite conflict state (unversioned path; versioned
            # buckets converge on the GENERATION SET instead — vids
            # are unique, every zone accumulates every generation)
            applied_pair = self._advance_pair(bucket, key, pair)
            if applied_pair is None and pair is not None:
                return None        # remote mutation lost the conflict
        if status is not None:
            self._preserve_null_version(bucket, key)
            if oseq is not None:
                # replicated generation: adopt the ORIGIN's order pair
                # and raise the local allocator past it (Lamport)
                self._bump_vseq(bucket, int(oseq[0]))
                seq = self._alloc_vseq(bucket)
            else:
                seq = self._alloc_vseq(bucket)
                oseq = [seq, self.zone if self.zone_log else ""]
            # multisite zones qualify minted ids with the zone name:
            # two zones' per-bucket seq counters would otherwise mint
            # COLLIDING ids for concurrently-created generations
            suffix = f"-{self.zone}" if self.zone_log else ""
            vid = version_id or (f"v{seq:012d}{suffix}"
                                 if status == "Enabled" else "null")
            doid = self._ver_data_oid(bucket, key, vid)
            self._remove_striped(doid)
            so = StripedObject(self.io, doid, self._layout)
            if data:
                so.write(data)
            import time as _t
            mtime = _t.time()
            ent = {"vid": vid, "seq": seq, "size": len(data),
                   "etag": etag, "mtime": mtime, "dm": False,
                   "oseq": [int(oseq[0]), str(oseq[1])]}
            # acl/owner ride the generation record so a resurfaced
            # older generation keeps its object ACL (reindex restores
            # from here)
            if acl is not None:
                ent["acl"] = acl
            if owner is not None:
                ent["owner"] = owner
            self._ver_put_entry(bucket, key, ent)
            # repoint the main index ONLY when this generation wins
            # the deterministic order — a replicated older generation
            # must not displace a newer current (the OLH update rule)
            ents = self._ver_entries(bucket, key)
            # compare by VID, not object identity: on a _gen_order tie
            # an identity check against whatever max() happened to
            # return first silently skipped the repoint
            if max(ents.values(),
                   key=self._gen_order).get("vid") == vid:
                self._index_add(bucket, key, len(data), etag,
                                mtime=mtime, acl=acl, owner=owner,
                                vid=vid)
            self.last_version_id = vid
            if _log:
                self._log_mutation(bucket, "put", key, etag, vid=vid,
                                   origin=origin, oseq=oseq)
            return etag
        self._remove_striped(f"{bucket}/{key}")  # replace semantics
        so = StripedObject(self.io, f"{bucket}/{key}", self._layout)
        if data:
            so.write(data)
        self._index_add(bucket, key, len(data), etag,
                        acl=acl, owner=owner)
        if _log:
            self._log_mutation(bucket, "put", key, etag,
                               pair=applied_pair, origin=origin)
        return etag

    def get_object(self, bucket: str, key: str,
                   version_id: str | None = None
                   ) -> tuple[bytes, dict]:
        self._check_bucket(bucket)
        if version_id is not None:
            ent = self._ver_entries(bucket, key).get(version_id)
            if ent is None:
                raise RGWError(404, "NoSuchVersion")
            if ent.get("dm"):
                raise RGWError(405, "MethodNotAllowed")
            so = StripedObject(
                self.io, self._ver_data_oid(bucket, key, version_id))
            return so.read(), ent
        idx = self.list_objects(bucket, prefix=key)
        meta = idx.get(key)
        if meta is None:
            raise RGWError(404, "NoSuchKey")
        doid = self._ver_data_oid(bucket, key, meta["vid"]) \
            if meta.get("vid") else f"{bucket}/{key}"
        so = StripedObject(self.io, doid)
        return so.read(), meta

    def delete_object(self, bucket: str, key: str,
                      version_id: str | None = None,
                      _log: bool = True,
                      _marker_vid: str | None = None,
                      pair: list | None = None,
                      origin: str | None = None,
                      oseq: list | None = None) -> str | None:
        """Unversioned: remove for good. Versioning enabled, no
        version_id: lay a DELETE MARKER (the data stays; GETs 404
        until the marker is deleted). With version_id: permanently
        remove that generation; removing the current one surfaces the
        next-newest. Returns the delete-marker version id when one
        was created."""
        self._check_bucket(bucket)
        status = self.get_versioning(bucket)
        if status is None and version_id is None:
            applied_pair = None
            if self.zone_log:
                if pair is None and \
                        self.list_objects(bucket,
                                          prefix=key).get(key) is None:
                    # a failed LOCAL delete must not mint a tombstone
                    # pair: the phantom tombstone would silently veto
                    # replicated puts on this zone only — divergence
                    raise RGWError(404, "NoSuchKey")
                applied_pair = self._advance_pair(bucket, key, pair)
                if applied_pair is None and pair is not None:
                    # remote delete lost the conflict: a newer local
                    # write keeps the object. Distinguishable from
                    # success so the sync agent's applied count stays
                    # truthful (only the agent ever passes a pair)
                    raise RGWError(409, "RemoteStale")
            self._index_rm(bucket, key)
            self._remove_striped(f"{bucket}/{key}")
            if _log:
                self._log_mutation(bucket, "del", key,
                                   pair=applied_pair, origin=origin)
            return None
        if status is None:
            raise RGWError(400, "InvalidArgument")
        if version_id is None:
            # delete marker (rgw_op.cc RGWDeleteObj versioned path;
            # S3 lays one even for a nonexistent key). On a SUSPENDED
            # bucket the marker takes version id 'null', overwriting
            # any null generation — repeated deletes must not
            # accumulate marker entries
            self._preserve_null_version(bucket, key)
            if oseq is not None:
                self._bump_vseq(bucket, int(oseq[0]))
                seq = self._alloc_vseq(bucket)
            else:
                seq = self._alloc_vseq(bucket)
                oseq = [seq, self.zone if self.zone_log else ""]
            suffix = f"-{self.zone}" if self.zone_log else ""
            vid = _marker_vid or (
                "null" if status == "Suspended"
                else f"v{seq:012d}{suffix}")
            if vid == "null":
                old = self._ver_entries(bucket, key).get("null")
                if old is not None and not old.get("dm"):
                    self._remove_striped(self._ver_data_oid(
                        bucket, key, "null"))
            self._ver_put_entry(bucket, key, {
                "vid": vid, "seq": seq, "size": 0, "etag": "",
                "mtime": __import__("time").time(), "dm": True,
                "oseq": [int(oseq[0]), str(oseq[1])]})
            # the marker hides the key ONLY when it wins the
            # deterministic order (a replicated marker concurrent
            # with a newer put must not shadow it — the OLH rule)
            ents = self._ver_entries(bucket, key)
            newest = max(ents.values(), key=self._gen_order)
            if newest.get("vid") == vid:
                try:
                    self._index_rm(bucket, key)
                except RGWError:
                    pass
            if _log:
                self._log_mutation(bucket, "dm", key, vid=vid,
                                   origin=origin, oseq=oseq)
            return vid
        # permanent delete of one generation
        ents = self._ver_entries(bucket, key)
        ent = ents.get(version_id)
        if ent is None:
            raise RGWError(404, "NoSuchVersion")
        if not ent.get("dm"):
            self._remove_striped(self._ver_data_oid(
                bucket, key, version_id))
        self._ver_rm_entry(bucket, key, version_id)
        del ents[version_id]
        cur = self.list_objects(bucket, prefix=key).get(key)
        cur_vid = (cur or {}).get("vid") or \
            ("null" if cur is not None else None)
        if cur_vid == version_id:
            # the visible generation died: surface the next-newest
            # non-marker one, or nothing
            self._reindex_current(bucket, key, ents)
        elif cur is None and ent.get("dm"):
            # removed a delete marker: if it was the newest entry the
            # key resurfaces (reindex picks the newest non-marker)
            self._reindex_current(bucket, key, ents)
        if _log:
            self._log_mutation(bucket, "delver", key,
                               vid=version_id, origin=origin)
        return None

    def _reindex_current(self, bucket: str, key: str,
                         ents: dict[str, dict]) -> None:
        """Point the main index at the newest remaining non-marker
        generation (or drop the key when a marker — or nothing — is
        newest)."""
        try:
            self._index_rm(bucket, key)
        except RGWError:
            pass
        if not ents:
            return
        newest = max(ents.values(), key=self._gen_order)
        if newest.get("dm"):
            return
        self._index_add(bucket, key, newest["size"], newest["etag"],
                        mtime=newest.get("mtime"), vid=newest["vid"],
                        acl=newest.get("acl"),
                        owner=newest.get("owner"))

    def list_versions(self, bucket: str, prefix: str = "") -> list:
        """Every generation of every key (newest first per key) —
        ListObjectVersions role. Unversioned-era objects appear as
        vid 'null' only once the key has a versioned mutation."""
        self._check_bucket(bucket)
        if self._bucket_fmt(bucket) != "omap":
            return []
        page = self._ver_omap(bucket, prefix)
        by_key: dict[str, list] = {}
        for k, v in page.items():
            key = k.split("\x00", 1)[0]
            by_key.setdefault(key, []).append(json.loads(v))
        out = []
        for key in sorted(by_key):
            # IsLatest = the newest generation by seq — a delete
            # marker that is newest IS the latest (it just hides the
            # key from plain listings)
            latest = max(by_key[key], key=self._gen_order)
            for ent in sorted(by_key[key], key=self._gen_order,
                              reverse=True):
                out.append({"key": key, **ent,
                            "is_current": ent is latest})
        return out

    def list_objects(self, bucket: str, prefix: str = "",
                     max_keys: int = 1000, marker: str = "") -> dict:
        self._check_bucket(bucket)
        return self._index_list(bucket, prefix, max_keys, marker)

    # -- lifecycle config (src/rgw/rgw_lc.cc RGWLifecycleConfiguration)
    def set_lifecycle(self, bucket: str, rules: list[dict]) -> None:
        """rules: [{"id", "prefix", "status", "days",
        "noncurrent_days"}] — current-version expiry after ``days``,
        noncurrent-generation expiry after ``noncurrent_days``."""
        for r in rules:
            if r.get("status", "Enabled") not in ("Enabled",
                                                  "Disabled"):
                raise RGWError(400, "MalformedXML")
            if not (r.get("days") or r.get("noncurrent_days")):
                raise RGWError(400, "MalformedXML")
        self._update_bucket_meta(bucket, lifecycle=rules)

    def get_lifecycle(self, bucket: str) -> list[dict]:
        rules = self.bucket_meta(bucket).get("lifecycle")
        if not rules:
            raise RGWError(404, "NoSuchLifecycleConfiguration")
        return rules

    def delete_lifecycle(self, bucket: str) -> None:
        self._update_bucket_meta(bucket, lifecycle=None)

    # -- multipart uploads (src/rgw/rgw_multi.cc roles) ----------------
    # Parts land as independent striped objects under a hidden
    # .multipart prefix; complete stitches them into the final object
    # and computes the S3 multipart etag (md5-of-binary-md5s "-N").

    def _mp_oid(self, bucket: str, key: str, upload_id: str,
                part: int | None = None) -> str:
        base = f".multipart.{bucket}/{key}/{upload_id}"
        return base if part is None else f"{base}.{part:05d}"

    def _mp_meta(self, bucket: str, key: str, upload_id: str) -> dict:
        try:
            return json.loads(self.io.read(
                self._mp_oid(bucket, key, upload_id)))
        except Exception:
            raise RGWError(404, "NoSuchUpload") from None

    def initiate_multipart(self, bucket: str, key: str) -> str:
        self._check_bucket(bucket)
        import secrets
        upload_id = secrets.token_hex(16)
        moid = self._mp_oid(bucket, key, upload_id)
        self.io.write_full(moid, json.dumps({"key": key,
                                             "parts": {}}).encode())
        if self._bucket_fmt(bucket) == "omap":
            # liveness marker for the upload_part guard: an aborted
            # upload's meta object is gone, so a guarded part record
            # fails ATOMICALLY instead of resurrecting the object
            self.io.setxattr(moid, "mp", b"1")
        return upload_id

    def upload_part(self, bucket: str, key: str, upload_id: str,
                    part_number: int, data: bytes) -> str:
        if not 1 <= part_number <= 10000:
            raise RGWError(400, "InvalidArgument")
        self._mp_meta(bucket, key, upload_id)   # NoSuchUpload check
        poid = self._mp_oid(bucket, key, upload_id, part_number)
        StripedObject(self.io, poid).remove()
        so = StripedObject(self.io, poid, self._layout)
        if data:
            so.write(data)
        etag = hashlib.md5(data).hexdigest()
        # record the part ATOMICALLY: concurrent part uploads must not
        # lose each other. Omap pools write one omap key per part (the
        # reference's cls_rgw-over-omap discipline); EC pools use the
        # atomic in-OSD cls method over the meta blob.
        from ceph_tpu_torch.client.rados import RadosError
        from ceph_tpu_torch.parallel import messages as _M
        moid = self._mp_oid(bucket, key, upload_id)
        try:
            if self._bucket_fmt(bucket) == "omap":
                # guard on the liveness marker: the guard+omap_set
                # pair evaluates atomically under the PG lock, so a
                # racing abort (which removes the meta object) makes
                # this fail instead of the OMAPSET's implicit touch
                # resurrecting the upload
                self.io.omap_set(
                    moid, {f"{part_number:05d}": json.dumps(
                        {"size": len(data), "etag": etag}).encode()},
                    guard=("mp", _M.CMPXATTR_EQ, b"1"))
            else:
                self.io.execute(
                    moid, "rgw", "mp_add_part",
                    json.dumps({"part": part_number,
                                "size": len(data),
                                "etag": etag}).encode())
        except RadosError as exc:
            if exc.code in (-2, -125):    # ENOENT / guard miss
                raise RGWError(404, "NoSuchUpload") from None
            raise
        return etag

    def _mp_parts(self, bucket: str, key: str,
                  upload_id: str) -> dict:
        """{str(part_number): {"size", "etag"}} for the upload
        (raises NoSuchUpload when the meta object is gone)."""
        meta = self._mp_meta(bucket, key, upload_id)
        if self._bucket_fmt(bucket) != "omap":
            return meta["parts"]
        omap = self.io.omap_get(self._mp_oid(bucket, key, upload_id))
        return {str(int(k)): json.loads(v) for k, v in omap.items()}

    def list_parts(self, bucket: str, key: str,
                   upload_id: str) -> dict:
        return self._mp_parts(bucket, key, upload_id)

    def complete_multipart(self, bucket: str, key: str, upload_id: str,
                           parts: list[tuple[int, str]]) -> str:
        """``parts``: the client's (part_number, etag) manifest — must
        match what was uploaded, ascending (S3 CompleteMultipart)."""
        have = self._mp_parts(bucket, key, upload_id)
        nums = [p for p, _ in parts]
        if not parts or any(b <= a for a, b in zip(nums, nums[1:])):
            # strictly ascending, unique (S3 InvalidPartOrder —
            # duplicates would stitch the same bytes twice)
            raise RGWError(400, "InvalidPartOrder")
        digests = b""
        for num, etag in parts:
            ent = have.get(str(num))
            if ent is None or ent["etag"].strip('"') != etag.strip('"'):
                raise RGWError(400, "InvalidPart")
            digests += bytes.fromhex(ent["etag"])
        # stitch: read parts in order, write the final object through
        # the normal put path (bucket index updates atomically)
        body = b"".join(
            StripedObject(self.io,
                          self._mp_oid(bucket, key, upload_id,
                                       num)).read()
            for num, _ in parts)
        self.put_object(bucket, key, body, _log=False)
        vid = self.last_version_id
        final_etag = (hashlib.md5(digests).hexdigest()
                      + f"-{len(parts)}")
        # the S3 multipart etag replaces the plain-md5 one — in the
        # index entry AND (versioned buckets) the generation record,
        # keeping the vid pointer so GETs keep reading the versioned
        # data object and replication carries the multipart etag
        self._index_add(bucket, key, len(body), final_etag, vid=vid)
        if vid:
            ent = self._ver_entries(bucket, key).get(vid)
            if ent is not None:
                ent["etag"] = final_etag
                self._ver_put_entry(bucket, key, ent)
        self._log_mutation(bucket, "put", key, final_etag, vid=vid)
        self.abort_multipart(bucket, key, upload_id)
        return final_etag

    def abort_multipart(self, bucket: str, key: str,
                        upload_id: str) -> None:
        for num in self._mp_parts(bucket, key, upload_id):
            StripedObject(self.io, self._mp_oid(bucket, key, upload_id,
                                                int(num))).remove()
        try:
            self.io.remove(self._mp_oid(bucket, key, upload_id))
        except Exception:
            pass


def _xml_escape(v: str) -> str:
    return (v.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def _xml_buckets(names: list[str]) -> bytes:
    items = "".join(
        f"<Bucket><Name>{_xml_escape(n)}</Name></Bucket>"
        for n in names)
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f"<ListAllMyBucketsResult><Owner><ID>ceph-tpu</ID></Owner>"
            f"<Buckets>{items}</Buckets>"
            f"</ListAllMyBucketsResult>").encode()


def _xml_listing(bucket: str, prefix: str, max_keys: int,
                 idx: dict, truncated: bool, marker: str) -> bytes:
    items = "".join(
        f"<Contents><Key>{_xml_escape(k)}</Key>"
        f"<Size>{m['size']}</Size>"
        f"<ETag>&quot;{m['etag']}&quot;</ETag></Contents>"
        for k, m in sorted(idx.items()))
    flag = "true" if truncated else "false"
    next_marker = (f"<NextMarker>{_xml_escape(max(idx))}</NextMarker>"
                   if truncated and idx else "")
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f"<ListBucketResult><Name>{_xml_escape(bucket)}</Name>"
            f"<Prefix>{_xml_escape(prefix)}</Prefix>"
            f"<Marker>{_xml_escape(marker)}</Marker>"
            f"<MaxKeys>{max_keys}</MaxKeys>"
            f"<IsTruncated>{flag}</IsTruncated>{next_marker}{items}"
            f"</ListBucketResult>").encode()


def _xml_initiate(bucket: str, key: str, upload_id: str) -> bytes:
    return (f"<InitiateMultipartUploadResult>"
            f"<Bucket>{_xml_escape(bucket)}</Bucket>"
            f"<Key>{_xml_escape(key)}</Key>"
            f"<UploadId>{upload_id}</UploadId>"
            f"</InitiateMultipartUploadResult>").encode()


def _xml_complete(bucket: str, key: str, etag: str) -> bytes:
    return (f"<CompleteMultipartUploadResult>"
            f"<Bucket>{_xml_escape(bucket)}</Bucket>"
            f"<Key>{_xml_escape(key)}</Key>"
            f'<ETag>"{etag}"</ETag>'
            f"</CompleteMultipartUploadResult>").encode()


def _xml_parts(bucket: str, key: str, upload_id: str,
               parts: dict) -> bytes:
    rows = "".join(
        f"<Part><PartNumber>{n}</PartNumber>"
        f'<ETag>"{p["etag"]}"</ETag><Size>{p["size"]}</Size></Part>'
        for n, p in sorted(parts.items(), key=lambda kv: int(kv[0])))
    return (f"<ListPartsResult><Bucket>{_xml_escape(bucket)}</Bucket>"
            f"<Key>{_xml_escape(key)}</Key>"
            f"<UploadId>{upload_id}</UploadId>{rows}"
            f"</ListPartsResult>").encode()


def _parse_complete_xml(body: bytes) -> list[tuple[int, str]]:
    """Parse the CompleteMultipartUpload manifest (PartNumber/ETag
    pairs, document order) — real XML parsing so every quoting/escape
    style (&quot;, ", bare) resolves uniformly."""
    import xml.etree.ElementTree as ET
    try:
        root = ET.fromstring(body.decode())
    except Exception:
        return []
    parts = []
    # namespace-blind matching: real S3 clients (boto3) stamp the
    # document with xmlns="http://s3.amazonaws.com/doc/2006-03-01/",
    # which ElementTree folds into every tag name
    for p in root.iter():
        if p.tag.rsplit("}", 1)[-1] != "Part":
            continue
        num = etag = None
        for child in p:
            tag = child.tag.rsplit("}", 1)[-1]
            if tag == "PartNumber":
                num = child.text
            elif tag == "ETag":
                etag = (child.text or "").strip().strip('"')
        if num:
            try:
                parts.append((int(num), etag or ""))
            except ValueError:
                return []
    return parts


def _xml_error(code: str, message: str) -> bytes:
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f"<Error><Code>{_xml_escape(code)}</Code>"
            f"<Message>{_xml_escape(message)}</Message>"
            f"</Error>").encode()


def _xml_versioning(status: str | None) -> bytes:
    inner = f"<Status>{status}</Status>" if status else ""
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f"<VersioningConfiguration>{inner}"
            f"</VersioningConfiguration>").encode()


def _xml_versions(bucket: str, entries: list) -> bytes:
    rows = []
    for e in entries:
        tag = "DeleteMarker" if e.get("dm") else "Version"
        latest = "true" if e["is_current"] else "false"
        size = f"<Size>{e['size']}</Size>" if not e.get("dm") else ""
        etag = (f"<ETag>&quot;{e['etag']}&quot;</ETag>"
                if not e.get("dm") else "")
        rows.append(
            f"<{tag}><Key>{_xml_escape(e['key'])}</Key>"
            f"<VersionId>{e['vid']}</VersionId>"
            f"<IsLatest>{latest}</IsLatest>{size}{etag}</{tag}>")
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f"<ListVersionsResult><Name>{_xml_escape(bucket)}</Name>"
            f"{''.join(rows)}</ListVersionsResult>").encode()


def _xml_lifecycle(rules: list[dict]) -> bytes:
    rows = []
    for r in rules:
        exp = (f"<Expiration><Days>{r['days']}</Days></Expiration>"
               if r.get("days") else "")
        nce = (f"<NoncurrentVersionExpiration><NoncurrentDays>"
               f"{r['noncurrent_days']}</NoncurrentDays>"
               f"</NoncurrentVersionExpiration>"
               if r.get("noncurrent_days") else "")
        rows.append(
            f"<Rule><ID>{_xml_escape(r.get('id', ''))}</ID>"
            f"<Filter><Prefix>{_xml_escape(r.get('prefix', ''))}"
            f"</Prefix></Filter>"
            f"<Status>{r.get('status', 'Enabled')}</Status>"
            f"{exp}{nce}</Rule>")
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f"<LifecycleConfiguration>{''.join(rows)}"
            f"</LifecycleConfiguration>").encode()


def _xml_acl(owner: str, acl: str) -> bytes:
    """Canned ACL rendered as an AccessControlPolicy document (the
    grants a canned ACL expands to in rgw_acl_s3.cc)."""
    grants = [f"<Grant><Grantee><ID>{_xml_escape(owner)}</ID>"
              f"</Grantee><Permission>FULL_CONTROL</Permission>"
              f"</Grant>"]
    if acl in ("public-read", "public-read-write"):
        grants.append("<Grant><Grantee><URI>http://acs.amazonaws.com"
                      "/groups/global/AllUsers</URI></Grantee>"
                      "<Permission>READ</Permission></Grant>")
    if acl == "public-read-write":
        grants.append("<Grant><Grantee><URI>http://acs.amazonaws.com"
                      "/groups/global/AllUsers</URI></Grantee>"
                      "<Permission>WRITE</Permission></Grant>")
    if acl == "authenticated-read":
        grants.append("<Grant><Grantee><URI>http://acs.amazonaws.com"
                      "/groups/global/AuthenticatedUsers</URI>"
                      "</Grantee><Permission>READ</Permission>"
                      "</Grant>")
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f"<AccessControlPolicy><Owner><ID>{_xml_escape(owner)}"
            f"</ID></Owner><AccessControlList>{''.join(grants)}"
            f"</AccessControlList></AccessControlPolicy>").encode()


def _xml_find(body: bytes, tag: str) -> list[str]:
    """All text values of ``tag`` anywhere in the document,
    namespace-blind (the S3-client xmlns folds into tag names)."""
    import xml.etree.ElementTree as ET
    try:
        root = ET.fromstring(body.decode())
    except Exception:
        return []
    out = []
    for el in root.iter():
        if el.tag.rsplit("}", 1)[-1] == tag:
            out.append((el.text or "").strip())
    return out


def _parse_lifecycle_xml(body: bytes) -> list[dict]:
    import xml.etree.ElementTree as ET
    try:
        root = ET.fromstring(body.decode())
    except Exception:
        raise RGWError(400, "MalformedXML") from None
    rules = []
    for el in root.iter():
        if el.tag.rsplit("}", 1)[-1] != "Rule":
            continue
        r: dict = {}
        for sub in el.iter():
            tag = sub.tag.rsplit("}", 1)[-1]
            text = (sub.text or "").strip()
            if tag == "ID":
                r["id"] = text
            elif tag == "Prefix":
                r["prefix"] = text
            elif tag == "Status":
                r["status"] = text
            elif tag in ("Days", "NoncurrentDays"):
                try:
                    days = float(text)
                except ValueError:
                    raise RGWError(400, "MalformedXML") from None
                if days <= 0:
                    raise RGWError(400, "MalformedXML")
                r["days" if tag == "Days"
                  else "noncurrent_days"] = days
        rules.append(r)
    if not rules:
        raise RGWError(400, "MalformedXML")
    return rules


# -- AWS Signature Version 4 (S3 request signing) ----------------------

def _sigv4_key(secret: str, date: str, region: str,
               service: str) -> bytes:
    k = hmac.new(("AWS4" + secret).encode(), date.encode(),
                 hashlib.sha256).digest()
    for part in (region, service, "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    return k


def _canonical_query(query: str) -> str:
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    return "&".join(
        f"{urllib.parse.quote(k, safe='')}="
        f"{urllib.parse.quote(v, safe='')}"
        for k, v in sorted(pairs))


def sign_request(method: str, path: str, query: str,
                 headers: dict[str, str], payload: bytes,
                 access_key: str, secret: str,
                 region: str = "default") -> dict[str, str]:
    """Client-side SigV4: returns the headers to add (Authorization,
    x-amz-date, x-amz-content-sha256). ``headers`` must already hold
    Host."""
    import time as _t
    amz_date = _t.strftime("%Y%m%dT%H%M%SZ", _t.gmtime())
    date = amz_date[:8]
    payload_hash = hashlib.sha256(payload).hexdigest()
    all_h = {k.lower(): v.strip() for k, v in headers.items()}
    all_h["x-amz-date"] = amz_date
    all_h["x-amz-content-sha256"] = payload_hash
    signed = ";".join(sorted(all_h))
    canonical = "\n".join([
        method,
        urllib.parse.quote(path),
        _canonical_query(query),
        "".join(f"{k}:{all_h[k]}\n" for k in sorted(all_h)),
        signed,
        payload_hash,
    ])
    scope = f"{date}/{region}/s3/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])
    sig = hmac.new(_sigv4_key(secret, date, region, "s3"),
                   to_sign.encode(), hashlib.sha256).hexdigest()
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}"),
    }


def verify_sigv4(handler, auth: dict[str, str],
                 payload: bytes) -> str:
    """Server side: recompute the signature from the request and the
    stored secret; raises RGWError(403) on any mismatch. Returns the
    authenticated access key (the request's identity for ACLs)."""
    hdr = handler.headers.get("Authorization", "")
    if not hdr.startswith("AWS4-HMAC-SHA256 "):
        raise RGWError(403, "AccessDenied")
    try:
        fields = dict(
            part.strip().split("=", 1)
            for part in hdr[len("AWS4-HMAC-SHA256 "):].split(","))
        access, date, region, service, _ = \
            fields["Credential"].split("/")
        signed = fields["SignedHeaders"].split(";")
        given_sig = fields["Signature"]
    except (KeyError, ValueError):
        raise RGWError(403, "AccessDenied") from None
    secret = auth.get(access)
    if secret is None:
        raise RGWError(403, "InvalidAccessKeyId")
    amz_date = handler.headers.get("x-amz-date", "")
    import calendar
    import time as _t
    try:
        ts = calendar.timegm(_t.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
    except ValueError:
        raise RGWError(403, "AccessDenied") from None
    if abs(_t.time() - ts) > 900:
        # AWS's ~15-minute skew window: without it every captured
        # signed request (incl. DELETEs) replays forever
        raise RGWError(403, "RequestTimeTooSkewed")
    payload_hash = handler.headers.get("x-amz-content-sha256", "")
    if hashlib.sha256(payload).hexdigest() != payload_hash:
        raise RGWError(403, "XAmzContentSHA256Mismatch")
    parsed = urllib.parse.urlparse(handler.path)
    canon_h = ""
    for k in signed:
        v = handler.headers.get(k, "")
        canon_h += f"{k}:{v.strip()}\n"
    canonical = "\n".join([
        handler.command,
        urllib.parse.quote(urllib.parse.unquote(parsed.path)),
        _canonical_query(parsed.query),
        canon_h,
        ";".join(signed),
        payload_hash,
    ])
    scope = f"{date}/{region}/{service}/aws4_request"
    to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical.encode()).hexdigest()])
    want = hmac.new(_sigv4_key(secret, date, region, service),
                    to_sign.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, given_sig):
        raise RGWError(403, "SignatureDoesNotMatch")
    return access


class _Handler(BaseHTTPRequestHandler):
    gw: RGWGateway = None          # set by server factory
    auth: dict[str, str] | None = None   # access_key -> secret
    #: Swift TempAuth token table (token -> (account, expiry)); per
    #: server instance (the bound subclass carries its own dict)
    swift_tokens: dict = None
    SWIFT_TOKEN_TTL = 3600.0

    # -- Swift REST dialect (src/rgw/rgw_rest_swift.cc role) ----------
    # The same buckets/objects the S3 dialect serves, exposed under
    # /v1/AUTH_<account>/<container>/<object> with TempAuth
    # (/auth/v1.0) — exactly how radosgw fronts one store with both
    # APIs. Containers map 1:1 onto buckets.

    def _swift_reply(self, status: int, body: bytes = b"",
                     headers: dict | None = None,
                     ctype: str = "text/plain; charset=utf-8") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for kk, vv in (headers or {}).items():
            self.send_header(kk, vv)
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _swift_auth_req(self) -> None:
        """GET /auth/v1.0 (TempAuth): X-Auth-User 'account:user' +
        X-Auth-Key -> X-Auth-Token + X-Storage-Url."""
        user = self.headers.get("X-Auth-User", "")
        key = self.headers.get("X-Auth-Key", "")
        account = user.split(":", 1)[0]
        if self.auth is not None:
            if not account or self.auth.get(account) != key:
                self._swift_reply(401, b"Unauthorized")
                return
        account = account or "anon"
        import secrets
        import time as _t
        now = _t.time()
        with self.swift_lock:
            if len(self.swift_tokens) > 1024:
                # reap expired tokens (a per-request re-authenticator
                # must not grow the table unboundedly); under the lock
                # — ThreadingHTTPServer inserts concurrently
                for tk in [tk for tk, (_a, exp) in
                           list(self.swift_tokens.items())
                           if exp < now]:
                    self.swift_tokens.pop(tk, None)
            token = "AUTH_tk" + secrets.token_hex(16)
            self.swift_tokens[token] = (account,
                                        now + self.SWIFT_TOKEN_TTL)
        host = self.headers.get("Host", "localhost")
        self._swift_reply(200, b"", headers={
            "X-Auth-Token": token,
            "X-Storage-Token": token,
            "X-Storage-Url": f"http://{host}/v1/AUTH_{account}",
        })

    def _swift_check_token(self) -> bool:
        if self.auth is None:
            return True                 # open server: token optional
        import time as _t
        token = self.headers.get("X-Auth-Token", "")
        with self.swift_lock:
            ent = self.swift_tokens.get(token)
            if ent is None or ent[1] < _t.time():
                self.swift_tokens.pop(token, None)
                self._swift_reply(401, b"Unauthorized")
                return False
        # account isolation: the token only authorizes ITS account's
        # /v1/AUTH_<acct> namespace (TempAuth semantics) — a valid
        # token for account a must not read/write AUTH_b
        parts = urllib.parse.urlparse(self.path).path.lstrip(
            "/").split("/", 2)
        url_acct = parts[1][len("AUTH_"):] if len(parts) > 1 else ""
        if url_acct != ent[0]:
            self._swift_reply(403, b"Forbidden")
            return False
        return True

    def _swift_split(self) -> tuple[str, str, dict]:
        """/v1/AUTH_<acct>[/container[/object...]] -> (container,
        object, query)."""
        parsed = urllib.parse.urlparse(self.path)
        parts = parsed.path.lstrip("/").split("/", 3)
        # parts[0] = 'v1', parts[1] = 'AUTH_<acct>'
        cont = urllib.parse.unquote(parts[2]) if len(parts) > 2 else ""
        obj = urllib.parse.unquote(parts[3]) if len(parts) > 3 else ""
        q = dict(urllib.parse.parse_qsl(parsed.query,
                                        keep_blank_values=True))
        return cont, obj, q

    def _swift_dispatch(self, method: str, payload: bytes) -> bool:
        """Route Swift-dialect paths; returns True when handled."""
        path = urllib.parse.urlparse(self.path).path
        if path.startswith("/auth/v1.0"):
            if method == "GET":
                self._swift_auth_req()
            else:
                self._swift_reply(405, b"Method Not Allowed")
            return True
        # only the Swift account shape routes here: /v1/AUTH_<acct>.
        # A plain S3 bucket literally named 'v1' keeps working (its
        # keys don't start with AUTH_); only /v1/AUTH_* is reserved,
        # like the reference's swift url prefix.
        parts = path.lstrip("/").split("/", 2)
        if not (parts[0] == "v1" and len(parts) > 1
                and parts[1].startswith("AUTH_")):
            return False
        if not self._swift_check_token():
            return True
        try:
            self._swift_op(method, payload)
        except RGWError as exc:
            status = exc.status
            if str(exc) in ("NoSuchBucket", "NoSuchKey"):
                status = 404
            self._swift_reply(status, str(exc).encode())
        except Exception as exc:  # pragma: no cover
            self._swift_reply(500, repr(exc).encode())
        return True

    def _swift_op(self, method: str, payload: bytes) -> None:
        cont, obj, q = self._swift_split()
        gw = self.gw
        fmt = q.get("format", "")
        if not cont:                      # account level
            if method in ("GET", "HEAD"):
                names = gw.list_buckets()
                if method == "HEAD":
                    self._swift_reply(204, b"", headers={
                        "X-Account-Container-Count": str(len(names))})
                    return
                if fmt == "json":
                    out = []
                    for n in names:
                        cnt, used = gw.container_stats(n)
                        out.append({"name": n, "count": cnt,
                                    "bytes": used})
                    self._swift_reply(200, json.dumps(out).encode(),
                                      ctype="application/json")
                else:
                    body = "".join(f"{n}\n" for n in names).encode()
                    self._swift_reply(200 if body else 204, body)
            else:
                self._swift_reply(405, b"Method Not Allowed")
            return
        if not obj:                       # container level
            if method == "PUT":
                existed = cont in gw.list_buckets()
                gw.create_bucket(cont)
                self._swift_reply(202 if existed else 201)
            elif method == "DELETE":
                gw.delete_bucket(cont)
                self._swift_reply(204)
            elif method == "HEAD":
                cnt, used = gw.container_stats(cont)
                self._swift_reply(204, b"", headers={
                    "X-Container-Object-Count": str(cnt),
                    "X-Container-Bytes-Used": str(used)})
            elif method == "GET":
                gw._check_bucket(cont)
                try:
                    limit = int(q.get("limit", "") or 10000)
                    if limit < 0:
                        raise ValueError
                except ValueError:
                    raise RGWError(412, "Bad limit") from None
                idx = gw.list_objects(cont, prefix=q.get("prefix", ""),
                                      max_keys=limit,
                                      marker=q.get("marker", ""))
                if fmt == "json":
                    out = [{"name": kk, "bytes": vv["size"],
                            "hash": vv["etag"]}
                           for kk, vv in sorted(idx.items())]
                    self._swift_reply(200, json.dumps(out).encode(),
                                      ctype="application/json")
                else:
                    body = "".join(f"{kk}\n"
                                   for kk in sorted(idx)).encode()
                    self._swift_reply(200 if body else 204, body)
            else:
                self._swift_reply(405, b"Method Not Allowed")
            return
        # object level
        if method == "PUT":
            etag = gw.put_object(cont, obj, payload)
            self._swift_reply(201, b"", headers={"ETag": etag})
        elif method == "GET":
            data, meta = gw.get_object(cont, obj)
            self._swift_reply(200, data, headers={
                "ETag": meta["etag"]},
                ctype="application/octet-stream")
        elif method == "HEAD":
            _, meta = gw.get_object(cont, obj)
            self.send_response(200)
            self.send_header("Content-Length", str(meta["size"]))
            self.send_header("ETag", meta["etag"])
            self.end_headers()
        elif method == "DELETE":
            gw.delete_object(cont, obj)
            self._swift_reply(204)
        else:
            self._swift_reply(405, b"Method Not Allowed")

    def _split(self) -> tuple[str, str, dict]:
        parsed = urllib.parse.urlparse(self.path)
        parts = parsed.path.lstrip("/").split("/", 1)
        bucket = urllib.parse.unquote(parts[0])
        key = urllib.parse.unquote(parts[1]) if len(parts) > 1 else ""
        # keep_blank_values: S3 sub-resources are bare keys (?uploads)
        q = dict(urllib.parse.parse_qsl(parsed.query,
                                        keep_blank_values=True))
        return bucket, key, q

    def _reply(self, status: int, body: bytes = b"",
               ctype: str = "application/xml") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _run(self, fn, payload: bytes = b"") -> None:
        try:
            # identity (RGWOp::verify_requester role): a signed
            # request authenticates to its access key; an UNSIGNED
            # request on an authed server is ANONYMOUS — allowed only
            # where a bucket/object ACL grants public access (before
            # ACLs landed, every request had to be signed)
            self.requester = None
            if self.auth is not None and \
                    self.headers.get("Authorization"):
                self.requester = verify_sigv4(self, self.auth,
                                              payload)
            # tenant attribution: every rados op this
            # request fans into carries the requester's flow label
            # through the handler thread's ambient context (the
            # gateway's ioctx falls back to current_flow())
            from ceph_tpu_torch.utils import flow_telemetry as _flow_tel
            with _flow_tel.flow_scope(
                    f"rgw:{self.requester or 'anonymous'}"):
                fn()
        except RGWError as exc:
            # S3 Error document; the message doubles as the Code when
            # it is one (NoSuchBucket/NoSuchKey/BucketNotEmpty/...)
            msg = str(exc)
            code = msg if msg.isalnum() else {
                400: "InvalidRequest", 403: "AccessDenied",
                404: "NoSuchKey", 409: "Conflict",
            }.get(exc.status, "InternalError")
            self._reply(exc.status, _xml_error(code, msg))
        except Exception as exc:  # pragma: no cover
            self._reply(500, _xml_error("InternalError", repr(exc)))

    def _access(self, bucket: str, want: str, key: str = "") -> None:
        """ACL gate (RGWOp::verify_permission seat). Open servers
        (no auth table) enforce nothing, as before."""
        if self.auth is None:
            return
        self.gw.check_access(bucket, self.requester, want, key)

    def _require_auth(self) -> None:
        """Account-level ops (list/create bucket) need an identity."""
        if self.auth is not None and self.requester is None:
            raise RGWError(403, "AccessDenied")

    def do_GET(self) -> None:  # noqa: N802
        if self._swift_dispatch("GET", b""):
            return
        bucket, key, q = self._split()

        def run() -> None:
            if not bucket:
                self._require_auth()
                self._reply(200, _xml_buckets(self.gw.list_buckets()))
            elif not key and "versioning" in q:
                self._access(bucket, "read")
                self._reply(200, _xml_versioning(
                    self.gw.get_versioning(bucket)))
            elif not key and "lifecycle" in q:
                self._access(bucket, "owner")
                self._reply(200, _xml_lifecycle(
                    self.gw.get_lifecycle(bucket)))
            elif not key and "versions" in q:
                self._access(bucket, "read")
                self._reply(200, _xml_versions(
                    bucket, self.gw.list_versions(
                        bucket, prefix=q.get("prefix", ""))))
            elif "acl" in q:
                self._access(bucket, "owner")
                meta = self.gw.bucket_meta(bucket)
                acl = meta.get("acl", "private")
                if key:
                    acl = self.gw._object_acl(bucket, key) or acl
                self._reply(200, _xml_acl(meta.get("owner", ""),
                                          acl))
            elif key and "versionId" in q:
                self._access(bucket, "read", key)
                data, meta = self.gw.get_object(
                    bucket, key, version_id=q["versionId"])
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("ETag", f'"{meta["etag"]}"')
                self.send_header("x-amz-version-id", meta["vid"])
                self.end_headers()
                self.wfile.write(data)
            elif key and "uploadId" in q:
                self._access(bucket, "read", key)
                parts = self.gw.list_parts(bucket, key, q["uploadId"])
                self._reply(200, _xml_parts(bucket, key,
                                            q["uploadId"], parts))
            elif not key:
                self._access(bucket, "read")
                prefix = q.get("prefix", "")
                marker = q.get("marker", "")
                try:
                    raw = q.get("max-keys")
                    # blank value (= absent pre-keep_blank_values
                    # behavior) falls back to the S3 default
                    max_keys = int(raw) if raw else 1000
                    if max_keys < 0:
                        raise ValueError
                except ValueError:
                    raise RGWError(400, "InvalidArgument") from None
                if max_keys == 0:
                    # AWS: max-keys=0 answers an empty, NON-truncated
                    # listing (truncated-with-no-marker would loop a
                    # paginating client forever)
                    idx, truncated = {}, False
                    self.gw._check_bucket(bucket)
                else:
                    # probe one past the page so IsTruncated is
                    # honest — a client that stops paginating must
                    # not miss keys
                    idx = self.gw.list_objects(
                        bucket, prefix=prefix, max_keys=max_keys + 1,
                        marker=marker)
                    truncated = len(idx) > max_keys
                    if truncated:
                        idx = dict(sorted(idx.items())[:max_keys])
                self._reply(200, _xml_listing(bucket, prefix,
                                              max_keys, idx,
                                              truncated, marker))
            else:
                self._access(bucket, "read", key)
                data, meta = self.gw.get_object(bucket, key)
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("ETag", f'"{meta["etag"]}"')
                if meta.get("vid"):
                    self.send_header("x-amz-version-id", meta["vid"])
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.end_headers()
                self.wfile.write(data)
        self._run(run)

    def do_PUT(self) -> None:  # noqa: N802
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n) if n else b""
        if self._swift_dispatch("PUT", body):
            return
        bucket, key, q = self._split()

        def run() -> None:
            if not key and "versioning" in q:
                self._access(bucket, "owner")
                status = next(iter(_xml_find(body, "Status")), "")
                self.gw.set_versioning(bucket, status)
                self._reply(200)
            elif not key and "lifecycle" in q:
                self._access(bucket, "owner")
                self.gw.set_lifecycle(bucket,
                                      _parse_lifecycle_xml(body))
                self._reply(200)
            elif "acl" in q:
                canned = self.headers.get("x-amz-acl", "") or \
                    next(iter(_xml_find(body, "Canned")), "private")
                self._access(bucket, "owner")
                if key:
                    self.gw.set_object_acl(bucket, key, canned)
                else:
                    self.gw.set_bucket_acl(bucket, canned)
                self._reply(200)
            elif not key:
                self._require_auth()
                self.gw.create_bucket(
                    bucket, owner=self.requester or "",
                    acl=self.headers.get("x-amz-acl", "private"))
                self._reply(200)
            elif "uploadId" in q and "partNumber" in q:
                self._access(bucket, "write")
                try:
                    part_no = int(q["partNumber"])
                except ValueError:
                    raise RGWError(400, "InvalidArgument") from None
                etag = self.gw.upload_part(bucket, key, q["uploadId"],
                                           part_no, body)
                self.send_response(200)
                self.send_header("ETag", f'"{etag}"')
                self.send_header("Content-Length", "0")
                self.end_headers()
            else:
                self._access(bucket, "write")
                etag = self.gw.put_object(
                    bucket, key, body,
                    acl=self.headers.get("x-amz-acl") or None,
                    owner=self.requester or None)
                self.send_response(200)
                self.send_header("ETag", f'"{etag}"')
                if self.gw.last_version_id:
                    self.send_header("x-amz-version-id",
                                     self.gw.last_version_id)
                self.send_header("Content-Length", "0")
                self.end_headers()
        self._run(run, payload=body)

    def do_POST(self) -> None:  # noqa: N802
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n) if n else b""
        if self._swift_dispatch("POST", body):
            return
        bucket, key, q = self._split()

        def run() -> None:
            if "uploads" in q and key:
                self._access(bucket, "write")
                upload_id = self.gw.initiate_multipart(bucket, key)
                self._reply(200, _xml_initiate(bucket, key, upload_id))
            elif "uploadId" in q and key:
                self._access(bucket, "write")
                parts = _parse_complete_xml(body)
                etag = self.gw.complete_multipart(
                    bucket, key, q["uploadId"], parts)
                self._reply(200, _xml_complete(bucket, key, etag))
            else:
                raise RGWError(400, "InvalidRequest")
        self._run(run, payload=body)

    def do_DELETE(self) -> None:  # noqa: N802
        if self._swift_dispatch("DELETE", b""):
            return
        bucket, key, q = self._split()

        def run() -> None:
            if key and "uploadId" in q:
                self._access(bucket, "write")
                self.gw.abort_multipart(bucket, key, q["uploadId"])
            elif not key and "lifecycle" in q:
                self._access(bucket, "owner")
                self.gw.delete_lifecycle(bucket)
            elif not key:
                self._access(bucket, "owner")
                self.gw.delete_bucket(bucket)
            elif "versionId" in q:
                self._access(bucket, "write")
                self.gw.delete_object(bucket, key,
                                      version_id=q["versionId"])
                self.send_response(204)
                self.send_header("x-amz-version-id", q["versionId"])
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            else:
                self._access(bucket, "write")
                marker_vid = self.gw.delete_object(bucket, key)
                if marker_vid is not None:
                    self.send_response(204)
                    self.send_header("x-amz-delete-marker", "true")
                    self.send_header("x-amz-version-id", marker_vid)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
            self._reply(204)
        self._run(run)

    def do_HEAD(self) -> None:  # noqa: N802
        if self._swift_dispatch("HEAD", b""):
            return
        bucket, key, _ = self._split()

        def run() -> None:
            self._access(bucket, "read", key)
            _, meta = self.gw.get_object(bucket, key)
            self.send_response(200)
            self.send_header("Content-Length", str(meta["size"]))
            self.send_header("ETag", f'"{meta["etag"]}"')
            if meta.get("vid"):
                self.send_header("x-amz-version-id", meta["vid"])
            self.end_headers()
        self._run(run)

    def log_message(self, *args) -> None:
        pass


class RGWServer:
    """Threaded HTTP front end (radosgw + civetweb role). ``auth``
    maps S3 access keys to secrets; when given, every request must be
    SigV4-signed."""

    def __init__(self, ioctx, host: str = "127.0.0.1",
                 port: int = 0,
                 auth: dict[str, str] | None = None,
                 zone_log: bool = False) -> None:
        from ceph_tpu_torch.analysis.lock_witness import make_lock
        gw = RGWGateway(ioctx, zone_log=zone_log)
        handler = type("BoundHandler", (_Handler,),
                       {"gw": gw, "auth": auth,
                        "swift_tokens": {},
                        "swift_lock": make_lock("rgw.swift")})
        self._srv = ThreadingHTTPServer((host, port), handler)
        self.port = self._srv.server_address[1]
        self.gateway = gw
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="rgw", daemon=True)

    def start(self) -> int:
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=2)
