"""The port's RADOS gateway (``ceph_tpu_torch/services/rgw.py``) against the
reference's (``ceph_tpu/services/rgw.py``), on the CPU.

Counterparts of the 11 tests of ``tests/test_rgw.py``. Each runs the
reference test's steps, with seeded payloads, on a reference and a port
``MiniCluster`` (up together for the module, a fresh pool a test) and
holds the port to the reference's returns, ``RGWError`` statuses, HTTP
statuses, headers and XML bodies, and stored objects of the test's pools
(every OSD's data, attrs and omap). Tolerance 0.

Both runs go through one normalization, :func:`normalize`, written here
and used by every ``test_torch_rgw*.py``: the gateway stamps index and
version entries (json ``mtime``) and GC enrollments (json ``t``) with
``time.time()``, which is read inside its functions and cannot be
swapped for one module (the clusters' heartbeats read the process clock),
so each distinct stamp maps to its order of appearance. The upload ids and
Swift tokens (``secrets.token_hex``) name objects, so they decide the PG
an upload's parts land in and cannot be normalized after the fact: in
:func:`rgw_deterministic` they count, the same in both packages, as the
striper's tags and the object classes' clock do (``deterministic`` of
``test_torch_striper.py``). Nothing else in either package reads
``secrets``. HTTP headers lose ``Date`` and the server's port.

The helpers here (``rgw_on_both``, ``normalize``, ``http``, ``signed``,
``serving``, ``rgw_err``) serve ``test_torch_rgw_versioning.py``,
``test_torch_rgw_bidir.py``, ``test_torch_rgw_multisite.py``,
``test_torch_rgw_swift.py`` and ``test_torch_rgw_ec.py`` too.
"""

import contextlib
import hashlib
import json
import re
import secrets
import threading
import urllib.error
import urllib.request
import xml.etree.ElementTree as ET

import pytest

from test_torch_striper import (  # noqa: F401  (cluster_pair: fixture)
    PKGS,
    assert_same,
    cluster_pair,
    deterministic,
    payload,
    pkg_mod,
    store_dump,
)

REF, PORT = PKGS


def rgw(pkg):
    return pkg_mod(pkg, "services.rgw")


def rgw_err(pkg, fn) -> tuple:
    """``fn()``'s ``RGWError`` as (status, message)."""
    with pytest.raises(rgw(pkg).RGWError) as ei:
        fn()
    return ei.value.status, str(ei.value)


# -- determinism and the one normalization ------------------------------

class _Tokens:
    """``secrets.token_hex`` stand-in counting from 1."""

    def __init__(self) -> None:
        self.n = 0
        self.lock = threading.Lock()

    def token_hex(self, nbytes: int = 32) -> str:
        with self.lock:
            self.n += 1
            return f"{self.n:0{2 * nbytes}x}"


@contextlib.contextmanager
def rgw_deterministic(pkg: str):
    """``deterministic(pkg)``, and upload ids and Swift tokens counting."""
    real = secrets.token_hex
    secrets.token_hex = _Tokens().token_hex
    try:
        with deterministic(pkg):
            yield
    finally:
        secrets.token_hex = real


_STAMP = re.compile(rb'"(mtime|t)": (-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)')


class _Stamps:
    """Each distinct stamp -> its order of appearance."""

    def __init__(self) -> None:
        self.ids: dict = {}

    def of(self, value) -> str:
        return f"#{self.ids.setdefault(value, len(self.ids))}"


def _normalize(obj, stamps: _Stamps):
    if isinstance(obj, dict):
        out = {}
        for key in sorted(obj, key=repr):
            val = obj[key]
            if key in ("mtime", "t") and isinstance(val, (int, float)) \
                    and not isinstance(val, bool):
                out[key] = stamps.of(float(val))
            else:
                out[_normalize(key, stamps)] = _normalize(val, stamps)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_normalize(v, stamps) for v in obj)
    if isinstance(obj, bytes):
        return _STAMP.sub(lambda m: b'"%s": "%s"' % (
            m.group(1), stamps.of(float(m.group(2))).encode()), obj)
    if isinstance(obj, str):
        return _normalize(obj.encode(), stamps).decode()
    return obj


def normalize(obj):
    """``obj`` with every json ``mtime`` and ``t`` stamp (a dict's
    value, or inside bytes or text) replaced by its order of appearance,
    dicts walked in key order."""
    return _normalize(obj, _Stamps())


def rgw_on_both(pair, pools: dict, scenario, compare: str = "full"):
    """Create ``pools`` ({name: spec}; a spec with ``k`` is an EC pool,
    ``backend="torch"`` in the port) in both clusters of ``pair``, run
    ``scenario(pkg, *ioctxs)`` on the reference then the port within
    :func:`rgw_deterministic`, and hold the port to the reference's
    normalized output and stored objects of those pools (``compare`` as
    ``on_both``'s: "full", "data" or "names"). Returns the port's
    output."""
    results = []
    for pkg in PKGS:
        cluster, rados = pair[pkg]
        for name, spec in pools.items():
            spec = dict(spec)
            if "k" in spec:
                if pkg == PORT:
                    spec["backend"] = "torch"
                cluster.create_ec_pool(name, **spec)
            else:
                cluster.create_pool(name, **spec)
        ios = [rados.open_ioctx(name) for name in pools]
        with rgw_deterministic(pkg):
            out = scenario(pkg, *ios)
        dump = {}
        for name in pools:
            dump.update(store_dump(cluster, compare != "full",
                                   cluster.mon.osdmap.pool_by_name[name]))
        if compare == "names":
            dump = dict.fromkeys(dump)
        results.append((normalize(out), normalize(dump)))
    assert_same(results)
    return results[1][0]


# -- HTTP ---------------------------------------------------------------

_HOST = re.compile(r"127\.0\.0\.1:\d+")


def http(method: str, url: str, data: bytes | None = None,
         headers: dict | None = None) -> tuple:
    """One request: (status, headers without ``Date`` and the server's
    port, body)."""
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, hdrs, body = resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as exc:
        status, hdrs, body = exc.code, exc.headers, exc.read()
    kept = {k: _HOST.sub("127.0.0.1:PORT", v) for k, v in hdrs.items()
            if k != "Date"}
    return status, kept, body


def signed(pkg, port: int, access: str, secret: str, path: str,
           method: str = "GET", data: bytes = b"", query: str = "",
           headers: dict | None = None) -> tuple:
    """A request signed with ``pkg``'s ``sign_request``."""
    url = f"http://127.0.0.1:{port}{path}" + (f"?{query}" if query else "")
    h = {"Host": f"127.0.0.1:{port}"}
    h.update(headers or {})
    h.update(rgw(pkg).sign_request(method, path, query, h, data, access,
                                   secret))
    return http(method, url, data or None, h)


@contextlib.contextmanager
def serving(pkg, io, **kw):
    """``pkg``'s ``RGWServer`` on ``io``, started: (server, base url)."""
    srv = rgw(pkg).RGWServer(io, **kw)
    port = srv.start()
    try:
        yield srv, f"http://127.0.0.1:{port}"
    finally:
        srv.stop()


def keys_of(body: bytes) -> list:
    return [c.findtext("Key") for c in ET.fromstring(body).findall("Contents")]


POOL = {"rgwpool": {"pg_num": 4, "size": 2}}


# -- tests/test_rgw.py ----------------------------------------------------

def test_gateway_api(cluster_pair):
    data = payload(3 << 20, 31)          # striped (3 pieces)

    def scenario(pkg, io):
        gw = rgw(pkg).RGWGateway(io)
        gw.create_bucket("photos")
        gw.create_bucket("photos")
        out = [gw.list_buckets()]
        etag = gw.put_object("photos", "a/b.jpg", data)
        got, meta = gw.get_object("photos", "a/b.jpg")
        out += [etag, got == data, meta]
        gw.put_object("photos", "a/c.jpg", b"tiny")
        gw.put_object("photos", "z.txt", b"zzz")
        out += [sorted(gw.list_objects("photos")),
                sorted(gw.list_objects("photos", prefix="a/")),
                rgw_err(pkg, lambda: gw.delete_bucket("photos"))]
        gw.delete_object("photos", "a/b.jpg")
        out.append(rgw_err(pkg, lambda: gw.get_object("photos", "a/b.jpg")))
        gw.delete_object("photos", "a/c.jpg")
        gw.delete_object("photos", "z.txt")
        gw.delete_bucket("photos")
        return out + [gw.list_buckets()]

    out = rgw_on_both(cluster_pair, {"rgw_api": POOL["rgwpool"]}, scenario)
    assert out[0] == ["photos"] and out[2] is True
    assert out[1] == hashlib.md5(data).hexdigest() == out[3]["etag"]
    assert out[3]["size"] == len(data)
    assert out[4] == ["a/b.jpg", "a/c.jpg", "z.txt"]
    assert out[5] == ["a/b.jpg", "a/c.jpg"]
    assert out[6] == (409, "BucketNotEmpty") and out[7][0] == 404
    assert out[8] == []


def test_http_s3_path_flow(cluster_pair):
    body = payload(100_000, 32)

    def scenario(pkg, io):
        with serving(pkg, io) as (_, base):
            out = [http("PUT", f"{base}/webdata"),
                   http("PUT", f"{base}/webdata/docs/readme.bin", body),
                   http("GET", f"{base}/webdata"), http("GET", base + "/"),
                   http("GET", f"{base}/webdata/docs/readme.bin"),
                   http("HEAD", f"{base}/webdata/docs/readme.bin"),
                   http("GET", f"{base}/webdata/missing"),
                   http("GET", f"{base}/nobucket/x"),
                   http("DELETE", f"{base}/webdata/docs/readme.bin"),
                   http("DELETE", f"{base}/webdata"),
                   http("GET", f"{base}/webdata")]
        return out

    out = rgw_on_both(cluster_pair, {"rgw_http": POOL["rgwpool"]}, scenario)
    etag = out[1][1]["ETag"]
    assert etag == f'"{hashlib.md5(body).hexdigest()}"'
    listing = ET.fromstring(out[2][2])
    assert listing.tag == "ListBucketResult"
    assert keys_of(out[2][2]) == ["docs/readme.bin"]
    names = [b.findtext("Name") for b in
             ET.fromstring(out[3][2]).find("Buckets").findall("Bucket")]
    assert names == ["webdata"]
    assert out[4][2] == body and out[4][1]["ETag"] == etag
    assert int(out[5][1]["Content-Length"]) == len(body)
    assert [o[0] for o in out[6:]] == [404, 404, 204, 204, 404]


def test_error_documents_are_s3_xml(cluster_pair):
    def scenario(pkg, io):
        with serving(pkg, io) as (_, base):
            return http("GET", f"{base}/nosuchbucket-xml/")

    status, _, body = rgw_on_both(cluster_pair, {"rgw_err": {"pg_num": 2,
                                                            "size": 2}},
                                  scenario)
    doc = ET.fromstring(body)
    assert status == 404 and doc.tag == "Error"
    assert doc.findtext("Code") == "NoSuchBucket"


def test_sigv4_signed_requests(cluster_pair):
    """SigV4: signed requests succeed; unsigned, forged and tampered ones
    get 403 with the S3 error codes."""
    body = payload(30_000, 33)

    def scenario(pkg, io):
        with serving(pkg, io, auth={"AKIATEST": "sekrit"}) as (srv, base):
            port = srv.port

            def sig(path, method="GET", data=b"", query="", secret="sekrit"):
                return signed(pkg, port, "AKIATEST", secret, path, method,
                              data, query)

            out = [http("GET", f"{base}/"), sig("/sbucket", "PUT"),
                   sig("/sbucket/a/b.bin", "PUT", body),
                   sig("/sbucket", query="prefix=a%2F"),
                   sig("/sbucket/a/b.bin"),
                   sig("/sbucket", secret="wrong")]
            headers = {"Host": f"127.0.0.1:{port}"}
            headers.update(rgw(pkg).sign_request(
                "PUT", "/sbucket/t", "", headers, b"payload-A", "AKIATEST",
                "sekrit"))
            out.append(http("PUT", f"{base}/sbucket/t", b"payload-B",
                            headers))
        return out

    out = rgw_on_both(cluster_pair, {"rgw_sig": POOL["rgwpool"]}, scenario)
    code = [ET.fromstring(o[2]).findtext("Code") if o[0] >= 400 else None
            for o in out]
    assert out[0][0] == 403 and code[0] == "AccessDenied"
    assert keys_of(out[3][2]) == ["a/b.bin"] and out[4][2] == body
    assert code[5] == "SignatureDoesNotMatch"
    assert out[6][0] == 403 and code[6] == "XAmzContentSHA256Mismatch"


def test_listing_pagination_is_truncated_honest(cluster_pair):
    def scenario(pkg, io):
        with serving(pkg, io) as (srv, base):
            gw = srv.gateway
            gw.create_bucket("pager")
            for i in range(7):
                gw.put_object("pager", f"k{i:02d}", b"x")
            return [http("GET", f"{base}/pager?max-keys=5"),
                    http("GET", f"{base}/pager?max-keys=10")]

    out = rgw_on_both(cluster_pair, {"rgw_pager": POOL["rgwpool"]}, scenario)
    first, second = (ET.fromstring(o[2]) for o in out)
    assert len(keys_of(out[0][2])) == 5
    assert first.findtext("IsTruncated") == "true"
    assert second.findtext("IsTruncated") == "false"
    assert len(keys_of(out[1][2])) == 7


def test_sigv4_rejects_stale_date(cluster_pair):
    """Replay protection: a request signed an hour ago is refused
    (RequestTimeTooSkewed)."""
    import time as _t
    from unittest import mock

    def scenario(pkg, io):
        with serving(pkg, io, auth={"AK": "sec"}) as (srv, base):
            headers = {"Host": f"127.0.0.1:{srv.port}"}
            old = _t.gmtime(_t.time() - 3600)
            with mock.patch("time.gmtime", return_value=old):
                headers.update(rgw(pkg).sign_request("GET", "/", "", headers,
                                                     b"", "AK", "sec"))
            return http("GET", f"{base}/", headers=headers)

    status, _, body = rgw_on_both(cluster_pair,
                                  {"rgw_stale": {"pg_num": 2, "size": 2}},
                                  scenario)
    assert status == 403
    assert ET.fromstring(body).findtext("Code") == "RequestTimeTooSkewed"


def test_listing_marker_pagination_walks_all_keys(cluster_pair):
    """Follow IsTruncated/NextMarker with ?marker= until every key is seen
    exactly once; a malformed max-keys is a 400 InvalidArgument."""
    want = [f"obj{i:03d}" for i in range(12)]

    def scenario(pkg, io):
        with serving(pkg, io) as (srv, base):
            gw = srv.gateway
            gw.create_bucket("walker")
            for k in want:
                gw.put_object("walker", k, b"x")
            pages, marker = [], ""
            for _ in range(10):
                url = f"{base}/walker?max-keys=5"
                if marker:
                    url += f"&marker={marker}"
                pages.append(http("GET", url))
                doc = ET.fromstring(pages[-1][2])
                if doc.findtext("IsTruncated") == "false":
                    break
                marker = doc.findtext("NextMarker")
                assert marker
            return pages, http("GET", f"{base}/walker?max-keys=abc")

    pages, bad = rgw_on_both(cluster_pair, {"rgw_walk": POOL["rgwpool"]},
                             scenario)
    assert len(pages) == 3
    assert sum((keys_of(p[2]) for p in pages), []) == want
    assert bad[0] == 400
    assert ET.fromstring(bad[2]).findtext("Code") == "InvalidArgument"


def test_multipart_upload_flow(cluster_pair):
    """Initiate, parts, list, complete with the md5-of-md5s etag, the
    stitched object readable; a wrong manifest refused; abort cleans a
    second upload's parts; no hidden object in the listing."""
    p1, p2, p3 = b"A" * (1 << 18), b"B" * (1 << 18), b"C" * 1000

    def scenario(pkg, io):
        gw = rgw(pkg).RGWGateway(io)
        gw.create_bucket("mp")
        upload_id = gw.initiate_multipart("mp", "big")
        etags = [gw.upload_part("mp", "big", upload_id, n, p)
                 for n, p in ((1, p1), (2, p2), (3, p3))]
        out = [upload_id, etags, gw.list_parts("mp", "big", upload_id)]
        out.append(gw.complete_multipart(
            "mp", "big", upload_id, list(zip((1, 2, 3), etags))))
        data, meta = gw.get_object("mp", "big")
        out += [data == p1 + p2 + p3, meta,
                rgw_err(pkg, lambda: gw.list_parts("mp", "big", upload_id))]
        u2 = gw.initiate_multipart("mp", "other")
        gw.upload_part("mp", "other", u2, 1, b"x")
        out.append(rgw_err(pkg, lambda: gw.complete_multipart(
            "mp", "other", u2, [(1, "deadbeef")])))
        gw.abort_multipart("mp", "other", u2)
        out += [rgw_err(pkg, lambda: gw.list_parts("mp", "other", u2)),
                sorted(gw.list_objects("mp"))]
        return out

    out = rgw_on_both(cluster_pair, {"rgw_mp": POOL["rgwpool"]}, scenario)
    e1, e2, e3 = out[1]
    want = hashlib.md5(bytes.fromhex(e1) + bytes.fromhex(e2)
                       + bytes.fromhex(e3)).hexdigest() + "-3"
    assert sorted(out[2]) == ["1", "2", "3"]
    assert out[3] == want and out[4] is True and out[5]["etag"] == want
    assert out[6] == (404, "NoSuchUpload")
    assert out[7] == (400, "InvalidPart") and out[8][0] == 404
    assert out[9] == ["big"]


def test_multipart_over_http(cluster_pair):
    blobs = ((1, b"part-one-" * 100), (2, b"part-two!" * 50))

    def scenario(pkg, io):
        with serving(pkg, io) as (srv, base):
            srv.gateway.create_bucket("mph")
            out = [http("POST", f"{base}/mph/file?uploads")]
            upload_id = re.search(rb"<UploadId>([0-9a-f]+)</UploadId>",
                                  out[0][2]).group(1).decode()
            etags = []
            for n, blob in blobs:
                out.append(http("PUT", f"{base}/mph/file?partNumber={n}"
                                f"&uploadId={upload_id}", blob))
                etags.append(out[-1][1]["ETag"].strip('"'))
            doc = ("<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>\"{e}\"</ETag>"
                "</Part>" for (n, _), e in zip(blobs, etags))
                + "</CompleteMultipartUpload>").encode()
            out += [http("POST", f"{base}/mph/file?uploadId={upload_id}",
                         doc),
                    http("GET", f"{base}/mph/file")]
        return out

    out = rgw_on_both(cluster_pair, {"rgw_mph": POOL["rgwpool"]}, scenario)
    assert [o[0] for o in out] == [200] * 5
    assert b"CompleteMultipartUploadResult" in out[3][2]
    assert out[4][2] == b"part-one-" * 100 + b"part-two!" * 50


def test_multipart_concurrent_parts(cluster_pair):
    """Parallel part uploads lose no entry (the atomic part record); the
    stitched object and its etag; duplicate part numbers refused. The
    parts race, so the stores are compared by object bytes."""
    def scenario(pkg, io):
        gw = rgw(pkg).RGWGateway(io)
        gw.create_bucket("mpc")
        uid = gw.initiate_multipart("mpc", "par")
        etags, errs = {}, []

        def up(n):
            try:
                etags[n] = gw.upload_part("mpc", "par", uid, n,
                                          bytes([n]) * 20000)
            except Exception as exc:  # noqa: BLE001
                errs.append(repr(exc))

        ts = [threading.Thread(target=up, args=(n,)) for n in range(1, 9)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        out = [errs, sorted(gw.list_parts("mpc", "par", uid))]
        etag = gw.complete_multipart("mpc", "par", uid,
                                     [(n, etags[n]) for n in range(1, 9)])
        data, meta = gw.get_object("mpc", "par")
        out += [etag, data == b"".join(bytes([n]) * 20000
                                       for n in range(1, 9)),
                meta["etag"] == etag]
        u2 = gw.initiate_multipart("mpc", "dup")
        e = gw.upload_part("mpc", "dup", u2, 1, b"z")
        out.append(rgw_err(pkg, lambda: gw.complete_multipart(
            "mpc", "dup", u2, [(1, e), (1, e)])))
        gw.abort_multipart("mpc", "dup", u2)
        return out

    out = rgw_on_both(cluster_pair, {"rgw_mpc": POOL["rgwpool"]}, scenario,
                      compare="data")
    assert out[0] == [] and out[1] == [str(n) for n in range(1, 9)]
    assert out[2].endswith("-8") and out[3] is True and out[4] is True
    assert out[5] == (400, "InvalidPartOrder")


def test_bucket_index_rides_omap_with_cls_fallback_on_ec(cluster_pair):
    """The index is omap on a replicated pool and the cls blob on an EC
    pool; a legacy bucket (no ``fmt`` attr) keeps the cls blob, in every
    gateway."""
    def scenario(pkg, rep, ec):
        m = rgw(pkg)
        gw = m.RGWGateway(rep)
        gw.create_bucket("b")
        out = [gw._bucket_fmt("b")]
        gw.put_object("b", "k1", b"data1")
        out += [gw.io.omap_get(".bucket.b"), gw.list_objects("b")]
        gw.delete_object("b", "k1")
        out.append(gw.io.omap_get(".bucket.b"))
        gw2 = m.RGWGateway(ec)
        gw2.create_bucket("eb")
        out.append(gw2._bucket_fmt("eb"))
        gw2.put_object("eb", "k2", b"data22")
        out.append(gw2.list_objects("eb"))
        gw2.delete_object("eb", "k2")
        out.append(gw2.list_objects("eb"))
        gw.io.write_full(".bucket.legacy", b"{}")
        b = json.loads(gw.io.read(".buckets"))
        b["legacy"] = {}
        gw.io.write_full(".buckets", json.dumps(b).encode())
        gw3 = m.RGWGateway(rep)
        out.append(gw3._bucket_fmt("legacy"))
        gw3.put_object("legacy", "old-k", b"legacy data")
        gw4 = m.RGWGateway(rep)
        out += [gw3.list_objects("legacy"), gw4.list_objects("legacy")]
        gw4.delete_object("legacy", "old-k")
        return out + [gw3.list_objects("legacy")]

    out = rgw_on_both(cluster_pair, {"rgw-rep": {"pg_num": 4, "size": 2},
                                     "rgw-ec": {"k": 2, "m": 1,
                                                "pg_num": 4}}, scenario)
    assert out[0] == "omap" and "k1" in out[1]
    assert out[2]["k1"]["size"] == 5 and out[3] == {}
    assert out[4] == "cls" and out[5]["k2"]["size"] == 6 and out[6] == {}
    assert out[7] == "cls"
    assert out[8]["old-k"]["size"] == out[9]["old-k"]["size"] == 11
    assert out[10] == {}


# -- the index's object class under concurrent writers on an EC pool ------

def test_concurrent_index_adds_on_ec_pool_keep_every_entry(cluster_pair):
    """Four gateways' worth of ``rgw.bucket_add`` calls at once on an EC
    pool's cls-blob index keep every entry, the port's on a device backend
    (``backend="torch"``) as the reference's on its host backend. The
    method reads the object and writes it back under the PG lock; a
    device pool's write commits after its engine flush, with the lock
    released, and the port's read lays the writes still in flight over
    the committed shards (``ECBackend.read_object_current``). The calls
    race, so the stores are compared by object names."""
    def scenario(pkg, io):
        io.write_full(".bucket.race", b"{}")

        def add(t):
            for i in range(10):
                io.execute(".bucket.race", "rgw", "bucket_add", json.dumps(
                    {"key": f"k{t}-{i}", "size": i, "etag": ""}).encode())

        ts = [threading.Thread(target=add, args=(t,)) for t in range(4)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        idx = json.loads(io.execute(".bucket.race", "rgw", "bucket_list",
                                    b"{}"))
        return sorted((k, v["size"]) for k, v in idx.items())

    out = rgw_on_both(cluster_pair, {"rgw_race": {"k": 2, "m": 1,
                                                  "pg_num": 1}},
                      scenario, compare="names")
    assert out == sorted((f"k{t}-{i}", i) for t in range(4)
                         for i in range(10))
