"""The port's RADOS gateway on an RS k=8,m=3 EC pool against the
reference's, on the CPU: ``chip_smoke.py`` phase 5j's steps (a)-(c) and
(e)-(g) at a small size.

A reference and a port ``MiniCluster`` of 12 OSDs, one after the other,
each with an ISA ``reed_sol_van`` k=8,m=3 pool (``pg_num`` 8;
``backend="torch"`` in the port, the reference's host backend in the
reference) served by an ``RGWServer`` with SigV4 credentials, and a
replicated pool for the multisite source zone. Over HTTP to 127.0.0.1,
one client thread (the chip phase's 8 and 4 threads would order the PG
logs by the race): (a) a bucket and objects of one and a half striper
pieces; (b) a multipart upload, completed; (c) a paged listing that walks
every key, then a GET of every object; (e) Swift TempAuth, the container
listing of the same bucket, an object's GET and HEAD; (f) objects under
``tmp/``, a lifecycle rule expiring ``tmp/`` after one day, one
``LifecycleProcessor.process``; (g) a ``zone_log`` gateway on the
replicated pool writes, overwrites one object and deletes one, and
``RGWSyncAgent`` into the EC gateway passes until one applies nothing,
then ``trim_applied``. The port is held to the reference's HTTP statuses,
headers and XML bodies, returns, and stores shard for shard on every
PG's acting set (``test_torch_cluster.py``'s comparison), after the one
normalization of ``test_torch_rgw.py``. Step (d), the kill, degraded GETs
and revive, runs on the card (``tests/test_torch_cuda.py``, phase 5j):
degraded reads under a kill can stall on the CPU in both packages
(ROADMAP section C). Tolerance 0.
"""

import hashlib
import xml.etree.ElementTree as ET

import numpy as np

from test_torch_cluster import _assert_same_stores, _stores
from test_torch_rgw import (
    PKGS,
    PORT,
    REF,
    http,
    keys_of,
    normalize,
    pkg_mod,
    rgw,
    rgw_deterministic,
    serving,
    signed,
)
from test_torch_striper import no_resend

PIECE = 1 << 20                     # the gateway's striper piece
OBJ = PIECE + PIECE // 2            # one and a half pieces
N_OBJ, MP_PARTS, MP_PART = 6, 3, 512 << 10
N_TMP, N_ZONE, PAGE = 4, 3, 4
CREDS = {"AKRGW": "rgw-secret"}
DAY_S = 0.05


def _rgw_ec_steps(pkg, cluster) -> dict:
    """Steps (a)-(c) and (e)-(g) on ``pkg``'s cluster: every reply, and
    whether each GET equals its model."""
    m, lc, sync = (rgw(pkg), pkg_mod(pkg, "services.rgw_lc"),
                   pkg_mod(pkg, "services.rgw_sync"))
    rng = np.random.default_rng(29)
    objs = {f"obj/{i:03d}": rng.integers(0, 256, OBJ, dtype=np.uint8)
            .tobytes() for i in range(N_OBJ)}
    parts = [rng.integers(0, 256, MP_PART, dtype=np.uint8).tobytes()
             for _ in range(MP_PARTS)]
    tmps = {f"tmp/{i:02d}": rng.integers(0, 256, 4096, dtype=np.uint8)
            .tobytes() for i in range(N_TMP)}
    zone = {f"z/{i:02d}": rng.integers(0, 256, OBJ, dtype=np.uint8)
            .tobytes() for i in range(N_ZONE)}
    rados = cluster.client()
    io_ec, io_rep = (rados.open_ioctx(p) for p in ("rgw_ec", "rgw_zone"))
    out: dict = {}
    with serving(pkg, io_ec, auth=CREDS) as (srv, base):
        def s3(path, method="GET", data=b"", query=""):
            return signed(pkg, srv.port, "AKRGW", "rgw-secret", path,
                          method, data, query)

        # (a) a bucket and its objects
        out["a"] = [s3("/bkt", "PUT")] + [s3(f"/bkt/{k}", "PUT", v)
                                          for k, v in objs.items()]
        # (b) multipart
        init = s3("/bkt/mp/big", "POST", query="uploads")
        uid = ET.fromstring(init[2]).findtext("UploadId")
        ups = [s3("/bkt/mp/big", "PUT", p,
                  query=f"partNumber={n}&uploadId={uid}")
               for n, p in enumerate(parts, 1)]
        doc = ("<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{n}</PartNumber>"
            f"<ETag>{u[1]['ETag']}</ETag></Part>"
            for n, u in enumerate(ups, 1)) +
            "</CompleteMultipartUpload>").encode()
        out["b"] = [init, ups, s3("/bkt/mp/big", "POST", doc,
                                  f"uploadId={uid}")]
        objs["mp/big"] = b"".join(parts)
        # (c) a paged listing, then every object
        pages, marker = [], ""
        for _ in range(N_OBJ + 2):
            q = f"marker={marker}&max-keys={PAGE}" if marker \
                else f"max-keys={PAGE}"
            pages.append(s3("/bkt", query=q))
            page = ET.fromstring(pages[-1][2])
            if page.findtext("IsTruncated") != "true":
                break
            marker = page.findtext("NextMarker")
        gets = {k: s3(f"/bkt/{k}") for k in objs}
        out["c"] = [pages, {k: (g[0], g[1], g[2] == objs[k],
                                hashlib.md5(g[2]).hexdigest())
                            for k, g in gets.items()},
                    sum((keys_of(p[2]) for p in pages), [])]
        # (e) Swift on the same store
        auth = http("GET", f"{base}/auth/v1.0",
                    headers={"X-Auth-User": "AKRGW:user",
                             "X-Auth-Key": "rgw-secret"})
        h = {"X-Auth-Token": auth[1]["X-Auth-Token"]}
        sw = f"{base}/v1/AUTH_AKRGW/bkt"
        first = next(iter(objs))
        got = http("GET", f"{sw}/{first}", headers=h)
        out["e"] = [auth, http("GET", sw, headers=h),
                    (got[0], got[1], got[2] == objs[first]),
                    http("HEAD", f"{sw}/{first}", headers=h)]
        # (f) lifecycle over tmp/
        puts = [s3(f"/bkt/{k}", "PUT", v) for k, v in tmps.items()]
        rule = (b"<LifecycleConfiguration><Rule><ID>tmp</ID><Filter>"
                b"<Prefix>tmp/</Prefix></Filter><Status>Enabled</Status>"
                b"<Expiration><Days>1</Days></Expiration></Rule>"
                b"</LifecycleConfiguration>")
        out["f"] = [puts, s3("/bkt", "PUT", rule, "lifecycle"),
                    lc.LifecycleProcessor(srv.gateway,
                                          day_seconds=DAY_S).process(),
                    sorted(srv.gateway.list_objects("bkt"))]
        # (g) a replicated source zone synced into the EC gateway
        src = m.RGWGateway(io_rep, zone_log=True)
        agent = sync.RGWSyncAgent(src, srv.gateway)
        src.create_bucket("zone")
        for k, v in zone.items():
            src.put_object("zone", k, v)
        passes = [agent.sync_once()]
        src.put_object("zone", "z/00", b"overwritten")
        src.delete_object("zone", "z/01")
        for _ in range(5):
            passes.append(agent.sync_once())
            if passes[-1]["zone"] == 0:
                break
        want = {k: src.get_object("zone", k)[0]
                for k in src.list_objects("zone")}
        have = {k: srv.gateway.get_object("zone", k)[0]
                for k in srv.gateway.list_objects("zone")}
        out["g"] = [passes, agent.trim_applied(), sorted(want),
                    want == have]
    return out


def test_rgw_on_ec_pool_matches_reference():
    """Steps (a)-(c) and (e)-(g) on both packages: equal replies and
    stores on every acting set, every GET equal to its model, the
    multipart etag in ``md5-N`` form, ``tmp/`` expired, the destination
    zone equal to the source."""
    # the reference registers its ``native`` backend lazily (ROADMAP C)
    pkg_mod(REF, "ops.backend").available_backends()
    results = []
    for pkg in PKGS:
        pool = {"k": 8, "m": 3, "plugin": "isa",
                "technique": "reed_sol_van", "pg_num": 8}
        if pkg == PORT:
            pool["backend"] = "torch"
        with rgw_deterministic(pkg), no_resend(), \
                pkg_mod(pkg, "qa.cluster").MiniCluster(n_osds=12) as c:
            c.create_ec_pool("rgw_ec", **pool)
            c.create_pool("rgw_zone", pg_num=8, size=3)
            out = _rgw_ec_steps(pkg, c)
            results.append((normalize(out), normalize(_stores(c))))
    (ref_out, ref_store), (out, store) = results
    assert out == ref_out
    statuses = [r[0] for r in out["a"]] + [out["b"][0][0], out["b"][2][0]] \
        + [u[0] for u in out["b"][1]]
    assert statuses == [200] * len(statuses)
    want_keys = sorted([f"obj/{i:03d}" for i in range(N_OBJ)] + ["mp/big"])
    assert out["c"][2] == want_keys
    assert all(g[0] == 200 and g[2] and g[1]["ETag"] == f'"{g[3]}"'
               for k, g in out["c"][1].items() if k != "mp/big")
    big = out["c"][1]["mp/big"]
    assert big[0] == 200 and big[2] and big[1]["ETag"].endswith(
        f'-{MP_PARTS}"')
    auth, listing, got, head = out["e"]
    assert auth[0] == 200 and listing[2].decode().split() == want_keys
    assert got[:1] == (200,) and got[2] and head[0] == 200
    assert out["f"][2]["expired"] == N_TMP and out["f"][3] == want_keys
    passes, trimmed, keys, equal = out["g"]
    assert passes[0]["zone"] == 0 and passes[1]["zone"] == 2
    assert passes[-1]["zone"] == 0 and trimmed > 0 and equal
    assert keys == ["z/00", "z/02"]
    _assert_same_stores(ref_store, store)
