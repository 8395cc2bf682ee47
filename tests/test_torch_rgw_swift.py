"""The port's Swift dialect (``ceph_tpu_torch/services/rgw.py`` ``_Handler``:
TempAuth, account, container and object requests, S3 interop on one
store) against the reference's, on the CPU.

Counterparts of the 4 tests of ``tests/test_rgw_swift.py``, over HTTP to a
reference and a port ``RGWServer`` with ``auth={"acct": "sekrit"}`` on
fresh pools of the module's ``MiniCluster`` pair. Each holds the port to
the reference's statuses, headers (Swift tokens count in both, see
``test_torch_rgw.py``) and bodies, and stored objects. Tolerance 0.
"""

import json

from test_torch_rgw import (  # noqa: F401  (cluster_pair: fixture)
    cluster_pair,
    http,
    rgw,
    rgw_on_both,
    serving,
)

SPEC = {"pg_num": 4, "size": 2}
AUTH = {"acct": "sekrit"}


def _swift_auth(base: str, key: str = "sekrit") -> tuple:
    return http("GET", f"{base}/auth/v1.0",
                headers={"X-Auth-User": "acct:user", "X-Auth-Key": key})


def _on_server(pair, name, steps):
    """``steps(pkg, base, swift_base, token_headers)`` against a server
    with Swift credentials, after one TempAuth; returns [auth reply,
    steps' output]."""
    def scenario(pkg, io):
        with serving(pkg, io, auth=AUTH) as (_, base):
            auth = _swift_auth(base)
            h = {"X-Auth-Token": auth[1]["X-Auth-Token"]}
            return [auth, steps(pkg, base, f"{base}/v1/AUTH_acct", h)]

    return rgw_on_both(pair, {name: SPEC}, scenario)


def test_tempauth_and_bad_creds(cluster_pair):
    def steps(pkg, base, _swift, _h):
        return [_swift_auth(base, "wrong"), http("GET", f"{base}/v1/AUTH_acct")]

    auth, (bad, no_token) = _on_server(cluster_pair, "sw_auth", steps)
    assert auth[0] == 200 and auth[1]["X-Auth-Token"].startswith("AUTH_tk")
    assert auth[1]["X-Storage-Url"].endswith("/v1/AUTH_acct")
    assert bad[0] == 401 and no_token[0] == 401


def test_container_and_object_lifecycle(cluster_pair):
    def steps(pkg, _base, s, h):
        return [http("PUT", f"{s}/cont", headers=h),
                http("PUT", f"{s}/cont", headers=h),
                http("PUT", f"{s}/cont/hello.txt", b"swift payload", h),
                http("GET", f"{s}/cont/hello.txt", headers=h),
                http("HEAD", f"{s}/cont/hello.txt", headers=h),
                http("PUT", f"{s}/cont/b.bin", b"x" * 100, h),
                http("HEAD", f"{s}/cont", headers=h),
                http("GET", f"{s}/cont", headers=h),
                http("GET", f"{s}/cont?format=json", headers=h),
                http("GET", f"{s}/cont?prefix=he", headers=h),
                http("GET", f"{s}/cont?limit=1", headers=h),
                http("GET", f"{s}/cont?marker=b.bin", headers=h),
                http("GET", s, headers=h),
                http("GET", f"{s}?format=json", headers=h),
                http("DELETE", f"{s}/cont", headers=h),
                http("DELETE", f"{s}/cont/hello.txt", headers=h),
                http("DELETE", f"{s}/cont/b.bin", headers=h),
                http("DELETE", f"{s}/cont/gone", headers=h),
                http("DELETE", f"{s}/cont", headers=h),
                http("GET", f"{s}/cont", headers=h)]

    _, out = _on_server(cluster_pair, "sw_cont", steps)
    assert [o[0] for o in out] == [201, 202, 201, 200, 200, 201, 204, 200,
                                   200, 200, 200, 200, 200, 200, 409, 204,
                                   204, 404, 204, 404]
    etag = out[3][1]["ETag"]
    assert "ETag" in out[2][1] and out[3][2] == b"swift payload"
    assert out[4][1]["ETag"] == etag and out[4][1]["Content-Length"] == "13"
    assert out[6][1]["X-Container-Object-Count"] == "2"
    assert out[6][1]["X-Container-Bytes-Used"] == "113"
    assert out[7][2].decode().splitlines() == ["b.bin", "hello.txt"]
    listing = json.loads(out[8][2])
    assert [e["name"] for e in listing] == ["b.bin", "hello.txt"]
    assert listing[0]["bytes"] == 100 and listing[1]["hash"] == etag
    assert out[9][2].split() == [b"hello.txt"]
    assert out[10][2].split() == [b"b.bin"]
    assert out[11][2].split() == [b"hello.txt"]
    assert "cont" in out[12][2].decode().split()
    ents = {e["name"]: e for e in json.loads(out[13][2])}
    assert ents["cont"]["count"] == 2 and ents["cont"]["bytes"] == 113


def test_s3_and_swift_share_the_store(cluster_pair):
    """An object PUT through Swift is read through S3 (SigV4 with the
    Swift account's key) and the other way round."""
    def steps(pkg, base, s, h):
        host = base[len("http://"):]
        sign = rgw(pkg).sign_request
        out = [http("PUT", f"{s}/shared", headers=h),
               http("PUT", f"{s}/shared/from-swift", b"x-api", h)]
        hdrs = {"Host": host}
        hdrs.update(sign("GET", "/shared/from-swift", "", {"Host": host},
                         b"", "acct", "sekrit"))
        out.append(http("GET", f"{base}/shared/from-swift", headers=hdrs))
        hdrs = {"Host": host}
        hdrs.update(sign("PUT", "/shared/from-s3", "", {"Host": host},
                         b"from-s3", "acct", "sekrit"))
        out += [http("PUT", f"{base}/shared/from-s3", b"from-s3", hdrs),
                http("GET", f"{s}/shared/from-s3", headers=h)]
        return out

    _, out = _on_server(cluster_pair, "sw_s3", steps)
    assert out[2][0] == 200 and out[2][2] == b"x-api"
    assert out[3][0] == 200 and out[4][0] == 200 and out[4][2] == b"from-s3"


def test_token_is_account_scoped(cluster_pair):
    def steps(pkg, base, _s, h):
        return http("GET", f"{base}/v1/AUTH_other", headers=h)

    _, other = _on_server(cluster_pair, "sw_scope", steps)
    assert other[0] == 403
