"""The port's one-way RGW multisite sync (``ceph_tpu_torch/services/
rgw_sync.py``: full then incremental sync, durable markers, delete
propagation, log trim) against the reference's, on the CPU.

Counterparts of the 4 tests of ``tests/test_rgw_multisite.py``. The
reference's tests share one pair of zones and add a bucket each; here
each test has its own two zone pools in the module's reference and port
``MiniCluster`` pair, runs the reference test's steps in both and holds
the port to the reference's returns and stored objects of both zones,
after the one normalization of ``test_torch_rgw.py``. Tolerance 0.
"""

import hashlib

from test_torch_rgw import (  # noqa: F401  (cluster_pair: fixture)
    cluster_pair,
    pkg_mod,
    rgw,
    rgw_err,
    rgw_on_both,
)

SPEC = {"pg_num": 4, "size": 2}


def _on_zones(pair, name, steps):
    """``steps(pkg, src, dst, agent, sync_mod)``: a zone-logging source and
    a plain destination, in fresh pools of both packages."""
    def scenario(pkg, io_a, io_b):
        m, s = rgw(pkg), pkg_mod(pkg, "services.rgw_sync")
        src = m.RGWGateway(io_a, zone_log=True)
        dst = m.RGWGateway(io_b)
        return steps(pkg, src, dst, s.RGWSyncAgent(src, dst), s)

    return rgw_on_both(pair, {f"{name}_a": SPEC, f"{name}_b": SPEC},
                       scenario)


def test_full_then_incremental_sync(cluster_pair):
    def steps(pkg, src, dst, agent, _s):
        src.create_bucket("photos")
        src.put_object("photos", "a.jpg", b"JPEGA" * 100)
        src.put_object("photos", "b.jpg", b"JPEGB" * 100)
        out = [agent.sync_once(), dst.list_buckets(),
               dst.get_object("photos", "a.jpg")[0],
               dst.get_object("photos", "b.jpg")[0]]
        src.put_object("photos", "c.jpg", b"NEW")
        src.put_object("photos", "a.jpg", b"A-V2")
        src.delete_object("photos", "b.jpg")
        out += [agent.sync_once(), dst.get_object("photos", "c.jpg")[0],
                dst.get_object("photos", "a.jpg")[0],
                rgw_err(pkg, lambda: dst.get_object("photos", "b.jpg"))]
        return out + [agent.sync_once(), sorted(dst.list_objects("photos"))]

    out = _on_zones(cluster_pair, "ms_full", steps)
    assert out[1] == ["photos"]
    assert out[2:4] == [b"JPEGA" * 100, b"JPEGB" * 100]
    assert out[4]["photos"] == 3 and out[5:7] == [b"NEW", b"A-V2"]
    assert out[7][0] == 404
    assert out[8]["photos"] == 0 and out[9] == ["a.jpg", "c.jpg"]


def test_marker_survives_agent_restart(cluster_pair):
    def steps(pkg, src, dst, agent, s):
        src.create_bucket("docs")
        src.put_object("docs", "one", b"1")
        out = [agent.sync_once()]
        src.put_object("docs", "two", b"2")
        return out + [s.RGWSyncAgent(src, dst).sync_once(),
                      dst.get_object("docs", "two")[0]]

    out = _on_zones(cluster_pair, "ms_mark", steps)
    assert out[1]["docs"] == 1 and out[2] == b"2"


def test_put_superseded_by_delete_converges(cluster_pair):
    def steps(pkg, src, dst, agent, _s):
        src.create_bucket("tmp")
        out = [agent.sync_once()]
        src.put_object("tmp", "ephemeral", b"short-lived")
        src.delete_object("tmp", "ephemeral")
        return out + [agent.sync_once(), dst.list_objects("tmp")]

    out = _on_zones(cluster_pair, "ms_tmp", steps)
    assert out[2] == {}


def test_etag_carried_and_log_trim(cluster_pair):
    """Replication carries the source's multipart etag; trim_applied
    reclaims the log and later mutations still sync."""
    def steps(pkg, src, dst, agent, _s):
        src.create_bucket("mp")
        out = [agent.sync_once()]
        up = src.initiate_multipart("mp", "big")
        src.upload_part("mp", "big", up, 1, b"P1" * 100)
        src.upload_part("mp", "big", up, 2, b"P2" * 100)
        e1 = hashlib.md5(b"P1" * 100).hexdigest()
        e2 = hashlib.md5(b"P2" * 100).hexdigest()
        final = src.complete_multipart("mp", "big", up, [(1, e1), (2, e2)])
        out += [final, agent.sync_once()]
        data, meta = dst.get_object("mp", "big")
        out += [data, meta, agent.trim_applied()]
        src.put_object("mp", "after-trim", b"still flows")
        return out + [agent.sync_once(),
                      dst.get_object("mp", "after-trim")[0]]

    out = _on_zones(cluster_pair, "ms_mp", steps)
    final = out[1]
    assert final.endswith("-2") and out[2]["mp"] == 1
    assert out[3] == b"P1" * 100 + b"P2" * 100 and out[4]["etag"] == final
    assert out[5] >= 1 and out[6]["mp"] == 1 and out[7] == b"still flows"
