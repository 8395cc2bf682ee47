"""The port's bidirectional (active-active) RGW multisite
(``ceph_tpu_torch/services/rgw_sync.py`` over two zone-logging gateways)
against the reference's, on the CPU.

Counterparts of the 10 tests of ``tests/test_rgw_bidir.py``. The reference
boots a cluster a test; here two zones are two fresh pools of the module's
reference and port ``MiniCluster`` pair, and each test runs the reference
test's steps in both and holds the port to the reference's returns,
``RGWError`` statuses and stored objects of both zones, after the one
normalization of ``test_torch_rgw.py``. Tolerance 0.
"""

import json
import threading

from test_torch_rgw import (  # noqa: F401  (cluster_pair: fixture)
    cluster_pair,
    pkg_mod,
    rgw,
    rgw_err,
    rgw_on_both,
)

SPEC = {"pg_num": 4, "size": 2}


def _zones(pkg, io_a, io_b):
    """Zones ``a`` and ``b`` and an agent each way."""
    m, s = rgw(pkg), pkg_mod(pkg, "services.rgw_sync")
    a = m.RGWGateway(io_a, zone_log=True, zone_name="a")
    b = m.RGWGateway(io_b, zone_log=True, zone_name="b")
    return a, b, s.RGWSyncAgent(a, b), s.RGWSyncAgent(b, a)


def _quiesce(ab, ba, rounds=10) -> list:
    """Both directions until neither applies an entry; the applied counts
    of each round."""
    counts = []
    for _ in range(rounds):
        na = sum(ab.sync_once().values())
        nb = sum(ba.sync_once().values())
        counts.append((na, nb))
        if na == 0 and nb == 0:
            return counts
    raise AssertionError("sync never quiesced (echo loop?)")


def _on_zones(pair, name, steps, compare="full"):
    """``steps(pkg, a, b, ab, ba)`` on fresh zone pools in both packages."""
    return rgw_on_both(
        pair, {f"{name}_a": SPEC, f"{name}_b": SPEC},
        lambda pkg, io_a, io_b: steps(pkg, *_zones(pkg, io_a, io_b)),
        compare)


def _get(z, bucket, key):
    return z.get_object(bucket, key)[0]


def _versions_view(z, bucket):
    return sorted((e["key"], e["vid"], bool(e.get("dm")), e["is_current"])
                  for e in z.list_versions(bucket))


def test_disjoint_writes_converge_without_echo(cluster_pair):
    def steps(pkg, a, b, ab, ba):
        a.create_bucket("shared")
        b.create_bucket("shared")
        a.put_object("shared", "from-a", b"A")
        b.put_object("shared", "from-b", b"B")
        out = [_quiesce(ab, ba)]
        out += [[_get(z, "shared", k) for k in ("from-a", "from-b")]
                for z in (a, b)]
        return out + [ab.sync_once(), ba.sync_once()]

    out = _on_zones(cluster_pair, "bd_disj", steps)
    assert out[1] == out[2] == [b"A", b"B"]
    assert sum(out[3].values()) == sum(out[4].values()) == 0


def test_concurrent_write_conflict_resolves_deterministically(cluster_pair):
    def steps(pkg, a, b, ab, ba):
        a.create_bucket("cw")
        b.create_bucket("cw")
        a.put_object("cw", "doc", b"version-from-a")
        b.put_object("cw", "doc", b"version-from-b")
        return [_quiesce(ab, ba), _get(a, "cw", "doc"), _get(b, "cw", "doc")]

    out = _on_zones(cluster_pair, "bd_cw", steps)
    assert out[1:] == [b"version-from-b"] * 2


def test_causal_overwrite_wins_regardless_of_zone(cluster_pair):
    def steps(pkg, a, b, ab, ba):
        a.create_bucket("seq")
        b.create_bucket("seq")
        b.put_object("seq", "k", b"gen1-from-b")
        out = [_quiesce(ab, ba), _get(a, "seq", "k")]
        a.put_object("seq", "k", b"gen2-from-a")
        return out + [_quiesce(ab, ba), _get(a, "seq", "k"),
                      _get(b, "seq", "k")]

    out = _on_zones(cluster_pair, "bd_seq", steps)
    assert out[1] == b"gen1-from-b"
    assert out[3:] == [b"gen2-from-a"] * 2


def test_delete_vs_write_conflict(cluster_pair):
    def steps(pkg, a, b, ab, ba):
        a.create_bucket("dv")
        b.create_bucket("dv")
        a.put_object("dv", "k", b"base")
        out = [_quiesce(ab, ba)]
        a.put_object("dv", "k", b"overwrite-from-a")
        b.delete_object("dv", "k")
        out.append(_quiesce(ab, ba))
        out += [rgw_err(pkg, lambda z=z: z.get_object("dv", "k"))
                for z in (a, b)]
        a.put_object("dv", "k2", b"base2")
        out.append(_quiesce(ab, ba))
        a.delete_object("dv", "k2")
        b.put_object("dv", "k2", b"survivor-from-b")
        return out + [_quiesce(ab, ba), _get(a, "dv", "k2"),
                      _get(b, "dv", "k2")]

    out = _on_zones(cluster_pair, "bd_dv", steps)
    assert out[2][0] == out[3][0] == 404
    assert out[6:] == [b"survivor-from-b"] * 2


def test_concurrent_local_puts_mint_distinct_pairs(cluster_pair):
    """Eight threads put one key in zone a: eight distinct pairs in its
    log, and the zones agree after sync. The puts race (which one wins is
    the race's), so the stores are compared by object names."""
    def steps(pkg, a, b, ab, ba):
        a.create_bucket("cc")
        b.create_bucket("cc")
        ts = [threading.Thread(target=a.put_object,
                               args=("cc", "k", f"t{i}".encode()))
              for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        log = a.io.omap_get(".rgwlog.cc")
        pairs = [tuple(json.loads(v)["pair"]) for v in log.values()]
        _quiesce(ab, ba)
        return [len(pairs), len(set(pairs)),
                _get(a, "cc", "k") == _get(b, "cc", "k")]

    assert _on_zones(cluster_pair, "bd_cc", steps, compare="names") == \
        [8, 8, True]


def test_failed_delete_mints_no_phantom_tombstone(cluster_pair):
    def steps(pkg, a, b, ab, ba):
        a.create_bucket("ph")
        b.create_bucket("ph")
        out = [rgw_err(pkg, lambda: a.delete_object("ph", "ghost"))]
        b.put_object("ph", "ghost", b"real")
        return out + [_quiesce(ab, ba), _get(a, "ph", "ghost"),
                      _get(b, "ph", "ghost")]

    out = _on_zones(cluster_pair, "bd_ph", steps)
    assert out[0] == (404, "NoSuchKey") and out[2:] == [b"real"] * 2


def test_versioned_generation_sets_converge(cluster_pair):
    def steps(pkg, a, b, ab, ba):
        for z in (a, b):
            z.create_bucket("vb")
            z.set_versioning("vb", "Enabled")
        a.put_object("vb", "doc", b"gen-a1")
        b.put_object("vb", "doc", b"gen-b1")
        out = [_quiesce(ab, ba)]
        vids = [sorted(e["vid"] for e in z.list_versions("vb", prefix="doc"))
                for z in (a, b)]
        return out + vids + [[a.get_object("vb", "doc", version_id=v)[0] ==
                              b.get_object("vb", "doc", version_id=v)[0]
                              for v in vids[0]]]

    out = _on_zones(cluster_pair, "bd_vb", steps)
    assert out[1] == out[2] and len(out[1]) == 2 and out[3] == [True, True]


def test_olh_current_converges_concurrent_puts(cluster_pair):
    """Concurrent versioned puts in both zones: both agree on the current
    generation, zone b's by the (1, "b") > (1, "a") order."""
    def steps(pkg, a, b, ab, ba):
        for z in (a, b):
            z.create_bucket("olh")
            z.set_versioning("olh", "Enabled")
        a.put_object("olh", "k", b"from-a")
        b.put_object("olh", "k", b"from-b")
        return [_quiesce(ab, ba), _versions_view(a, "olh"),
                _versions_view(b, "olh"),
                sum(1 for e in a.list_versions("olh") if e["is_current"]),
                _get(a, "olh", "k"), _get(b, "olh", "k")]

    out = _on_zones(cluster_pair, "bd_olh", steps)
    assert out[1] == out[2] and out[3] == 1
    assert out[4:] == [b"from-b"] * 2


def test_olh_current_converges_put_vs_delete_marker(cluster_pair):
    def steps(pkg, a, b, ab, ba):
        for z in (a, b):
            z.create_bucket("olhdm")
            z.set_versioning("olhdm", "Enabled")
        a.put_object("olhdm", "k", b"base")
        out = [_quiesce(ab, ba)]
        a.put_object("olhdm", "k", b"newer-a")
        b.delete_object("olhdm", "k")
        out += [_quiesce(ab, ba), _versions_view(a, "olhdm"),
                _versions_view(b, "olhdm"),
                [e for e in a.list_versions("olhdm") if e["is_current"]]]
        return out + [rgw_err(pkg, lambda z=z: z.get_object("olhdm", "k"))
                      for z in (a, b)]

    out = _on_zones(cluster_pair, "bd_olhdm", steps)
    assert out[2] == out[3]
    assert len(out[4]) == 1 and out[4][0].get("dm")
    assert out[5][0] == out[6][0] == 404


def test_olh_marker_loses_to_causally_later_put(cluster_pair):
    def steps(pkg, a, b, ab, ba):
        for z in (a, b):
            z.create_bucket("olhseq")
            z.set_versioning("olhseq", "Enabled")
        a.put_object("olhseq", "k", b"v1")
        out = [_quiesce(ab, ba)]
        b.delete_object("olhseq", "k")
        out.append(_quiesce(ab, ba))
        a.put_object("olhseq", "k", b"v2")
        return out + [_quiesce(ab, ba), _versions_view(a, "olhseq"),
                      _versions_view(b, "olhseq"), _get(a, "olhseq", "k"),
                      _get(b, "olhseq", "k")]

    out = _on_zones(cluster_pair, "bd_olhseq", steps)
    assert out[3] == out[4] and out[5:] == [b"v2"] * 2
