"""The port's RGW versioning, lifecycle, ACLs and deferred GC
(``ceph_tpu_torch/services/{rgw,rgw_lc}.py``) against the reference's, on
the CPU.

Counterparts of the 16 tests of ``tests/test_rgw_versioning.py``. Each
runs the reference test's steps with seeded payloads on a reference and a
port ``MiniCluster`` (up together for the module, a fresh pool a test;
a reference test that built on an earlier one's bucket repeats its steps)
and holds the port to the reference's returns, ``RGWError`` statuses,
HTTP statuses and bodies and stored objects, after the one normalization
of ``test_torch_rgw.py``. Tolerance 0.
"""

import time
import xml.etree.ElementTree as ET

import pytest

from test_torch_rgw import (  # noqa: F401  (cluster_pair: fixture)
    cluster_pair,
    http,
    payload,
    pkg_mod,
    rgw,
    rgw_err,
    rgw_on_both,
    serving,
    signed,
)

SPEC = {"pg_num": 4, "size": 2}


def _lc(pkg):
    return pkg_mod(pkg, "services.rgw_lc")


# -- versioning ---------------------------------------------------------

def test_olh_equal_seq_tie_repoints_deterministically(cluster_pair):
    """Two generations with an equal (origin seq, zone) pair: the one
    whose vid orders after the current wins the tie and repoints the
    index, the one ordering before does not; every generation stays
    readable by id."""
    def scenario(pkg, io):
        gw = rgw(pkg).RGWGateway(io)
        gw.create_bucket("tieb")
        gw.set_versioning("tieb", "Enabled")
        gw.put_object("tieb", "k", b"local")
        v1 = gw.last_version_id
        s1 = gw._ver_entries("tieb", "k")[v1]["oseq"][0]
        gw.put_object("tieb", "k", b"tie-wins", version_id="vzz-tie",
                      oseq=[s1, ""])
        out = [v1, gw.get_object("tieb", "k")[0],
               gw.list_objects("tieb", prefix="k")["k"]["vid"]]
        gw.put_object("tieb", "k", b"tie-loses", version_id="v-low",
                      oseq=[s1, ""])
        return out + [gw.get_object("tieb", "k")[0],
                      gw.list_objects("tieb", prefix="k")["k"]["vid"],
                      gw.get_object("tieb", "k", version_id=v1)[0],
                      gw.get_object("tieb", "k", version_id="v-low")[0]]

    out = rgw_on_both(cluster_pair, {"ver_tie": SPEC}, scenario)
    assert out[1:] == [b"tie-wins", "vzz-tie", b"tie-wins", "vzz-tie",
                       b"local", b"tie-loses"]


def _cycle(pkg, gw) -> list:
    """The reference's versioned put/get/delete cycle on bucket ``vb``."""
    gw.create_bucket("vb")
    gw.put_object("vb", "pre", b"pre-versioning")
    gw.set_versioning("vb", "Enabled")
    out = [gw.get_versioning("vb")]
    gw.put_object("vb", "k", b"one")
    v1 = gw.last_version_id
    gw.put_object("vb", "k", b"two")
    v2 = gw.last_version_id
    out += [v1, v2, gw.get_object("vb", "k")[0],
            gw.get_object("vb", "k", version_id=v1)[0],
            gw.get_object("vb", "k", version_id=v2)[0]]
    marker = gw.delete_object("vb", "k")
    out += [marker, rgw_err(pkg, lambda: gw.get_object("vb", "k")),
            gw.get_object("vb", "k", version_id=v1)[0]]
    gw.delete_object("vb", "k", version_id=marker)
    out.append(gw.get_object("vb", "k")[0])
    gw.delete_object("vb", "k", version_id=v2)
    return out + [gw.get_object("vb", "k")[0],
                  rgw_err(pkg, lambda: gw.get_object("vb", "k",
                                                     version_id=v2))]


def test_versioned_put_get_delete_cycle(cluster_pair):
    out = rgw_on_both(cluster_pair, {"ver_cycle": SPEC},
                      lambda pkg, io: _cycle(pkg, rgw(pkg).RGWGateway(io)))
    assert out[0] == "Enabled" and out[1] != out[2]
    assert out[3:6] == [b"two", b"one", b"two"]
    assert out[6] is not None and out[7][0] == 404 and out[8] == b"one"
    assert out[9:] == [b"two", b"one", (404, "NoSuchVersion")]


def test_null_version_preserved_on_enable(cluster_pair):
    """The pre-versioning generation survives as version 'null' (on the
    reference test's bucket, after its cycle)."""
    def scenario(pkg, io):
        gw = rgw(pkg).RGWGateway(io)
        _cycle(pkg, gw)
        if "pre" not in gw.list_objects("vb"):
            gw.put_object("vb", "pre", b"pre-versioning-2")
        gw.put_object("vb", "pre", b"after-enable")
        return [gw.list_versions("vb", prefix="pre"),
                gw.get_object("vb", "pre", version_id="null")[0],
                gw.get_object("vb", "pre")[0]]

    out = rgw_on_both(cluster_pair, {"ver_null": SPEC}, scenario)
    assert "null" in {e["vid"] for e in out[0]}
    assert out[1:] == [b"pre-versioning", b"after-enable"]


def test_suspended_overwrites_null_only(cluster_pair):
    def scenario(pkg, io):
        gw = rgw(pkg).RGWGateway(io)
        gw.create_bucket("sb")
        gw.set_versioning("sb", "Enabled")
        gw.put_object("sb", "x", b"kept")
        kept = gw.last_version_id
        gw.set_versioning("sb", "Suspended")
        gw.put_object("sb", "x", b"null-1")
        out = [gw.last_version_id]
        gw.put_object("sb", "x", b"null-2")
        return out + [[e["vid"] for e in gw.list_versions("sb", prefix="x")],
                      gw.get_object("sb", "x")[0],
                      gw.get_object("sb", "x", version_id=kept)[0]]

    out = rgw_on_both(cluster_pair, {"ver_susp": SPEC}, scenario)
    assert out[0] == "null" and out[1].count("null") == 1
    assert out[2:] == [b"null-2", b"kept"]


def test_versioning_over_http(cluster_pair):
    conf = (b"<VersioningConfiguration><Status>Enabled</Status>"
            b"</VersioningConfiguration>")

    def scenario(pkg, io):
        with serving(pkg, io) as (_, base):
            out = [http("PUT", f"{base}/hv"),
                   http("PUT", f"{base}/hv?versioning", conf),
                   http("GET", f"{base}/hv?versioning"),
                   http("PUT", f"{base}/hv/doc.txt", b"v1"),
                   http("PUT", f"{base}/hv/doc.txt", b"v2")]
            vid1 = out[3][1]["x-amz-version-id"]
            out += [http("GET", f"{base}/hv/doc.txt"),
                    http("GET", f"{base}/hv/doc.txt?versionId={vid1}"),
                    http("DELETE", f"{base}/hv/doc.txt")]
            marker = out[-1][1]["x-amz-version-id"]
            out += [http("GET", f"{base}/hv/doc.txt"),
                    http("GET", f"{base}/hv?versions"),
                    http("DELETE",
                         f"{base}/hv/doc.txt?versionId={marker}"),
                    http("GET", f"{base}/hv/doc.txt")]
        return out

    out = rgw_on_both(cluster_pair, {"ver_http": SPEC}, scenario)
    assert ET.fromstring(out[2][2]).findtext("Status") == "Enabled"
    vid1, vid2 = (out[i][1]["x-amz-version-id"] for i in (3, 4))
    assert vid1 != vid2 and out[5][2] == b"v2" and out[6][2] == b"v1"
    assert out[7][1]["x-amz-delete-marker"] == "true"
    marker = out[7][1]["x-amz-version-id"]
    assert out[8][0] == 404
    doc = ET.fromstring(out[9][2])
    assert {v.findtext("VersionId") for v in doc.findall("Version")} == \
        {vid1, vid2}
    assert [d.findtext("VersionId") for d in doc.findall("DeleteMarker")] \
        == [marker]
    assert out[11][2] == b"v2"


# -- lifecycle ----------------------------------------------------------

def test_lifecycle_expires_current_and_noncurrent(cluster_pair):
    """The clock driven through ``process(now=...)``: past one day the
    current generation gets a marker, past two the noncurrent ones are
    reaped and the orphaned marker swept; a quiesced pass does nothing."""
    def scenario(pkg, io):
        gw = rgw(pkg).RGWGateway(io)
        gw.create_bucket("lc")
        gw.set_versioning("lc", "Enabled")
        gw.put_object("lc", "logs/old", b"gen1")
        gw.put_object("lc", "logs/old", b"gen2")
        gw.put_object("lc", "keep/fresh", b"fresh")
        proc = _lc(pkg).LifecycleProcessor(gw, day_seconds=10.0)
        gw.set_lifecycle("lc", [
            {"id": "expire-logs", "prefix": "logs/", "status": "Enabled",
             "days": 1, "noncurrent_days": 2}])
        newest = max(float(e["mtime"]) for e in
                     gw.list_versions("lc", prefix="logs/old"))
        out = [proc.process(now=newest + 15.0),
               rgw_err(pkg, lambda: gw.get_object("lc", "logs/old")),
               gw.get_object("lc", "keep/fresh")[0],
               [e for e in gw.list_versions("lc", prefix="logs/old")
                if not e.get("dm")]]
        out += [proc.process(now=newest + 25.0),
                gw.list_versions("lc", prefix="logs/old"),
                proc.process(now=newest + 25.0)]
        return out

    out = rgw_on_both(cluster_pair, {"lc_vers": SPEC}, scenario)
    assert out[0]["expired"] == 1 and out[1][0] == 404
    assert out[2] == b"fresh" and len(out[3]) == 2
    assert out[4]["noncurrent_reaped"] == 2
    assert out[4]["markers_cleaned"] == 1 and out[5] == []
    assert (out[6]["expired"], out[6]["noncurrent_reaped"],
            out[6]["markers_cleaned"]) == (0, 0, 0)


def test_lifecycle_unversioned_deletes_for_good(cluster_pair):
    def scenario(pkg, io):
        gw = rgw(pkg).RGWGateway(io)
        gw.create_bucket("lcu")
        gw.put_object("lcu", "tmp/a", b"x")
        gw.put_object("lcu", "data/b", b"y")
        proc = _lc(pkg).LifecycleProcessor(gw, day_seconds=0.1)
        gw.set_lifecycle("lcu", [{"id": "tmp", "prefix": "tmp/",
                                  "status": "Enabled", "days": 1}])
        time.sleep(0.12)
        return [proc.process(), sorted(gw.list_objects("lcu"))]

    out = rgw_on_both(cluster_pair, {"lc_unv": SPEC}, scenario)
    assert out[0]["expired"] == 1 and out[1] == ["data/b"]


def test_lifecycle_over_http(cluster_pair):
    body = (b"<LifecycleConfiguration><Rule><ID>r1</ID>"
            b"<Filter><Prefix>tmp/</Prefix></Filter>"
            b"<Status>Enabled</Status>"
            b"<Expiration><Days>30</Days></Expiration>"
            b"</Rule></LifecycleConfiguration>")

    def scenario(pkg, io):
        with serving(pkg, io) as (_, base):
            return [http("PUT", f"{base}/hlc"),
                    http("PUT", f"{base}/hlc?lifecycle", body),
                    http("GET", f"{base}/hlc?lifecycle"),
                    http("DELETE", f"{base}/hlc?lifecycle"),
                    http("GET", f"{base}/hlc?lifecycle")]

    out = rgw_on_both(cluster_pair, {"lc_http": SPEC}, scenario)
    rule = ET.fromstring(out[2][2]).find("Rule")
    assert rule.findtext("ID") == "r1"
    assert rule.find("Filter").findtext("Prefix") == "tmp/"
    assert rule.find("Expiration").findtext("Days") == "30.0"
    assert out[4][0] == 404
    assert ET.fromstring(out[4][2]).findtext("Code") == \
        "NoSuchLifecycleConfiguration"


def test_lifecycle_thread_expires_in_the_background(cluster_pair):
    """The background worker (``LifecycleThread``) runs passes until
    stopped: an unversioned ``tmp/`` object expires without a call of
    ``process``. How many passes it makes meanwhile is the clock's, so the
    stores are compared by object bytes."""
    def scenario(pkg, io):
        gw = rgw(pkg).RGWGateway(io)
        gw.create_bucket("lct")
        gw.put_object("lct", "tmp/a", b"x")
        gw.put_object("lct", "data/b", b"y")
        gw.set_lifecycle("lct", [{"id": "tmp", "prefix": "tmp/",
                                  "status": "Enabled", "days": 1}])
        worker = _lc(pkg).LifecycleThread(gw, interval=0.05,
                                          day_seconds=0.01).start()
        try:
            deadline = time.monotonic() + 20
            while "tmp/a" in gw.list_objects("lct") and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
        finally:
            worker.stop()
        return [sorted(gw.list_objects("lct")), worker._thread.name,
                worker._thread.is_alive()]

    out = rgw_on_both(cluster_pair, {"lc_thread": SPEC}, scenario,
                      compare="data")
    assert out == [["data/b"], "rgw-lc", False]


# -- ACLs ---------------------------------------------------------------

CREDS = {"OWNER": "s1", "OTHER": "s2"}


def test_canned_acls_enforced(cluster_pair):
    conf = (b"<VersioningConfiguration><Status>Enabled</Status>"
            b"</VersioningConfiguration>")

    def scenario(pkg, io):
        with serving(pkg, io, auth=CREDS) as (srv, base):
            def owner(path, method="GET", data=b"", query="", headers=None):
                return signed(pkg, srv.port, "OWNER", "s1", path, method,
                              data, query, headers)

            def other(path, method="GET", data=b"", query="", headers=None):
                return signed(pkg, srv.port, "OTHER", "s2", path, method,
                              data, query, headers)

            def acl(canned):
                return {"x-amz-acl": canned}

            return [
                owner("/private", "PUT"),
                owner("/private/secret.txt", "PUT", b"classified"),
                owner("/private/secret.txt"), other("/private/secret.txt"),
                http("GET", f"{base}/private/secret.txt"),
                other("/private", "DELETE"),
                owner("/pub", "PUT", headers=acl("public-read")),
                owner("/pub/page.html", "PUT", b"<html>"),
                http("GET", f"{base}/pub/page.html"),
                other("/pub/page.html"), other("/pub/x", "PUT", b"no"),
                http("PUT", f"{base}/pub/x", b"no"),
                owner("/drop", "PUT", headers=acl("public-read-write")),
                other("/drop/from-other", "PUT", b"o"),
                http("PUT", f"{base}/drop/from-anon", b"a"),
                http("GET", f"{base}/drop/from-other"),
                owner("/ar", "PUT", headers=acl("authenticated-read")),
                owner("/ar/f", "PUT", b"members-only"), other("/ar/f"),
                http("GET", f"{base}/ar/f"),
                other("/private", "PUT", conf, query="versioning"),
                other("/private", "GET", query="acl"),
                owner("/private/open.txt", "PUT", b"open",
                      headers=acl("public-read")),
                http("GET", f"{base}/private/open.txt"),
                http("GET", f"{base}/private/secret.txt"),
                owner("/pub", query="acl"),
                http("PUT", f"{base}/anonbkt")]

    out = rgw_on_both(cluster_pair, {"acl_canned": SPEC}, scenario)
    status = [o[0] for o in out]
    assert status == [200, 200, 200, 403, 403, 403, 200, 200, 200, 200,
                      403, 403, 200, 200, 200, 200, 200, 200, 200, 403,
                      403, 403, 200, 200, 403, 200, 403]
    assert out[2][2] == b"classified" and out[8][2] == out[9][2] == b"<html>"
    assert out[15][2] == b"o" and out[18][2] == b"members-only"
    assert out[23][2] == b"open"
    doc = ET.fromstring(out[25][2])
    assert doc.find("Owner").findtext("ID") == "OWNER"
    uris = [g.findtext("Grantee/URI") for g in doc.find("AccessControlList")]
    assert any(u and u.endswith("AllUsers") for u in uris)


def test_multipart_into_versioned_bucket(cluster_pair):
    """Complete keeps the versioned data pointer and carries the multipart
    etag into the generation record."""
    p1, p2 = payload(1 << 20, 41), payload(100, 42)

    def scenario(pkg, io):
        gw = rgw(pkg).RGWGateway(io)
        gw.create_bucket("mpv")
        gw.set_versioning("mpv", "Enabled")
        up = gw.initiate_multipart("mpv", "big")
        e1 = gw.upload_part("mpv", "big", up, 1, p1)
        e2 = gw.upload_part("mpv", "big", up, 2, p2)
        etag = gw.complete_multipart("mpv", "big", up, [(1, e1), (2, e2)])
        data, meta = gw.get_object("mpv", "big")
        return [etag, data == p1 + p2, meta,
                gw.list_versions("mpv", prefix="big")]

    out = rgw_on_both(cluster_pair, {"mp_vers": SPEC}, scenario)
    etag, same, meta, gens = out
    assert etag.endswith("-2") and same is True
    assert meta["etag"] == etag and meta.get("vid")
    assert {e["vid"]: e for e in gens}[meta["vid"]]["etag"] == etag


def test_suspended_deletes_do_not_accumulate_markers(cluster_pair):
    def scenario(pkg, io):
        gw = rgw(pkg).RGWGateway(io)
        gw.create_bucket("sdm")
        gw.set_versioning("sdm", "Suspended")
        gw.put_object("sdm", "k", b"data")
        return [[gw.delete_object("sdm", "k") for _ in range(3)],
                gw.list_versions("sdm", prefix="k")]

    marks, vers = rgw_on_both(cluster_pair, {"susp_dm": SPEC}, scenario)
    assert marks == ["null"] * 3
    assert len(vers) == 1 and vers[0]["dm"] and vers[0]["vid"] == "null"


def test_object_acl_survives_version_resurface(cluster_pair):
    """Deleting the current generation by id keeps the resurfaced one's
    object ACL (private in a public-read bucket)."""
    def scenario(pkg, io):
        with serving(pkg, io, auth=CREDS) as (srv, base):
            gw = srv.gateway
            gw.create_bucket("aclver", owner="OWNER", acl="public-read")
            gw.set_versioning("aclver", "Enabled")
            gw.put_object("aclver", "k", b"gen1", acl="private",
                          owner="OWNER")
            gw.put_object("aclver", "k", b"gen2", acl="private",
                          owner="OWNER")
            v2 = gw.last_version_id
            out = [http("GET", f"{base}/aclver/k")]
            gw.delete_object("aclver", "k", version_id=v2)
            return out + [gw.get_object("aclver", "k")[0],
                          http("GET", f"{base}/aclver/k")]

    out = rgw_on_both(cluster_pair, {"acl_ver": SPEC}, scenario)
    assert out[0][0] == 403 and out[1] == b"gen1" and out[2][0] == 403


def test_anonymous_denied_on_ownerless_bucket(cluster_pair):
    def scenario(pkg, io):
        with serving(pkg, io, auth=CREDS) as (srv, base):
            srv.gateway.create_bucket("legacy")
            srv.gateway.put_object("legacy", "o", b"x")
            return [http("GET", f"{base}/legacy/o"),
                    signed(pkg, srv.port, "OTHER", "s2", "/legacy/o")]

    anon, other = rgw_on_both(cluster_pair, {"acl_anon": SPEC}, scenario)
    assert anon[0] == 403 and other[0] == 200 and other[2] == b"x"


# -- multisite replication of versioned objects -------------------------

def test_multisite_replicates_versions(cluster_pair):
    def scenario(pkg, io, io2):
        m = rgw(pkg)
        src = m.RGWGateway(io, zone_log=True)
        dst = m.RGWGateway(io2)
        agent = pkg_mod(pkg, "services.rgw_sync").RGWSyncAgent(src, dst)
        src.create_bucket("ms")
        src.set_versioning("ms", "Enabled")
        src.put_object("ms", "doc", b"gen-1")
        v1 = src.last_version_id
        out = [agent.sync_once(), dst.get_versioning("ms"),
               dst.get_object("ms", "doc")[0]]
        src.put_object("ms", "doc", b"gen-2")
        v2 = src.last_version_id
        marker = src.delete_object("ms", "doc")
        out += [v1, v2, marker, agent.sync_once(),
                dst.list_versions("ms", prefix="doc"),
                rgw_err(pkg, lambda: dst.get_object("ms", "doc")),
                dst.get_object("ms", "doc", version_id=v2)[0]]
        src.delete_object("ms", "doc", version_id=marker)
        return out + [agent.sync_once(), dst.get_object("ms", "doc")[0]]

    out = rgw_on_both(cluster_pair, {"ms_v1": SPEC, "ms_v2": SPEC},
                      scenario)
    assert out[1] == "Enabled" and out[2] == b"gen-1"
    v1, v2, marker = out[3:6]
    vers = {e["vid"]: e for e in out[7]}
    assert set(vers) == {v1, v2, marker}
    assert vers[marker]["dm"] and vers[marker]["is_current"]
    assert out[8][0] == 404 and out[9] == b"gen-2" and out[11] == b"gen-2"


def test_gc_reaps_orphaned_tails_after_crash_mid_delete(cluster_pair):
    """A gateway that dies mid-delete leaves striped tails and its GC
    enrollment; the lifecycle worker's GC pass reaps them; a healthy
    delete leaves no enrollment."""
    blob = payload(3 << 20, 43)

    def scenario(pkg, io):
        so_cls = pkg_mod(pkg, "client.striper").StripedObject
        gw = rgw(pkg).RGWGateway(io)
        gw.create_bucket("gcb")
        gw.put_object("gcb", "victim", blob)
        soid = "gcb/victim"
        out = [sorted(n for n in gw.io.list_objects()
                      if n.startswith(soid + "."))]
        orig = so_cls.remove

        def dying_remove(self):
            self.io.remove(self._piece(0))
            raise ConnectionError("gateway died mid-delete")

        so_cls.remove = dying_remove
        try:
            with pytest.raises(ConnectionError):
                gw.delete_object("gcb", "victim")
        finally:
            so_cls.remove = orig
        out += [sorted(gw.gc_list()),
                sorted(n for n in gw.io.list_objects()
                       if n.startswith(soid + "."))]
        time.sleep(2.1)
        out += [_lc(pkg).LifecycleProcessor(gw).process(),
                [n for n in gw.io.list_objects()
                 if n.startswith(soid + ".")], gw.gc_list()]
        gw.put_object("gcb", "fine", b"x" * 100)
        gw.delete_object("gcb", "fine")
        return out + [gw.gc_list()]

    out = rgw_on_both(cluster_pair, {"gc_crash": SPEC}, scenario)
    assert len(out[0]) >= 2 and out[1] == ["gcb/victim"] and out[2]
    assert out[3]["gc_entries"] == 1
    assert out[3]["gc_objects"] >= len(out[2])
    assert out[4] == [] and out[5] == {} and out[6] == {}


def test_gc_stale_enrollment_spares_reuploaded_object(cluster_pair):
    """A reaper pass holding a stale enrollment of generation A spares the
    re-uploaded generation B's live pieces (the tags); the same stale
    entry still reaps a crashed delete's orphaned pieces."""
    first, second = payload(2 << 20, 44), payload(2 << 20, 45)

    def scenario(pkg, io):
        so_cls = pkg_mod(pkg, "client.striper").StripedObject
        gw = rgw(pkg).RGWGateway(io)
        gw.create_bucket("gcrace")
        gw.put_object("gcrace", "obj", first)
        soid = "gcrace/obj"
        old_tag = so_cls(gw.io, soid).tag
        gw._gc_enroll(soid, old_tag)
        stale = {soid: (time.time() - 3600.0, old_tag)}
        gw.put_object("gcrace", "obj", second)
        new_tag = so_cls(gw.io, soid).tag
        real_pending = gw._gc_pending
        gw._gc_pending = lambda: stale
        try:
            out = [old_tag, new_tag, gw.gc_process(grace=0),
                   gw.get_object("gcrace", "obj")[0] == second]
        finally:
            gw._gc_pending = real_pending
        orig = so_cls.remove

        def dying_remove(self):
            raise ConnectionError("died mid-delete")

        so_cls.remove = dying_remove
        try:
            with pytest.raises(ConnectionError):
                gw.delete_object("gcrace", "obj")
        finally:
            so_cls.remove = orig
        out.append(sorted(gw.gc_list()))
        time.sleep(0.01)
        return out + [gw.gc_process(grace=0),
                      [n for n in gw.io.list_objects()
                       if n.startswith(soid + ".")], gw.gc_list()]

    out = rgw_on_both(cluster_pair, {"gc_race": SPEC}, scenario)
    old_tag, new_tag = out[0], out[1]
    assert old_tag and new_tag and new_tag != old_tag
    assert out[2] == {"entries": 1, "objects": 0} and out[3] is True
    assert out[4] == ["gcrace/obj"] and out[5]["objects"] > 0
    assert out[6] == [] and out[7] == {}
