"""The port's in-OSD object classes (``ceph_tpu_torch/cls/``) and the OSD's
``OSD_OP_CALL`` against the reference's (``ceph_tpu/cls/``,
``ceph_tpu/osd/osd.py``), on the CPU.

Counterparts of the 14 tests of ``tests/test_cls.py``: the pure method
tests run each step through both packages' ``cls.call`` and compare the
``(code, out, new_obj)`` of every step; the end-to-end tests run the
reference test's steps through ``ioctx.execute`` on a reference and a
port ``MiniCluster`` (up together, a fresh pool a test) and compare the
outputs and the pool's stored objects. Beside them: ``cls.methods()`` is
equal between the packages, and every registered method, given the same
inputs and objects, returns the same ``(code, out, new_obj)``. The
classes' clock is a counter in both packages (``deterministic``).
Tolerance 0.
"""

import json
import threading

import pytest

from test_torch_striper import (  # noqa: F401  (cluster_pair: fixture)
    PKGS,
    cluster_pair,
    deterministic,
    on_both,
    pkg_mod,
)

REF, PORT = PKGS


def _norm(pkg: str, result):
    """``(code, out, new_obj)`` with the REMOVE sentinel named."""
    code, out, new = result
    return code, out, "REMOVE" if new is pkg_mod(pkg, "cls").REMOVE else new


def _steps(pkg: str, steps):
    """Run ``steps`` [(cls, method, input, obj or a step index)] through
    ``pkg``'s classes; an int obj takes that step's new object."""
    mod = pkg_mod(pkg, "cls")
    trace = []
    with deterministic(pkg):
        for cls_name, method, inp, obj in steps:
            if isinstance(obj, int):
                obj = trace[obj][2]
            trace.append(_norm(pkg, mod.call(cls_name, method, inp, obj)))
    return trace


def _both_steps(steps):
    ref, port = _steps(REF, steps), _steps(PORT, steps)
    assert port == ref
    return port


def _j(obj) -> bytes:
    return json.dumps(obj).encode()


# -- pure -----------------------------------------------------------------

def test_methods_equal_reference():
    assert pkg_mod(PORT, "cls").methods() == pkg_mod(REF, "cls").methods()
    assert "lock.lock" in pkg_mod(PORT, "cls").methods()


def test_registry_and_unknown_method():
    trace = _both_steps([("nope", "nope", b"", None)])
    assert trace == [(-8, b"", None)]


def test_lock_semantics_pure():
    req = {"name": "l", "cookie": "c1", "type": "exclusive", "duration": 0}
    req2 = dict(req, cookie="c2")
    trace = _both_steps([
        ("lock", "lock", _j(req), None),
        ("lock", "lock", _j(req2), 0),
        ("lock", "lock", _j(req), 0),
        ("lock", "unlock", _j({"name": "l", "cookie": "c1"}), 2),
        ("lock", "lock", _j(req2), 3)])
    assert [t[0] for t in trace] == [0, -16, 0, 0, 0]


def test_version_refcount_numops_pure():
    trace = _both_steps([
        ("version", "set", b'{"ver": 5, "tag": "t"}', None),
        ("version", "inc", b"", 0),
        ("version", "read", b"", 1),
        ("version", "check", b'{"ver": 6, "op": "eq"}', 1),
        ("version", "check", b'{"ver": 7, "op": "ge"}', 1),
        ("refcount", "get", b'{"tag": "a"}', None),
        ("refcount", "get", b'{"tag": "b"}', 5),
        ("refcount", "read", b"", 6),
        ("refcount", "put", b'{"tag": "a"}', 6),
        ("refcount", "put", b'{"tag": "b"}', 8),
        ("numops", "add", b'{"key": "x", "value": 2.5}', None),
        ("numops", "mul", b'{"key": "x", "value": 4}', 10)])
    assert json.loads(trace[2][1]) == {"ver": 6, "tag": "t"}
    assert trace[3][0] == 0 and trace[4][0] == -125
    assert json.loads(trace[7][1]) == ["a", "b"]
    assert trace[8][2] != "REMOVE" and trace[9][2] == "REMOVE"
    assert json.loads(trace[11][1]) == {"x": 10.0}


def test_timeindex_statelog_pure():
    steps = []
    for i, (ts, key) in enumerate(((10.0, "a"), (20.0, "b"), (30.0, "c"))):
        steps.append(("timeindex", "add", _j({"ts": ts, "key": key}),
                      i - 1 if i else None))
    steps += [("timeindex", "list", b'{"from": 15, "to": 35}', 2),
              ("timeindex", "trim", b'{"to": 25}', 2),
              ("timeindex", "list", b"", 4),
              ("statelog", "add",
               b'{"client": "c1", "op_id": 1, "state": "started"}', None),
              ("statelog", "list", b'{"client": "c1"}', 6),
              ("statelog", "remove", b'{"client": "c1", "op_id": 1}', 6),
              ("statelog", "list", b"", 8)]
    trace = _both_steps(steps)
    assert [e["key"] for e in json.loads(trace[3][1])] == ["b", "c"]
    assert [e["key"] for e in json.loads(trace[5][1])] == ["c"]
    assert json.loads(trace[7][1])["c1/1"]["state"] == "started"
    assert json.loads(trace[9][1]) == {}


#: one request carrying every key the classes read, with plausible values
SINK = {"name": "n", "key": "k", "id": "i", "source": "s", "value": 3,
        "ver": 2, "type": "exclusive", "to": 50, "from": 0, "tag": "t",
        "src": "n", "dst": "m", "size": 10, "pos": 4, "pair": "p",
        "meta": {"size": 1}, "max_entries": 5, "bucket": "b", "zone": "z",
        "ts": 12.0, "token": "123456", "t": 1.7e9, "step": 1,
        "state": "s", "secret": "3132333435363738393031323334353637383930",
        "refs": ["a"], "prefix": "", "part": 1, "owner": "o", "op": "eq",
        "object": "o", "max_keys": 5, "marker": "", "keep": 1, "ino": 5,
        "etag": "e", "duration": 0, "digits": 6, "count": 1, "cookie": "c",
        "client": "c", "bytes": 7, "op_id": 1}
INPUTS = (b"", b"{}", b"null", b"[1]", b"raw text", _j(SINK),
          _j(dict(SINK, type="shared", op="ge", value=-1.5)))


def _every_method(pkg: str):
    """Each method of each class on every input, first on no object, then
    on the object the class's earlier calls left (threaded per class)."""
    mod = pkg_mod(pkg, "cls")
    trace, objs = [], {}
    with deterministic(pkg):
        for name in mod.methods():
            cls_name, method = name.split(".")
            for inp in INPUTS:
                for obj in (None, objs.get(cls_name)):
                    res = _norm(pkg, mod.call(cls_name, method, inp, obj))
                    trace.append((name, inp, obj, res))
                    if isinstance(res[2], bytes):
                        objs[cls_name] = res[2]
    return trace


def test_every_method_equals_reference():
    ref, port = _every_method(REF), _every_method(PORT)
    assert len(port) == len(ref) > 55 * len(INPUTS)
    for got, want in zip(port, ref):
        assert got == want, want[:3]
    # the sweep reached mutations and reads, not only refusals
    assert any(isinstance(r[3][2], bytes) for r in port)
    assert any(r[3][0] == 0 and r[3][1] for r in port)


# -- end to end through OSD_OP_CALL ----------------------------------------

def _raises(pkg, fn) -> int:
    with pytest.raises(pkg_mod(pkg, "client.rados").RadosError) as ei:
        fn()
    return ei.value.code


def test_exec_lock_end_to_end(cluster_pair):
    lock = {"name": "watch", "cookie": "me", "type": "exclusive",
            "duration": 0}
    other = dict(lock, cookie="you")

    def scenario(pkg, io):
        io.execute("guarded", "lock", "lock", _j(lock))
        code = _raises(pkg, lambda: io.execute("guarded", "lock", "lock",
                                               _j(other)))
        info = json.loads(io.execute("guarded", "lock", "info"))
        io.execute("guarded", "lock", "unlock",
                   _j({"name": "watch", "cookie": "me"}))
        io.execute("guarded", "lock", "lock", _j(other))
        return code, info

    code, info = on_both(cluster_pair, "lockpool", scenario)
    assert code == -16 and "watch/me" in info["lockers"]


def test_exec_log_end_to_end(cluster_pair):
    def scenario(pkg, io):
        for i in range(5):
            io.execute("events", "log", "add", f"event-{i}".encode())
        out = [json.loads(io.execute("events", "log", "list")),
               json.loads(io.execute("events", "log", "list",
                                     _j({"max_entries": 2})))]
        io.execute("events", "log", "trim", _j({"keep": 1}))
        out.append(json.loads(io.execute("events", "log", "list")))
        out.append(io.stat("events"))
        return out

    out = on_both(cluster_pair, "logpool", scenario)
    assert [e["data"] for e in out[0]] == [f"event-{i}" for i in range(5)]
    assert [e["data"] for e in out[1]] == ["event-3", "event-4"]
    assert [e["data"] for e in out[2]] == ["event-4"]
    assert out[3] > 0


def test_refcount_removal_end_to_end(cluster_pair):
    def scenario(pkg, io):
        io.execute("rc_obj", "refcount", "get", b'{"tag": "one"}')
        state = io.read("rc_obj")
        io.execute("rc_obj", "refcount", "put", b'{"tag": "one"}')
        return state, _raises(pkg, lambda: io.read("rc_obj"))

    state, code = on_both(cluster_pair, "rcpool", scenario)
    assert state and code == -2


def test_hello_end_to_end(cluster_pair):
    def scenario(pkg, io):
        out = [io.execute("greet", "hello", "say_hello", b"ceph")]
        io.execute("greet", "hello", "record_hello", b"tpu")
        out.append(io.execute("greet", "hello", "replay", b""))
        return out

    assert on_both(cluster_pair, "hellopool", scenario) == \
        [b"Hello, ceph!", b"Hello, tpu!"]


def test_cls_rbd_directory_atomicity(cluster_pair):
    """Concurrent image creates and removes through the in-OSD directory
    methods lose no entry, in both packages (the racing ops leave their
    versions in their order: object bytes compared)."""
    import concurrent.futures

    def scenario(pkg, io):
        rbd_mod = pkg_mod(pkg, "services.rbd")
        rbd = rbd_mod.RBD(io)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda i: rbd.create(f"img{i}", 1 << 20),
                          range(12)))
        out = [rbd.list()]
        with pytest.raises(rbd_mod.RBDError):
            rbd.create("img0", 1 << 20)
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda i: rbd.remove(f"img{i}"), range(12)))
        out.append(rbd.list())
        rbd.create("old", 4096)
        io.execute("rbd_directory", "rbd", "dir_rename_image",
                   _j({"src": "old", "dst": "new"}))
        out.append(rbd.list())
        io.execute("rbd_directory", "rbd", "dir_remove_image",
                   _j({"name": "new"}))
        return out

    out = on_both(cluster_pair, "rbddir", scenario, compare="data")
    assert out == [sorted(f"img{i}" for i in range(12)), [], ["new"]]


def test_cls_user_accounting(cluster_pair):
    def scenario(pkg, io):
        for b, cnt, size in (("b1", 3, 300), ("b2", 1, 50), ("b1", 2, 10)):
            io.execute(".user.alice", "user", "add_bucket",
                       _j({"bucket": b, "count": cnt, "bytes": size}))
        out = [json.loads(io.execute(".user.alice", "user", "get_header"))]
        io.execute(".user.alice", "user", "remove_bucket",
                   _j({"bucket": "b2"}))
        out.append(json.loads(io.execute(".user.alice", "user",
                                         "get_header")))
        return out

    out = on_both(cluster_pair, "userpool", scenario)
    assert out[0]["stats"] == {"count": 6, "bytes": 360}
    assert out[0]["buckets"] == ["b1", "b2"]
    assert out[1]["stats"] == {"count": 5, "bytes": 310}


def test_cls_cas_chunk_refcounting(cluster_pair):
    oid = "chunk.abc123"

    def scenario(pkg, io):
        for src in ("obj1", "obj2", "obj1"):
            io.execute(oid, "cas", "chunk_create_or_get_ref",
                       _j({"source": src}))
        refs = json.loads(io.execute(oid, "cas", "references"))
        for src in ("obj1", "obj2"):
            io.execute(oid, "cas", "chunk_put_ref", _j({"source": src}))
        return refs, _raises(pkg, lambda: io.read(oid))

    refs, code = on_both(cluster_pair, "caspool", scenario)
    assert refs["refs"] == ["obj1", "obj2"] and code == -2


def test_cls_otp_totp(cluster_pair):
    secret = "3132333435363738393031323334353637383930"  # RFC 6238 key
    now = 1.7e9

    def scenario(pkg, io):
        totp = pkg_mod(pkg, "cls.classes")._totp
        io.execute(".otp.box", "otp", "create",
                   _j({"id": "admin", "secret": secret}))
        out = []
        for token in (totp(secret, now), totp(secret, now - 30), "000000"):
            out.append(json.loads(io.execute(
                ".otp.box", "otp", "check",
                _j({"id": "admin", "token": token, "t": now}))))
        return [totp(secret, now)] + out

    good, *checks = on_both(cluster_pair, "otppool", scenario)
    assert checks[0]["ok"] is True and checks[1]["ok"] is True
    assert checks[2]["ok"] is False or good == "000000"


def test_cls_journal_control_plane(cluster_pair):
    """The journal class's registry, monotonic commits, retirement and
    trim floor through the Journaler; the first commits race (the
    registry's key order follows them: object names compared)."""
    def scenario(pkg, io):
        jmod = pkg_mod(pkg, "services.journal")
        j = jmod.Journaler(io, "clsjrn")
        j.create()
        for i in range(10):
            j.append(f"entry-{i}".encode())
        js = [jmod.Journaler(io, "clsjrn") for _ in range(4)]
        ts = [threading.Thread(target=js[i].commit,
                               args=(f"reader-{i}", i + 1))
              for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        out = [j.clients()]
        jmod.Journaler(io, "clsjrn").commit("reader-3", 1)
        out.append(j.committed("reader-3"))
        for i in range(4):
            jmod.Journaler(io, "clsjrn").commit(f"reader-{i}", 200)
        j.retire("reader-0")
        with pytest.raises(jmod.JournalError):
            jmod.Journaler(io, "clsjrn").commit("reader-0", 5)
        floor = j.trim()
        out += [floor, j.trim_floor(), sorted(j.clients())]
        return out

    out = on_both(cluster_pair, "jrnpool", scenario, compare="names")
    assert out[0] == {f"reader-{i}": i + 1 for i in range(4)}
    assert out[1] == 4 and out[2] > 0 and out[3] == out[2]
    assert "reader-0" not in out[4]


def test_cls_journal_migrates_legacy_control_state(cluster_pair):
    def scenario(pkg, io):
        jmod = pkg_mod(pkg, "services.journal")
        j = jmod.Journaler(io, "legacyjrn")
        j.create()
        for i in range(5):
            j.append(f"e{i}".encode())
        hdr = j.header_oid
        io.execute(f"{hdr}.clients", "log", "add", b"reader-a")
        io.execute(f"{hdr}.clients", "log", "add", b"reader-b")
        io.execute(f"{hdr}.clients", "log", "add", b"retired/reader-b")
        io.write_full(f"{hdr}.client.reader-a", (3).to_bytes(8, "little"))
        io.write_full(f"{hdr}.trimmed", (64).to_bytes(8, "little"))
        fresh = jmod.Journaler(io, "legacyjrn")
        out = [fresh.committed("reader-a"), fresh.clients(),
               fresh.trim_floor(),
               _raises(pkg, lambda: io.read(f"{hdr}.client.reader-a")),
               jmod.Journaler(io, "legacyjrn").committed("reader-a")]
        return out

    out = on_both(cluster_pair, "legacypool", scenario)
    assert out == [3, {"reader-a": 3}, 64, -2, 3]
