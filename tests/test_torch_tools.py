"""The port's host tools (``ceph_tpu_torch.tools``: ``flame``,
``crushtool``, ``osdmaptool``, ``dencoder``, ``ceph_cli``, ``vstart``)
against the reference's (``ceph_tpu.tools``), on the CPU.

Counterparts of ``tests/test_placement_tools.py``,
``tests/test_admin_tools_offline.py``'s dencoder tests, the flame part of
``tests/test_profiler.py`` and ``tests/test_admin_tools.py``'s
``test_ceph_cli``: the same inputs go through both packages' tools, and
the outputs must be equal (crushtool and osdmaptool JSON, every dencoder
type's encoded bytes and JSON dump, flame's renderings, the ``ceph``
CLI's return codes and its deterministic outputs; ``status`` holds
epochs and addresses that differ between two clusters, so its keys are
compared, and ``osd tree`` is compared without addresses). Then
``vstart``: in process and as ``python -m``, its JSON has the reference's
keys, ``/metrics`` answers, SIGTERM stops it with exit 0, and without a
card its default backend (``auto_device``) raises before a cluster
starts. Every spawned process has its own timeout, and every cluster
takes ephemeral ports.
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu.qa.cluster import MiniCluster as RefCluster
from ceph_tpu.tools import ceph_cli as ref_ceph_cli
from ceph_tpu.tools import crushtool as ref_crushtool
from ceph_tpu.tools import dencoder as ref_dencoder
from ceph_tpu.tools import flame as ref_flame
from ceph_tpu.tools import osdmaptool as ref_osdmaptool
from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.ops import crc32c_torch
from ceph_tpu_torch.qa.cluster import MiniCluster
from ceph_tpu_torch.tools import (ceph_cli, crushtool, dencoder, flame,
                                  osdmaptool, vstart)
from ceph_tpu_torch.utils import profiler as prof_mod

ROOT = Path(__file__).resolve().parents[1]
#: each spawned tool process's own deadline, seconds
PROC_TIMEOUT = 120
#: the vstart subprocess test's own deadline, seconds
VSTART_DEADLINE = 60


def _run(fn, argv) -> tuple[int, str, str]:
    """``fn(argv)`` with stdout and stderr captured."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def _module(name: str, *argv, stdin: bytes | None = None,
            env: dict | None = None) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", f"ceph_tpu_torch.tools.{name}", *argv],
        input=stdin, capture_output=True, timeout=PROC_TIMEOUT, cwd=ROOT,
        env={**os.environ, **(env or {})})


def _json_docs(text: str) -> list:
    """The JSON documents printed one after the other in ``text``."""
    dec, docs, i = json.JSONDecoder(), [], 0
    text = text.strip()
    while i < len(text):
        doc, i = dec.raw_decode(text, i)
        docs.append(doc)
        while i < len(text) and text[i].isspace():
            i += 1
    return docs


# -- crushtool and osdmaptool (tests/test_placement_tools.py) -----------

def test_crushtool_build_show_test_equal_reference(tmp_path):
    maps = {}
    for pkg, tool in (("ref", ref_crushtool), ("port", crushtool)):
        out = tmp_path / f"{pkg}.json"
        assert tool.main(["--build", "12", "--per-host", "4",
                          "--out", str(out)]) == 0
        maps[pkg] = out.read_text()
    assert maps["ref"] == maps["port"]
    path = str(tmp_path / "port.json")
    for argv in (["--show"],
                 ["--test", "--num-rep", "3", "--max-x", "511"],
                 ["--test", "--num-rep", "11"],
                 ["--show", "--test", "--rule", "data", "--num-rep", "8",
                  "--min-x", "7", "--max-x", "300"]):
        ref = _run(ref_crushtool.main, ["--map", path, *argv])
        got = _run(crushtool.main, ["--map", path, *argv])
        assert got == ref, argv
        assert got[0] == 0, got
    rep = json.loads(_run(crushtool.main, [
        "--map", path, "--test", "--num-rep", "3", "--max-x", "511"])[1])
    assert rep["bad_mappings"] == 0
    assert len(rep["device_utilization"]) == 12
    assert rep["spread"]["stddev_pct"] < 20.0
    # 13 replicas on 12 OSDs: short mappings, exit 1 in both
    ref = _run(ref_crushtool.main, ["--map", path, "--test",
                                    "--num-rep", "13", "--max-x", "63"])
    assert _run(crushtool.main, ["--map", path, "--test", "--num-rep",
                                 "13", "--max-x", "63"]) == ref
    assert ref[0] == 1
    assert _run(crushtool.main, []) == _run(ref_crushtool.main, []) == \
        (22, "", "need --build or --map\n")


def test_crushtool_json_mapping_identical():
    """A map serialized and reloaded (ids become strings in JSON) gives
    the original's placements, and the reference's reload of the same
    document gives the same."""
    from ceph_tpu.parallel import crush as ref_crush
    from ceph_tpu_torch.parallel import crush
    cm = crush.build_flat_map(10, 3)
    doc = json.loads(json.dumps(crushtool.map_to_json(cm)))
    assert doc == json.loads(json.dumps(ref_crushtool.map_to_json(
        ref_crush.build_flat_map(10, 3))))
    cm2 = crushtool.map_from_json(doc)
    ref2 = ref_crushtool.map_from_json(doc)
    for x in range(200):
        assert cm.do_rule("data", x, 3) == cm2.do_rule("data", x, 3) == \
            ref2.do_rule("data", x, 3)
    assert crushtool.map_to_json(cm2) == crushtool.map_to_json(cm)


@pytest.mark.parametrize("argv", [
    ["--createsimple", "6", "--pg-num", "32", "--test-map-pgs"],
    ["--createsimple", "6", "--pg-num", "32", "--dump", "--test-map-pgs"],
    ["--createsimple", "8", "--ec", "4,2", "--pg-num", "16",
     "--test-map-pgs"],
    ["--createsimple", "12", "--ec", "8,3", "--pg-num", "32", "--dump",
     "--test-map-pgs"],
    ["--createsimple", "12", "--ec", "8,3", "--pool", "ecpool"],
], ids=["rep-test", "rep-dump-test", "ec42-test", "ec83-dump-test",
        "ec83-dump"])
def test_osdmaptool_createsimple_equal_reference(argv):
    ref = _run(ref_osdmaptool.main, argv)
    got = _run(osdmaptool.main, argv)
    assert got == ref
    assert got[0] == 0
    docs = _json_docs(got[1])
    if "--test-map-pgs" in argv:
        rep = docs[-1]
        assert rep["bad_mappings"] == 0
        assert rep["pgs"] == int(argv[argv.index("--pg-num") + 1])
    if "--dump" in argv or "--test-map-pgs" not in argv:
        pools = docs[0]["pools"]
        assert all(p["ec"] == ("--ec" in argv) for p in pools.values())
    assert _run(osdmaptool.main, []) == _run(ref_osdmaptool.main, []) == \
        (22, "", "need --createsimple or -m\n")


# -- dencoder (tests/test_admin_tools_offline.py) ----------------------

TYPES = sorted(dencoder._message_types()) + sorted(dencoder.STRUCTS)


def test_dencoder_list_and_test_equal_reference():
    ref = _run(ref_dencoder.main, ["list"])
    got = _run(dencoder.main, ["list"])
    assert got == ref
    assert got[1].split() == TYPES
    ref = _run(ref_dencoder.main, ["test"])
    got = _run(dencoder.main, ["test"])
    assert got == ref
    out = json.loads(got[1])
    assert got[0] == 0 and out["types"] == len(TYPES) >= 28
    assert not out["failures"]
    assert _run(dencoder.main, ["type", "NoSuchType", "encode"]) == \
        _run(ref_dencoder.main, ["type", "NoSuchType", "encode"])


class _Stdin:
    def __init__(self, raw: bytes) -> None:
        self.buffer = io.BytesIO(raw)


@pytest.mark.parametrize("name", TYPES)
def test_dencoder_type_encode_and_dump_equal_reference(name, capsysbinary,
                                                        monkeypatch):
    """``type NAME encode`` gives the reference's bytes; each package's
    ``decode`` and ``dump_json`` of those bytes give the same output."""
    out = {}
    for pkg, tool in (("ref", ref_dencoder), ("port", dencoder)):
        assert tool.main(["type", name, "encode"]) == 0
        out[pkg] = capsysbinary.readouterr().out
    assert out["port"] == out["ref"]
    assert out["port"]
    for action in ("decode", "dump_json"):
        got = {}
        for pkg, tool in (("ref", ref_dencoder), ("port", dencoder)):
            monkeypatch.setattr(sys, "stdin", _Stdin(out["port"]))
            assert tool.main(["type", name, action]) == 0
            got[pkg] = capsysbinary.readouterr().out
        assert got["port"] == got["ref"], action
        if action == "decode":
            assert got["port"] == b"ok\n"


def test_dencoder_hashinfo_host_and_linear_fold_to_the_same_bytes():
    """The sample folds with ``append`` (host hashing); the OSD's write
    path folds B2's linear crc parts with ``append_linear``. Both encode
    to the same bytes, and each round-trips through the dencoder's
    ``HashInfo`` entry."""
    spec = dencoder.STRUCTS["HashInfo"]
    host = spec["sample"]()
    chunks = {i: np.full(16, i, dtype=np.uint8) for i in range(3)}
    lin = crc32c_torch.crc_linear_device(
        torch.from_numpy(np.stack([chunks[i] for i in range(3)])))
    linear = ec_util.HashInfo(3)
    linear.append_linear(0, {i: int(lin[i]) for i in range(3)}, 16)
    raw = spec["encode"](host)
    assert spec["encode"](linear) == raw
    for h in (host, linear):
        back = spec["decode"](spec["encode"](h))
        assert spec["eq"](h, back) and spec["encode"](back) == raw
    ref_spec = ref_dencoder.STRUCTS["HashInfo"]
    assert ref_spec["encode"](ref_spec["sample"]()) == raw


def test_dencoder_cli_pipeline():
    """encode | dump_json through ``python -m``, as the reference's test
    drives its binary; the dump equals the reference's."""
    enc = _module("dencoder", "type", "OSDMap", "encode")
    assert enc.returncode == 0 and enc.stdout, enc.stderr
    dump = _module("dencoder", "type", "OSDMap", "dump_json",
                   stdin=enc.stdout)
    assert dump.returncode == 0, dump.stderr
    assert json.loads(dump.stdout)["epoch"] == 42
    spec = ref_dencoder.STRUCTS["OSDMap"]
    want = ref_dencoder._jsonable(spec["dump"](spec["decode"](enc.stdout)))
    assert json.loads(dump.stdout) == want
    listed = _module("dencoder", "list")
    assert listed.returncode == 0
    assert listed.stdout.decode().split() == TYPES


# -- flame (tests/test_profiler.py) -------------------------------------

FOLDED = "\n".join([
    "wire;Messenger._loop (parallel/messenger.py);socket recv 40",
    "wire;Messenger._loop (parallel/messenger.py);decode frame 12",
    "pg_process;OSD._do_op (osd/osd.py);ECBackend.submit 30",
    "pg_process;OSD._do_op (osd/osd.py);PG.lock wait 7",
    "commit_wait;Condition.wait (threading.py) 25",
    "idle;Event.wait (threading.py) 3",
    "idle;Event.wait (threading.py) 2",
    "garbage line",
    "",
    "engine_stage_wait;DeviceEncodeEngine._run;cuda sync 1",
])


def _busy_folded() -> str:
    """The port profiler's own export of a short burst of work."""
    prof_mod.reset_for_tests()
    p = prof_mod.profiler()
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(i * i for i in range(2000))

    worker = threading.Thread(target=spin, name="busy")
    worker.start()
    p.start(hz=200)
    try:
        time.sleep(0.4)
    finally:
        p.stop()
        stop.set()
        worker.join()
    text = p.folded()
    prof_mod.reset_for_tests()
    return text


@pytest.mark.parametrize("source", ["synthetic", "json", "profiler"])
def test_flame_renders_equal_reference(source):
    text = _busy_folded() if source == "profiler" else FOLDED
    if source == "json":
        text = json.dumps({"folded": text}, indent=2, sort_keys=True)
    stacks = flame.parse_folded(text)
    assert stacks == ref_flame.parse_folded(text)
    assert stacks and sum(stacks.values()) > 0
    if source != "profiler":
        # a frame may hold spaces: the count is after the last one
        assert stacks[("wire", "Messenger._loop (parallel/messenger.py)",
                       "socket recv")] == 40
        assert stacks[("idle", "Event.wait (threading.py)")] == 5
    tree = flame.render_tree(flame.build_tree(stacks))
    assert tree and tree == ref_flame.render_tree(
        ref_flame.build_tree(stacks))
    assert flame.render_tree(flame.build_tree(stacks), min_pct=0.0,
                             width=60) == ref_flame.render_tree(
        ref_flame.build_tree(stacks), min_pct=0.0, width=60)
    for n in (1, 5, 20):
        assert flame.render_top(stacks, n) == \
            ref_flame.render_top(stacks, n)
        assert flame.top_frames(stacks, n) == \
            ref_flame.top_frames(stacks, n)
    stage = next(iter(stacks))[0]
    assert flame.filter_stage(stacks, stage) == \
        ref_flame.filter_stage(stacks, stage)


def test_flame_cli_equal_reference(tmp_path):
    path = tmp_path / "dump.folded"
    path.write_text(FOLDED)
    for argv in ([str(path)], ["--top", "3", str(path)],
                 ["--stage", "idle", str(path)],
                 ["--min-pct", "20", str(path)],
                 ["--stage", "nope", str(path)]):
        assert _run(flame.main, argv) == _run(ref_flame.main, argv), argv
    assert _run(flame.main, ["--stage", "nope", str(path)]) == \
        (1, "", "no samples\n")
    piped = _module("flame", "--top", "10", "-",
                    stdin=FOLDED.encode())
    assert piped.returncode == 0, piped.stderr
    assert piped.stdout.decode() == _run(ref_flame.main,
                                         ["--top", "10", str(path)])[1]


# -- the ceph CLI and osdmaptool -m on live clusters --------------------

@pytest.fixture(scope="module")
def clusters():
    """A reference and a port MiniCluster of 3 OSDs, each with the
    reference test's pool and object."""
    with RefCluster(n_osds=3) as ref, MiniCluster(n_osds=3) as port:
        for c in (ref, port):
            c.create_pool("admpool", pg_num=2, size=3)
            c.client().open_ioctx("admpool").write_full("obj1",
                                                        b"x" * 1000)
        yield ref, port


def _no_addrs(v, drop=("addr",)):
    """``v`` without the keys two clusters cannot share: their OSDs'
    addresses and, for a live map, its epoch (each mon commits boots and
    pool changes at its own pace)."""
    if isinstance(v, dict):
        return {k: _no_addrs(x, drop) for k, x in v.items()
                if k not in drop}
    if isinstance(v, list):
        return [_no_addrs(x, drop) for x in v]
    return v


#: the reference test's commands, then its error cases; each runs on
#: both clusters in turn
CLI_STEPS = [
    ["status"], ["health"], ["health", "detail"], ["osd", "tree"],
    ["osd", "pool", "create", "clipool", "2", "2"],
    ["osd", "pool", "ls"],
    ["osd", "erasure-code-profile", "set", "cliec", "k=2", "m=1"],
    ["osd", "erasure-code-profile", "get", "cliec"],
    ["osd", "erasure-code-profile", "ls"],
    ["osd", "out", "1"], ["osd", "in", "1"],
    ["osd", "pool", "create", "clipool", "2", "2"],
    ["osd", "erasure-code-profile", "get", "nope"],
    ["no", "such", "command"],
]


def test_ceph_cli_equal_reference(clusters):
    ref, port = clusters
    for cmd in CLI_STEPS:
        want = _run(ref_ceph_cli.main, ["-m", ref.mon_addr, *cmd])
        got = _run(ceph_cli.main, ["-m", port.mon_addr, *cmd])
        assert got[0] == want[0], (cmd, got, want)
        assert got[2] == want[2], cmd
        if cmd == ["status"]:
            assert got[0] == 0
            assert sorted(json.loads(got[1])) == \
                sorted(json.loads(want[1]))
        elif cmd == ["osd", "tree"]:
            assert _no_addrs(json.loads(got[1])) == \
                _no_addrs(json.loads(want[1]))
        else:
            assert got[1] == want[1], cmd
    out = _run(ceph_cli.main, ["-m", port.mon_addr, "osd", "pool", "ls"])
    assert "clipool" in out[1]
    out = _run(ceph_cli.main, ["-m", port.mon_addr, "osd",
                               "erasure-code-profile", "get", "cliec"])
    assert json.loads(out[1])["k"] == "2"
    # usage errors, no mon contacted
    assert _run(ceph_cli.main, ["status"])[:2] == \
        _run(ref_ceph_cli.main, ["status"])[:2] == (22, "")
    assert _run(ceph_cli.main, ["daemon"]) == \
        _run(ref_ceph_cli.main, ["daemon"])


def test_ceph_cli_daemon_passthrough_equal_reference(clusters):
    ref, port = clusters
    for cmd in (["perf", "dump"], ["config", "get", "key=osd_heartbeat_grace"],
                ["status"], ["dump_ops_in_flight"], ["profile", "status"]):
        want = _run(ref_ceph_cli.main, ["daemon", ref.osds[0].asok.path,
                                        *cmd])
        got = _run(ceph_cli.main, ["daemon", port.osds[0].asok.path, *cmd])
        assert got[0] == want[0] == 0, cmd
        assert sorted(json.loads(got[1])) == sorted(json.loads(want[1])), cmd
    perf = json.loads(_run(ceph_cli.main, [
        "daemon", port.osds[0].asok.path, "perf", "dump"])[1])
    assert "op" in perf and "device_batches" in perf
    assert json.loads(_run(ceph_cli.main, [
        "daemon", port.osds[0].asok.path, "config", "get",
        "key=osd_heartbeat_grace"])[1]) == json.loads(_run(
            ref_ceph_cli.main, ["daemon", ref.osds[0].asok.path, "config",
                                "get", "key=osd_heartbeat_grace"])[1])


def test_osdmaptool_live_map_equal_reference(clusters):
    ref, port = clusters
    # settled after the CLI test's ``osd out`` / ``osd in``
    for c in clusters:
        c.wait_for_clean(timeout=30)
    for argv in (["--test-map-pgs"], ["--dump"]):
        want = _run(ref_osdmaptool.main, ["-m", ref.mon_addr, *argv])
        got = _run(osdmaptool.main, ["-m", port.mon_addr, *argv])
        assert got[0] == want[0] == 0, argv
        drop = ("addr", "epoch")
        assert _no_addrs(_json_docs(got[1]), drop) == \
            _no_addrs(_json_docs(want[1]), drop), argv
    rep = _json_docs(_run(osdmaptool.main, ["-m", port.mon_addr,
                                            "--test-map-pgs"])[1])[-1]
    assert rep["bad_mappings"] == 0 and rep["pgs"] >= 2


@pytest.mark.parametrize("name", ["crushtool", "osdmaptool", "flame",
                                  "ceph_cli"])
def test_tool_runs_as_module(name, clusters, tmp_path):
    _, port = clusters
    if name == "crushtool":
        proc = _module("crushtool", "--build", "6", "--per-host", "2")
        want = _run(crushtool.main, ["--build", "6", "--per-host", "2"])[1]
    elif name == "osdmaptool":
        proc = _module("osdmaptool", "-m", port.mon_addr, "--test-map-pgs")
        want = _run(osdmaptool.main, ["-m", port.mon_addr,
                                      "--test-map-pgs"])[1]
    elif name == "flame":
        path = tmp_path / "f.folded"
        path.write_text(FOLDED)
        proc = _module("flame", str(path))
        want = _run(flame.main, [str(path)])[1]
    else:
        proc = _module("ceph_cli", "-m", port.mon_addr, "osd", "pool", "ls")
        want = _run(ceph_cli.main, ["-m", port.mon_addr, "osd", "pool",
                                    "ls"])[1]
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert proc.stdout.decode() == want


# -- vstart -------------------------------------------------------------

def _vstart_proc(pkg: str, *argv) -> tuple[dict, int, str]:
    """``python -m PKG.tools.vstart ARGV``: the JSON it prints, then its
    exit code after SIGTERM and its stderr; all within VSTART_DEADLINE."""
    deadline = time.monotonic() + VSTART_DEADLINE
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.tools.vstart", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    lines: list[str] = []
    errs: list[str] = []
    readers = [threading.Thread(target=lambda f=f, acc=acc: acc.extend(f),
                                daemon=True)
               for f, acc in ((proc.stdout, lines), (proc.stderr, errs))]
    try:
        for r in readers:
            r.start()
        info = None
        while info is None and time.monotonic() < deadline \
                and proc.poll() is None:
            try:
                info = json.loads("".join(lines))
            except ValueError:
                time.sleep(0.1)
        assert info is not None, (proc.poll(), "".join(lines),
                                  "".join(errs)[-2000:])
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        for r in readers:
            r.join(timeout=5)
        return info, rc, "".join(errs)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ref_vstart_info():
    """The JSON the reference's vstart prints. Its exit code is not held:
    on the CPU the reference's process aborts at exit now and then
    (``FATAL: exception not rethrown``, 1 of 6 SIGTERMs), in its
    interpreter's teardown after its cluster stopped."""
    info, _rc, _err = _vstart_proc("ceph_tpu", "-n", "3", "--ec", "2,1",
                                   "--prometheus")
    return info


def test_vstart_start_in_process(ref_vstart_info):
    cluster, info, stop = vstart.start(
        ["-n", "3", "--ec", "2,1", "--backend", "torch", "--prometheus"])
    try:
        assert sorted(info) == sorted(ref_vstart_info)
        assert info["pools"] == ref_vstart_info["pools"] == ["rbd", "ecpool"]
        assert sorted(info["osd_asoks"]) == [0, 1, 2]
        assert info["mon_addr"] == cluster.mon_addr
        body = urllib.request.urlopen(info["metrics_url"],
                                      timeout=10).read().decode()
        assert "# TYPE ceph_tpu_" in body
        rc, out, _ = _run(ceph_cli.main, ["-m", info["mon_addr"], "osd",
                                          "erasure-code-profile", "get",
                                          "ecpool_profile"])
        assert rc == 0
        assert json.loads(out) == {"plugin": "jerasure", "k": "2", "m": "1",
                                   "backend": "torch"}
        io_ = cluster.client().open_ioctx("ecpool")
        io_.write_full("v", b"vstart" * 1000)
        assert io_.read("v") == b"vstart" * 1000
    finally:
        stop()


def test_vstart_subprocess_json_and_sigterm(ref_vstart_info):
    t0 = time.monotonic()
    info, rc, err = _vstart_proc("ceph_tpu_torch", "-n", "3", "--ec", "2,1",
                                 "--backend", "torch", "--prometheus")
    assert rc == 0, err[-2000:]
    assert sorted(info) == sorted(ref_vstart_info)
    assert sorted(info["osd_asoks"]) == ["0", "1", "2"]
    assert "cluster up" in err
    assert time.monotonic() - t0 < VSTART_DEADLINE


def test_vstart_without_a_card_refuses_the_default_backend(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    booted = []
    monkeypatch.setattr(MiniCluster, "start",
                        lambda self: booted.append(self) or self)
    with pytest.raises(ErasureCodeError, match="backend auto_device: no "
                                               "CUDA device"):
        vstart.start(["-n", "3", "--ec", "2,1"])
    assert not booted
    # with the card asked for by name, the mon refuses the profile
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(AssertionError, match="backend cuda: no CUDA device"):
        vstart.start(["-n", "3", "--ec", "2,1", "--backend", "cuda"])
    # as a process: no JSON, a non-zero exit, the error on stderr
    proc = _module("vstart", "-n", "3", "--ec", "2,1",
                   env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert not proc.stdout
    assert b"backend auto_device: no CUDA device" in proc.stderr
