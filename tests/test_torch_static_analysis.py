"""The port's static-analysis gate (``ceph_tpu_torch/analysis/linters``)
and the wire round-trip contract, on the CPU.

Counterparts of ``tests/test_static_analysis.py``. Gate: the seven AST
lint families over the whole ``ceph_tpu_torch`` package report zero
findings outside the justified baseline
(``ceph_tpu_torch/analysis/baseline.json``) and zero stale baseline
entries, the verdict ``python -m ceph_tpu_torch.analysis`` exits
non-zero on.

Each family is proven live by seeding a synthetic violation and
asserting it is caught, and clean on its clean case. Every planted and
clean source also goes through the reference's checker of the same
family (``ceph_tpu/analysis/linters``) under the reference's package
path, and the two key sets must be equal once ``ceph_tpu/`` reads
``ceph_tpu_torch/``: a port that drifts from the reference fails even
where it matches the expectation written here. The reference's
jit-hygiene family looks at ``@jax.jit`` and Pallas bodies, which the
port has none of; its counterpart is launch hygiene: host syncs inside
the functions of ``ops/*_cuda.py`` that launch a kernel and inside the
fused flush's device step (``osd/ec_util.py``).

The encode -> decode round-trip over every message type of the port's
``parallel/messages.py`` keeps the wire-symmetry lint and the runtime
contract together, and each payload equals the reference's encoding.
"""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from ceph_tpu.analysis import linters as ref_linters
from ceph_tpu.parallel import messages as RM
from ceph_tpu_torch.analysis import linters
from ceph_tpu_torch.parallel import messages as M


def _src(text: str, rel: str = "ceph_tpu_torch/synthetic.py"
         ) -> linters.SourceFile:
    return linters.SourceFile("/synthetic/" + rel, text, rel=rel)


def _to_ref(text: str) -> str:
    return text.replace("ceph_tpu_torch", "ceph_tpu")


def _from_ref(key: str) -> str:
    return re.sub(r"\bceph_tpu(?=[/.])", "ceph_tpu_torch", key)


def _ref_src(text: str, rel: str) -> ref_linters.SourceFile:
    return ref_linters.SourceFile("/synthetic/" + _to_ref(rel),
                                  _to_ref(text), rel=_to_ref(rel))


def _check(name: str, text: str,
           rel: str = "ceph_tpu_torch/synthetic.py") -> list:
    """The port's ``name`` checker on one source, held to the
    reference's checker of the same name on the same source under the
    reference's package path: equal key sets, or the test fails."""
    port = getattr(linters, name)(_src(text, rel=rel))
    ref = getattr(ref_linters, name)(_ref_src(text, rel))
    assert {f.key for f in port} == {_from_ref(f.key) for f in ref}, \
        (name, [f.key for f in port], [f.key for f in ref])
    return port


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def test_package_gate_zero_new_zero_stale():
    findings = linters.run_all()
    new, stale = linters.diff_baseline(findings)
    assert not new, "NEW lint findings (fix them or justify in " \
        "ceph_tpu_torch/analysis/baseline.json):\n" + \
        "\n".join(f.format() for f in new)
    assert not stale, "STALE baseline entries (the violation no " \
        f"longer exists; prune them): {[e['key'] for e in stale]}"


def test_scan_covers_the_port_only():
    rels = {s.rel.replace(os.sep, "/") for s in linters.iter_sources()}
    assert "ceph_tpu_torch/osd/device_engine.py" in rels
    assert "ceph_tpu_torch/ops/gf_cuda.py" in rels
    assert all(r.startswith("ceph_tpu_torch/") for r in rels)


def test_lint_baseline_entries_are_justified():
    baseline = linters.load_baseline()
    assert baseline.get("lint"), "baseline should carry the known set"
    for ent in baseline["lint"]:
        assert ent.get("justification", "").strip(), ent
        assert not ent["justification"].startswith("TODO"), \
            f"unjustified baseline entry: {ent['key']}"


@pytest.mark.parametrize("cmd", [["-m", "ceph_tpu_torch.analysis"],
                                 ["-m", "ceph_tpu_torch.tools.analyze"]])
def test_cli_entry_points_exit_zero_on_clean_tree(cmd):
    proc = subprocess.run([sys.executable, *cmd], capture_output=True,
                          text=True, cwd=linters.REPO_ROOT, timeout=300)
    assert proc.returncode == 0, (cmd, proc.stdout, proc.stderr)
    assert "0 new" in proc.stdout and "0 stale" in proc.stdout


def test_cli_exits_nonzero_on_new_finding(tmp_path):
    bad = tmp_path / "pkg" / "bad.py"
    bad.parent.mkdir()
    bad.write_text(
        "class C:\n"
        "    def __init__(self):\n"
        "        import threading\n"
        "        self._lock = threading.Lock()\n"
        "        self.x = 0\n"
        "    def locked_read(self):\n"
        "        with self._lock:\n"
        "            return self.x\n"
        "    def racy_write(self):\n"
        "        self.x = 1\n")
    from ceph_tpu_torch.tools.analyze import main
    assert main(["--root", str(tmp_path / "pkg")]) == 1


def test_cli_exits_nonzero_on_stale_baseline(tmp_path):
    clean = tmp_path / "pkg" / "ok.py"
    clean.parent.mkdir()
    clean.write_text("X = 1\n")
    stale = tmp_path / "baseline.json"
    stale.write_text(json.dumps({
        "lint": [{"key": "registry_drift:counter-unused:ghost",
                  "justification": "was real once"}],
        "witness": []}))
    from ceph_tpu_torch.tools.analyze import main
    assert main(["--root", str(tmp_path / "pkg"),
                 "--baseline", str(stale)]) == 1


def test_cli_subprocess_exits_nonzero_on_stale_baseline(tmp_path):
    """``python -m ceph_tpu_torch.analysis`` over the live tree with one
    extra (stale) entry in a copy of the baseline exits 1 and names it."""
    baseline = linters.load_baseline()
    baseline["lint"].append({"key": "registry_drift:counter-unused:ghost",
                             "justification": "was real once"})
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(baseline))
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.analysis", "--baseline",
         str(path)], capture_output=True, text=True,
        cwd=linters.REPO_ROOT, timeout=300)
    assert proc.returncode == 1, (proc.stdout, proc.stderr)
    assert "STALE baseline entry registry_drift:counter-unused:ghost" \
        in proc.stdout


# ---------------------------------------------------------------------------
# family 1: wire symmetry, seeded violations
# ---------------------------------------------------------------------------

def _wire_keys(text: str) -> set[str]:
    fs = _check("check_wire_symmetry", text)
    return {f.key.split(":", 2)[-1] for f in fs}


def test_wire_symmetry_field_order_asymmetry_caught():
    text = '''
class MBad:
    MSG_TYPE = 250
    FIELDS = [("tid", "u64"), ("oid", "str")]
    def encode_payload(self):
        e = Encoder()
        Encoder.u64(e, self.tid)
        Encoder.str(e, self.oid)
        return e.getvalue()
    @classmethod
    def decode_payload(cls, buf):
        d = Decoder(buf)
        msg = cls()
        if not d.eof():
            msg.oid = Decoder.str(d)
        if not d.eof():
            msg.tid = Decoder.u64(d)
        return msg
'''
    keys = _wire_keys(text)
    assert any(k.startswith("MBad:field-order-asymmetry")
               for k in keys), keys


def test_wire_symmetry_one_sided_override_caught():
    text = '''
class MHalf:
    MSG_TYPE = 251
    FIELDS = [("tid", "u64")]
    def encode_payload(self):
        e = Encoder()
        Encoder.u64(e, self.tid)
        return e.getvalue()
'''
    assert "MHalf:override-asymmetry" in _wire_keys(text)


def test_wire_symmetry_unknown_kind_and_dup_caught():
    text = '''
class MA:
    MSG_TYPE = 252
    FIELDS = [("a", "u64"), ("a", "u64"), ("b", "quux")]
class MB:
    MSG_TYPE = 252
    FIELDS = [("c", "u64")]
'''
    keys = _wire_keys(text)
    assert "MA:dup-field:a" in keys
    assert "MA:unknown-kind:b" in keys
    assert "MB:dup-msg-type:252" in keys


def test_wire_symmetry_tail_intolerant_decode_caught():
    text = '''
class MTail:
    MSG_TYPE = 253
    FIELDS = [("tid", "u64"), ("stages", "str")]
    def encode_payload(self):
        e = Encoder()
        Encoder.u64(e, self.tid)
        Encoder.str(e, self.stages)
        return e.getvalue()
    @classmethod
    def decode_payload(cls, buf):
        d = Decoder(buf)
        msg = cls()
        msg.tid = Decoder.u64(d)
        msg.stages = Decoder.str(d)
        return msg
'''
    assert "MTail:decode-not-tail-tolerant" in _wire_keys(text)


def test_wire_symmetry_real_messages_clean():
    src = [s for s in linters.iter_sources()
           if s.rel.endswith("parallel/messages.py")][0]
    assert linters.check_wire_symmetry(src) == []


# ---------------------------------------------------------------------------
# family 2: launch hygiene, seeded violations
# ---------------------------------------------------------------------------

def _launch_keys(body: str,
                 rel: str = "ceph_tpu_torch/ops/synth_cuda.py") -> set[str]:
    fs = linters.check_launch_hygiene(_src(body, rel=rel))
    return {f.key.split(":", 2)[-1] for f in fs}


_WRAPPER = '''
import numpy as np
import torch
launches = 0
def matvec(mat: np.ndarray, data: torch.Tensor, n: int) -> torch.Tensor:
    if not data.is_cuda:
        return data
    if data.dtype != torch.uint8 or data.dim() != 2 or not \\
            data.is_contiguous() or data.data_ptr() % 16:
        raise ValueError("bad")
    out = torch.empty((n, data.shape[1]), dtype=torch.uint8,
                      device=data.device)
    vec = int(n % 16 == 0 and data.data_ptr() % 16 == 0)
    {body}
    err = _lib().synth_launch(data.data_ptr(), out.data_ptr(), vec)
    global launches
    launches += 1
    return out
'''


def test_launch_wrapper_metadata_is_clean():
    """Shape, dtype, device, data_ptr(), dim(), is_contiguous() and
    arithmetic on them are host metadata: no finding."""
    assert _launch_keys(_WRAPPER.format(body="pass")) == set()


@pytest.mark.parametrize("body,key", [
    ("total = int(data.sum())", "matvec:host-sync:int:data.sum()"),
    ("peak = data.max().item()", "matvec:host-sync:item:data.max()"),
    ("rows = out.tolist()", "matvec:host-sync:tolist:out"),
    ("host = data.cpu()", "matvec:host-sync:cpu:data"),
    ("arr = out.numpy()", "matvec:host-sync:numpy:out"),
    ("torch.cuda.synchronize()",
     "matvec:host-sync:synchronize:torch.cuda"),
    ("flag = bool(out[0, 0])", "matvec:host-sync:bool:out[0, 0]"),
    ("arr = np.asarray(data)", "matvec:host-pull:data"),
    ("if data.any():\n        raise ValueError('zero')",
     "matvec:host-branch:data.any()"),
])
def test_launch_host_sync_caught(body, key):
    keys = _launch_keys(_WRAPPER.format(body=body))
    assert key in keys, keys


def test_launch_event_wait_caught():
    keys = _launch_keys('''
import torch
launches = 0
def step(x: torch.Tensor) -> torch.Tensor:
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    global launches
    launches += 1
    return x
''')
    assert "step:host-sync:synchronize:done" in keys, keys


def test_launch_scope_is_functions_that_launch():
    """A host-plan helper in a wrapper module (no launch of its own) may
    pull host arrays; so may a finalize closure that waits for a step
    it was handed (its own scope), and a module outside the scope."""
    plan = '''
import numpy as np
import torch
def plan_arrays(plan) -> dict:
    cols = np.arange(4)
    return {"rows": cols.tolist()}
def table(x: torch.Tensor) -> list:
    return x.cpu().tolist()
'''
    assert _launch_keys(plan) == set()
    closure = '''
import torch
launches = 0
def launch(x: torch.Tensor):
    global launches
    launches += 1
    def finalize():
        torch.cuda.synchronize()
        return x.cpu()
    return finalize
'''
    assert _launch_keys(closure) == set()
    assert _launch_keys(_WRAPPER.format(body="host = data.cpu()"),
                        rel="ceph_tpu_torch/osd/synth.py") == set()


def test_launch_fused_step_scope():
    """In osd/ec_util.py the fused flush's device-step functions are in
    scope by name (they launch through their callees); other functions
    of the module are not."""
    text = '''
import torch
def fused_step(mat, data_dev: torch.Tensor, lens, lmax: int, backend):
    parity = backend_mod.matvec(mat, data_dev, backend)
    if int(parity[0, 0]):
        pass
    return parity
def encode(sinfo, codec, data: torch.Tensor):
    return data.cpu().numpy()
'''
    keys = _launch_keys(text, rel="ceph_tpu_torch/osd/ec_util.py")
    assert keys == {"fused_step:host-sync:int:parity[0, 0]"}, keys


def test_launch_live_tree_clean():
    """The live contract: no kernel wrapper and no device step of the
    fused flush pulls a tensor to the host (``gf_block_sparse_cuda``'s
    ``cols.tolist()`` runs in ``plan_arrays`` on the host plan, which
    launches nothing)."""
    srcs = [s for s in linters.iter_sources()
            if s.rel.replace(os.sep, "/").endswith("_cuda.py")
            or s.rel.replace(os.sep, "/").endswith("osd/ec_util.py")]
    assert len(srcs) >= 6
    for src in srcs:
        assert linters.check_launch_hygiene(src) == [], src.rel
    wrappers = [s for s in srcs if s.rel.endswith("_cuda.py")]
    launching = [fn.name for s in wrappers for fn in ast.walk(s.tree)
                 if isinstance(fn, ast.FunctionDef)
                 and linters._launches_kernel(fn)]
    # every kernel B1-B6 has its launching function in scope
    assert {"matvec_device", "crc_rows", "matvec", "xor_strips",
            "__call__"} <= set(launching), launching


# ---------------------------------------------------------------------------
# family 3: registry drift, seeded violations
# ---------------------------------------------------------------------------

def _drift_pair(*texts: str) -> tuple[set[str], set[str]]:
    """The port's and the reference's registry-drift keys over the same
    sources (each under its own package path)."""
    drift, ref = linters.RegistryDrift(), ref_linters.RegistryDrift()
    for i, t in enumerate(texts):
        rel = f"ceph_tpu_torch/synthetic{i}.py"
        drift.collect(_src(t, rel=rel))
        ref.collect(_ref_src(t, rel))
    return ({f.key for f in drift.findings()},
            {_from_ref(f.key) for f in ref.findings()})


def _drift_keys(*texts: str) -> set[str]:
    port, ref = _drift_pair(*texts)
    assert port == ref, (sorted(port), sorted(ref))
    return port


def test_drift_unregistered_counter_caught():
    keys = _drift_keys(
        "perf.add_u64_counter('good')\n"
        "perf.inc('good')\n"
        "perf.inc('ghost_key')\n")
    assert "registry_drift:counter-unregistered:ghost_key" in keys
    assert "registry_drift:counter-unused:good" not in keys


def test_drift_unused_counter_caught_and_fstring_family_not():
    keys = _drift_keys(
        "perf.add_u64_counter('never_touched')\n"
        "perf.add_u64_counter('faults_x')\n"
        "perf.add_u64_counter('faults_y')\n"
        "perf.inc(f'faults_{kind}')\n")
    assert "registry_drift:counter-unused:never_touched" in keys
    assert "registry_drift:counter-unused:faults_x" not in keys


def test_drift_unknown_option_caught():
    keys = _drift_keys(
        "from ceph_tpu_torch.utils.config import g_conf\n"
        "x = g_conf()['no_such_option']\n")
    assert "registry_drift:unknown-option:no_such_option" in keys


def test_drift_unread_option_caught():
    keys = _drift_keys(
        "Option('dead_knob', int, 1)\n")
    assert "registry_drift:option-unread:dead_knob" in keys


def test_drift_engine_knob_resolver_counts_as_read():
    """The port's device engine resolves its knobs through ``knob(arg,
    env, option)`` / ``_conf_knob(env, option)`` (argument > env >
    g_conf): the option named last is read. This is the one place the
    port's drift checker reads more than the reference's, whose engine
    passes ``lambda: g_conf()[option]`` instead of the option's name;
    every other key is still the reference's."""
    port, ref = _drift_pair(
        "Option('host_flush_bytes', int, 1)\n"
        "Option('engine_window', int, 3)\n"
        "v = knob(arg, 'CEPH_TPU_HOST_FLUSH_BYTES', 'host_flush_bytes')\n"
        "w = _conf_knob('CEPH_TPU_ENGINE_WINDOW', 'engine_window')\n")
    resolver = {"registry_drift:option-unread:host_flush_bytes",
                "registry_drift:option-unread:engine_window"}
    assert not any("option-unread" in k for k in port), port
    assert resolver <= ref
    assert port == ref - resolver, (sorted(port), sorted(ref))


def test_erasure_code_backend_option_is_read():
    """The runtime twin of the drift finding this option once was: the
    ``auto`` backend honours ``erasure_code_backend`` as the
    reference's does, and falls back to the device ladder on ``auto``.
    A codec reads the option once, when it is built, and not on every
    flush."""
    from ceph_tpu_torch.models import instance
    from ceph_tpu_torch.ops import backend
    from ceph_tpu_torch.utils.config import g_conf
    conf = g_conf()
    old = conf["erasure_code_backend"]
    profile = {"k": "2", "m": "1", "technique": "reed_sol_van"}
    try:
        assert backend.resolve_name("auto", "cpu") == "torch"
        conf.set("erasure_code_backend", "numpy")
        assert backend.resolve_name("auto", "cpu") == "numpy"
        assert backend.resolve_name("torch", "cpu") == "torch"
        codec = instance().factory("jerasure", dict(profile), device="cpu")
        conf.set("erasure_code_backend", "auto")
        assert codec.resolved_backend == "numpy"
        codec.backend = "torch"
        assert codec.resolved_backend == "torch"
        assert instance().factory(
            "jerasure", dict(profile), device="cpu").resolved_backend \
            == "torch"
    finally:
        conf.set("erasure_code_backend", old)


def test_drift_asok_unregistered_invoke_caught():
    keys = _drift_keys(
        "asok.register_command('real cmd', handler)\n"
        "asok_command(path, 'real cmd')\n"
        "asok_command(path, 'phantom cmd')\n")
    assert "registry_drift:asok-unregistered:phantom cmd" in keys
    assert "registry_drift:asok-unregistered:real cmd" not in keys


def test_drift_tuner_knob_unobserved_caught():
    """A tuner-managed knob (the port's live utils/knobs registry names
    them) whose Option is declared with NO observer consumer anywhere is
    flagged."""
    bad = _drift_keys(
        "Option('engine_window', int, 3)\n"
        "x = g_conf()['engine_window']\n")
    assert "registry_drift:tuner-knob-unobserved:engine_window" \
        in bad
    good = _drift_keys(
        "Option('engine_window', int, 3)\n"
        "x = g_conf()['engine_window']\n"
        "g_conf().add_observer('engine_window', fn)\n")
    assert not any("tuner-knob-unobserved:engine_window" in k
                   for k in good)
    seam = _drift_keys(
        "Option('mesh_flush_bytes', int, 1)\n"
        "x = g_conf()['mesh_flush_bytes']\n"
        "self._observe_knob('mesh_flush_bytes', fn)\n")
    assert not any("tuner-knob-unobserved:mesh_flush_bytes" in k
                   for k in seam)
    keys_idiom = _drift_keys(
        "Option('trace_sample_every', int, 64)\n"
        "x = g_conf()['trace_sample_every']\n"
        "_CFG_KEYS = ('trace_sample_every',)\n")
    assert not any(
        "tuner-knob-unobserved:trace_sample_every" in k
        for k in keys_idiom)
    other = _drift_keys(
        "Option('mon_lease', float, 5.0)\n"
        "x = g_conf()['mon_lease']\n")
    assert not any("tuner-knob-unobserved" in k for k in other)


def test_drift_rule_knob_unregistered_caught():
    keys = _drift_keys(
        "Rule('flush_shrink', 'engine_flush_bytes', 'down', pred)\n"
        "Rule('typo', 'engine_flush_byte', 'down', pred)\n")
    assert "registry_drift:rule-knob-unregistered:engine_flush_byte" \
        in keys
    assert not any(k.endswith(":engine_flush_bytes") and
                   "rule-knob" in k for k in keys)


# ---------------------------------------------------------------------------
# family 4: lock discipline, seeded violations
# ---------------------------------------------------------------------------

def _lock_keys(text: str) -> set[str]:
    fs = _check("check_lock_discipline", text)
    return {f.key.split(":", 1)[-1] for f in fs}


_LOCK_CLASS = '''
import threading
class Daemon:
    def __init__(self):
        self._lock = threading.Lock()
        self._table = {{}}
    def read(self):
        with self._lock:
            return dict(self._table)
    {method}
'''


def test_unlocked_mutation_caught():
    keys = _lock_keys(_LOCK_CLASS.format(method=(
        "def clobber(self):\n"
        "        self._table = {}\n")))
    assert "ceph_tpu_torch/synthetic.py:Daemon.clobber:_table" in keys


def test_locked_mutation_clean():
    keys = _lock_keys(_LOCK_CLASS.format(method=(
        "def safe(self):\n"
        "        with self._lock:\n"
        "            self._table = {}\n")))
    assert not keys, keys


def test_locked_suffix_convention_respected():
    keys = _lock_keys(_LOCK_CLASS.format(method=(
        "def clobber_locked(self):\n"
        "        self._table = {}\n")))
    assert not keys, keys


def test_caller_holds_lock_context_respected():
    keys = _lock_keys(_LOCK_CLASS.format(method=(
        "def _clobber(self):\n"
        "        self._table = {}\n"
        "    def entry(self):\n"
        "        with self._lock:\n"
        "            self._clobber()\n")))
    assert not keys, keys


def test_make_lock_seam_counts_as_a_lock():
    text = '''
from ceph_tpu_torch.analysis.lock_witness import make_lock
class Daemon:
    def __init__(self):
        self._lock = make_lock("daemon.state")
        self._q = []
    def read(self):
        with self._lock:
            return list(self._q)
    def racy(self):
        self._q = []
'''
    assert "ceph_tpu_torch/synthetic.py:Daemon.racy:_q" in \
        _lock_keys(text)


# ---------------------------------------------------------------------------
# notify under a foreign lock
# ---------------------------------------------------------------------------

def _notify_keys(text: str) -> set[str]:
    return {f.key for f in _check("check_notify_under_lock", text)}


_NOTIFY_CLASS = '''
import threading
class Daemon:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv_lock = threading.Lock()
        self._cv = threading.Condition(self._cv_lock)
    {method}
'''


def test_notify_under_foreign_lock_caught():
    keys = _notify_keys(_NOTIFY_CLASS.format(method=(
        "def hurry_up_and_wait(self):\n"
        "        with self._lock:\n"
        "            with self._cv:\n"
        "                self._cv.notify_all()\n")))
    assert "notify_under_lock:ceph_tpu_torch/synthetic.py:" \
        "Daemon.hurry_up_and_wait:_cv" in keys


def test_notify_under_own_lock_clean():
    keys = _notify_keys(_NOTIFY_CLASS.format(method=(
        "def ok(self):\n"
        "        with self._cv:\n"
        "            self._cv.notify()\n"
        "    def ok2(self):\n"
        "        with self._cv_lock:\n"
        "            self._cv.notify_all()\n")))
    assert not keys, keys


def test_notify_after_release_clean():
    keys = _notify_keys(_NOTIFY_CLASS.format(method=(
        "def polite(self):\n"
        "        with self._lock:\n"
        "            self._ready = True\n"
        "        with self._cv:\n"
        "            self._cv.notify_all()\n")))
    assert not keys, keys


def test_notify_under_lock_sees_make_condition_seam():
    text = '''
from ceph_tpu_torch.analysis.lock_witness import make_condition, make_lock
class Daemon:
    def __init__(self):
        self._lock = make_lock("daemon.state")
        self._cv = make_condition("daemon.cv")
    def racy(self):
        with self._lock:
            self._cv.notify()
'''
    assert "notify_under_lock:ceph_tpu_torch/synthetic.py:" \
        "Daemon.racy:_cv" in _notify_keys(text)


# ---------------------------------------------------------------------------
# the wire round-trip over every message type
# ---------------------------------------------------------------------------

def _value_for(kind: str, salt: str):
    return {
        "u8": 7, "u16": 300, "u32": 70_000, "u64": 1 << 40,
        "i32": -5, "i64": -(1 << 40), "f64": 3.5, "bool": True,
        "str": f"s-{salt}", "bytes": b"b-" + salt.encode(),
        "str_map": {"k1": f"v-{salt}", "k2": "v2"},
        "bytes_map": {"k": b"v-" + salt.encode()},
        "i32_list": [-1, 2, 3],
        "u64_list": [1, 99, 1 << 33],
        "str_list": [f"a-{salt}", "b"],
        "bytes_list": [b"x", b"y-" + salt.encode()],
    }[kind]


def _all_message_classes():
    return sorted(M._REGISTRY.items())


@pytest.mark.parametrize(
    "mtype,cls", _all_message_classes(),
    ids=[c.__name__ for _, c in _all_message_classes()])
def test_every_message_roundtrips_field_for_field(mtype, cls):
    """Populate EVERY field (optional/appended ones included) with a
    non-default value; encode -> decode_message -> field-for-field
    equality; the payload equals the reference's encoding of the same
    message byte for byte."""
    kwargs = {name: _value_for(kind, name)
              for name, kind in cls.FIELDS}
    msg = cls(**kwargs)
    payload = msg.encode_payload()
    out = M.decode_message(mtype, payload)
    assert type(out) is cls
    for name, kind in cls.FIELDS:
        assert getattr(out, name) == kwargs[name], \
            f"{cls.__name__}.{name} ({kind}) did not round-trip"
    assert payload == RM._REGISTRY[mtype](**kwargs).encode_payload()


@pytest.mark.parametrize(
    "mtype,cls",
    [(t, c) for t, c in _all_message_classes() if len(c.FIELDS) > 1],
    ids=[c.__name__ for _, c in _all_message_classes()
         if len(c.FIELDS) > 1])
def test_appended_fields_are_tail_tolerant(mtype, cls):
    """An older peer that only knew the first field sends a short
    payload; the decode keeps defaults for every appended field."""
    from ceph_tpu_torch.utils.encoding import Encoder
    name0, kind0 = cls.FIELDS[0]
    body = Encoder()
    M._ENC[kind0](body, _value_for(kind0, name0))
    e = Encoder()
    e.section(1, body)
    out = M.decode_message(mtype, e.getvalue())
    assert getattr(out, name0) == _value_for(kind0, name0)
    fresh = cls()
    for name, kind in cls.FIELDS[1:]:
        assert getattr(out, name) == getattr(fresh, name), \
            f"{cls.__name__}.{name}: truncated payload must leave " \
            "the default"


def test_registry_covers_every_declared_class():
    """Every Message subclass in the module with a non-zero MSG_TYPE is
    registered (so the parametrized round-trip above is complete), and
    the port registers the reference's types with the same fields."""
    import inspect
    declared = [obj for _, obj in inspect.getmembers(M, inspect.isclass)
                if issubclass(obj, M.Message) and obj is not M.Message
                and obj.MSG_TYPE]
    assert {c.MSG_TYPE for c in declared} == set(M._REGISTRY)
    assert {t: c.FIELDS for t, c in M._REGISTRY.items()} == \
        {t: c.FIELDS for t, c in RM._REGISTRY.items()}


# ---------------------------------------------------------------------------
# family 5: fsync seam, seeded violations
# ---------------------------------------------------------------------------

def _fsync_keys(text: str,
                rel: str = "ceph_tpu_torch/store/synthstore.py") -> set[str]:
    fs = _check("check_fsync_seam", text, rel)
    return {f.key for f in fs}


def test_untimed_fsync_in_store_caught():
    keys = _fsync_keys('''
import os

class SynthStore:
    def commit(self):
        self._wal.flush()
        os.fsync(self._wal.fileno())
''')
    assert "untimed-fsync:ceph_tpu_torch/store/synthstore.py:commit" \
        in keys


def test_untimed_fdatasync_in_store_caught():
    keys = _fsync_keys('''
import os

def barrier(fd):
    os.fdatasync(fd)
''')
    assert ("untimed-fsync:ceph_tpu_torch/store/synthstore.py:barrier"
            in keys)


def test_fsync_outside_store_dir_not_flagged():
    assert _fsync_keys('''
import os

def anywhere(fd):
    os.fsync(fd)
''', rel="ceph_tpu_torch/utils/synth.py") == set()


def test_timed_seam_calls_are_clean():
    assert _fsync_keys('''
from ceph_tpu_torch.utils import store_telemetry

class SynthStore:
    def commit(self):
        store_telemetry.timed_fsync(self._wal.fileno(), site="synth")
        store_telemetry.timed_sync("synth.data", self._data.sync)
''') == set()


def test_real_store_files_have_no_untimed_fsyncs():
    store_srcs = [s for s in linters.iter_sources()
                  if s.rel.replace(os.sep, "/").startswith(
                      "ceph_tpu_torch/store/")]
    assert store_srcs
    for src in store_srcs:
        assert linters.check_fsync_seam(src) == [], src.rel


# ---------------------------------------------------------------------------
# family 6: reactor affinity, seeded violations
# ---------------------------------------------------------------------------

def _affinity_keys(text: str,
                   rel: str = "ceph_tpu_torch/crimson/synth.py") -> set[str]:
    fs = _check("check_reactor_affinity", text, rel)
    return {f.key for f in fs}


def test_reactor_affinity_global_state_caught():
    keys = _affinity_keys('''
_EPOCH = 0

def bump():
    global _EPOCH
    _EPOCH += 1
''')
    assert ("reactor-affinity:ceph_tpu_torch/crimson/synth.py:bump:global"
            in keys)


def test_reactor_affinity_blocking_sleep_in_coroutine_caught():
    keys = _affinity_keys('''
import time

async def beacon_loop(self):
    while True:
        time.sleep(1.0)
''')
    assert ("reactor-affinity:ceph_tpu_torch/crimson/synth.py:"
            "beacon_loop:blocking-sleep" in keys)


def test_reactor_affinity_sync_sleep_outside_coroutine_clean():
    assert _affinity_keys('''
import time

def wait_for_boot(self):
    time.sleep(0.1)
''') == set()


def test_reactor_affinity_raw_lock_caught():
    keys = _affinity_keys('''
import threading

class Shard:
    def __init__(self):
        self._lock = threading.Lock()
''')
    assert ("reactor-affinity:ceph_tpu_torch/crimson/synth.py:"
            "__init__:raw-lock" in keys)


def test_reactor_affinity_witnessed_lock_and_asyncio_clean():
    assert _affinity_keys('''
import asyncio
from ceph_tpu_torch.analysis.lock_witness import make_lock

class Shard:
    def __init__(self):
        self._lock = make_lock("crimson.synth")

    async def tick(self):
        await asyncio.sleep(0.1)
''') == set()


def test_reactor_affinity_scoped_to_crimson():
    assert _affinity_keys('''
import threading

_STATE = {}

def anywhere():
    global _STATE
    _STATE = {"lock": threading.Lock()}
''', rel="ceph_tpu_torch/osd/synth.py") == set()


def test_reactor_affinity_live_crimson_tree_clean():
    crimson_srcs = [s for s in linters.iter_sources()
                    if s.rel.replace(os.sep, "/").startswith(
                        "ceph_tpu_torch/crimson/")]
    assert crimson_srcs
    for src in crimson_srcs:
        assert linters.check_reactor_affinity(src) == [], src.rel


# ---------------------------------------------------------------------------
# family 7: flow context, seeded violations
# ---------------------------------------------------------------------------

def _flow_keys(text: str,
               rel: str = "ceph_tpu_torch/osd/synth.py") -> set[str]:
    fs = _check("check_flow_context", text, rel)
    return {f.key for f in fs}


def test_flow_context_dropped_at_qos_seam_caught():
    keys = _flow_keys('''
class SynthWQ:
    def enqueue(self, key, fn, qos="client"):
        self._queues[qos].append((key, fn))
''')
    assert ("flow_context:ceph_tpu_torch/osd/synth.py:SynthWQ.enqueue"
            in keys)


def test_flow_context_captured_at_qos_seam_clean():
    assert _flow_keys('''
from ceph_tpu_torch.utils import flow_telemetry as _flows

class SynthWQ:
    def enqueue(self, key, fn, qos="client"):
        fn._flow = _flows.capture_flow(qos)
        self._queues[qos].append((key, fn))
''') == set()


def test_flow_context_current_flow_read_also_satisfies():
    assert _flow_keys('''
from ceph_tpu_torch.utils import flow_telemetry as _flows

def submit(op, qos):
    op.flow = _flows.current_flow() or ""
    _ship(op, qos)
''') == set()


def test_flow_context_seam_module_itself_exempt():
    assert _flow_keys('''
def capture_flow(qos="client"):
    return ("", qos)
''', rel="ceph_tpu_torch/utils/flow_telemetry.py") == set()


def test_flow_context_live_tree_clean():
    for src in linters.iter_sources():
        assert linters.check_flow_context(src) == [], src.rel
