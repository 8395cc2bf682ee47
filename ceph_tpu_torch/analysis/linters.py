"""Codebase-specific AST lints over the ``ceph_tpu_torch`` package.

Seven checker families, each the *static twin* of a runtime contract
the port gates:

1. **wire symmetry**: every message class in ``parallel/messages.py``
   must encode and decode the same field sequence in the same order.
   The schema-generated path (``FIELDS`` drives both directions) is
   symmetric by construction; the lint pins the schema's
   well-formedness (known kinds, unique names, unique MSG_TYPE) and
   polices manual ``encode_payload``/``decode_payload`` overrides: both
   or neither, identical field order, tail-tolerant decode (the
   appended-optional ``stages``/``trace`` pattern).

2. **launch hygiene**: inside a function that launches a kernel (a
   ``*_cuda.py`` wrapper that calls its ``*_launch`` entry or bumps its
   ``launches`` counter) or runs the fused flush's device step
   (``osd/ec_util.py``), a host sync: ``.item()``, ``.tolist()``,
   ``.cpu()``, ``.numpy()``, ``int()``/``float()``/``bool()`` of a
   tensor, a Python branch on a tensor, or a ``synchronize()`` call. A
   host pull inside the device step stalls the launching thread on the
   card and serialises the engine's window.

3. **registry drift**: every PerfCounters key *updated* must be
   registered and vice versa; every ``g_conf`` key read must be a
   declared Option; every ``asok_command`` invocation must name a
   prefix some daemon registers; every tuner-managed knob has an
   observer consumer and every tuner Rule names a registered knob.

4. **lock discipline**: in classes that own a ``_lock``, methods
   mutating attributes that are elsewhere accessed under that lock
   must themselves hold it. With it, **notify under lock**: a
   condition notified while a different lock of the class is held.

5. **fsync seam**: every durability barrier under
   ``ceph_tpu_torch/store/`` goes through the timed-fsync seam
   (``utils/store_telemetry.timed_fsync``/``timed_fdatasync``/
   ``timed_sync``); a direct ``os.fsync``/``os.fdatasync`` call is an
   unmeasured commit stall.

6. **reactor affinity**: shared-nothing discipline for
   ``ceph_tpu_torch/crimson/``: no module-global mutable state, no
   blocking ``time.sleep`` inside reactor coroutines, no raw
   ``threading`` sync primitives outside the witnessed ``make_lock``
   seam.

7. **flow context**: every enqueue seam accepting a ``qos=`` parameter
   must thread the per-tenant flow context (``capture_flow``/
   ``current_flow``) across the handoff.

Findings diff against the justified allowlist in
``analysis/baseline.json``; any NEW finding (or a stale baseline
entry) fails ``tests/test_torch_static_analysis.py``. Keys carry no
line numbers, so routine edits don't churn the baseline.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass

PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PKG_ROOT)
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")

#: field kinds the Encoder/Decoder tables support (mirrors the _ENC
#: table in parallel/messages.py; the checker prefers the table parsed
#: from the file itself when present)
DEFAULT_KINDS = frozenset((
    "u8", "u16", "u32", "u64", "i32", "i64", "f64", "bool", "str",
    "bytes", "str_map", "bytes_map", "i32_list", "u64_list",
    "str_list", "bytes_list"))

#: launch-hygiene scope: the kernel wrappers (repo-relative glob parts)
#: and the device-step functions of the fused flush, which launch
#: through their callees
LAUNCH_DIR = "ceph_tpu_torch/ops"
LAUNCH_SUFFIX = "_cuda.py"
DEVICE_STEPS = {"ceph_tpu_torch/osd/ec_util.py": frozenset((
    "_flush_device_fused_async", "fused_step", "_segments"))}

#: attribute reads that are host metadata of a tensor, not its values
_STATIC_ATTRS = frozenset((
    "shape", "ndim", "dtype", "device", "is_cuda", "nbytes",
    "itemsize", "layout", "requires_grad"))
#: tensor methods whose result is host metadata (no device wait)
_STATIC_METHODS = frozenset((
    "dim", "numel", "size", "stride", "data_ptr", "element_size",
    "is_contiguous", "get_device", "storage_offset", "is_pinned"))
#: calls whose result is static regardless of argument taint
_STATIC_CALLS = frozenset((
    "len", "isinstance", "type", "hasattr", "getattr", "id", "repr"))


@dataclass(frozen=True)
class Finding:
    checker: str
    path: str          # repo-relative
    line: int
    key: str           # stable id (no line numbers) for the baseline
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] " \
               f"{self.message}  ({self.key})"


class SourceFile:
    def __init__(self, path: str, text: str,
                 rel: str | None = None) -> None:
        self.path = path
        self.rel = rel or os.path.relpath(path, REPO_ROOT)
        self.text = text
        self.tree = ast.parse(text, filename=path)


def iter_sources(root: str = PKG_ROOT) -> list[SourceFile]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path, encoding="utf-8") as f:
                text = f.read()
            try:
                out.append(SourceFile(path, text))
            except SyntaxError as exc:       # pragma: no cover
                raise RuntimeError(f"unparseable {path}: {exc}")
    return out


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:                        # pragma: no cover
        return "<expr>"


def _walk_in_order(node: ast.AST):
    """DFS in source order (ast.walk is BFS; order matters for the
    encode/decode sequence extraction)."""
    for child in ast.iter_child_nodes(node):
        yield child
        yield from _walk_in_order(child)


# ---------------------------------------------------------------------------
# 1. wire symmetry
# ---------------------------------------------------------------------------

def _literal_fields(node: ast.AST) -> list[tuple[str, str]] | None:
    """Parse a ``FIELDS = [(name, kind), ...]`` literal."""
    if not isinstance(node, (ast.List, ast.Tuple)):
        return None
    out = []
    for elt in node.elts:
        if not (isinstance(elt, ast.Tuple) and len(elt.elts) == 2
                and all(isinstance(e, ast.Constant)
                        and isinstance(e.value, str)
                        for e in elt.elts)):
            return None
        out.append((elt.elts[0].value, elt.elts[1].value))
    return out


def _self_attr_reads(fn: ast.FunctionDef, names: set[str]) -> list[str]:
    """``self.X`` loads in source order, X restricted to ``names``."""
    out = []
    for node in _walk_in_order(fn):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.ctx, ast.Load) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and node.attr in names:
            out.append(node.attr)
    return out


def _attr_stores(fn: ast.FunctionDef, names: set[str]) -> list[str]:
    """``<obj>.X = ...`` stores (plus ``setattr(obj, "X", ...)``) in
    source order, X restricted to ``names``."""
    out = []
    for node in _walk_in_order(fn):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.ctx, ast.Store) and node.attr in names:
            out.append(node.attr)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id == "setattr" and len(node.args) >= 2 and \
                isinstance(node.args[1], ast.Constant) and \
                node.args[1].value in names:
            out.append(node.args[1].value)
    return out


def check_wire_symmetry(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    kinds = set(DEFAULT_KINDS)
    # prefer the module's own _ENC table as ground truth
    for node in src.tree.body:
        if isinstance(node, ast.Assign) and \
                any(isinstance(t, ast.Name) and t.id == "_ENC"
                    for t in node.targets) and \
                isinstance(node.value, ast.Dict):
            parsed = {k.value for k in node.value.keys
                      if isinstance(k, ast.Constant)}
            if parsed:
                kinds = parsed

    msg_types: dict[int, str] = {}
    for cls in src.tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        fields = None
        mtype = None
        encode_fn = decode_fn = None
        for item in cls.body:
            if isinstance(item, ast.Assign):
                for t in item.targets:
                    if isinstance(t, ast.Name) and t.id == "FIELDS":
                        fields = _literal_fields(item.value)
                    elif isinstance(t, ast.Name) and t.id == "MSG_TYPE" \
                            and isinstance(item.value, ast.Constant):
                        mtype = item.value.value
            elif isinstance(item, ast.FunctionDef):
                if item.name == "encode_payload":
                    encode_fn = item
                elif item.name == "decode_payload":
                    decode_fn = item
        if fields is None and mtype is None:
            continue

        def add(code: str, message: str, line: int = cls.lineno):
            findings.append(Finding(
                "wire_symmetry", src.rel, line,
                f"wire_symmetry:{src.rel}:{cls.name}:{code}", message))

        if fields:
            seen: set[str] = set()
            for name, kind in fields:
                if kind not in kinds:
                    add(f"unknown-kind:{name}",
                        f"{cls.name}.{name}: unknown wire kind "
                        f"{kind!r} (no encoder/decoder)")
                if name in seen:
                    add(f"dup-field:{name}",
                        f"{cls.name}: duplicate field {name!r}")
                seen.add(name)
        if isinstance(mtype, int) and mtype:
            if mtype in msg_types:
                add(f"dup-msg-type:{mtype}",
                    f"{cls.name}: MSG_TYPE {mtype} already used by "
                    f"{msg_types[mtype]}")
            else:
                msg_types[mtype] = cls.name

        if fields and (encode_fn or decode_fn):
            names = {n for n, _ in fields}
            if encode_fn is None or decode_fn is None:
                side = "encode_payload" if encode_fn else \
                    "decode_payload"
                add("override-asymmetry",
                    f"{cls.name}: overrides only {side} — the "
                    "generated twin no longer mirrors it")
            else:
                enc = _self_attr_reads(encode_fn, names)
                dec = _attr_stores(decode_fn, names)
                if enc != dec:
                    add("field-order-asymmetry",
                        f"{cls.name}: encode order {enc} != decode "
                        f"order {dec}")
                field_order = [n for n, _ in fields if n in set(enc)]
                if enc and enc != field_order:
                    add("encode-diverges-from-fields",
                        f"{cls.name}: encode order {enc} diverges "
                        f"from FIELDS order {field_order}")
                dec_src = ast.get_source_segment(
                    src.text, decode_fn) or ""
                if dec and "eof(" not in dec_src:
                    add("decode-not-tail-tolerant",
                        f"{cls.name}: custom decode_payload has no "
                        "eof() guard — appended-optional fields from "
                        "newer peers will not be tail-tolerated")
    return findings


# ---------------------------------------------------------------------------
# 2. launch hygiene
# ---------------------------------------------------------------------------

#: ``torch.<name>(...)`` calls that build no tensor
_NON_TENSOR_TORCH = frozenset(("device", "Size", "Generator", "dtype"))
#: tensor methods that copy the tensor's values to the host, and the
#: builtins that coerce one; their results are host values (the pull
#: itself is the finding)
_HOST_PULL_METHODS = ("item", "tolist", "cpu", "numpy")
_HOST_COERCIONS = ("int", "float", "bool")


def _expr_tainted(node: ast.AST, tainted: set[str]) -> bool:
    """Does this expression carry a tensor's values? Metadata accessors
    (shape/dtype/device/numel()/data_ptr()/len/...) sanitize, and a
    ``torch.<factory>(...)`` call makes a tensor whatever its
    arguments."""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return False
        return _expr_tainted(node.value, tainted)
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and (fn.id in _STATIC_CALLS or
                                         fn.id in _HOST_COERCIONS):
            return False
        if isinstance(fn, ast.Attribute):
            if fn.attr in _STATIC_METHODS or \
                    fn.attr in _HOST_PULL_METHODS:
                return False
            if isinstance(fn.value, ast.Name) and fn.value.id == "torch":
                return fn.attr not in _NON_TENSOR_TORCH
        parts = [fn.value] if isinstance(fn, ast.Attribute) else []
        parts += list(node.args) + [kw.value for kw in node.keywords]
        return any(_expr_tainted(p, tainted) for p in parts)
    if isinstance(node, ast.Subscript):
        return _expr_tainted(node.value, tainted)
    if isinstance(node, (ast.Constant, ast.Lambda)):
        return False
    return any(_expr_tainted(c, tainted)
               for c in ast.iter_child_nodes(node))


def _assigned_names(target: ast.AST) -> list[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out = []
        for e in target.elts:
            out.extend(_assigned_names(e))
        return out
    if isinstance(target, ast.Starred):
        return _assigned_names(target.value)
    return []


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def _walk_own(node: ast.AST):
    """DFS in source order over ``node``'s own body: nested functions,
    lambdas and classes are scopes of their own (a ``finalize`` closure
    that waits for the step it was handed is not the step)."""
    for child in ast.iter_child_nodes(node):
        yield child
        if not isinstance(child, _SCOPES):
            yield from _walk_own(child)


def _launches_kernel(fn: ast.FunctionDef) -> bool:
    """A kernel wrapper: bumps its module's ``*launches`` counter, as
    every ``*_cuda.py`` wrapper does right after its launch."""
    return any(isinstance(n, ast.AugAssign) and
               isinstance(n.target, ast.Name) and
               n.target.id.endswith("launches")
               for n in _walk_own(fn))


def _check_launch_function(src: SourceFile,
                           fn: ast.FunctionDef) -> list[Finding]:
    findings: list[Finding] = []

    def add(code: str, message: str, line: int):
        findings.append(Finding(
            "launch_hygiene", src.rel, line,
            f"launch_hygiene:{src.rel}:{fn.name}:{code}", message))

    args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
    tainted: set[str] = {a.arg for a in args if a.annotation is not None
                         and "Tensor" in _unparse(a.annotation)}

    # taint propagation, two passes for loop-carried names
    for _pass in (0, 1):
        for node in _walk_own(fn):
            if isinstance(node, ast.Assign):
                t = _expr_tainted(node.value, tainted)
                for tgt in node.targets:
                    for name in _assigned_names(tgt):
                        if t:
                            tainted.add(name)
                        else:
                            tainted.discard(name)
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, ast.Name):
                if _expr_tainted(node.value, tainted):
                    tainted.add(node.target.id)
            elif isinstance(node, ast.For):
                t = _expr_tainted(node.iter, tainted)
                for name in _assigned_names(node.target):
                    if t:
                        tainted.add(name)

    for node in _walk_own(fn):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)) and \
                _expr_tainted(node.test, tainted):
            snippet = _unparse(node.test)[:48]
            add(f"host-branch:{snippet}",
                f"{fn.name}: Python branch on tensor value "
                f"`{snippet}` waits for the card to decide it",
                node.lineno)
        elif isinstance(node, ast.Call):
            cfn = node.func
            if isinstance(cfn, ast.Name) and \
                    cfn.id in _HOST_COERCIONS and node.args \
                    and _expr_tainted(node.args[0], tainted):
                add(f"host-sync:{cfn.id}:{_unparse(node.args[0])[:32]}",
                    f"{fn.name}: {cfn.id}() of tensor "
                    f"`{_unparse(node.args[0])[:48]}` pulls it to the "
                    "host and waits for the card", node.lineno)
            elif isinstance(cfn, ast.Attribute) and \
                    cfn.attr in _HOST_PULL_METHODS and \
                    _expr_tainted(cfn.value, tainted):
                add(f"host-sync:{cfn.attr}:{_unparse(cfn.value)[:32]}",
                    f"{fn.name}: .{cfn.attr}() of tensor "
                    f"`{_unparse(cfn.value)[:48]}` inside the device "
                    "step waits for the card", node.lineno)
            elif isinstance(cfn, ast.Attribute) and \
                    cfn.attr == "synchronize":
                add(f"host-sync:synchronize:{_unparse(cfn.value)[:32]}",
                    f"{fn.name}: {_unparse(cfn)}() inside the device "
                    "step blocks the launching thread on the card",
                    node.lineno)
            elif isinstance(cfn, ast.Attribute) and \
                    cfn.attr == "asarray" and \
                    isinstance(cfn.value, ast.Name) and \
                    cfn.value.id == "np" and node.args and \
                    _expr_tainted(node.args[0], tainted):
                add(f"host-pull:{_unparse(node.args[0])[:32]}",
                    f"{fn.name}: np.asarray of tensor "
                    f"`{_unparse(node.args[0])[:48]}` pulls it to the "
                    "host inside the device step", node.lineno)
    return findings


def check_launch_hygiene(src: SourceFile) -> list[Finding]:
    rel = src.rel.replace(os.sep, "/")
    steps = DEVICE_STEPS.get(rel)
    wrappers = rel.startswith(LAUNCH_DIR + "/") and \
        rel.endswith(LAUNCH_SUFFIX)
    if steps is None and not wrappers:
        return []
    findings: list[Finding] = []
    for node in ast.walk(src.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                ((steps is not None and node.name in steps) or
                 (wrappers and _launches_kernel(node))):
            findings.extend(_check_launch_function(src, node))
    return findings


# ---------------------------------------------------------------------------
# 3. registry drift (counters / config / asok)
# ---------------------------------------------------------------------------

_COUNTER_REG = {"add_u64_counter": "u64", "add_gauge": "gauge",
                "add_time_avg": "time_avg", "add_histogram": "hist"}
#: update methods that are distinctive enough to always count
_COUNTER_USE_STRONG = ("ginc", "tinc", "hinc",
                       # the tuner's guarded-update seams
                       # (publish_perf=False engines skip counters,
                       # so every update routes through these)
                       "_count", "_count_gauge")
#: generic names counted only on perf-ish receivers ("logger" is the
#: reference's name for a PerfCounters instance)
_COUNTER_USE_WEAK = ("inc", "set_gauge", "time")
_PERF_RECV_HINTS = ("perf", "counter", "logger")
#: the device engine's knob resolvers (osd/device_engine.py: argument >
#: ``CEPH_TPU_*`` env > ``g_conf()[option]``), which take the option
#: name as their last argument
_OPTION_READ_SEAMS = ("knob", "_conf_knob")


def _fstring_affix(node: ast.AST) -> tuple[str, str] | None:
    """(leading, trailing) constant parts of an f-string key — how
    dynamic registry keys (``f"faults_{kind}"``,
    ``f"{name}_tracing"``) still mark their key family as used."""
    if not isinstance(node, ast.JoinedStr) or not node.values:
        return None
    lead = node.values[0]
    trail = node.values[-1]
    prefix = lead.value if isinstance(lead, ast.Constant) and \
        isinstance(lead.value, str) else ""
    suffix = trail.value if isinstance(trail, ast.Constant) and \
        isinstance(trail.value, str) else ""
    if not prefix and not suffix:
        return None
    return (prefix, suffix)


def _affix_match(key: str, affixes: list[tuple[str, str]]) -> bool:
    return any(key.startswith(p) and key.endswith(s)
               for p, s in affixes)


class RegistryDrift:
    """Cross-file collector: feed every SourceFile through
    :meth:`collect`, then read :meth:`findings`."""

    def __init__(self) -> None:
        self.counters_registered: dict[str, tuple[str, int]] = {}
        self.counters_used: dict[str, tuple[str, int]] = {}
        self.options_declared: dict[str, tuple[str, int]] = {}
        self.options_read: dict[str, tuple[str, int]] = {}
        self.asok_registered: dict[str, tuple[str, int]] = {}
        self.asok_invoked: dict[str, tuple[str, int]] = {}
        #: options consumed through a config observer (the
        #: cached-read discipline tuner-managed knobs must follow)
        self.options_observed: dict[str, tuple[str, int]] = {}
        #: (prefix, suffix) families touched via f-string keys
        self.counter_affixes: list[tuple[str, str]] = []
        self.option_affixes: list[tuple[str, str]] = []
        #: knobs named by tuner policy Rules: every rule's actuator
        #: must be a registered TUNER_KNOBS entry, or its firings
        #: silently step nothing
        self.rule_knobs: dict[str, tuple[str, int]] = {}

    # -- collection ----------------------------------------------------
    def collect(self, src: SourceFile) -> None:
        conf_aliases = {"conf", "cfg", "_conf", "_g_conf"}
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    _unparse(node.value.func).endswith("g_conf"):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        conf_aliases.add(tgt.id)
        for node in ast.walk(src.tree):
            # the loop-over-keys observer idiom (utils/tracing):
            # `_CFG_KEYS = ("a", "b", ...)` + `for key in _CFG_KEYS:
            # conf.add_observer(key, ...)` — the tuple constant IS
            # the observation declaration
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Tuple):
                names = [t.id if isinstance(t, ast.Name) else
                         getattr(t, "attr", "")
                         for t in node.targets]
                if any("CFG_KEYS" in (n or "") for n in names):
                    for elt in node.value.elts:
                        if isinstance(elt, ast.Constant) and \
                                isinstance(elt.value, str):
                            self.options_observed.setdefault(
                                elt.value, (src.rel, node.lineno))
            if not isinstance(node, ast.Call):
                if isinstance(node, ast.Subscript) and \
                        self._is_conf(node.value, conf_aliases):
                    if isinstance(node.slice, ast.Constant) and \
                            isinstance(node.slice.value, str):
                        self.options_read.setdefault(
                            node.slice.value,
                            (src.rel, node.lineno))
                    else:
                        affix = _fstring_affix(node.slice)
                        if affix:
                            self.option_affixes.append(affix)
                continue
            fn = node.func
            lit0 = node.args[0].value if (
                node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)) else None
            dyn0 = _fstring_affix(node.args[0]) if node.args else None
            # `inc("a" if hit else "b")`: both branches are keys
            cond0: list[str] = []
            if node.args and isinstance(node.args[0], ast.IfExp):
                cond0 = [e.value for e in (node.args[0].body,
                                           node.args[0].orelse)
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str)]
            if isinstance(fn, ast.Attribute):
                recv = _unparse(fn.value).lower()
                perfish = any(h in recv for h in _PERF_RECV_HINTS)
                if fn.attr in _COUNTER_REG and lit0:
                    self.counters_registered.setdefault(
                        lit0, (src.rel, node.lineno))
                elif fn.attr in _COUNTER_USE_STRONG or \
                        (fn.attr in _COUNTER_USE_WEAK and perfish):
                    if lit0:
                        self.counters_used.setdefault(
                            lit0, (src.rel, node.lineno))
                    elif dyn0:
                        self.counter_affixes.append(dyn0)
                    for key in cond0:
                        self.counters_used.setdefault(
                            key, (src.rel, node.lineno))
                elif fn.attr in ("get", "set") and \
                        self._is_conf(fn.value, conf_aliases):
                    if lit0:
                        self.options_read.setdefault(
                            lit0, (src.rel, node.lineno))
                    elif dyn0:
                        self.option_affixes.append(dyn0)
                elif fn.attr in ("add_observer",
                                 "_observe_knob") and lit0:
                    # direct observer registration, or the device
                    # engine's _observe_knob seam (same contract:
                    # first arg is the option, consumer caches)
                    self.options_observed.setdefault(
                        lit0, (src.rel, node.lineno))
                elif fn.attr == "register_command" and lit0:
                    self.asok_registered.setdefault(
                        lit0, (src.rel, node.lineno))
                elif fn.attr == "asok_command" and len(node.args) >= 2 \
                        and isinstance(node.args[1], ast.Constant):
                    self.asok_invoked.setdefault(
                        node.args[1].value, (src.rel, node.lineno))
            elif isinstance(fn, ast.Name):
                if fn.id == "Option" and lit0:
                    self.options_declared.setdefault(
                        lit0, (src.rel, node.lineno))
                elif fn.id in _OPTION_READ_SEAMS and node.args and \
                        isinstance(node.args[-1], ast.Constant) and \
                        isinstance(node.args[-1].value, str):
                    self.options_read.setdefault(
                        node.args[-1].value, (src.rel, node.lineno))
                elif fn.id == "asok_command" and len(node.args) >= 2 \
                        and isinstance(node.args[1], ast.Constant):
                    self.asok_invoked.setdefault(
                        node.args[1].value, (src.rel, node.lineno))
                elif fn.id == "Rule" and len(node.args) >= 3 and \
                        isinstance(node.args[1], ast.Constant) and \
                        isinstance(node.args[1].value, str) and \
                        isinstance(node.args[2], ast.Constant) and \
                        node.args[2].value in ("up", "down"):
                    # a tuner policy rule (Rule(name, knob, dir, ...));
                    # the direction literal disambiguates it from
                    # crush/fault Rule constructors
                    self.rule_knobs.setdefault(
                        node.args[1].value, (src.rel, node.lineno))

    @staticmethod
    def _is_conf(recv: ast.AST, aliases: set[str]) -> bool:
        if isinstance(recv, ast.Call):
            return _unparse(recv.func).endswith("g_conf")
        if isinstance(recv, ast.Name):
            return recv.id in aliases
        if isinstance(recv, ast.Attribute):
            return recv.attr in ("conf", "_conf")
        return False

    # -- findings ------------------------------------------------------
    def findings(self) -> list[Finding]:
        out: list[Finding] = []

        def add(kind: str, key: str, where: tuple[str, int],
                message: str):
            out.append(Finding(
                "registry_drift", where[0], where[1],
                f"registry_drift:{kind}:{key}", message))

        for key, where in sorted(self.counters_used.items()):
            if key not in self.counters_registered:
                add("counter-unregistered", key, where,
                    f"counter {key!r} updated but never registered "
                    "(runtime KeyError the first time it fires)")
        for key, where in sorted(self.counters_registered.items()):
            if key not in self.counters_used and \
                    not _affix_match(key, self.counter_affixes):
                add("counter-unused", key, where,
                    f"counter {key!r} registered but never updated "
                    "anywhere — dead metric, dashboards read 0")
        for key, where in sorted(self.options_read.items()):
            if key not in self.options_declared:
                add("unknown-option", key, where,
                    f"config key {key!r} read but not declared as an "
                    "Option (g_conf raises KeyError)")
        for key, where in sorted(self.options_declared.items()):
            if key not in self.options_read and \
                    not _affix_match(key, self.option_affixes):
                add("option-unread", key, where,
                    f"option {key!r} declared but never read in the "
                    "package — dead knob")
        for key, where in sorted(self.asok_invoked.items()):
            if key not in self.asok_registered:
                add("asok-unregistered", key, where,
                    f"asok command {key!r} invoked but no daemon "
                    "registers it")
        # every tuner-managed knob must be consumed through
        # a config OBSERVER somewhere — the tuner mutates these at
        # runtime, so a consumer re-reading g_conf per-op/per-flush
        # pays the config RLock on every read, and a consumer that
        # caches WITHOUT an observer silently ignores the tuner
        for key in self._tuner_knob_names():
            if key in self.options_declared and \
                    key not in self.options_observed:
                add("tuner-knob-unobserved", key,
                    self.options_declared[key],
                    f"tuner-managed knob {key!r} has no add_observer "
                    "consumer: runtime pushes either cost a hot-path "
                    "config read or never reach the daemon")
        # every tuner policy rule must actuate a registered Knob —
        # a typo'd knob name makes the rule's firings step nothing
        # (the engine looks the knob up and skips silently)
        knob_names = set(self._tuner_knob_names())
        if knob_names:
            for key, where in sorted(self.rule_knobs.items()):
                if key not in knob_names:
                    add("rule-knob-unregistered", key, where,
                        f"tuner rule steps knob {key!r} but "
                        "TUNER_KNOBS has no such entry — the rule "
                        "can never actuate")
        return out

    @staticmethod
    def _tuner_knob_names() -> list[str]:
        """The actuator registry (utils/knobs.TUNER_KNOBS) — imported
        live rather than re-parsed: the registry IS the contract."""
        try:
            from ceph_tpu_torch.utils.knobs import tuner_managed_names
            return tuner_managed_names()
        except Exception:
            return []


# ---------------------------------------------------------------------------
# 4. lock discipline
# ---------------------------------------------------------------------------

_LOCK_CTORS = ("threading.Lock", "threading.RLock", "make_lock",
               "make_rlock", "lock_witness.make_lock",
               "lock_witness.make_rlock")


def _lock_attrs(cls: ast.ClassDef) -> set[str]:
    out = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call):
            fname = _unparse(node.value.func)
            if fname in _LOCK_CTORS or fname.endswith(".make_lock") \
                    or fname.endswith(".make_rlock"):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self":
                        out.add(tgt.attr)
    return out


def _with_lock_items(node: ast.With, locks: set[str]) -> bool:
    for item in node.items:
        ctx = item.context_expr
        if isinstance(ctx, ast.Attribute) and \
                isinstance(ctx.value, ast.Name) and \
                ctx.value.id == "self" and ctx.attr in locks:
            return True
    return False


def _locked_context_methods(methods: list[ast.FunctionDef],
                            locks: set[str]) -> set[str]:
    """Methods only ever called (within this class) while the lock is
    held — the caller-holds-lock idiom (mon's ``_dispatch`` takes
    ``self._lock`` once and fans out to every handler). Computed to a
    fixpoint so a handler's helpers inherit the context. A method with
    any call site outside a locked region (or no internal call sites
    at all — public API) is NOT lock-held context."""
    names = {m.name for m in methods}
    # method -> list of (callee, in_with_lock_span) call sites
    sites: dict[str, list[tuple[str, bool]]] = {n: [] for n in names}
    for m in methods:
        spans = [(n.lineno, n.end_lineno or n.lineno)
                 for n in ast.walk(m)
                 if isinstance(n, ast.With)
                 and _with_lock_items(n, locks)]
        for node in ast.walk(m):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == "self" and \
                    node.func.attr in names:
                in_span = any(a <= node.lineno <= b
                              for a, b in spans)
                sites[node.func.attr].append((m.name, in_span))
    # greatest fixpoint: assume every internally-called method is
    # lock-held, then evict any with a call site that is neither
    # inside a with-lock span nor from a (still-)locked caller —
    # mutually-recursive helper clusters (paxos pump/collect/begin)
    # whose every external entry is locked stay locked
    locked: set[str] = {n for n in names if sites[n]}
    changed = True
    while changed:
        changed = False
        for name in sorted(locked):
            if not all(in_span or caller in locked
                       for caller, in_span in sites[name]):
                locked.discard(name)
                changed = True
    return locked


def check_lock_discipline(src: SourceFile) -> list[Finding]:
    findings: list[Finding] = []
    for cls in [n for n in ast.walk(src.tree)
                if isinstance(n, ast.ClassDef)]:
        locks = _lock_attrs(cls)
        if not locks:
            continue
        methods = [n for n in cls.body
                   if isinstance(n, ast.FunctionDef)]

        # attrs touched inside with-self-lock blocks anywhere
        protected: set[str] = set()
        for m in methods:
            for node in ast.walk(m):
                if isinstance(node, ast.With) and \
                        _with_lock_items(node, locks):
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Attribute) and \
                                isinstance(sub.value, ast.Name) and \
                                sub.value.id == "self" and \
                                sub.attr not in locks:
                            protected.add(sub.attr)
        if not protected:
            continue
        locked_ctx = _locked_context_methods(methods, locks)

        for m in methods:
            if m.name == "__init__":
                continue
            # caller-holds-lock conventions: the documented ``_locked``
            # name suffix, and methods only reachable under the lock
            if m.name.endswith("_locked") or m.name in locked_ctx:
                continue
            src_seg = ast.get_source_segment(src.text, m) or ""
            if ".acquire(" in src_seg:
                continue           # manual acquire/release pattern

            # collect assignments to protected attrs OUTSIDE any
            # with-self-lock block
            locked_spans: list[tuple[int, int]] = []
            for node in ast.walk(m):
                if isinstance(node, ast.With) and \
                        _with_lock_items(node, locks):
                    locked_spans.append(
                        (node.lineno, node.end_lineno or node.lineno))

            def in_locked(line: int) -> bool:
                return any(a <= line <= b for a, b in locked_spans)

            for node in ast.walk(m):
                target = None
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Attribute) and \
                                isinstance(tgt.value, ast.Name) and \
                                tgt.value.id == "self" and \
                                tgt.attr in protected:
                            target = tgt
                elif isinstance(node, ast.AugAssign) and \
                        isinstance(node.target, ast.Attribute) and \
                        isinstance(node.target.value, ast.Name) and \
                        node.target.value.id == "self" and \
                        node.target.attr in protected:
                    target = node.target
                if target is not None and not in_locked(node.lineno):
                    findings.append(Finding(
                        "lock_discipline", src.rel, node.lineno,
                        f"lock_discipline:{src.rel}:{cls.name}."
                        f"{m.name}:{target.attr}",
                        f"{cls.name}.{m.name}: mutates "
                        f"self.{target.attr} (elsewhere accessed "
                        f"under {sorted(locks)}) without holding "
                        "the lock"))
    return findings


#: call spellings that construct a condition variable (own-lock arg
#: recorded so notifying under the cond's OWN lock never flags)
_COND_CTORS = ("threading.Condition", "make_condition",
               "lock_witness.make_condition")


def _cond_attrs(cls: ast.ClassDef) -> dict[str, str | None]:
    """``self.<attr>`` condition variables of this class ->
    the ``self.<lock>`` attr passed as their lock (None when the
    cond owns its lock)."""
    out: dict[str, str | None] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call):
            fname = _unparse(node.value.func)
            if fname not in _COND_CTORS and \
                    not fname.endswith(".make_condition"):
                continue
            own = None
            args = list(node.value.args) + [
                kw.value for kw in node.value.keywords
                if kw.arg == "lock"]
            for a in args:
                if isinstance(a, ast.Attribute) and \
                        isinstance(a.value, ast.Name) and \
                        a.value.id == "self":
                    own = a.attr
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    out[tgt.attr] = own
    return out


def check_notify_under_lock(src: SourceFile) -> list[Finding]:
    """``self.<cond>.notify()``/``notify_all()`` executed
    lexically inside a ``with self.<lock>`` span where ``<lock>`` is a
    DIFFERENT lock of the same class than the cond's own. The woken
    thread's first act is usually to take that other lock — signalling
    while still holding it turns every wakeup into an immediate block
    (the hurry-up-and-wait shape the dispatch X-ray's wakeup-latency
    plane measures at runtime); notify after release instead. The
    cond's OWN lock is exempt: Python requires holding it to
    notify."""
    findings: list[Finding] = []
    for cls in [n for n in ast.walk(src.tree)
                if isinstance(n, ast.ClassDef)]:
        locks = _lock_attrs(cls)
        conds = _cond_attrs(cls)
        if not locks or not conds:
            continue
        for m in [n for n in cls.body
                  if isinstance(n, ast.FunctionDef)]:
            spans: list[tuple[int, int, str]] = []
            for node in ast.walk(m):
                if not isinstance(node, ast.With):
                    continue
                for item in node.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Attribute) and \
                            isinstance(ctx.value, ast.Name) and \
                            ctx.value.id == "self" and \
                            ctx.attr in locks and \
                            ctx.attr not in conds:
                        spans.append((node.lineno,
                                      node.end_lineno or node.lineno,
                                      ctx.attr))
            if not spans:
                continue
            for node in ast.walk(m):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("notify",
                                               "notify_all")):
                    continue
                recv = node.func.value
                if not (isinstance(recv, ast.Attribute)
                        and isinstance(recv.value, ast.Name)
                        and recv.value.id == "self"
                        and recv.attr in conds):
                    continue
                own = conds[recv.attr]
                held = [lk for a, b, lk in spans
                        if a <= node.lineno <= b
                        and lk != own and lk != recv.attr]
                if held:
                    findings.append(Finding(
                        "notify_under_lock", src.rel, node.lineno,
                        f"notify_under_lock:{src.rel}:{cls.name}."
                        f"{m.name}:{recv.attr}",
                        f"{cls.name}.{m.name}: notifies "
                        f"self.{recv.attr} while holding "
                        f"self.{held[0]} — the woken thread blocks "
                        "right back on that lock; release before "
                        "signalling"))
    return findings


# ---------------------------------------------------------------------------
# 5. fsync seam
# ---------------------------------------------------------------------------

#: the directory whose durability barriers must be timed (repo-
#: relative prefix)
FSYNC_SEAM_DIR = "ceph_tpu_torch/store"

#: call spellings that ARE a raw durability barrier
_RAW_SYNC_CALLS = frozenset((
    "os.fsync", "os.fdatasync", "fsync", "fdatasync"))


def check_fsync_seam(src: SourceFile) -> list[Finding]:
    """Direct ``os.fsync``/``os.fdatasync`` calls under
    ``ceph_tpu_torch/store/``: untimed commit stalls. The store layer must
    route every barrier through ``utils/store_telemetry``'s named
    seam so fsync count/bytes/wall land per call site; a store that
    syncs directly reopens the blind spot under
    ``commit_wait``."""
    rel = src.rel.replace(os.sep, "/")
    if not rel.startswith(FSYNC_SEAM_DIR + "/"):
        return []
    findings: list[Finding] = []

    def visit(node: ast.AST, func: str) -> None:
        for child in ast.iter_child_nodes(node):
            name = func
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                name = child.name
            if isinstance(child, ast.Call) and \
                    _unparse(child.func) in _RAW_SYNC_CALLS:
                findings.append(Finding(
                    "fsync_seam", src.rel, child.lineno,
                    f"untimed-fsync:{rel}:{func}",
                    f"{_unparse(child.func)} in {func}(): durability "
                    "barrier bypasses the timed-fsync seam "
                    "(store_telemetry.timed_fsync/timed_fdatasync/"
                    "timed_sync) — an unmeasured commit stall"))
            visit(child, name)

    visit(src.tree, "<module>")
    return findings


#: reactor-affinity scope (repo-relative directory prefix): the
#: shard-per-core subsystem whose run-to-completion discipline the
#: checker pins statically
REACTOR_DIR = "ceph_tpu_torch/crimson"

#: sync primitives whose DIRECT construction inside crimson bypasses
#: the lock witness (cross-shard edges must go through make_lock /
#: make_condition so contention is attributable)
_RAW_LOCK_CALLS = frozenset((
    "threading.Lock", "threading.RLock", "threading.Condition"))


def check_reactor_affinity(src: SourceFile) -> list[Finding]:
    """Shared-nothing discipline for ``ceph_tpu_torch/crimson/``:
    the static twin of the runtime hop counters (``ophop_
    wq_continuation == 0``) and the lock witness. Three violation
    classes:

    * ``global`` statements — module-level mutable state is shared
      across every reactor thread; crimson state lives on the shard
      (``Reactor``/``ReactorServices``) or on the OSD control plane,
      never in module globals.
    * blocking ``time.sleep`` inside ``async def`` — parks the whole
      reactor (every PG pinned to it stalls admission-to-commit);
      coroutines use ``asyncio.sleep`` or an injectable seam.
    * direct ``threading.Lock/RLock/Condition`` construction — a
      cross-shard edge the lock witness cannot see; the deliberate
      edges (map waiters, tid counter, sub-write batch fan-in) go
      through ``make_lock`` and are witnessed.
    """
    rel = src.rel.replace(os.sep, "/")
    if not rel.startswith(REACTOR_DIR + "/"):
        return []
    findings: list[Finding] = []

    def visit(node: ast.AST, func: str, in_async: bool) -> None:
        for child in ast.iter_child_nodes(node):
            name, is_async = func, in_async
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef)):
                name = child.name
                is_async = isinstance(child, ast.AsyncFunctionDef)
            if isinstance(child, ast.Global):
                findings.append(Finding(
                    "reactor_affinity", src.rel, child.lineno,
                    f"reactor-affinity:{rel}:{func}:global",
                    f"global {', '.join(child.names)} in {func}(): "
                    "module-level mutable state is visible to every "
                    "reactor — shared-nothing state lives on the "
                    "shard or the OSD control plane"))
            if isinstance(child, ast.Call):
                callee = _unparse(child.func)
                if in_async and callee == "time.sleep":
                    findings.append(Finding(
                        "reactor_affinity", src.rel, child.lineno,
                        f"reactor-affinity:{rel}:{func}:"
                        "blocking-sleep",
                        f"time.sleep in async {func}(): blocks the "
                        "whole reactor (every PG pinned to it) — "
                        "use asyncio.sleep or an injectable seam"))
                if callee in _RAW_LOCK_CALLS:
                    findings.append(Finding(
                        "reactor_affinity", src.rel, child.lineno,
                        f"reactor-affinity:{rel}:{func}:raw-lock",
                        f"{callee}() in {func}(): cross-shard sync "
                        "primitive invisible to the lock witness — "
                        "route through analysis.lock_witness."
                        "make_lock/make_condition"))
            visit(child, name, is_async)

    visit(src.tree, "<module>", False)
    return findings


# ---------------------------------------------------------------------------
# 7. flow context
# ---------------------------------------------------------------------------

#: the module that DEFINES the flow-context seam — its own helpers
#: take ``qos`` by construction and are exempt
FLOW_SEAM_MODULE = "ceph_tpu_torch/utils/flow_telemetry.py"


def check_flow_context(src: SourceFile) -> list[Finding]:
    """Every enqueue seam that accepts a ``qos=`` parameter must
    thread the flow context across the handoff: a queue
    admission point classifies the op for scheduling, which is exactly
    where the submitting thread's flow label dies unless the seam
    captures it (``flow_telemetry.capture_flow(qos)``) or reads it
    (``current_flow()``) into whatever rides the queue. A ``qos``
    parameter with neither is a per-tenant attribution hole: every op
    through it lands in the unattributed bucket and the gap_report
    coverage gate erodes silently. Static twin of the >=95%%
    ops+bytes attribution acceptance run."""
    rel = src.rel.replace(os.sep, "/")
    if rel == FLOW_SEAM_MODULE:
        return []
    findings: list[Finding] = []

    def visit(node: ast.AST, owner: str) -> None:
        for child in ast.iter_child_nodes(node):
            name = owner
            if isinstance(child, ast.ClassDef):
                name = child.name
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                args = child.args
                params = {a.arg for a in (args.posonlyargs + args.args
                                          + args.kwonlyargs)}
                if "qos" in params:
                    seg = ast.get_source_segment(src.text, child) or ""
                    if "capture_flow" not in seg and \
                            "current_flow" not in seg:
                        qual = f"{owner}.{child.name}" if owner \
                            else child.name
                        findings.append(Finding(
                            "flow_context", src.rel, child.lineno,
                            f"flow_context:{rel}:{qual}",
                            f"{qual}: accepts qos= but never threads "
                            "the flow context (capture_flow/"
                            "current_flow) — ops crossing this seam "
                            "lose their tenant label and land "
                            "unattributed"))
                name = child.name
            visit(child, name)

    visit(src.tree, "")
    return findings


# ---------------------------------------------------------------------------
# driver + baseline
# ---------------------------------------------------------------------------

def run_all(root: str = PKG_ROOT,
            sources: list[SourceFile] | None = None) -> list[Finding]:
    if sources is None:
        sources = iter_sources(root)
    findings: list[Finding] = []
    drift = RegistryDrift()
    for src in sources:
        findings.extend(check_wire_symmetry(src))
        findings.extend(check_launch_hygiene(src))
        findings.extend(check_lock_discipline(src))
        findings.extend(check_notify_under_lock(src))
        findings.extend(check_fsync_seam(src))
        findings.extend(check_reactor_affinity(src))
        findings.extend(check_flow_context(src))
        drift.collect(src)
    findings.extend(drift.findings())
    findings.sort(key=lambda f: (f.path, f.line, f.key))
    return findings


def load_baseline(path: str = BASELINE_PATH) -> dict:
    if not os.path.exists(path):
        return {"lint": [], "witness": []}
    with open(path) as f:
        return json.load(f)


def diff_baseline(findings: list[Finding],
                  baseline: dict | None = None
                  ) -> tuple[list[Finding], list[dict]]:
    """(new findings not in the baseline, stale baseline entries whose
    violation no longer exists). Both must be empty for the gate."""
    if baseline is None:
        baseline = load_baseline()
    allow = {e["key"]: e for e in baseline.get("lint", ())}
    keys = {f.key for f in findings}
    new = [f for f in findings if f.key not in allow]
    stale = [e for k, e in sorted(allow.items()) if k not in keys]
    return new, stale
