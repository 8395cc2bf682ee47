"""faults — the process-wide, deterministically seeded fault registry.

The qa suites' scattered injection knobs (``ms_inject_socket_failures``,
``store.inject_data_error``, messenger ``blocked_peers``) each spoke a
private dialect, none was schedulable mid-run, and none could answer
"what fired, in what order?" after the fact. This module is the one
API the chaos harness, MiniCluster, the load generator, and tests
drive (the teuthology Thrasher + ``ms inject`` yamls role, unified):

- **Scoped rules** (:meth:`FaultRegistry.add`): each rule names a fault
  ``kind`` plus a match scope and firing policy —

  =================  ==================================================
  ``msgr_drop``      silently drop matching outbound/inbound frames
                     (the socket-failure / partition-window role)
  ``msgr_delay``     hold a matching frame ``delay_s`` before the wire
                     (congestion / slow-link windows)
  ``store_eio``      a matching store read answers EIO
                     (bluestore_debug_inject_read_err role)
  ``store_latency``  a matching store read stalls ``delay_s``
                     (a dying disk's long tail)
  ``engine_launch``  the device engine's next matching encode flush
                     launch raises (rides the existing failure-drain
                     path; the port's ECBackend fails the op, EIO)
  ``engine_decode``  same for a signature-batched decode flush
  =================  ==================================================

  Scope fields: ``entity`` (sender, e.g. ``"osd.1"`` or ``"osd.*"``),
  ``peer`` (dest addr or entity), ``msg_type``, ``cid_prefix`` /
  ``oid_prefix`` for stores. Policy: ``p`` (probability), ``every``
  (every Nth match), ``max_fires``, ``delay_s``.

- **Determinism contract**: firing decisions are a pure function of
  ``(registry seed, rule id, per-rule match counter)`` — a stateless
  crc32-derived hash, NOT a shared RNG stream — so the i-th match of a
  rule decides identically across runs regardless of thread
  interleaving. Same seed + same rules + same match sequence => same
  fault sequence (pinned by tests/test_faults.py).

- **Schedule** (:meth:`schedule`): timed/op-counted actions
  (``kill_osd``, ``revive_osd``, arm-a-rule) the load generator pops
  via :meth:`pop_due` and executes against its MiniCluster — fault
  timing expressed in the workload's own clock.

- **Accounting**: every fire lands in the ``faults`` PerfCounters
  (prometheus + the ``fault status`` asok dump, test_counter_schema
  lint) and in a bounded event log (:meth:`fired`) for after-the-fact
  sequence comparison.

The hooks are free when idle: each hook is gated on a plain attribute
check against empty rule lists, no locks taken.
"""

from __future__ import annotations

import fnmatch
import threading
import time
from collections import deque

from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.utils.perf_counters import collection

log = Dout("faults")

MSGR_KINDS = ("msgr_drop", "msgr_delay")
STORE_KINDS = ("store_eio", "store_latency")
ENGINE_KINDS = ("engine_launch", "engine_decode")
KINDS = MSGR_KINDS + STORE_KINDS + ENGINE_KINDS

_EVENT_LOG_MAX = 4096

#: msg-type FAMILIES: a rule naming the singleton sub-write types also
#: matches their batched twins (ISSUE 9 — a chaos rule written against
#: MECSubWrite/MECSubWriteReply must keep biting when the bulk-ingest
#: path ships the same payload as one MECSubWriteBatch per peer, so a
#: dropped/delayed batch degrades exactly like N dropped singletons)
_MSG_TYPE_FAMILY = {
    30: (30, 67),     # MECSubWrite -> + MECSubWriteBatch
    31: (31, 68),     # MECSubWriteReply -> + MECSubWriteBatchReply
    # ISSUE 15: the streaming objecter's batched client frames — a
    # rule on MOSDOp/MOSDOpReply keeps biting when the client leg
    # coalesces the same writes into one MOSDOpBatch per (pool, PG),
    # so a dropped batched submit degrades exactly like N singleton
    # drops (and recovers the same way: per-op singleton resends)
    20: (20, 69),     # MOSDOp -> + MOSDOpBatch
    21: (21, 70),     # MOSDOpReply -> + MOSDOpReplyBatch
}


def _msg_type_matches(rule_type: int, msg_type: int) -> bool:
    return msg_type in _MSG_TYPE_FAMILY.get(rule_type, (rule_type,))


class InjectedFault(RuntimeError):
    """Raised for injected engine faults (flows down the engine's
    existing failure-drain / host-fallback path)."""


def _hash01(seed: int, rule_id: int, n: int) -> float:
    """Deterministic per-(rule, match-index) uniform in [0, 1): the
    decision function the determinism contract rests on. A full
    avalanche mixer (splitmix-style) — NOT a crc, whose linearity
    turns a seed change into a constant xor that can leave the
    compared low bits untouched."""
    x = (seed * 0x9E3779B9 + rule_id * 0x85EBCA6B
         + n * 0xC2B2AE35 + 0x5BF03635) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x / float(1 << 32)


class Rule:
    """One scoped fault rule. Matching is cheap string/prefix work;
    the fire decision is the stateless hash above."""

    __slots__ = ("rule_id", "kind", "entity", "peer", "msg_type",
                 "cid_prefix", "oid_prefix", "p", "every", "max_fires",
                 "delay_s", "fires", "matches", "_registry", "active")

    def __init__(self, rule_id: int, kind: str, *, entity: str = "*",
                 peer: str = "*", msg_type: int | None = None,
                 cid_prefix: str = "", oid_prefix: str = "",
                 p: float = 1.0, every: int | None = None,
                 max_fires: int | None = None, delay_s: float = 0.0,
                 registry: "FaultRegistry | None" = None) -> None:
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        self.rule_id = rule_id
        self.kind = kind
        self.entity = entity
        self.peer = peer
        self.msg_type = msg_type
        self.cid_prefix = cid_prefix
        self.oid_prefix = oid_prefix
        self.p = p
        self.every = every
        self.max_fires = max_fires
        self.delay_s = delay_s
        self.fires = 0
        self.matches = 0
        self.active = True
        self._registry = registry

    def remove(self) -> None:
        if self._registry is not None:
            self._registry.remove(self)

    def _decide(self, seed: int) -> bool:
        """One match arrived: count it and decide (caller holds the
        registry lock). The decision for match #n is a pure function
        of (seed, rule_id, n)."""
        if not self.active:
            return False
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        n = self.matches
        self.matches += 1
        if self.every is not None:
            fire = (n % self.every) == self.every - 1
        else:
            fire = self.p >= 1.0 or _hash01(seed, self.rule_id, n) < self.p
        if fire:
            self.fires += 1
        return fire

    def describe(self) -> dict:
        return {"id": self.rule_id, "kind": self.kind,
                "entity": self.entity, "peer": self.peer,
                "msg_type": self.msg_type,
                "cid_prefix": self.cid_prefix,
                "oid_prefix": self.oid_prefix, "p": self.p,
                "every": self.every, "max_fires": self.max_fires,
                "delay_s": self.delay_s, "matches": self.matches,
                "fires": self.fires, "active": self.active}


def _match_name(pattern: str, name: str) -> bool:
    if pattern == "*" or pattern == name:
        return True
    return fnmatch.fnmatchcase(name, pattern)


class FaultRegistry:
    """Process-wide rule set + schedule + accounting. One instance per
    process through :func:`registry`; tests may build private ones."""

    def __init__(self, seed: int = 0, perf=None) -> None:
        self._lock = threading.Lock()
        self._seed = seed
        self._next_id = 1
        # split by hook family so the hot hooks gate on one attribute
        self._msgr_rules: list[Rule] = []
        self._store_rules: list[Rule] = []
        self._engine_rules: list[Rule] = []
        self._schedule: list[dict] = []
        self._events: deque = deque(maxlen=_EVENT_LOG_MAX)
        #: monotonic fire counter (NOT len(_events) — the bounded
        #: deque plateaus): the tracer's per-op fault-window probe
        #: compares this across a root span's lifetime
        self._fires_total = 0
        self._perf = perf

    # -- configuration ------------------------------------------------
    @property
    def seed(self) -> int:
        return self._seed

    def reseed(self, seed: int) -> None:
        """Set the decision seed and clear rules/schedule/log — the
        'fresh deterministic run' entry point."""
        with self._lock:
            self._seed = seed
            self._msgr_rules = []
            self._store_rules = []
            self._engine_rules = []
            self._schedule = []
            self._events.clear()

    def add(self, kind: str, **kw) -> Rule:
        with self._lock:
            rule = Rule(self._next_id, kind, registry=self, **kw)
            self._next_id += 1
            if kind in MSGR_KINDS:
                self._msgr_rules = self._msgr_rules + [rule]
            elif kind in STORE_KINDS:
                self._store_rules = self._store_rules + [rule]
            else:
                self._engine_rules = self._engine_rules + [rule]
        if self._perf is not None:
            self._perf.set_gauge("fault_rules", self.rule_count())
        return rule

    def remove(self, rule: Rule) -> None:
        with self._lock:
            rule.active = False
            self._msgr_rules = [r for r in self._msgr_rules
                                if r is not rule]
            self._store_rules = [r for r in self._store_rules
                                 if r is not rule]
            self._engine_rules = [r for r in self._engine_rules
                                  if r is not rule]
        if self._perf is not None:
            self._perf.set_gauge("fault_rules", self.rule_count())

    def rule_count(self) -> int:
        with self._lock:
            return (len(self._msgr_rules) + len(self._store_rules)
                    + len(self._engine_rules))

    def clear(self) -> None:
        self.reseed(self._seed)

    # -- accounting ---------------------------------------------------
    def _note(self, rule: Rule | None, kind: str, detail: str) -> None:
        with self._lock:
            self._fires_total += 1
            self._events.append(
                {"rule": rule.rule_id if rule else 0, "kind": kind,
                 "detail": detail,
                 "n": rule.fires if rule else 0})
        if self._perf is not None:
            self._perf.inc("faults_fired")
            key = f"faults_{kind}"
            try:
                self._perf.inc(key)
            except KeyError:
                pass
        log(5, f"fault fired: {kind} {detail}")

    def fired(self) -> list[dict]:
        """The bounded fire log, oldest first — the sequence two runs
        with the same seed + schedule compare for reproducibility."""
        with self._lock:
            return list(self._events)

    def describe(self) -> dict:
        with self._lock:
            rules = (self._msgr_rules + self._store_rules
                     + self._engine_rules)
            return {"seed": self._seed,
                    "rules": [r.describe() for r in rules],
                    "schedule": [dict(s) for s in self._schedule],
                    "fired": len(self._events)}

    # -- hooks (hot paths; free when no rules) ------------------------
    def message_fault(self, entity: str, peer: str, msg_type: int
                      ) -> tuple[bool, float]:
        """Outbound/inbound frame check: returns (drop, delay_s).
        Called from the messenger send path and the receive loop."""
        if not self._msgr_rules:
            return False, 0.0
        drop, delay = False, 0.0
        with self._lock:
            for rule in self._msgr_rules:
                if rule.msg_type is not None and \
                        not _msg_type_matches(rule.msg_type, msg_type):
                    continue
                if not _match_name(rule.entity, entity):
                    continue
                if not _match_name(rule.peer, peer):
                    continue
                if not rule._decide(self._seed):
                    continue
                if rule.kind == "msgr_drop":
                    drop = True
                else:
                    delay = max(delay, rule.delay_s)
                fired = rule
                self._fires_total += 1
                self._events.append(
                    {"rule": fired.rule_id, "kind": fired.kind,
                     "detail": f"{entity}->{peer} type={msg_type}",
                     "n": fired.fires})
        if drop or delay:
            if self._perf is not None:
                self._perf.inc("faults_fired")
                if drop:
                    self._perf.inc("faults_msgr_drop")
                if delay:
                    self._perf.inc("faults_msgr_delay")
        return drop, delay

    def store_read_fault(self, cid: str, oid: str
                         ) -> tuple[bool, float]:
        """Store read check: returns (eio, delay_s). The store sleeps
        the delay then raises its own EIOError when eio is set."""
        if not self._store_rules:
            return False, 0.0
        eio, delay = False, 0.0
        with self._lock:
            for rule in self._store_rules:
                if rule.cid_prefix and not cid.startswith(
                        rule.cid_prefix):
                    continue
                if rule.oid_prefix and not oid.startswith(
                        rule.oid_prefix):
                    continue
                if not rule._decide(self._seed):
                    continue
                if rule.kind == "store_eio":
                    eio = True
                else:
                    delay = max(delay, rule.delay_s)
                self._fires_total += 1
                self._events.append(
                    {"rule": rule.rule_id, "kind": rule.kind,
                     "detail": f"{cid}/{oid}", "n": rule.fires})
        if eio or delay:
            if self._perf is not None:
                self._perf.inc("faults_fired")
                if eio:
                    self._perf.inc("faults_store_eio")
                if delay:
                    self._perf.inc("faults_store_latency")
        return eio, delay

    def engine_fault(self, point: str) -> None:
        """Device-engine launch check (``point`` is ``"launch"`` for
        encode flushes, ``"decode"`` for decode flushes): raises
        InjectedFault when a matching rule fires — the engine's
        existing error paths turn that into an op error (the port's
        EC backend keeps no host fallback)."""
        if not self._engine_rules:
            return
        kind = "engine_launch" if point == "launch" else "engine_decode"
        fired = None
        with self._lock:
            for rule in self._engine_rules:
                if rule.kind != kind:
                    continue
                if rule._decide(self._seed):
                    fired = rule
                    self._fires_total += 1
                    self._events.append(
                        {"rule": rule.rule_id, "kind": rule.kind,
                         "detail": point, "n": rule.fires})
                    break
        if fired is not None:
            if self._perf is not None:
                self._perf.inc("faults_fired")
                self._perf.inc(f"faults_{kind}")
            raise InjectedFault(
                f"injected {kind} fault (rule {fired.rule_id})")

    # -- action schedule ----------------------------------------------
    def schedule(self, action: str, *, at_s: float | None = None,
                 at_ops: int | None = None, **kw) -> dict:
        """Queue a timed/op-counted action for the workload driver
        (load_gen) to pop and execute: ``kill_osd``, ``revive_osd``,
        or anything the driver maps. Exactly one of ``at_s``
        (workload-elapsed seconds) / ``at_ops`` (completed-op count)
        must be given."""
        if (at_s is None) == (at_ops is None):
            raise ValueError("exactly one of at_s/at_ops required")
        ent = {"action": action, "at_s": at_s, "at_ops": at_ops,
               "done": False, **kw}
        with self._lock:
            self._schedule.append(ent)
        return ent

    def pop_due(self, elapsed_s: float, ops_done: int) -> list[dict]:
        """Actions whose trigger has passed and that have not fired
        yet; marks them fired and logs them (the driver executes)."""
        due = []
        with self._lock:
            for ent in self._schedule:
                if ent["done"]:
                    continue
                trig = ent["at_s"] is not None and \
                    elapsed_s >= ent["at_s"] or \
                    ent["at_ops"] is not None and ops_done >= ent["at_ops"]
                if trig:
                    ent["done"] = True
                    due.append(dict(ent))
                    self._fires_total += 1
                    self._events.append(
                        {"rule": 0, "kind": "action",
                         "detail": ent["action"],
                         "n": ent["at_ops"] if ent["at_ops"]
                         is not None else ent["at_s"]})
        if due and self._perf is not None:
            self._perf.inc("faults_fired", len(due))
            self._perf.inc("faults_actions", len(due))
        return due

    def note_action(self, action: str, detail: str = "") -> None:
        """Record an externally-executed fault action (MiniCluster's
        kill_osd/revive_osd land here) so the event log is the one
        place the whole fault sequence can be read back from."""
        self._note(None, "action", f"{action} {detail}".strip())
        if self._perf is not None:
            self._perf.inc("faults_actions")


# -- process-wide singleton --------------------------------------------

_lock = threading.Lock()
_registry: FaultRegistry | None = None


def _make_perf():
    perf = collection().get("faults")
    if perf is None:
        perf = collection().create("faults")
        perf.add_gauge("fault_rules", "scoped fault rules installed")
        perf.add_u64_counter("faults_fired",
                             "total injected-fault fires (all kinds)")
        perf.add_u64_counter("faults_msgr_drop",
                             "frames dropped by injection")
        perf.add_u64_counter("faults_msgr_delay",
                             "frames delayed by injection")
        perf.add_u64_counter("faults_store_eio",
                             "store reads answered injected EIO")
        perf.add_u64_counter("faults_store_latency",
                             "store reads stalled by injection")
        perf.add_u64_counter("faults_engine_launch",
                             "device encode launches failed by "
                             "injection")
        perf.add_u64_counter("faults_engine_decode",
                             "device decode flushes failed by "
                             "injection")
        perf.add_u64_counter("faults_actions",
                             "scheduled/driver fault actions executed "
                             "(osd kill/revive etc.)")
    return perf


def registry() -> FaultRegistry:
    """The process-wide registry (lazily created; counters attach to
    the global PerfCounters collection exactly once)."""
    global _registry
    with _lock:
        if _registry is None:
            _registry = FaultRegistry(perf=_make_perf())
        return _registry


def registry_if_exists() -> FaultRegistry | None:
    """The registry ONLY if something already created it — probes
    (autopsies, tracer fault windows) must not allocate one."""
    return _registry


def fire_count() -> int:
    """Monotonic total of fault fires (0 when no registry exists).
    The tracer samples this at root-span open and again at the tail
    decision: a delta means a fault fired inside the op's window."""
    reg = _registry
    if reg is None:
        return 0
    return reg._fires_total


def reset_for_tests(seed: int = 0) -> FaultRegistry:
    reg = registry()
    reg.reseed(seed)
    return reg


# -- module-level hook shims (importers stay one call away) ------------

def message_fault(entity: str, peer: str, msg_type: int
                  ) -> tuple[bool, float]:
    reg = _registry
    if reg is None or not reg._msgr_rules:
        return False, 0.0
    return reg.message_fault(entity, peer, msg_type)


def msgr_rules_active() -> bool:
    """Cheap probe for the messenger's loopback gate: while ANY msgr
    chaos rule is installed, in-process sends take the full TCP path,
    so drop/delay windows keep their exact wire semantics."""
    reg = _registry
    return reg is not None and bool(reg._msgr_rules)


def store_read_fault(cid: str, oid: str) -> tuple[bool, float]:
    reg = _registry
    if reg is None or not reg._store_rules:
        return False, 0.0
    return reg.store_read_fault(cid, oid)


def check_store_read(cid: str, oid: str) -> bool:
    """Convenience for stores: sleeps an injected latency inline and
    returns True when the read must answer EIO."""
    eio, delay = store_read_fault(cid, oid)
    if delay > 0:
        time.sleep(delay)
    return eio


def engine_fault(point: str) -> None:
    reg = _registry
    if reg is None or not reg._engine_rules:
        return
    reg.engine_fault(point)


def register_asok(asok) -> None:
    """``fault status`` on every daemon: rules, schedule, fire counts
    (the counters key mirrors the other registries' asok contract so
    the schema lint can hold it to the same bar)."""

    def _status(_args: dict) -> dict:
        reg = registry()
        out = reg.describe()
        out["counters"] = _make_perf().dump()
        out["recent"] = reg.fired()[-50:]
        return out

    asok.register_command(
        "fault status", _status,
        "fault-injection registry: rules, schedule, fire log")
