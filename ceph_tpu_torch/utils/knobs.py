"""Typed actuator knobs — the registry the closed-loop tuner steps.

The OSD hot path has a sensor for every stage, but
the knobs those sensors argue about — engine launch-window depth,
flush thresholds, the dense->mesh crossover, sampling rates — were
hand-set constants. This module declares them as typed actuators: a
:class:`Knob` names the ``g_conf`` Option it steps, its safe bounds
(narrower than the Option's hard min/max — the tuner explores inside
an envelope an operator pre-approved), its step law (additive for
small integers like the window, geometric for byte thresholds and
rates), and its cool-down (how long a step must be observed before
the next actuation anywhere).

Pushes ride the existing config-observer seam: ``push`` writes the
``mon`` layer of the process ConfigProxy, so every daemon that
registered a cached observer (osd/device_engine, utils/tracing,
utils/profiler) picks the new value up without a hot-path config
read. Operator pins win by construction — the ``env`` and
``override`` layers outrank ``mon`` — and :meth:`KnobRegistry.push`
reports a pinned knob instead of pretending the step landed.

Safety invariant (the mid-adjustment-kill contract the scenario test
pins): every value that can ever reach a daemon passes
``clamp`` + the Option's own coercion, so ANY prefix of a tuner
run — including one that dies between step and revert — leaves every
knob inside its declared bounds.
"""

from __future__ import annotations

from dataclasses import dataclass

from ceph_tpu_torch.utils.config import ConfigProxy, g_conf


@dataclass(frozen=True)
class Knob:
    """One tuner-managed actuator over a declared config Option."""

    name: str              # the g_conf Option this knob actuates
    lo: float              # tuner envelope (within the Option bounds)
    hi: float
    step: float            # step size: factor (mul) or delta (add)
    kind: str = "mul"      # "mul" | "add"
    cooldown_s: float = 3.0
    subsystem: str = ""
    desc: str = ""

    def __post_init__(self) -> None:
        assert self.kind in ("mul", "add"), self.kind
        assert self.lo <= self.hi, (self.name, self.lo, self.hi)
        assert self.step > (1.0 if self.kind == "mul" else 0.0)

    def _quantize(self, value: float, conf: ConfigProxy):
        opt = conf.schema.get(self.name)
        if opt.type is int:
            value = int(round(value))
        return opt.coerce(value)

    def clamp(self, value: float, conf: ConfigProxy | None = None):
        conf = conf or g_conf()
        return self._quantize(min(self.hi, max(self.lo, value)), conf)

    def up(self, value: float, conf: ConfigProxy | None = None):
        nxt = value * self.step if self.kind == "mul" \
            else value + self.step
        return self.clamp(nxt, conf)

    def down(self, value: float, conf: ConfigProxy | None = None):
        nxt = value / self.step if self.kind == "mul" \
            else value - self.step
        return self.clamp(nxt, conf)

    def stepped(self, value: float, direction: str,
                conf: ConfigProxy | None = None):
        assert direction in ("up", "down"), direction
        return self.up(value, conf) if direction == "up" \
            else self.down(value, conf)


class KnobRegistry:
    """Declared actuators, keyed by Option name (insertion-ordered:
    evaluation order is declaration order, part of determinism)."""

    def __init__(self, knobs: list[Knob] | None = None) -> None:
        self._knobs: dict[str, Knob] = {}
        for k in knobs or ():
            self.add(k)

    def add(self, knob: Knob) -> Knob:
        if knob.name in self._knobs:
            raise ValueError(f"duplicate knob {knob.name}")
        self._knobs[knob.name] = knob
        return knob

    def get(self, name: str) -> Knob:
        return self._knobs[name]

    def names(self) -> list[str]:
        return list(self._knobs)

    def __iter__(self):
        return iter(self._knobs.values())

    def __contains__(self, name: str) -> bool:
        return name in self._knobs

    # -- views ---------------------------------------------------------
    def vector(self, conf: ConfigProxy | None = None) -> dict:
        """{knob name: current effective value} — what gap_report
        prints next to its attribution table."""
        conf = conf or g_conf()
        return {name: conf.get(name) for name in self._knobs}

    def vector_detail(self, conf: ConfigProxy | None = None) -> dict:
        """Per-knob value + winning config source + whether a higher
        layer pins it against tuner ('mon'-layer) pushes."""
        conf = conf or g_conf()
        out = {}
        for name, knob in self._knobs.items():
            src = conf.source_of(name)
            out[name] = {"value": conf.get(name), "source": src,
                         "pinned": src in ("env", "override"),
                         "lo": knob.lo, "hi": knob.hi,
                         "subsystem": knob.subsystem}
        return out

    # -- actuation -----------------------------------------------------
    def push(self, name: str, value,
             conf: ConfigProxy | None = None) -> tuple[object, bool]:
        """Clamp + write one knob through the mon layer. Returns
        (applied value as clamped, landed) — ``landed`` False means a
        higher-precedence layer pins the knob and daemons will not
        see the write."""
        conf = conf or g_conf()
        knob = self._knobs[name]
        value = knob.clamp(value, conf)
        conf.set(name, value, source="mon")
        return value, conf.source_of(name) == "mon"


#: the actuator set: every knob the ROADMAP names as
#: hand-set today, each bounded inside its Option's hard range
TUNER_KNOBS = KnobRegistry([
    Knob("engine_window", lo=1, hi=16, step=1, kind="add",
         cooldown_s=3.0, subsystem="osd/device_engine",
         desc="launch-window depth: overlap vs HBM working set"),
    Knob("engine_flush_bytes", lo=1 << 20, hi=256 << 20, step=2.0,
         kind="mul", cooldown_s=3.0, subsystem="osd/device_engine",
         desc="flush threshold: batching amortization vs batching "
              "latency"),
    Knob("host_flush_bytes", lo=64 << 10, hi=4 << 20, step=2.0,
         kind="mul", cooldown_s=3.0, subsystem="osd/device_engine",
         desc="host-matvec crossover for small flushes"),
    Knob("mesh_flush_bytes", lo=128 << 10, hi=64 << 20, step=2.0,
         kind="mul", cooldown_s=3.0, subsystem="osd/device_engine",
         desc="dense->mesh crossover: single-chip vs sharded step"),
    Knob("crimson_smp", lo=1, hi=16, step=1, kind="add",
         cooldown_s=6.0, subsystem="crimson/osd",
         desc="shared-nothing reactor count (seastar --smp role); a "
              "step applies to crimson OSDs started afterwards — the "
              "observer caches it for the next boot, live reactors "
              "never reshard"),
    Knob("crimson_flush_bytes", lo=256 << 10, hi=64 << 20, step=2.0,
         kind="mul", cooldown_s=3.0, subsystem="crimson/osd",
         desc="crimson engine flush window: stripe-batch amortization "
              "vs run-to-completion commit latency (the only async "
              "boundary on the RTC path)"),
    Knob("objecter_stream_max_ops", lo=1, hi=256, step=2.0,
         kind="mul", cooldown_s=3.0, subsystem="client/objecter",
         desc="streaming-objecter batch window: writes coalesced "
              "per (pool, PG) frame — batching amortization vs "
              "head-of-line latency (ROADMAP 1b/5d)"),
    Knob("osd_read_set_spread", lo=1, hi=8, step=1, kind="add",
         cooldown_s=3.0, subsystem="osd/ec_backend",
         desc="any-k read-set rotation width: hot-object read "
              "balance vs decode-signature reuse (ROADMAP 3)"),
    Knob("client_cache_bytes", lo=8 << 20, hi=256 << 20, step=2.0,
         kind="mul", cooldown_s=3.0, subsystem="client/object_cacher",
         desc="librados cache-tier capacity: hit rate vs client "
              "memory (stepped on measured hit rate)"),
    Knob("trace_sample_every", lo=8, hi=1024, step=2.0, kind="mul",
         cooldown_s=6.0, subsystem="utils/tracing",
         desc="head-sample keep rate: observability vs overhead"),
    Knob("profiler_hz", lo=10.0, hi=200.0, step=2.0, kind="mul",
         cooldown_s=6.0, subsystem="utils/profiler",
         desc="stack-sampling rate while a profiler runs"),
])


def tuner_managed_names() -> list[str]:
    """The knob names the registry-drift lint holds to the
    cached-observer bar: a knob the tuner mutates at runtime must be
    consumed through ``add_observer``, never re-read per-op."""
    return TUNER_KNOBS.names()


def knob_vector(conf: ConfigProxy | None = None) -> dict:
    """Convenience for report surfaces (gap_report, bench lines)."""
    return TUNER_KNOBS.vector(conf)
