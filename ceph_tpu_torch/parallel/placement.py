"""PG placement over a device mesh — port of ``ceph_tpu/parallel/placement.py``.

Ceph maps PGs to OSDs with CRUSH, a deterministic, stable-under-remap hash
of the pgid. This module is the same idea one level down: a mesh
(parallel/mesh.py) has ``stripe`` rows of slots, and a CRUSH-stable hash of
the pgid picks the row (the *placement slot*) whose slots own that PG's
device work. The device engine keys its staging buffers by (signature,
slot) and launches each slot's flushes on the slot's submesh, and the deep
scrub verifies a PG's batches there, so

- a PG's encode/decode/scrub work always lands on the same slots,
  deterministic across daemon restarts;
- different slots' flushes ride disjoint slots (their own streams, and
  their own devices on a mesh of several cards), so the engine's in-flight
  window overlaps them.

The map is a pure function of (pgid, mesh shape): nothing is stored,
nothing rebalances. The EC backend and the Objecter also key their
read-set and replica choices by :func:`stable_hash`; the mgr tuner
publishes slot weights (:func:`set_slot_weights`), which bias the map
while more than one slot exists.
"""

from __future__ import annotations

import math
import os
import zlib

from ceph_tpu_torch.analysis.lock_witness import make_lock
from ceph_tpu_torch.parallel import mesh as mesh_mod
from ceph_tpu_torch.parallel.mesh import Mesh
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.device_telemetry import telemetry


def stable_hash(key) -> int:
    """CRUSH-stable 32-bit hash of ``str(key)``: a pure function,
    identical across processes, restarts, and python hash seeds (the
    rjenkins role — crc32 here; the point is stability, not
    avalanche quality)."""
    return zlib.crc32(str(key).encode("utf-8")) & 0xFFFFFFFF


# -- load-aware slot weighting -----------------------------------------
#
# Hash-uniform placement is the default AND the fallback: weights only
# exist while the mgr tuner is active and publishing its load signal
# (per-slot live staged bytes). A weight vector biases the pgid->slot
# map via weighted rendezvous hashing — still a pure function of (pgid,
# weights) — and clearing the weights restores the hash-uniform map.

_weights_lock = make_lock("placement.weights")
_slot_weights: dict[int, float] | None = None


def set_slot_weights(weights: dict[int, float] | None) -> None:
    """Publish (or clear, with None/empty) the tuner's slot-weight
    vector. Non-positive weights are floored to a small epsilon —
    a loaded slot is de-preferred, never excluded (excluding a slot
    would strand its staged state)."""
    global _slot_weights
    if not weights:
        with _weights_lock:
            _slot_weights = None
        return
    cleaned = {int(s): max(1e-6, float(w))
               for s, w in weights.items()}
    with _weights_lock:
        _slot_weights = cleaned


def slot_weights() -> dict[int, float] | None:
    """The active weight vector (None = hash-uniform)."""
    with _weights_lock:
        return dict(_slot_weights) if _slot_weights else None


class PlacementMap:
    """pgid -> stripe-row placement over one mesh. Slots are the mesh's
    ``stripe`` coordinates; a slot's submesh is that row of the mesh as a
    (1, shard) mesh of the same ``Slot`` objects (their streams included)
    under the parent's axis names, so every sharded-codec step runs on it
    unchanged."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self.n_slots = int(mesh.shape["stripe"])
        self._lock = make_lock("placement.submesh")
        self._submeshes: dict[int, Mesh] = {}

    def slot(self, pgid) -> int:
        """pgid -> stripe row. Hash-uniform modulo by default; when the
        tuner published slot weights, weighted rendezvous hashing
        (highest-random-weight with -ln(u)/w scores) biases new assignments
        toward lightly loaded rows while staying a pure,
        process-independent function of (pgid, weights)."""
        weights = _slot_weights
        if weights:
            return self._weighted_slot(pgid, weights)
        return stable_hash(pgid) % self.n_slots

    def _weighted_slot(self, pgid, weights: dict[int, float]) -> int:
        best, best_score = 0, math.inf
        for s in range(self.n_slots):
            w = weights.get(s, 1.0)
            # u in (0, 1): never 0 (log) and never exactly 1
            u = (stable_hash(f"{pgid}|slot{s}") + 1.0) / 4294967298.0
            score = -math.log(u) / w
            if score < best_score:
                best, best_score = s, score
        return best

    def submesh(self, slot: int) -> Mesh:
        """The slot's stripe row as a standalone (1, shard) mesh. Cached:
        step caches key by mesh identity, so the same slot always hands
        back the same Mesh object."""
        slot %= self.n_slots
        with self._lock:
            sm = self._submeshes.get(slot)
            if sm is None:
                sm = self._submeshes[slot] = Mesh(
                    self.mesh.devices[slot:slot + 1, :],
                    axis_names=self.mesh.axis_names)
            return sm

    def owners(self, pgid) -> list:
        """The slots owning this PG's device work."""
        return list(self.mesh.devices[self.slot(pgid), :])


def enabled() -> bool:
    """The placement on/off switch: the environment beats the declared
    Option."""
    env = os.environ.get("CEPH_TPU_MESH_PLACEMENT")
    if env is not None:
        return env != "0"
    return bool(g_conf()["mesh_placement"])


_lock = make_lock("placement.active")
_active: tuple[int, PlacementMap] | None = None
#: (telemetry, slot count) last noted: the gauge is written when either
#: changes (a test's telemetry reset makes a fresh gauge)
_noted_slots: tuple | None = None


def active_map() -> PlacementMap | None:
    """The placement map over the process default mesh, or None when no
    mesh is set or placement is switched off. Rebuilt when the default
    mesh changes; the ``placement_slots`` gauge tracks the active slot
    count. Called per staged op, so the steady state is two dict reads."""
    global _active
    mesh = mesh_mod.get_default_mesh()
    if mesh is None or not enabled():
        _note_slots(0)
        return None
    with _lock:
        if _active is None or _active[0] != id(mesh):
            _active = (id(mesh), PlacementMap(mesh))
        pmap = _active[1]
    _note_slots(pmap.n_slots)
    return pmap


def _note_slots(n: int) -> None:
    global _noted_slots
    tel = telemetry()
    if _noted_slots is not None and _noted_slots[0] is tel and \
            _noted_slots[1] == n:
        return
    tel.note_placement_slots(n)
    _noted_slots = (tel, n)
