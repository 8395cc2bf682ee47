"""PG placement hashing — the host part of ``ceph_tpu/parallel/placement.py``.

The reference maps a pgid to the stripe row of a device mesh that owns
its device work, with a CRUSH-stable hash of the pgid. The port has no
mesh yet (ROADMAP A.5), so only the host parts are here: the hash, which
the EC backend and the Objecter key their read-set and replica choices
by, and the slot-weight vector the mgr tuner publishes (its weights rule
fires only with more than one slot, so on one card it stays inert).
"""

from __future__ import annotations

import zlib

from ceph_tpu_torch.analysis.lock_witness import make_lock


def stable_hash(key) -> int:
    """CRUSH-stable 32-bit hash of ``str(key)``: a pure function,
    identical across processes, restarts, and python hash seeds (the
    rjenkins role — crc32 here; the point is stability, not
    avalanche quality)."""
    return zlib.crc32(str(key).encode("utf-8")) & 0xFFFFFFFF


# -- load-aware slot weighting -----------------------------------------
#
# Hash-uniform placement is the default AND the fallback: weights only
# exist while the mgr tuner is active and publishing its chip-load
# signal (per-slot live staged bytes). A weight vector biases the
# pgid->slot map via weighted rendezvous hashing in the reference's
# PlacementMap (ROADMAP A.5 here); clearing the weights restores the
# hash-uniform map.

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
