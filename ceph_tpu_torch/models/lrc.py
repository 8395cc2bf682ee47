"""LRC — Locally Repairable Codes by layer composition; port of
``ceph_tpu/models/lrc.py``.

Reference: src/erasure-code/lrc/ErasureCodeLrc.{h,cc}. An LRC codec is a
*composition*: a global ``mapping`` string assigns positions (``D`` = object
data, ``_`` = computed), and an ordered list of ``layers``, each a
[mapping, profile] pair wrapping another registered EC plugin over the
subset of positions that are non-'_' in its mapping (``D`` = that layer's
input, ``c`` = chunks it computes). Encode applies layers in order; decode
runs a fixed-point over layers, repairing locally first and falling back to
the global layer — which is the entire point: a single lost chunk is
repaired from its local group (l reads) instead of k.

The simple ``k/m/l`` form generates mapping+layers exactly like the
reference's parse_kml (ErasureCodeLrc.cc:295-421): local_group_count =
(k+m)/l groups, each 'D'*(k/lgc) + 'c'*(m/lgc) global parity + one local
parity; constraints (k+m)%l == 0, k%lgc == 0, m%lgc == 0.

Layer profiles default to jerasure reed_sol_van, mirroring the reference's
default layer plugin. Every layer's sub-codec is built on the LRC codec's
own torch ``device``, so its matvecs run there (kernel B1 on CUDA).
"""

from __future__ import annotations

import json

import numpy as np

from ceph_tpu_torch.models.base import ErasureCode
from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.models.registry import PLUGIN_VERSION, ErasureCodePlugin

__erasure_code_version__ = PLUGIN_VERSION


class Layer:
    """One composition layer: a sub-codec over a subset of positions
    (reference: ErasureCodeLrc::Layer, ErasureCodeLrc.h:47-75)."""

    def __init__(self, mapping: str, sub_profile: dict, backend: str,
                 device="cuda") -> None:
        from ceph_tpu_torch.models.registry import instance
        self.mapping = mapping
        self.positions = [i for i, ch in enumerate(mapping) if ch != "_"]
        self.data_pos = [i for i, ch in enumerate(mapping) if ch == "D"]
        self.coding_pos = [i for i, ch in enumerate(mapping) if ch == "c"]
        if not self.data_pos or not self.coding_pos:
            raise ErasureCodeError(
                f"layer mapping {mapping!r} needs at least one D and one c")
        prof = dict(sub_profile)
        plugin = prof.pop("plugin", "jerasure")
        prof["k"] = str(len(self.data_pos))
        prof["m"] = str(len(self.coding_pos))
        prof.setdefault("backend", backend)
        self.codec = instance().factory(plugin, prof, device=device)
        # local index of a global position within this layer
        self.local = {pos: i for i, pos in enumerate(
            self.data_pos + self.coding_pos)}

    def encode(self, known: dict[int, np.ndarray]) -> dict[int, np.ndarray]:
        """Compute this layer's coding positions from known chunks."""
        chunks = {self.local[p]: known[p] for p in self.data_pos}
        coded = self.codec.encode_chunks(
            list(range(len(self.positions))), chunks)
        return {self.data_pos[0] * 0 + pos: coded[self.local[pos]]
                for pos in self.coding_pos}

    def try_decode(self, known: dict[int, np.ndarray],
                   targets: set[int]) -> dict[int, np.ndarray]:
        """Attempt to recover this layer's missing positions; {} if the
        layer cannot make progress."""
        missing = [p for p in self.positions if p not in known]
        wanted = [p for p in missing if p in targets or True]
        if not missing:
            return {}
        avail_local = {self.local[p]: known[p]
                       for p in self.positions if p in known}
        if len(avail_local) < len(self.data_pos):
            return {}
        want_local = [self.local[p] for p in wanted]
        try:
            dec = self.codec.decode_chunks(want_local, avail_local)
        except ErasureCodeError:
            return {}
        inv = {v: k for k, v in self.local.items()}
        return {inv[li]: arr for li, arr in dec.items() if li in want_local}

    def minimum_for(self, missing_local: list[int],
                    avail_local: list[int]) -> list[int] | None:
        try:
            plan = self.codec.minimum_to_decode(missing_local, avail_local)
            return sorted(plan)
        except ErasureCodeError:
            return None


def generate_kml(k: int, m: int, l: int) -> tuple[str, list]:
    """The reference's k/m/l -> mapping+layers generation
    (ErasureCodeLrc.cc:295-421)."""
    if (k + m) % l:
        raise ErasureCodeError(f"k+m={k + m} must be a multiple of l={l}")
    lgc = (k + m) // l
    if k % lgc:
        raise ErasureCodeError(f"k={k} must be a multiple of (k+m)/l={lgc}")
    if m % lgc:
        raise ErasureCodeError(f"m={m} must be a multiple of (k+m)/l={lgc}")
    kg, mg = k // lgc, m // lgc
    mapping = ("D" * kg + "_" * mg + "_") * lgc
    layers: list = [["".join(("D" * kg + "c" * mg + "_") for _ in range(lgc)),
                     {}]]
    for i in range(lgc):
        row = "".join(("D" * l + "c") if i == j else "_" * (l + 1)
                      for j in range(lgc))
        layers.append([row, {}])
    return mapping, layers


class ErasureCodeLrc(ErasureCode):
    def __init__(self, device="cuda") -> None:
        super().__init__(device)
        self.mapping = ""
        self.layers: list[Layer] = []

    def init(self, profile):
        profile = dict(profile)
        backend = str(profile.get("backend", "auto"))
        has_kml = any(x in profile for x in ("k", "m", "l"))
        if has_kml:
            if "mapping" in profile or "layers" in profile:
                raise ErasureCodeError(
                    "mapping/layers cannot be set when k, m, l are set")
            if not all(x in profile for x in ("k", "m", "l")):
                raise ErasureCodeError("all of k, m, l must be set together")
            k = self.to_int("k", profile, -1)
            m = self.to_int("m", profile, -1)
            l = self.to_int("l", profile, -1)
            mapping, layer_desc = generate_kml(k, m, l)
        else:
            mapping = profile.get("mapping", "")
            raw = profile.get("layers", "[]")
            layer_desc = json.loads(raw) if isinstance(raw, str) else raw
            if not mapping or not layer_desc:
                raise ErasureCodeError(
                    "lrc requires either k/m/l or mapping+layers")
        self.mapping = mapping
        self.layers = []
        for entry in layer_desc:
            lm, lp = entry[0], (entry[1] if len(entry) > 1 else {})
            if isinstance(lp, str):
                lp = dict(kv.split("=", 1) for kv in lp.split()) if lp else {}
            if len(lm) != len(mapping):
                raise ErasureCodeError(
                    f"layer mapping {lm!r} length != global {mapping!r}")
            self.layers.append(Layer(lm, lp, backend, self.device))
        # sanity: every non-data position computed by exactly >= 1 layer
        computed = {p for lay in self.layers for p in lay.coding_pos}
        holes = [i for i, ch in enumerate(mapping)
                 if ch == "_" and i not in computed]
        if holes:
            raise ErasureCodeError(
                f"mapping positions {holes} are computed by no layer")
        self._profile = profile
        self._profile["mapping"] = mapping
        # logical chunk i -> raw position: data chunks at the 'D'
        # positions in order, then coding positions (the reference's
        # chunk_mapping derived from the mapping string,
        # ErasureCodeLrc::parse_kml / ErasureCode.cc:260-279 remap)
        data_pos = [i for i, ch in enumerate(mapping) if ch == "D"]
        coding_pos = [i for i, ch in enumerate(mapping) if ch != "D"]
        self.chunk_mapping = data_pos + coding_pos

    # -- geometry ----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return len(self.mapping)

    def get_data_chunk_count(self) -> int:
        return sum(1 for ch in self.mapping if ch == "D")

    # -- encode ------------------------------------------------------------

    def encode_chunks(self, want_to_encode, chunks):
        known = {int(p): np.asarray(v, dtype=np.uint8)
                 for p, v in chunks.items()}
        for lay in self.layers:
            missing_inputs = [p for p in lay.data_pos if p not in known]
            if missing_inputs:
                raise ErasureCodeError(
                    f"layer {lay.mapping!r} inputs {missing_inputs} unknown "
                    f"(layers must be ordered so inputs come first)")
            known.update(lay.encode(known))
        return {p: known[p] for p in want_to_encode
                if p in known and p not in chunks}

    def encode(self, want_to_encode, data):
        split = self.encode_prepare(data)
        data_positions = [i for i, ch in enumerate(self.mapping) if ch == "D"]
        known = {pos: split[i] for i, pos in enumerate(data_positions)}
        coded = self.encode_chunks(list(range(len(self.mapping))), known)
        known.update(coded)
        return {p: known[p] for p in want_to_encode if p in known}

    # -- decode ------------------------------------------------------------

    def decode_chunks(self, want_to_read, chunks):
        known = {int(p): np.asarray(v, dtype=np.uint8)
                 for p, v in chunks.items()}
        targets = set(want_to_read)
        # local-first: smaller layers repair with fewer reads (the LRC point)
        by_span = sorted(self.layers, key=lambda l: len(l.positions))
        while not targets <= set(known):
            progress = False
            for lay in by_span:
                got = lay.try_decode(known, targets)
                new = {p: v for p, v in got.items() if p not in known}
                if new:
                    known.update(new)
                    progress = True
            if not progress:
                raise ErasureCodeError(
                    f"lrc: cannot decode {sorted(targets - set(known))} "
                    f"from {sorted(chunks)}", errno_=5)
        return {p: known[p] for p in want_to_read}

    def minimum_to_decode(self, want_to_read, available):
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return {c: [(0, 1)] for c in sorted(want)}
        # simulate the layered repair, tracking which chunks get read
        known = set(avail)
        used: set[int] = set(want & avail)
        targets = set(want)
        by_span = sorted(self.layers, key=lambda l: len(l.positions))
        while not targets <= known:
            progress = False
            for lay in by_span:
                missing = [p for p in lay.positions if p not in known]
                if not missing:
                    continue
                avail_local = [lay.local[p]
                               for p in lay.positions if p in known]
                missing_local = [lay.local[p] for p in missing]
                plan = lay.minimum_for(missing_local, avail_local)
                if plan is None:
                    continue
                inv = {v: k for k, v in lay.local.items()}
                used |= {inv[li] for li in plan if inv[li] in avail}
                known |= set(missing)
                progress = True
            if not progress:
                raise ErasureCodeError(
                    f"lrc: cannot decode {sorted(targets - known)} from "
                    f"{sorted(avail)}", errno_=5)
        return {c: [(0, 1)] for c in sorted(used)}


class LrcPlugin(ErasureCodePlugin):
    def factory(self, profile, device):
        codec = ErasureCodeLrc(device=device)
        codec.init(profile)
        return codec


def __erasure_code_init__(name, registry):
    registry.add(name, LrcPlugin())
