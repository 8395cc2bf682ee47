"""Clay layered codec on the device — port of ``ceph_tpu/models/clay_device.py``.

The Clay host algorithm (models/clay.py ``_decode_layered``,
ErasureCodeClay.cc:644-709) is GF(2^8)-linear and acts byte position by
byte position along the sub-chunks, with control flow that depends only
on (q, t, erased). ``trace_layered`` replays that control flow once and
records vectorizable op groups; everything below executes them over whole
[nodes, planes, lanes] arrays:

- the pairwise coupling transforms (C <-> U) are 2x2 GF-constant maps
  applied across lanes, with per-slot coefficients (``_varmul_tables``);
- each plane's MDS solve is one small GF matrix over the plane's nodes;
- the score levels become a short static chain (<= m+1 levels).

Three forms, each byte-identical to the host oracle:

- :func:`build_encode_fast` — the staged torch encode (gather, varmul,
  plane-wise matvec, varmul): **kernel B3's plain version**;
- :func:`build_encode_kernel` — kernel B3 (csrc/clay_encode.cu via
  ops/clay_cuda.py): uncouple, plane-wise MDS and recouple of one lane
  tile in one launch;
- :func:`build_transform` / :class:`ClayDeviceCodec` — the staged torch
  layered decode for any padded erasure signature: **kernel B4's plain
  version**;
- :func:`build_transform_kernel` — kernel B4 (csrc/clay_transform.cu):
  the whole multi-level decode of one lane tile in one launch, state in
  shared memory;
- :func:`build_decode_matvec` — the per-signature choice between kernel
  B5 (block-sparse, ops/gf_block_sparse.py) and the dense product for a
  linearized matrix, by measurement on the card.

The returned callables take and return torch tensors and run where their
input lies: a kernel for a CUDA tensor (or raise), the plain version for a
CPU tensor. :func:`build_encode_fused` is the reference's one-XLA-program
encode (a recorded negative result there, no Pallas kernel): the same
three stages composed in one torch function, the plane-wise MDS as one
bit-sliced ``torch.matmul``. No daemon path calls it.
"""

from __future__ import annotations

import os
import time
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from ceph_tpu_torch.ops import backend as backend_mod
from ceph_tpu_torch.ops import (bitmatrix, clay_cuda, gf256, gf_block_sparse,
                                gf_torch)
from ceph_tpu_torch.utils import tracepoints
from ceph_tpu_torch.utils.device_telemetry import telemetry
from ceph_tpu_torch.utils.lru import BoundedLRU

# host-only spans: a Clay call is one kernel, which a profiler's trace
# times already, and a span's pair of CUDA events took 28 us of host time
# a repair call under the profiler (H100 host; 56 us without), enough to
# let the host pace a traced stretch the card paces untraced
_CLAY = tracepoints.provider("clay")
_SPAN_ENCODE = _CLAY.span("encode")


# -- static trace ------------------------------------------------------

@dataclass
class LevelOps:
    """Vectorizable op groups for one score level (all index arrays)."""
    # phase 1: U for intact nodes
    ident: list = field(default_factory=list)      # (node, z)
    pair_a: dict = field(default_factory=dict)     # variant -> [(nxy, z, nsw, zsw)]
    # per-plane MDS decode of erased U
    planes: list = field(default_factory=list)     # [z, ...]
    # phase 2: C for erased nodes
    ident2: list = field(default_factory=list)     # (node, z)
    type_c: dict = field(default_factory=dict)     # variant -> [(nxy, z, nsw, zsw)]
    pair_b: list = field(default_factory=list)     # (nxy, z, nsw, zsw)


def trace_layered(codec, erased: frozenset[int]) -> list[LevelOps]:
    """Replay _decode_layered's control flow (ErasureCodeClay.cc:
    644-709) recording ops instead of computing bytes. ``erased`` is
    the PADDED node-id set (virtual/parity fill to m, as the host path
    builds it)."""
    q, t = codec.q, codec.t
    ssc = codec.sub_chunk_no
    zvecs = [codec.get_plane_vector(z) for z in range(ssc)]
    order = [sum(1 for i in erased if i % q == zvecs[z][i // q])
             for z in range(ssc)]
    max_score = max(order) if erased else 0
    levels = []
    for score in range(max_score + 1):
        ops = LevelOps()
        planes = [z for z in range(ssc) if order[z] == score]
        for z in planes:
            zv = zvecs[z]
            for y in range(t):
                for x in range(q):
                    node_xy = q * y + x
                    if node_xy in erased:
                        continue
                    node_sw = q * y + zv[y]
                    if zv[y] == x:
                        ops.ident.append((node_xy, z))
                    elif zv[y] < x or node_sw in erased:
                        z_sw = codec._z_sw(z, x, zv[y], y)
                        variant = 1 if zv[y] > x else 0
                        ops.pair_a.setdefault(variant, []).append(
                            (node_xy, z, node_sw, z_sw))
        ops.planes = planes
        for z in planes:
            zv = zvecs[z]
            for node_xy in sorted(erased):
                x, y = node_xy % q, node_xy // q
                node_sw = q * y + zv[y]
                if zv[y] == x:
                    ops.ident2.append((node_xy, z))
                elif node_sw not in erased:
                    z_sw = codec._z_sw(z, x, zv[y], y)
                    variant = 1 if zv[y] > x else 0
                    ops.type_c.setdefault(variant, []).append(
                        (node_xy, z, node_sw, z_sw))
                elif zv[y] < x:
                    z_sw = codec._z_sw(z, x, zv[y], y)
                    ops.pair_b.append((node_xy, z, node_sw, z_sw))
        levels.append(ops)
    return levels


# -- pft coefficient extraction ----------------------------------------

def _pft_matrix(codec, want: list[int], known_slots: list[int]
                ) -> np.ndarray:
    """2x2 (or 1x2) GF matrix of one pairwise-transform solve, probed
    from the pft codec (GF-linear)."""
    rows = []
    for basis in range(len(known_slots)):
        known = {s: np.array([1 if i == basis else 0], dtype=np.uint8)
                 for i, s in enumerate(known_slots)}
        out = codec.pft.decode_chunks(want, known)
        rows.append([int(np.asarray(out[w])[0]) for w in want])
    return np.array(rows, dtype=np.uint8).T   # [len(want), len(known)]


def pft_coefficients(codec) -> dict:
    """All coefficient matrices the trace can reference, per slot
    variant (slot order (i0,i1,i2,i3) = (1,0,3,2) when zy > x)."""
    coeffs = {}
    for variant, slots in ((0, (0, 1, 2, 3)), (1, (1, 0, 3, 2))):
        i0, i1, i2, i3 = slots
        # pair_a: (U_xy, U_sw) from (C_xy, C_sw)
        coeffs[("a", variant)] = _pft_matrix(codec, [i2, i3], [i0, i1])
        # type_c: C_xy from (C_sw, U_xy)
        coeffs[("c", variant)] = _pft_matrix(codec, [i0], [i1, i2])
    # pair_b: (C_xy, C_sw) from (U_xy, U_sw); called with zv[y] < x
    # only, so slot order is fixed at variant 0
    coeffs[("b", 0)] = _pft_matrix(codec, [0, 1], [2, 3])
    return coeffs


# -- plain torch execution ---------------------------------------------

def _varmul_tables(coef: np.ndarray) -> list[tuple[int, np.ndarray]]:
    """Bit tables for an elementwise multiply by VARYING constants:
    y[e] = coef[e] (*) x[e] = XOR_b ((x>>b)&1) * gf_mul(coef, 2^b)[e].
    Returns only the bit planes with a nonzero table."""
    out = []
    for b in range(8):
        tab = gf256.gf_mul(coef, 1 << b)
        if tab.any():
            out.append((b, tab))
    return out


def _varmul(x: torch.Tensor, tables) -> torch.Tensor:
    """Apply _varmul_tables to x [rows, cols, L] (tables [rows, cols]
    broadcast over lanes). A 0/1 byte times a byte never carries, so the
    uint8 product is the masked select."""
    y = None
    for b, tab in tables:
        t = torch.from_numpy(np.ascontiguousarray(tab[:, :, None])).to(
            x.device)
        term = ((x >> b) & 1) * t
        y = term if y is None else y ^ term
    return torch.zeros_like(x) if y is None else y


def _index(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(arr, dtype=np.int64)).to(device)


def build_transform(codec, erased: frozenset[int]):
    """``C[q*t, ssc, L] uint8 tensor -> C'`` filling the erased nodes
    (kernel B4's plain version). ``erased``: padded node-id set,
    |erased| <= m.

    Per level, phase 1 is one whole-array masked pass
    ``U' = sel(mask, a1(*)C + a2(*)C[perm], U)``, the MDS solve is one
    bit-sliced product over (planes-in-level x lanes), and phase 2 is one
    more masked pass over C."""
    levels = trace_layered(codec, erased)
    coeffs = pft_coefficients(codec)
    qt = codec.q * codec.t
    ssc = codec.sub_chunk_no
    intact = [i for i in range(qt) if i not in erased]
    er = sorted(erased)
    dmat = _mds_decode_matrix(codec, intact, er)

    static = []
    for ops in levels:
        # phase 1 tables: U[n,z] = a1[n,z](*)C[n,z] ^ a2[n,z](*)C[perm]
        a1 = np.zeros((qt, ssc), dtype=np.uint8)
        a2 = np.zeros((qt, ssc), dtype=np.uint8)
        pn = np.tile(np.arange(qt, dtype=np.int64)[:, None], (1, ssc))
        pz = np.tile(np.arange(ssc, dtype=np.int64)[None, :], (qt, 1))
        mask_u = np.zeros((qt, ssc), dtype=bool)
        for n, z in ops.ident:
            a1[n, z] = 1
            mask_u[n, z] = True
        for v, lst in ops.pair_a.items():
            m = coeffs[("a", v)]
            for nxy, z, nsw, zsw in lst:
                a1[nxy, z], a2[nxy, z] = int(m[0][0]), int(m[0][1])
                pn[nxy, z], pz[nxy, z] = nsw, zsw
                mask_u[nxy, z] = True
                a1[nsw, zsw], a2[nsw, zsw] = int(m[1][1]), int(m[1][0])
                pn[nsw, zsw], pz[nsw, zsw] = nxy, z
                mask_u[nsw, zsw] = True
        # phase 2 tables:
        #   C[n,z] = b1(*)C[perm2] ^ b2(*)U[n,z] ^ b3(*)U[perm2]
        b1 = np.zeros((qt, ssc), dtype=np.uint8)
        b2 = np.zeros((qt, ssc), dtype=np.uint8)
        b3 = np.zeros((qt, ssc), dtype=np.uint8)
        p2n = np.tile(np.arange(qt, dtype=np.int64)[:, None], (1, ssc))
        p2z = np.tile(np.arange(ssc, dtype=np.int64)[None, :], (qt, 1))
        mask_c = np.zeros((qt, ssc), dtype=bool)
        for n, z in ops.ident2:
            b2[n, z] = 1
            mask_c[n, z] = True
        for v, lst in ops.type_c.items():
            m = coeffs[("c", v)]
            for nxy, z, nsw, zsw in lst:
                b1[nxy, z] = int(m[0][0])
                b2[nxy, z] = int(m[0][1])
                p2n[nxy, z], p2z[nxy, z] = nsw, zsw
                mask_c[nxy, z] = True
        mb = coeffs[("b", 0)]
        for nxy, z, nsw, zsw in ops.pair_b:
            b2[nxy, z], b3[nxy, z] = int(mb[0][0]), int(mb[0][1])
            p2n[nxy, z], p2z[nxy, z] = nsw, zsw
            mask_c[nxy, z] = True
            b2[nsw, zsw], b3[nsw, zsw] = int(mb[1][1]), int(mb[1][0])
            p2n[nsw, zsw], p2z[nsw, zsw] = nxy, z
            mask_c[nsw, zsw] = True
        static.append({
            "planes": np.asarray(ops.planes, dtype=np.int64),
            "t_a1": _varmul_tables(a1), "t_a2": _varmul_tables(a2),
            "perm": (pn, pz), "mask_u": mask_u,
            "t_b1": _varmul_tables(b1), "t_b2": _varmul_tables(b2),
            "t_b3": _varmul_tables(b3),
            "perm2": (p2n, p2z), "mask_c": mask_c,
        })

    def transform(c_in: torch.Tensor) -> torch.Tensor:
        dev = c_in.device
        C = c_in
        U = torch.zeros_like(C)
        L = C.shape[-1]
        intact_idx, er_idx = _index(intact, dev), _index(er, dev)
        for entry in static:
            pn, pz = (_index(a, dev) for a in entry["perm"])
            cand = _varmul(C, entry["t_a1"]) ^ \
                _varmul(C[pn, pz], entry["t_a2"])
            mask = torch.from_numpy(entry["mask_u"]).to(dev)[:, :, None]
            U = torch.where(mask, cand, U)
            if len(entry["planes"]):
                planes = _index(entry["planes"], dev)
                x = U[intact_idx][:, planes, :].reshape(len(intact), -1)
                y = gf_torch.matvec(dmat, x).reshape(
                    len(er), len(planes), L)
                U[er_idx[:, None], planes[None, :]] = y
            p2n, p2z = (_index(a, dev) for a in entry["perm2"])
            cand = _varmul(C[p2n, p2z], entry["t_b1"]) ^ \
                _varmul(U, entry["t_b2"]) ^ \
                _varmul(U[p2n, p2z], entry["t_b3"])
            mask = torch.from_numpy(entry["mask_c"]).to(dev)[:, :, None]
            C = torch.where(mask, cand, C)
        return C

    return transform


def _mds_decode_matrix(codec, intact: list, er: list) -> np.ndarray:
    """[len(er), len(intact)] matrix recovering erased-U from intact-U
    (identical per plane), probed from the scalar MDS codec."""
    probe = {i: np.zeros(len(intact), dtype=np.uint8) for i in intact}
    for idx, i in enumerate(intact):
        probe[i][idx] = 1
    sol = codec.mds.decode_chunks(er, probe)
    return np.stack([np.asarray(sol[i], dtype=np.uint8) for i in er])


class _Tables:
    """Holder for ``tables_only`` builds."""

    def __init__(self, tables: dict) -> None:
        self.tables = tables


def build_encode_fast(codec, tables_only: bool = False):
    """Structured ENCODE (kernel B3's plain version): for the all-parity
    erasure pattern the score-level chain collapses to ONE active level,
    so encode is exactly three stages —

      1. U_data = pairwise uncouple of C_data (2-term GF combos, one
         gather + two coefficient-table passes over the data array; the
         erased partners' C is zero by construction and drops out);
      2. U_parity = the plane-wise MDS encode — ONE [m, kk] GF product
         over (ssc x lanes);
      3. C_parity = pairwise recouple (2-term combos reading U_parity
         and gathered C_data).

    Returns ``[k, ssc, L] uint8 tensor -> [m, ssc, L]`` on the input's
    device (``.tables`` holds the structure tables), or only the tables
    with ``tables_only``."""
    q, t = codec.q, codec.t
    qt, ssc = q * t, codec.sub_chunk_no
    k, m = codec.k, codec.m
    erased = frozenset(codec._node_id(i) for i in range(k, k + m))
    levels = trace_layered(codec, erased)
    active = [ops for ops in levels
              if ops.ident or ops.pair_a or ops.planes]
    assert len(active) == 1 and sorted(active[0].planes) == \
        list(range(ssc)), "encode trace is not single-level"
    ops = active[0]
    coeffs = pft_coefficients(codec)
    # intact rows = data nodes (grid ids 0..k-1) PLUS the nu virtual
    # nodes (grid ids k..k+nu-1): virtual C is zero, but virtual U mixes
    # real data and feeds the MDS solve, so they get real rows
    intact = [i for i in range(qt) if i not in erased]
    kk = len(intact)
    assert kk == k + codec.nu, (kk, k, codec.nu)
    er = sorted(erased)
    row_of = {n: idx for idx, n in enumerate(intact)}
    prow_of = {n: idx for idx, n in enumerate(er)}
    #: input embedding: padded row -> data chunk index (-1 = virtual)
    src = np.full(kk, -1, dtype=np.int32)
    for i in range(k):
        src[row_of[codec._node_id(i)]] = i

    # stage 1 tables over INTACT slots [kk, ssc]
    a1 = np.zeros((kk, ssc), dtype=np.uint8)
    a2 = np.zeros((kk, ssc), dtype=np.uint8)
    perm = np.zeros((kk, ssc), dtype=np.int32)   # flat intact-slot idx
    for n, z in ops.ident:
        a1[row_of[n], z] = 1
        perm[row_of[n], z] = row_of[n] * ssc + z
    for v, lst in ops.pair_a.items():
        mm = coeffs[("a", v)]
        for nxy, z, nsw, zsw in lst:
            r = row_of[nxy]
            a1[r, z], perm[r, z] = int(mm[0][0]), r * ssc + z
            if nsw in erased:
                # partner C is an erased node: zero by construction
                a2[r, z] = 0
            else:
                a2[r, z] = int(mm[0][1])
                perm[r, z] = row_of[nsw] * ssc + zsw
            rs = prow_of.get(nsw)
            if rs is None:
                r2 = row_of[nsw]
                a1[r2, zsw] = int(mm[1][1])
                a2[r2, zsw] = int(mm[1][0])
                perm[r2, zsw] = r * ssc + z
    dmat = _mds_decode_matrix(codec, intact, er)

    # stage 3 tables over PARITY slots [m, ssc]
    b1 = np.zeros((m, ssc), dtype=np.uint8)      # * C_data[perm_c]
    b2 = np.zeros((m, ssc), dtype=np.uint8)      # * U_par[self]
    b3 = np.zeros((m, ssc), dtype=np.uint8)      # * U_par[perm_u]
    perm_c = np.zeros((m, ssc), dtype=np.int32)
    perm_u = np.zeros((m, ssc), dtype=np.int32)
    for n, z in ops.ident2:
        b2[prow_of[n], z] = 1
    for v, lst in ops.type_c.items():
        mm = coeffs[("c", v)]
        for nxy, z, nsw, zsw in lst:
            r = prow_of[nxy]
            b1[r, z] = int(mm[0][0])
            perm_c[r, z] = row_of[nsw] * ssc + zsw
            b2[r, z] = int(mm[0][1])
    mb = coeffs[("b", 0)]
    for nxy, z, nsw, zsw in ops.pair_b:
        r, rs = prow_of[nxy], prow_of[nsw]
        b2[r, z], b3[r, z] = int(mb[0][0]), int(mb[0][1])
        perm_u[r, z] = rs * ssc + zsw
        b2[rs, zsw], b3[rs, zsw] = int(mb[1][1]), int(mb[1][0])
        perm_u[rs, zsw] = r * ssc + z

    tables = {
        "kk": kk, "ssc": ssc, "k": k, "m": m, "dmat": dmat,
        "t_a1": _varmul_tables(a1.reshape(-1, 1)),
        "t_a2": _varmul_tables(a2.reshape(-1, 1)),
        "t_b1": _varmul_tables(b1.reshape(-1, 1)),
        "t_b2": _varmul_tables(b2.reshape(-1, 1)),
        "t_b3": _varmul_tables(b3.reshape(-1, 1)),
        "perm": perm.reshape(-1), "perm_c": perm_c.reshape(-1),
        "perm_u": perm_u.reshape(-1), "src": src,
        "a1": a1.reshape(-1), "a2": a2.reshape(-1),
        "b1": b1.reshape(-1), "b2": b2.reshape(-1),
        "b3": b3.reshape(-1),
    }
    if tables_only:
        return _Tables(tables)
    virt = src < 0

    def encode_fast(c_data: torch.Tensor) -> torch.Tensor:
        dev = c_data.device
        L = c_data.shape[-1]
        # embed the k data chunks into the kk intact rows (virtual node
        # rows are zero)
        padded = c_data[_index(np.maximum(src, 0), dev)]
        padded[torch.from_numpy(virt).to(dev)] = 0
        flat = padded.reshape(kk * ssc, L)
        u_d = _varmul(flat[:, None, :], tables["t_a1"]) ^ \
            _varmul(flat[_index(perm.reshape(-1), dev)][:, None, :],
                    tables["t_a2"])
        u_p = gf_torch.matvec(dmat, u_d.reshape(kk, ssc * L))
        flat_u = u_p.reshape(m * ssc, L)
        out = _varmul(flat[_index(perm_c.reshape(-1), dev)][:, None, :],
                      tables["t_b1"]) ^ \
            _varmul(flat_u[:, None, :], tables["t_b2"]) ^ \
            _varmul(flat_u[_index(perm_u.reshape(-1), dev)][:, None, :],
                    tables["t_b3"])
        return out.reshape(m, ssc, L)

    encode_fast.tables = tables
    return encode_fast


def build_encode_fused(codec):
    """The three structured-encode stages composed in one function, with
    the plane-wise MDS product done inline as a bit-sliced matrix product
    (the reference's single-XLA-program form, which it records as a
    negative result: outside a kernel the gathers and the bit planes
    materialize). No daemon path calls it; kernel B3 is the encode.

    Stage 2 is ONE ``torch.matmul`` of the 0/1 bit-matrix ``[8m, 8kk]``
    by the data's bit planes ``[8kk, ssc*L]``, in float32 (CUDA has no
    int8 matmul; every sum is at most 8*kk, exact in float32), then
    ``& 1`` and the planes repacked into bytes. Any L, no padding.

    Returns ``[k, ssc, L] uint8 tensor -> [m, ssc, L]`` on the input's
    device."""
    tb = build_encode_fast(codec, tables_only=True).tables
    kk, ssc, m = tb["kk"], tb["ssc"], tb["m"]
    bmat = torch.from_numpy(
        bitmatrix.expand_bitmatrix(tb["dmat"]).astype(np.float32))
    src, virt = np.maximum(tb["src"], 0), tb["src"] < 0

    def encode(c_data: torch.Tensor) -> torch.Tensor:
        dev = c_data.device
        L = c_data.shape[-1]
        padded = c_data[_index(src, dev)]
        padded[torch.from_numpy(virt).to(dev)] = 0
        flat = padded.reshape(kk * ssc, L)
        u_d = _varmul(flat[:, None, :], tb["t_a1"]) ^ \
            _varmul(flat[_index(tb["perm"], dev)][:, None, :], tb["t_a2"])
        shifts = torch.arange(8, dtype=torch.uint8, device=dev)
        # bit plane 8j+c = bit c of row j, as expand_bitmatrix orders them
        dbits = ((u_d.reshape(kk, 1, ssc * L) >> shifts[None, :, None])
                 & 1).reshape(8 * kk, ssc * L).to(torch.float32)
        acc = torch.matmul(bmat.to(dev), dbits)
        pbits = (acc.to(torch.int32) & 1).to(torch.uint8).reshape(
            m, 8, ssc * L)
        u_p = (pbits << shifts[None, :, None]).sum(
            dim=1, dtype=torch.int32).to(torch.uint8)
        flat_u = u_p.reshape(m * ssc, L)
        out = _varmul(flat[_index(tb["perm_c"], dev)][:, None, :],
                      tb["t_b1"]) ^ \
            _varmul(flat_u[:, None, :], tb["t_b2"]) ^ \
            _varmul(flat_u[_index(tb["perm_u"], dev)][:, None, :],
                    tb["t_b3"])
        return out.reshape(m, ssc, L)

    encode.tables = tb
    return encode


def encode_kernel_arrays(tb: dict) -> dict:
    """build_encode_fast's tables as kernel B3 reads them: input rows
    (data chunk i, plane z) -> i*ssc + z, or -1 where the value is zero
    (a virtual node, or a coefficient of 0)."""
    kk, ssc, m = tb["kk"], tb["ssc"], tb["m"]
    src = tb["src"]

    def in_row(intact_flat: np.ndarray) -> np.ndarray:
        j2, z = np.divmod(intact_flat.astype(np.int64), ssc)
        return np.where(src[j2] >= 0, src[j2] * ssc + z, -1)

    flat = np.arange(kk * ssc)
    return {
        "kk": kk, "ssc": ssc, "k": tb["k"], "m": m,
        "ps_row": in_row(flat).astype(np.int32),
        "pa_row": np.where(tb["a2"] != 0, in_row(tb["perm"]),
                           -1).astype(np.int32),
        "a1": tb["a1"], "a2": tb["a2"],
        "dmat": np.ascontiguousarray(tb["dmat"], dtype=np.uint8),
        "pc_row": np.where(tb["b1"] != 0, in_row(tb["perm_c"]),
                           -1).astype(np.int32),
        "pu": tb["perm_u"].astype(np.int32),
        "b1": tb["b1"], "b2": tb["b2"], "b3": tb["b3"],
    }


def build_encode_kernel(codec):
    """Kernel B3: the whole structured encode chain (uncouple, plane-wise
    MDS, recouple) of a lane tile in ONE launch (csrc/clay_encode.cu).

    Returns ``[k, ssc, L] uint8 tensor -> [m, ssc, L]``, any L: the
    kernel for a CUDA tensor, :func:`build_encode_fast` (the plain
    version) for a CPU tensor. Each call is span ``clay.encode``; the
    tables' build is the set-up phase ``b3_tables``."""
    t0 = time.perf_counter()
    fast = build_encode_fast(codec)
    kern = clay_cuda.EncodeKernel(encode_kernel_arrays(fast.tables))
    telemetry().note_setup("b3_tables", time.perf_counter() - t0)

    def encode(c_data: torch.Tensor) -> torch.Tensor:
        with _SPAN_ENCODE():
            if not c_data.is_cuda:
                return fast(c_data)
            return kern(c_data)

    encode.tables = fast.tables
    encode.plain = fast
    return encode


def build_decode_tables(codec, erased: frozenset[int]) -> dict:
    """Global (level-independent) slot tables + per-level masks for
    the layered DECODE chain (decode_layered,
    src/erasure-code/clay/ErasureCodeClay.cc:644-709).

    The per-slot coefficient and partner assignments are GEOMETRIC —
    fixed by (slot, erased signature), independent of the score level;
    only WHICH slots update varies by level. So one set of global tables
    + one mask per level expresses the whole multi-level chain. Overlap
    consistency is asserted while merging."""
    levels = trace_layered(codec, erased)
    coeffs = pft_coefficients(codec)
    qt = codec.q * codec.t
    ssc = codec.sub_chunk_no

    a1 = np.zeros((qt, ssc), dtype=np.uint8)
    a2 = np.zeros((qt, ssc), dtype=np.uint8)
    pn = np.tile(np.arange(qt, dtype=np.int32)[:, None], (1, ssc))
    pz = np.tile(np.arange(ssc, dtype=np.int32)[None, :], (qt, 1))
    b1 = np.zeros((qt, ssc), dtype=np.uint8)
    b2 = np.zeros((qt, ssc), dtype=np.uint8)
    b3 = np.zeros((qt, ssc), dtype=np.uint8)
    p2n = np.tile(np.arange(qt, dtype=np.int32)[:, None], (1, ssc))
    p2z = np.tile(np.arange(ssc, dtype=np.int32)[None, :], (qt, 1))
    seen_u = np.zeros((qt, ssc), dtype=bool)
    seen_c = np.zeros((qt, ssc), dtype=bool)
    masks_u, masks_c, level_planes = [], [], []

    def put_u(n, z, v1, v2, tn, tz):
        if seen_u[n, z]:
            assert (a1[n, z], a2[n, z], pn[n, z], pz[n, z]) == \
                (v1, v2, tn, tz), "level-dependent U slot"
        seen_u[n, z] = True
        a1[n, z], a2[n, z] = v1, v2
        pn[n, z], pz[n, z] = tn, tz

    def put_c(n, z, v1, v2, v3, tn, tz):
        if seen_c[n, z]:
            assert (b1[n, z], b2[n, z], b3[n, z], p2n[n, z],
                    p2z[n, z]) == (v1, v2, v3, tn, tz), \
                "level-dependent C slot"
        seen_c[n, z] = True
        b1[n, z], b2[n, z], b3[n, z] = v1, v2, v3
        p2n[n, z], p2z[n, z] = tn, tz

    for ops in levels:
        mu = np.zeros((qt, ssc), dtype=bool)
        mc = np.zeros((qt, ssc), dtype=bool)
        for n, z in ops.ident:
            put_u(n, z, 1, 0, n, z)
            mu[n, z] = True
        for v, lst in ops.pair_a.items():
            mm = coeffs[("a", v)]
            for nxy, z, nsw, zsw in lst:
                put_u(nxy, z, int(mm[0][0]), int(mm[0][1]), nsw, zsw)
                mu[nxy, z] = True
                put_u(nsw, zsw, int(mm[1][1]), int(mm[1][0]), nxy, z)
                mu[nsw, zsw] = True
        for n, z in ops.ident2:
            put_c(n, z, 0, 1, 0, n, z)
            mc[n, z] = True
        for v, lst in ops.type_c.items():
            mm = coeffs[("c", v)]
            for nxy, z, nsw, zsw in lst:
                put_c(nxy, z, int(mm[0][0]), int(mm[0][1]), 0,
                      nsw, zsw)
                mc[nxy, z] = True
        mb = coeffs[("b", 0)]
        for nxy, z, nsw, zsw in ops.pair_b:
            put_c(nxy, z, 0, int(mb[0][0]), int(mb[0][1]), nsw, zsw)
            mc[nxy, z] = True
            put_c(nsw, zsw, 0, int(mb[1][1]), int(mb[1][0]), nxy, z)
            mc[nsw, zsw] = True
        masks_u.append(mu)
        masks_c.append(mc)
        level_planes.append(list(ops.planes))
    return {
        "a1": a1, "a2": a2, "pn": pn, "pz": pz,
        "b1": b1, "b2": b2, "b3": b3, "p2n": p2n, "p2z": p2z,
        "masks_u": masks_u, "masks_c": masks_c,
        "planes": level_planes,
    }


def transform_kernel_arrays(codec, erased: frozenset[int]) -> dict:
    """build_decode_tables as kernel B4 reads them: node-major state rows
    r = n*ssc + z, global coefficient/partner tables, and per level the
    CSR lists of U rows to update, MDS planes and C rows to update."""
    tb = build_decode_tables(codec, erased)
    qt, ssc = codec.q * codec.t, codec.sub_chunk_no
    er = sorted(erased)
    intact = [i for i in range(qt) if i not in erased]
    n_levels = len(tb["masks_u"])
    b1 = tb["b1"].reshape(-1)
    p2 = (tb["p2n"] * ssc + tb["p2z"]).reshape(-1).astype(np.int32)

    def csr(lists):
        off = np.cumsum([0] + [len(x) for x in lists]).astype(np.int32)
        flat = np.concatenate([np.asarray(x, dtype=np.int32)
                               for x in lists]) if off[-1] else \
            np.zeros(0, dtype=np.int32)
        return off, flat

    u_lists = [np.flatnonzero(mu.reshape(-1)) for mu in tb["masks_u"]]
    c_lists = [np.flatnonzero(mc.reshape(-1)) for mc in tb["masks_c"]]
    for rows in c_lists:
        # phase 2 updates C in place: a row it reads C from (b1 != 0)
        # must not be one it writes in the same level
        reads = p2[rows][b1[rows] != 0]
        assert not np.isin(reads, rows).any(), "phase-2 read/write overlap"
    u_off, u_rows = csr(u_lists)
    c_off, c_rows = csr(c_lists)
    p_off, planes = csr(tb["planes"])
    load = np.zeros(qt, dtype=np.uint8)
    load[intact] = 1
    return {
        "qt": qt, "ssc": ssc, "kk": len(intact), "e": len(er),
        "n_levels": n_levels,
        "a1": tb["a1"].reshape(-1), "a2": tb["a2"].reshape(-1),
        "pair": (tb["pn"] * ssc + tb["pz"]).reshape(-1).astype(np.int32),
        "b1": b1, "b2": tb["b2"].reshape(-1), "b3": tb["b3"].reshape(-1),
        "p2": p2,
        "u_off": u_off, "u_rows": u_rows, "p_off": p_off,
        "planes": planes, "c_off": c_off, "c_rows": c_rows,
        "intact": np.asarray(intact, dtype=np.int32),
        "er": np.asarray(er, dtype=np.int32),
        "dmat": np.ascontiguousarray(
            _mds_decode_matrix(codec, intact, er), dtype=np.uint8),
        "load": load,
    }


def build_transform_kernel(codec, erased: frozenset[int]):
    """Kernel B4: the WHOLE multi-level layered decode of a lane tile in
    ONE launch (csrc/clay_transform.cu) — the decode counterpart of
    :func:`build_encode_kernel`, matching decode_layered
    (ErasureCodeClay.cc:644-709).

    Returns ``[qt, ssc, L] uint8 tensor (erased rows zero) ->
    [e, ssc, L]``: the recovered C of sorted(erased). ``erased`` must be
    the PADDED node-id set (|erased| == m the way _decode_layered pads
    it). The kernel for a CUDA tensor; :func:`build_transform` (the plain
    version) for a CPU tensor."""
    plain = build_transform(codec, erased)
    kern = clay_cuda.TransformKernel(transform_kernel_arrays(codec, erased))
    er = sorted(erased)

    def transform(c_full: torch.Tensor) -> torch.Tensor:
        if not c_full.is_cuda:
            return plain(c_full)[_index(er, c_full.device)]
        return kern(c_full)

    transform.erased = er
    transform.plain = plain
    return transform


def _vartabs_of(coef: np.ndarray):
    """(bits tuple, stacked [rows, P] int32 table) — the varying-constant
    multiply decomposition as one stacked table."""
    tabs = _varmul_tables(coef.reshape(-1, 1))
    if not tabs:
        return (), np.zeros((coef.size, 1), dtype=np.int32)
    bits = tuple(b for b, _ in tabs)
    stacked = np.stack([t.reshape(-1) for _, t in tabs],
                       axis=1).astype(np.int32)
    return bits, stacked


def _best_of(fn, sample: torch.Tensor, reps: int = 3) -> float:
    """Fastest of ``reps`` timed calls, seconds, by CUDA events (one
    untimed warm-up call builds the kernel)."""
    fn(sample)
    torch.cuda.synchronize(sample.device)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(sample)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def build_decode_matvec(codec, mat: np.ndarray, label: str = "decode"):
    """Pick block-sparse (kernel B5) vs dense for a linearized signature
    matrix, BY MEASUREMENT on the card.

    The dense product is the ``cuda`` backend's (ops/backend.py: kernel
    B1 where the matrix fits it, else the counted bit-sliced product).
    The plan's static cost model gates obviously-dense matrices; when it
    predicts a win, both run a short best-of-3 sample on the card and the
    faster one is kept. That is a policy, not a fallback: a failed build
    or launch of either raises.

    ``CEPH_TPU_CLAY_SPARSE``: ``never``/``0`` forces dense,
    ``always``/``1`` forces sparse, default measures (on a CUDA codec
    only: CPU tensors run the plain versions, whose times mean nothing
    for the card, so a CPU codec stays dense).

    Returns ``fn(x [k, N] uint8 tensor) -> [m, N]`` with ``fn.path`` in
    {"sparse", "dense"} and ``fn.measured`` carrying the calibration
    numbers, which the device telemetry also records (``calibrations``,
    as the reference's does, with the calibration's ``seconds``, also the
    set-up phase ``calibration``). Each call of ``fn`` is span
    ``clay.<label>_product`` with its ``route``."""
    mat = np.asarray(mat, dtype=np.uint8)
    sig = (f"[{mat.shape[0]}x{mat.shape[1]}]"
           f"#{zlib.crc32(mat.tobytes()):08x}")
    span = _CLAY.span(f"{label}_product")

    def dense_fn(x):
        return backend_mod.matvec(mat, x, "cuda")

    def sparse_fn(x):
        return gf_block_sparse.matvec_device(mat, x)

    def done(fn, path, measured=None):
        route = {"route": path}

        def product(x):
            with span(route):
                return fn(x)

        product.path = path
        product.measured = measured or {}
        if measured:
            telemetry().note_calibration(label, sig, path, measured)
        return product

    mode = os.environ.get("CEPH_TPU_CLAY_SPARSE", "auto").lower()
    if mode in ("0", "never", "off"):
        return done(dense_fn, "dense")
    if mode in ("1", "always", "force"):
        return done(sparse_fn, "sparse")
    plan = gf_block_sparse.plan_for(mat)
    if not plan.worthwhile or codec.device.type != "cuda":
        return done(dense_fn, "dense",
                    {"cost_frac": plan.cost_frac, "skipped": True})
    t0 = time.perf_counter()
    sample = torch.zeros((mat.shape[1], 1 << 15), dtype=torch.uint8,
                         device=codec.device)
    t_dense = _best_of(dense_fn, sample)
    t_sparse = _best_of(sparse_fn, sample)
    seconds = time.perf_counter() - t0
    telemetry().note_setup("calibration", seconds)
    measured = {"cost_frac": round(plan.cost_frac, 4),
                "dense_s": t_dense, "sparse_s": t_sparse,
                "label": label, "seconds": seconds}
    if t_sparse < t_dense:
        return done(sparse_fn, "sparse", measured)
    return done(dense_fn, "dense", measured)


class ClayDeviceCodec:
    """Per-codec cache of layered transforms (the plain B4 form), keyed
    by the padded erased-node signature (bounded: C(k+m, m) signatures
    exist)."""

    def __init__(self, codec) -> None:
        self.codec = codec
        self._fns: BoundedLRU = BoundedLRU(64, "clay.transforms")

    def transform(self, erased: frozenset[int], c_in) -> torch.Tensor:
        """c_in: [q*t, ssc, L] uint8 (numpy or tensor); returns the
        completed node array on c_in's device (the codec's for numpy)."""
        fn = self._fns.get_or_build(
            erased, lambda: build_transform(self.codec, erased))
        if isinstance(c_in, np.ndarray):
            c_in = torch.from_numpy(
                np.ascontiguousarray(c_in, dtype=np.uint8)).to(
                    self.codec.device)
        return fn(c_in)
