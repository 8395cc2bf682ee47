"""Clay codes — Coupled-LAYer MSR codes (repair-bandwidth optimal).

Port of ``ceph_tpu/models/clay.py``. Reference:
src/erasure-code/clay/ErasureCodeClay.{h,cc} (FAST'18 "Clay Codes:
Moulding MDS Codes to Yield Vector Codes"). Parameters k, m, d in
[k, k+m-1] (default k+m-1); q = d-k+1, nu pads (k+m) to a multiple of q
with virtual zero chunks, t = (k+m+nu)/q, and every chunk is an *array* of
``sub_chunk_no = q^t`` sub-chunks (ErasureCodeClay.cc:295).

Geometry: nodes live on a q x t grid (node = y*q + x); a sub-chunk is
addressed by a plane vector z in [q]^t. Node (x,y) at plane z is *coupled*
with node (z_y, y) at the companion plane z(y->x): the pair's coupled
values (C) and uncoupled values (U) form one codeword of a fixed k=2,m=2
scalar MDS code (the "pft"); slot order is canonical with the higher-x
member first. For each plane, the U values across all q*t nodes form a
codeword of the scalar MDS code with k+nu data chunks (the "mds", default
jerasure reed_sol_van; ScalarMDS composition, ErasureCodeClay.h:35-40).
Both inner codecs are pinned to the host (``device="cpu"``, ``numpy``):
the plane machinery issues thousands of tiny per-sub-chunk solves.

Encode = decode_layered with the m parity nodes erased
(ErasureCodeClay.cc:128-157). decode_layered processes planes in
"intersection score" order, converting helpers C->U, MDS-decoding each
plane's erased U, then U->C for the erased nodes (ErasureCodeClay.cc:
644-709). Single-node repair reads only sub_chunk_no/q sub-chunks from each
of d helpers (ErasureCodeClay.cc:394-644), surfaced through
``minimum_to_decode`` as (offset, count) sub-chunk ranges.

Device execution. For a fixed erasure signature the layered machinery is
ONE flat GF(2^8) matrix applied byte position by byte position: encode
``[m*ssc, k*ssc]``, decode ``[e*ssc, a*ssc]``, repair ``[ssc, d*ssc/q]``
(ssc = sub_chunk_no), probed out of the host path once and LRU-cached per
signature. Routing by backend (``cuda`` plays the reference's ``pallas``):

============  =================  ================================  =====================
backend       encode             decode                            repair
============  =================  ================================  =====================
``cuda``      kernel B3          B4 if ``decode_kernel=true``;     calibrated B5 vs dense
                                 else calibrated B5 vs dense
``torch``     B3's plain form    dense bit-sliced product          dense
``numpy``     host matrix        host matrix                       host matrix
============  =================  ================================  =====================

``CEPH_TPU_CLAY_SPARSE`` (``always``/``never``) overrides the calibration
(models/clay_device.py ``build_decode_matvec``). A failed kernel build or
launch raises: the reference's catch-and-fall-back paths are not ported.
The host plane machinery remains the oracle.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ceph_tpu_torch.models.base import SIMD_ALIGN, ErasureCode
from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.models.registry import PLUGIN_VERSION, ErasureCodePlugin
from ceph_tpu_torch.ops import backend as backend_mod
from ceph_tpu_torch.utils.lru import BoundedLRU

__erasure_code_version__ = PLUGIN_VERSION


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


class ErasureCodeClay(ErasureCode):
    DEFAULT_K, DEFAULT_M = 4, 2

    #: linearized-transform cache bound (decode signatures are C(k+m, <=m);
    #: same role/sizing idea as the ISA decode-table LRU, isa/README:57-62)
    LIN_CACHE_SIZE = 64

    def __init__(self, device="cuda") -> None:
        super().__init__(device)
        self._k = self._m = self.d = 0
        self.q = self.t = self.nu = 0
        self.sub_chunk_no = 1
        self.mds = None   # scalar MDS over q*t nodes (k+nu data)
        self.pft = None   # pairwise transform: k=2, m=2 codec
        self.backend = "auto"
        self.linearize = True
        self.decode_kernel = False
        self.sparse_lin = True
        self._enc_fn = None
        self._lin_cache: BoundedLRU = BoundedLRU(self.LIN_CACHE_SIZE)

    # -- profile -----------------------------------------------------------

    def init(self, profile):
        from ceph_tpu_torch.models.registry import instance
        profile = dict(profile)
        k = self.to_int("k", profile, self.DEFAULT_K)
        m = self.to_int("m", profile, self.DEFAULT_M)
        d = self.to_int("d", profile, k + m - 1)
        if k < 2:
            raise ErasureCodeError(f"clay: k={k} must be >= 2")
        if m < 1:
            raise ErasureCodeError(f"clay: m={m} must be >= 1")
        if not (k <= d <= k + m - 1):
            raise ErasureCodeError(
                f"clay: d={d} must be within [{k}, {k + m - 1}]")
        scalar_mds = profile.get("scalar_mds", "jerasure")
        if scalar_mds not in ("jerasure", "isa", "shec"):
            raise ErasureCodeError(
                f"clay: scalar_mds={scalar_mds!r} must be jerasure|isa|shec")
        technique = profile.get("technique",
                                "single" if scalar_mds == "shec"
                                else "reed_sol_van")
        backend = str(profile.get("backend", "auto"))
        try:
            self._resolved = (backend,
                              backend_mod.resolve_name(backend, self.device))
        except KeyError as exc:
            raise ErasureCodeError(str(exc)) from exc
        self._k, self._m, self.d = k, m, d
        self.q = d - k + 1
        self.nu = (self.q - (k + m) % self.q) % self.q
        if k + m + self.nu > 254:
            raise ErasureCodeError("clay: k+m+nu must be <= 254")
        self.t = (k + m + self.nu) // self.q
        self.sub_chunk_no = self.q ** self.t

        self.backend = backend
        self.linearize = self.to_bool("linearize", profile, True)
        #: opt-in: route decode_chunks through the structured decode
        #: (kernel B4 on cuda) instead of the linearized matrix
        self.decode_kernel = self.to_bool("decode_kernel", profile, False)
        #: let the block-sparse kernel B5 take a signature's matvec when
        #: it MEASURES faster than the dense product on the card
        #: (clay_device.build_decode_matvec)
        self.sparse_lin = self.to_bool("sparse_lin", profile, True)
        self._lin_cache.clear()
        self._enc_fn = None
        # the plane machinery issues thousands of tiny per-sub-chunk
        # solves: the inner codecs stay on the host whatever the hot
        # path's device
        mds_profile = {"technique": technique, "k": str(k + self.nu),
                       "m": str(m), "backend": "numpy"}
        pft_profile = {"technique": technique, "k": "2", "m": "2",
                       "backend": "numpy"}
        if scalar_mds == "shec":
            mds_profile["c"] = pft_profile["c"] = "2"
        self.mds = instance().factory(scalar_mds, mds_profile, device="cpu")
        self.pft = instance().factory(scalar_mds, pft_profile, device="cpu")
        profile.setdefault("plugin", "clay")
        profile["d"] = str(d)
        profile["scalar_mds"] = scalar_mds
        profile["technique"] = technique
        self._profile = profile

    @property
    def resolved_backend(self) -> str:
        """``backend`` resolved when it was set: ``auto`` reads the
        ``erasure_code_backend`` option then, not on every flush."""
        if self._resolved[0] != self.backend:
            self._resolved = (self.backend, backend_mod.resolve_name(
                self.backend, self.device))
        return self._resolved[1]

    # -- geometry ----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self._k + self._m

    def get_data_chunk_count(self) -> int:
        return self._k

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_chunk_size(self, stripe_width: int) -> int:
        unit = _lcm(SIMD_ALIGN, self.sub_chunk_no)
        base = -(-stripe_width // self.k)
        return -(-base // unit) * unit

    def _node_id(self, chunk: int) -> int:
        """External chunk id -> internal node id (parity shifts past the nu
        virtual nodes, ErasureCodeClay.cc:134-140)."""
        return chunk if chunk < self.k else chunk + self.nu

    def _chunk_id(self, node: int) -> int | None:
        if node < self.k:
            return node
        if node < self.k + self.nu:
            return None  # virtual
        return node - self.nu

    def get_plane_vector(self, z: int) -> list[int]:
        zv = [0] * self.t
        for i in range(self.t):
            zv[self.t - 1 - i] = z % self.q
            z //= self.q
        return zv

    # -- pairwise transform helpers ---------------------------------------

    def _pft_solve(self, want: list[int], known: dict[int, np.ndarray]):
        """One pairwise-transform solve: slots 0,1 = coupled pair (higher-x
        member first), slots 2,3 = their uncoupled values."""
        return self.pft.decode_chunks(want, known)

    @staticmethod
    def _slots(x: int, zy: int):
        """Canonical slot order: (own, partner, own_u, partner_u)."""
        if zy > x:
            return 1, 0, 3, 2
        return 0, 1, 2, 3

    # -- encode / decode (full-chunk paths) --------------------------------

    def encode_chunks(self, want_to_encode, chunks):
        if self.linearize:
            return self._encode_chunks_lin(want_to_encode, chunks)
        return self._encode_chunks_host(want_to_encode, chunks)

    def _encode_chunks_host(self, want_to_encode, chunks):
        n = self.k + self.m
        size = len(next(iter(chunks.values())))
        nodes = {}
        for i in range(n):
            node = self._node_id(i)
            if i < self.k:
                nodes[node] = np.array(chunks[i], dtype=np.uint8)
            else:
                nodes[node] = np.zeros(size, dtype=np.uint8)
        for i in range(self.k, self.k + self.nu):
            nodes[i] = np.zeros(size, dtype=np.uint8)
        erased = {self._node_id(i) for i in range(self.k, n)}
        self._decode_layered(erased, nodes, size)
        out = {}
        for pos in want_to_encode:
            if self.k <= pos < n:
                out[pos] = nodes[self._node_id(pos)]
        return out

    def decode(self, want_to_read, chunks, chunk_size):
        avail = set(chunks)
        if self._is_repair(set(want_to_read), avail) and \
                chunk_size > len(next(iter(chunks.values()))):
            return self._repair(list(want_to_read)[0], chunks, chunk_size)
        return super().decode(want_to_read, chunks, chunk_size)

    def decode_chunks(self, want_to_read, chunks):
        if self.linearize:
            return self._decode_chunks_lin(want_to_read, chunks)
        return self._decode_chunks_host(want_to_read, chunks)

    def _decode_chunks_host(self, want_to_read, chunks):
        n = self.k + self.m
        size = len(next(iter(chunks.values())))
        nodes, erased = {}, set()
        for i in range(n):
            node = self._node_id(i)
            if i in chunks:
                nodes[node] = np.array(chunks[i], dtype=np.uint8)
            else:
                nodes[node] = np.zeros(size, dtype=np.uint8)
                erased.add(node)
        for i in range(self.k, self.k + self.nu):
            nodes[i] = np.zeros(size, dtype=np.uint8)
        if len(erased) > self.m:
            raise ErasureCodeError(
                f"clay: {len(erased)} erasures > m={self.m}", errno_=5)
        self._decode_layered(set(erased), nodes, size)
        return {i: nodes[self._node_id(i)] for i in want_to_read}

    # -- the layered decoder (ErasureCodeClay.cc:644-709) ------------------

    def _decode_layered(self, erased: set[int], nodes: dict[int, np.ndarray],
                        size: int) -> None:
        q, t = self.q, self.t
        if size % self.sub_chunk_no:
            raise ErasureCodeError(
                f"clay: chunk size {size} not a multiple of "
                f"{self.sub_chunk_no} sub-chunks")
        sc = size // self.sub_chunk_no
        erased = self._pad_erased(erased)
        u_buf = {i: np.zeros(size, dtype=np.uint8) for i in range(q * t)}

        order = np.zeros(self.sub_chunk_no, dtype=np.int64)
        zvecs = [self.get_plane_vector(z) for z in range(self.sub_chunk_no)]
        for z in range(self.sub_chunk_no):
            zv = zvecs[z]
            order[z] = sum(1 for i in erased if i % q == zv[i // q])
        max_score = int(order.max()) if len(erased) else 0

        def sl(arr, z):
            return arr[z * sc:(z + 1) * sc]

        for score in range(max_score + 1):
            planes = [z for z in range(self.sub_chunk_no) if order[z] == score]
            # phase 1: compute U for intact nodes, then MDS-decode erased U
            for z in planes:
                zv = zvecs[z]
                for y in range(t):
                    for x in range(q):
                        node_xy = q * y + x
                        if node_xy in erased:
                            continue
                        node_sw = q * y + zv[y]
                        if zv[y] == x:
                            sl(u_buf[node_xy], z)[:] = sl(nodes[node_xy], z)
                        elif zv[y] < x or node_sw in erased:
                            self._uncoupled_from_coupled(
                                nodes, u_buf, x, y, z, zv, sc)
                self._decode_uncoupled(erased, z, sc, u_buf)
            # phase 2: convert erased nodes' U back to C
            for z in planes:
                zv = zvecs[z]
                for node_xy in erased:
                    x, y = node_xy % q, node_xy // q
                    node_sw = q * y + zv[y]
                    if zv[y] == x:
                        sl(nodes[node_xy], z)[:] = sl(u_buf[node_xy], z)
                    elif node_sw not in erased:
                        self._recover_type1(nodes, u_buf, x, y, z, zv, sc)
                    elif zv[y] < x:
                        self._coupled_from_uncoupled(
                            nodes, u_buf, x, y, z, zv, sc)

    def _pad_erased(self, erased) -> frozenset:
        """The erased node-id set padded to m with parity nodes, as the
        layered decoder and its device forms take it."""
        erased = set(erased)
        for i in range(self.k + self.nu, self.q * self.t):
            if len(erased) >= self.m:
                break
            erased.add(i)
        return frozenset(erased)

    def _z_sw(self, z: int, x: int, zy: int, y: int) -> int:
        return z + (x - zy) * self.q ** (self.t - 1 - y)

    def _uncoupled_from_coupled(self, nodes, u_buf, x, y, z, zv, sc):
        """(C_xy, C_sw) -> (U_xy, U_sw) (ErasureCodeClay.cc:837-867)."""
        node_xy, node_sw = self.q * y + x, self.q * y + zv[y]
        z_sw = self._z_sw(z, x, zv[y], y)
        i0, i1, i2, i3 = self._slots(x, zv[y])
        known = {i0: nodes[node_xy][z * sc:(z + 1) * sc],
                 i1: nodes[node_sw][z_sw * sc:(z_sw + 1) * sc]}
        out = self._pft_solve([2, 3], known)
        u_buf[node_xy][z * sc:(z + 1) * sc] = out[i2]
        u_buf[node_sw][z_sw * sc:(z_sw + 1) * sc] = out[i3]

    def _coupled_from_uncoupled(self, nodes, u_buf, x, y, z, zv, sc):
        """(U_xy, U_sw) -> (C_xy, C_sw) (ErasureCodeClay.cc:810-835);
        called with zv[y] < x so slot order is fixed."""
        node_xy, node_sw = self.q * y + x, self.q * y + zv[y]
        z_sw = self._z_sw(z, x, zv[y], y)
        known = {2: u_buf[node_xy][z * sc:(z + 1) * sc],
                 3: u_buf[node_sw][z_sw * sc:(z_sw + 1) * sc]}
        out = self._pft_solve([0, 1], known)
        nodes[node_xy][z * sc:(z + 1) * sc] = out[0]
        nodes[node_sw][z_sw * sc:(z_sw + 1) * sc] = out[1]

    def _recover_type1(self, nodes, u_buf, x, y, z, zv, sc):
        """C_xy from (C_sw, U_xy) (ErasureCodeClay.cc:772-808)."""
        node_xy, node_sw = self.q * y + x, self.q * y + zv[y]
        z_sw = self._z_sw(z, x, zv[y], y)
        i0, i1, i2, i3 = self._slots(x, zv[y])
        known = {i1: nodes[node_sw][z_sw * sc:(z_sw + 1) * sc],
                 i2: u_buf[node_xy][z * sc:(z + 1) * sc]}
        out = self._pft_solve([i0], known)
        nodes[node_xy][z * sc:(z + 1) * sc] = out[i0]

    def _decode_uncoupled(self, erased: set[int], z: int, sc: int,
                          u_buf) -> None:
        """MDS-decode the plane's erased uncoupled values
        (ErasureCodeClay.cc:739-757)."""
        known = {i: u_buf[i][z * sc:(z + 1) * sc]
                 for i in range(self.q * self.t) if i not in erased}
        out = self.mds.decode_chunks(sorted(erased), known)
        for i in erased:
            u_buf[i][z * sc:(z + 1) * sc] = out[i]

    # -- repair path (sub-chunk-efficient single failure) ------------------

    def _is_repair(self, want: set[int], avail: set[int]) -> bool:
        """ErasureCodeClay.cc:303-322."""
        if want <= avail or len(want) > 1:
            return False
        lost = self._node_id(next(iter(want)))
        for x in range(self.q):
            node = (lost // self.q) * self.q + x
            chunk = self._chunk_id(node)
            if chunk is not None and chunk not in want and chunk not in avail:
                return False
        return len(avail) >= self.d

    def get_repair_subchunks(self, lost_node: int) -> list[tuple[int, int]]:
        """(offset, count) sub-chunk ranges each helper must read
        (ErasureCodeClay.cc:362-376)."""
        y, x = lost_node // self.q, lost_node % self.q
        seq = self.q ** (self.t - 1 - y)
        return [(x * seq + i * self.q * seq, seq)
                for i in range(self.q ** y)]

    def minimum_to_decode(self, want_to_read, available):
        want, avail = set(want_to_read), set(available)
        if not self._is_repair(want, avail):
            chunks = self._minimum_to_decode_chunks(want_to_read, available)
            return {c: [(0, self.sub_chunk_no)] for c in chunks}
        lost = self._node_id(next(iter(want)))
        ranges = self.get_repair_subchunks(lost)
        minimum = {}
        for x in range(self.q):  # lost node's y-group first
            node = (lost // self.q) * self.q + x
            chunk = self._chunk_id(node)
            if chunk is not None and chunk not in want:
                minimum[chunk] = ranges
        for chunk in sorted(avail):
            if len(minimum) >= self.d:
                break
            minimum.setdefault(chunk, ranges)
        if len(minimum) != self.d:
            raise ErasureCodeError("clay: repair needs d helpers", errno_=5)
        return minimum

    def _repair(self, want_chunk: int, chunks, chunk_size: int):
        if self.linearize:
            return self._repair_lin(want_chunk, chunks, chunk_size)
        return self._repair_host(want_chunk, chunks, chunk_size)

    def _repair_host(self, want_chunk: int, chunks, chunk_size: int):
        """Repair one chunk from d helpers' sub-chunk reads
        (ErasureCodeClay.cc:394-644). Helper buffers hold only the
        repair-plane sub-chunks, concatenated in plane order."""
        q, t = self.q, self.t
        lost = self._node_id(want_chunk)
        repair_subchunks = self.sub_chunk_no // q
        helper_len = len(next(iter(chunks.values())))
        if helper_len % repair_subchunks:
            raise ErasureCodeError("clay: bad helper buffer size")
        sc = helper_len // repair_subchunks
        if chunk_size != self.sub_chunk_no * sc:
            raise ErasureCodeError("clay: chunk_size/helper size mismatch")

        helper, aloof = {}, set()
        for i in range(self.k + self.m):
            node = self._node_id(i)
            if i in chunks:
                helper[node] = np.asarray(chunks[i], dtype=np.uint8)
            elif i != want_chunk:
                aloof.add(node)
        for i in range(self.k, self.k + self.nu):
            helper[i] = np.zeros(helper_len, dtype=np.uint8)
        recovered = np.zeros(chunk_size, dtype=np.uint8)

        # plane ordering by intersection score over {lost} + aloof
        plan = self.get_repair_subchunks(lost)
        repair_planes = [z for off, cnt in plan for z in range(off, off + cnt)]
        plane_to_ind = {z: i for i, z in enumerate(repair_planes)}
        erasures = {(lost // q) * q + x for x in range(q)} | aloof
        if len(erasures) > self.m:
            raise ErasureCodeError(
                f"clay: repair infeasible, {len(erasures)} erasures > m",
                errno_=5)
        u_buf = {i: np.zeros(chunk_size, dtype=np.uint8)
                 for i in range(q * t)}
        scored: dict[int, list[int]] = {}
        for z in repair_planes:
            zv = self.get_plane_vector(z)
            score = sum(1 for node in ({lost} | aloof)
                        if node % q == zv[node // q])
            scored.setdefault(score, []).append(z)

        def hsl(node, z):  # helper sub-chunk (by repair-plane index)
            i = plane_to_ind[z]
            return helper[node][i * sc:(i + 1) * sc]

        for score in sorted(scored):
            for z in scored[score]:
                zv = self.get_plane_vector(z)
                # phase 1: U for intact nodes on this plane
                for y in range(t):
                    for x in range(q):
                        node_xy = q * y + x
                        if node_xy in erasures:
                            continue
                        node_sw = q * y + zv[y]
                        z_sw = self._z_sw(z, x, zv[y], y)
                        i0, i1, i2, i3 = self._slots(x, zv[y])
                        if zv[y] == x:
                            u_buf[node_xy][z * sc:(z + 1) * sc] = \
                                hsl(node_xy, z)
                        elif node_sw in aloof:
                            known = {i0: hsl(node_xy, z),
                                     i3: u_buf[node_sw][z_sw * sc:
                                                        (z_sw + 1) * sc]}
                            out = self._pft_solve([i2], known)
                            u_buf[node_xy][z * sc:(z + 1) * sc] = out[i2]
                        else:
                            known = {i0: hsl(node_xy, z),
                                     i1: hsl(node_sw, z_sw)}
                            out = self._pft_solve([i2], known)
                            u_buf[node_xy][z * sc:(z + 1) * sc] = out[i2]
                self._decode_uncoupled(erasures, z, sc, u_buf)
                # phase 2: recover lost node's C on this plane
                for node in sorted(erasures):
                    x, y = node % q, node // q
                    node_sw = q * y + zv[y]
                    z_sw = self._z_sw(z, x, zv[y], y)
                    i0, i1, i2, i3 = self._slots(x, zv[y])
                    if node in aloof:
                        continue
                    if x == zv[y]:
                        if node == lost:
                            recovered[z * sc:(z + 1) * sc] = \
                                u_buf[node][z * sc:(z + 1) * sc]
                    else:
                        # partner is the lost node: its companion sub-chunk
                        if node_sw != lost or node not in helper:
                            continue
                        known = {i0: hsl(node, z),
                                 i2: u_buf[node][z * sc:(z + 1) * sc]}
                        out = self._pft_solve([i1], known)
                        recovered[z_sw * sc:(z_sw + 1) * sc] = out[i1]
        return {want_chunk: recovered}

    # -- linearized device path (see module docstring) ---------------------
    #
    # Every host path above is GF(2^8)-linear and acts byte-position-wise
    # along the sub-chunk payload: output byte j of any sub-chunk depends
    # only on byte j of input sub-chunks. So one probe call whose sub-chunk
    # payload width equals the input dimension D — with input (chunk i,
    # sub-chunk z) carrying the basis byte-row e_{i*ssc+z} — reads the whole
    # flat transform matrix out of the host oracle in a single pass.

    @staticmethod
    def _probe_basis(ids, rows: int):
        """chunk id -> flat basis payload of ``rows`` sub-chunks, payload
        width D = len(ids)*rows."""
        d_in = len(ids) * rows
        out = {}
        for idx, cid in enumerate(ids):
            buf = np.zeros((rows, d_in), dtype=np.uint8)
            for z in range(rows):
                buf[z, idx * rows + z] = 1
            out[cid] = buf.reshape(-1)
        return out

    @staticmethod
    def _stack(chunks, ids, rows: int, sc: int) -> np.ndarray:
        x = np.empty((len(ids) * rows, sc), dtype=np.uint8)
        for idx, cid in enumerate(ids):
            x[idx * rows:(idx + 1) * rows] = np.asarray(
                chunks[cid], dtype=np.uint8).reshape(rows, sc)
        return x

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """Host bytes onto the device the resolved backend runs on."""
        dev = self.device if self.resolved_backend in \
            backend_mod.DEVICE_BACKENDS else torch.device("cpu")
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def _encode_matrix(self) -> np.ndarray:
        ssc = self.sub_chunk_no
        probe = self._probe_basis(range(self.k), ssc)
        parity = self._encode_chunks_host(
            list(range(self.k, self.k + self.m)), probe)
        d_in = self.k * ssc
        mat = np.empty((self.m * ssc, d_in), dtype=np.uint8)
        for p in range(self.m):
            mat[p * ssc:(p + 1) * ssc] = parity[self.k + p].reshape(ssc, d_in)
        return mat

    def _encode_fn(self):
        """The structured encoder: kernel B3 for a CUDA tensor, its plain
        version for a CPU tensor."""
        if self._enc_fn is None:
            from ceph_tpu_torch.models import clay_device
            self._enc_fn = clay_device.build_encode_kernel(self)
        return self._enc_fn

    def _encode_chunks_lin(self, want_to_encode, chunks):
        ssc = self.sub_chunk_no
        size = len(next(iter(chunks.values())))
        if size % ssc:
            raise ErasureCodeError(
                f"clay: chunk size {size} not a multiple of {ssc} sub-chunks")
        sc = size // ssc
        x = self._stack(chunks, range(self.k), ssc, sc)
        resolved = self.resolved_backend
        if resolved in backend_mod.DEVICE_BACKENDS:
            par = self._encode_fn()(
                self._upload(x).reshape(self.k, ssc, sc)).cpu().numpy()
            return {pos: par[pos - self.k].reshape(-1)
                    for pos in want_to_encode
                    if self.k <= pos < self.k + self.m}
        mat = self._lin_cached(("enc",), self._encode_matrix)
        parity = self._lin_matvec(("enc",), mat, x, resolved, "encode")
        out = {}
        for pos in want_to_encode:
            if self.k <= pos < self.k + self.m:
                p = pos - self.k
                out[pos] = parity[p * ssc:(p + 1) * ssc].reshape(-1)
        return out

    def _lin_cached(self, key, build):
        """get_or_build on the linearized-transform LRU."""
        return self._lin_cache.get_or_build(key, build)

    def _lin_matvec(self, sig_key: tuple, mat: np.ndarray, x: np.ndarray,
                    resolved: str, label: str) -> np.ndarray:
        """One linearized-signature matvec: on ``cuda`` the per-signature
        choice between kernel B5 and the dense product is measured on the
        card once and LRU-cached next to the matrix
        (clay_device.build_decode_matvec); every other backend keeps the
        plain dispatch."""
        xt = self._upload(x)
        if resolved == "cuda" and self.sparse_lin:
            from ceph_tpu_torch.models.clay_device import build_decode_matvec
            fn = self._lin_cached(
                ("sparse",) + sig_key,
                lambda: build_decode_matvec(self, mat, label=label))
            return fn(xt).cpu().numpy()
        return backend_mod.matvec(mat, xt, resolved).cpu().numpy()

    def _decode_matrix(self, avail: tuple, erased: tuple) -> np.ndarray:
        ssc = self.sub_chunk_no
        probe = self._probe_basis(avail, ssc)
        rec = self._decode_chunks_host(list(erased), probe)
        d_in = len(avail) * ssc
        mat = np.empty((len(erased) * ssc, d_in), dtype=np.uint8)
        for row, c in enumerate(erased):
            mat[row * ssc:(row + 1) * ssc] = rec[c].reshape(ssc, d_in)
        return mat

    def _decode_chunks_lin(self, want_to_read, chunks):
        n = self.k + self.m
        ssc = self.sub_chunk_no
        size = len(next(iter(chunks.values())))
        if size % ssc:
            raise ErasureCodeError(
                f"clay: chunk size {size} not a multiple of {ssc} sub-chunks")
        avail = tuple(sorted(c for c in chunks if c < n))
        erased = tuple(c for c in range(n) if c not in chunks)
        if len(erased) > self.m:
            raise ErasureCodeError(
                f"clay: {len(erased)} erasures > m={self.m}", errno_=5)
        out = {c: np.asarray(chunks[c], dtype=np.uint8)
               for c in want_to_read if c in chunks}
        missing = [c for c in want_to_read if c not in chunks]
        if not missing:
            return out
        if self.decode_kernel:
            return self._decode_chunks_kernel(want_to_read, chunks,
                                              out, missing, size)
        mat = self._lin_cached(
            ("dec", avail, erased),
            lambda: self._decode_matrix(avail, erased))
        x = self._stack(chunks, avail, ssc, size // ssc)
        rec = self._lin_matvec(("dec", avail, erased), mat, x,
                               self.resolved_backend, "decode")
        for row, c in enumerate(erased):
            if c in missing:
                out[c] = rec[row * ssc:(row + 1) * ssc].reshape(-1)
        return out

    def _decode_chunks_kernel(self, want_to_read, chunks, out,
                              missing, size):
        """Run the structured decode for this erasure signature (padded
        to m nodes the way _decode_layered pads), cached per signature
        like the ISA decode-table LRU
        (src/erasure-code/isa/ErasureCodeIsa.cc:226-303)."""
        from ceph_tpu_torch.models import clay_device
        n = self.k + self.m
        ssc = self.sub_chunk_no
        sc = size // ssc
        qt = self.q * self.t
        key = self._pad_erased({self._node_id(c) for c in range(n)
                                if c not in chunks})
        fn = self._lin_cached(
            ("ker", key),
            lambda: clay_device.build_transform_kernel(self, key))
        c_full = np.zeros((qt, ssc, sc), dtype=np.uint8)
        for c, buf in chunks.items():
            node = self._node_id(c)
            if node not in key and c < n:
                c_full[node] = np.asarray(
                    buf, dtype=np.uint8).reshape(ssc, sc)
        rec = fn(self._upload(c_full)).cpu().numpy()
        er_sorted = sorted(key)
        for c in missing:
            node = self._node_id(c)
            out[c] = rec[er_sorted.index(node)].reshape(-1)
        return out

    def _repair_matrix(self, want_chunk: int, helpers: tuple) -> np.ndarray:
        rss = self.sub_chunk_no // self.q
        probe = self._probe_basis(helpers, rss)
        d_in = len(helpers) * rss
        rec = self._repair_host(want_chunk, probe, self.sub_chunk_no * d_in)
        return rec[want_chunk].reshape(self.sub_chunk_no, d_in)

    def _repair_lin(self, want_chunk: int, chunks, chunk_size: int):
        rss = self.sub_chunk_no // self.q
        helper_len = len(next(iter(chunks.values())))
        if helper_len % rss:
            raise ErasureCodeError("clay: bad helper buffer size")
        sc = helper_len // rss
        if chunk_size != self.sub_chunk_no * sc:
            raise ErasureCodeError("clay: chunk_size/helper size mismatch")
        helpers = tuple(sorted(chunks))
        mat = self._lin_cached(
            ("rep", want_chunk, helpers),
            lambda: self._repair_matrix(want_chunk, helpers))
        x = self._stack(chunks, helpers, rss, sc)
        rec = self._lin_matvec(("rep", want_chunk, helpers), mat, x,
                               self.resolved_backend, "repair")
        return {want_chunk: rec.reshape(-1)}


class ClayPlugin(ErasureCodePlugin):
    def factory(self, profile, device):
        codec = ErasureCodeClay(device=device)
        codec.init(profile)
        return codec


def __erasure_code_init__(name, registry):
    registry.add(name, ClayPlugin())
