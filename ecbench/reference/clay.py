"""Plain Clay encoder (coupled-layer MSR code) for the benchmark's reference.

A frozen, plain form of Ceph's Clay encode (src/erasure-code/clay/
ErasureCodeClay.cc: encode is ``decode_layered`` with the parity nodes
erased). Parameters k, m, d: q = d - k + 1, nu virtual zero nodes pad
k + m to a multiple of q, t = (k + m + nu) / q, and a chunk holds
ssc = q^t sub-chunks. Node (x, y) = y * q + x; plane z has the base-q digit
vector zv (most significant first).

Two inner codes, both systematic Reed-Solomon over GF(2^8) built as this
repository's jerasure ``reed_sol_van`` builds them (``vandermonde_coding``):
the scalar MDS code over the q * t nodes' uncoupled values of a plane
(k + nu data), and the pairwise transform (pft), a k=2, m=2 code whose four
slots are (C of the higher-x member, C of the lower, U of each).

Everything is GF(2^8)-linear and acts byte position by byte position, so
whole lane vectors [L] are carried through each step; one encode is some
thousands of vector operations, whatever L is.
"""

from __future__ import annotations

import numpy as np
import torch

from ecbench.reference import gf256


def vandermonde_coding(k: int, m: int) -> np.ndarray:
    """m x k coding rows: V[i, j] = i^j over the k + m points 0..k+m-1
    (0^0 = 1), reduced by column operations until its top k x k block is
    the identity."""
    n = k + m
    v = np.array([[gf256.power(i, j) for j in range(k)] for i in range(n)],
                 dtype=np.int64)
    for i in range(k):
        if v[i, i] == 0:
            j = next(j for j in range(i + 1, k) if v[i, j])
            v[:, [i, j]] = v[:, [j, i]]
        s = gf256.inverse(int(v[i, i]))
        v[:, i] = [gf256.mul(s, int(e)) for e in v[:, i]]
        for j in range(k):
            f = int(v[i, j])
            if j != i and f:
                v[:, j] = [int(a) ^ gf256.mul(f, int(b))
                           for a, b in zip(v[:, j], v[:, i])]
    if not np.array_equal(v[:k], np.eye(k, dtype=np.int64)):
        raise ArithmeticError("vandermonde reduction did not reach identity")
    return v[k:].astype(np.uint8)


class ClayCode:
    def __init__(self, k: int, m: int, d: int, device) -> None:
        if not k <= d <= k + m - 1:
            raise ValueError(f"d={d} outside [{k}, {k + m - 1}]")
        self.k, self.m, self.d = k, m, d
        self.q = d - k + 1
        self.nu = (self.q - (k + m) % self.q) % self.q
        self.t = (k + m + self.nu) // self.q
        self.ssc = self.q ** self.t
        self.field = gf256.Field(device)
        self.mds = vandermonde_coding(k + self.nu, m)
        pft = vandermonde_coding(2, 2)
        #: the pft's 4 x 2 generator: slots 0, 1 data, 2, 3 parity
        self.pft_gen = np.concatenate([np.eye(2, dtype=np.uint8), pft])
        self._pft_solvers: dict[tuple, np.ndarray] = {}

    def plane_vector(self, z: int) -> list[int]:
        zv = [0] * self.t
        for i in range(self.t):
            zv[self.t - 1 - i] = z % self.q
            z //= self.q
        return zv

    def _pft(self, want: list[int], known: dict[int, torch.Tensor]):
        """Solve the pft codeword for slots ``want`` from two known slots."""
        slots = tuple(sorted(known))
        key = (slots, tuple(want))
        if key not in self._pft_solvers:
            inv = gf256.mat_inverse(self.pft_gen[list(slots)])
            self._pft_solvers[key] = np.array(
                [[gf256.mul(int(self.pft_gen[w, 0]), int(inv[0, j]))
                  ^ gf256.mul(int(self.pft_gen[w, 1]), int(inv[1, j]))
                  for j in range(2)] for w in want], dtype=np.uint8)
        out = self.field.matvec(self._pft_solvers[key],
                                torch.stack([known[s] for s in slots]))
        return dict(zip(want, out))

    @staticmethod
    def _slots(x: int, zy: int) -> tuple[int, int, int, int]:
        """(own C, partner C, own U, partner U): the higher-x member of a
        coupled pair takes slot 0."""
        return (1, 0, 3, 2) if zy > x else (0, 1, 2, 3)

    def _z_sw(self, z: int, x: int, zy: int, y: int) -> int:
        return z + (x - zy) * self.q ** (self.t - 1 - y)

    def encode(self, data: torch.Tensor) -> torch.Tensor:
        """[k, ssc, L] uint8 data chunks -> [m, ssc, L] parity chunks."""
        k, q, t, ssc, nu = self.k, self.q, self.t, self.ssc, self.nu
        if data.shape[:2] != (k, ssc):
            raise ValueError(f"data must be [{k}, {ssc}, L], got "
                             f"{tuple(data.shape)}")
        n = q * t
        c = torch.zeros((n, ssc, data.shape[2]), dtype=torch.uint8,
                        device=data.device)
        c[:k] = data
        u = torch.zeros_like(c)
        erased = set(range(k + nu, n))
        zvs = [self.plane_vector(z) for z in range(ssc)]
        score = [sum(1 for i in erased if i % q == zv[i // q]) for zv in zvs]
        for s in range(max(score) + 1):
            planes = [z for z in range(ssc) if score[z] == s]
            for z in planes:
                zv = zvs[z]
                for y in range(t):
                    for x in range(q):
                        xy, sw = q * y + x, q * y + zv[y]
                        if xy in erased:
                            continue
                        if zv[y] == x:
                            u[xy, z] = c[xy, z]
                        elif zv[y] < x or sw in erased:
                            zs = self._z_sw(z, x, zv[y], y)
                            i0, i1, i2, i3 = self._slots(x, zv[y])
                            out = self._pft([i2, i3],
                                            {i0: c[xy, z], i1: c[sw, zs]})
                            u[xy, z], u[sw, zs] = out[i2], out[i3]
                u[k + nu:, z] = self.field.matvec(self.mds, u[:k + nu, z])
            for z in planes:
                zv = zvs[z]
                for xy in sorted(erased):
                    x, y = xy % q, xy // q
                    sw = q * y + zv[y]
                    zs = self._z_sw(z, x, zv[y], y)
                    i0, i1, i2, i3 = self._slots(x, zv[y])
                    if zv[y] == x:
                        c[xy, z] = u[xy, z]
                    elif sw not in erased:
                        c[xy, z] = self._pft(
                            [i0], {i1: c[sw, zs], i2: u[xy, z]})[i0]
                    elif zv[y] < x:
                        out = self._pft([0, 1], {2: u[xy, z], 3: u[sw, zs]})
                        c[xy, z], c[sw, zs] = out[0], out[1]
        return c[k + nu:]
