"""jerasure-semantics plugin — port of ``ceph_tpu/models/jerasure.py``.

Reference: src/erasure-code/jerasure/ErasureCodeJerasure.{h,cc} and its
factory switch (ErasureCodePluginJerasure.cc:34-72). Defaults are
technique=reed_sol_van, k=7, m=3, w=8 (ErasureCodeJerasure.h:90-92). Every
technique is a choice of coding matrix over the same matvec:

- ``reed_sol_van``    — systematic Vandermonde RS (gf256.rs_vandermonde_matrix)
- ``reed_sol_r6_op``  — RAID-6 RS: m=2, rows [1,1,..], [1,2,4,..]
- ``cauchy_orig``     — Cauchy matrix 1/(i ^ (m+j))
- ``cauchy_good``     — Cauchy improved so row 0 is all ones and later rows
  minimise the popcount of their bit-matrix expansion
- ``liberation`` / ``blaum_roth`` / ``liber8tion`` — the reference's
  parameter constraints (m=2; liberation: w prime, k<=w; liber8tion: k<=8)
  over the RAID-6 RS generator.

Only w=8 is implemented.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.models.matrix_codec import MatrixErasureCode
from ceph_tpu_torch.models.registry import PLUGIN_VERSION, ErasureCodePlugin
from ceph_tpu_torch.ops import bitmatrix, gf256

__erasure_code_version__ = PLUGIN_VERSION

TECHNIQUES = (
    "reed_sol_van", "reed_sol_r6_op", "cauchy_orig", "cauchy_good",
    "liberation", "blaum_roth", "liber8tion",
)


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    return all(n % i for i in range(2, int(n ** 0.5) + 1))


def reed_sol_r6_matrix(k: int) -> np.ndarray:
    """RAID-6 RS: parity row of ones + row of powers of 2."""
    row0 = np.ones(k, dtype=np.uint8)
    row1 = np.array([gf256.gf_pow(2, j) for j in range(k)], dtype=np.uint8)
    return np.stack([row0, row1])


def improve_cauchy_matrix(mat: np.ndarray) -> np.ndarray:
    """jerasure's ``cauchy_good`` improvement: divide every column j by
    mat[0, j] so row 0 becomes all ones, then for each later row pick the
    divisor that minimises the ones in its bit-matrix expansion."""
    mat = mat.copy()
    m, k = mat.shape
    for j in range(k):
        mat[:, j] = gf256.gf_div(mat[:, j], mat[0, j])
    for i in range(1, m):
        best_row, best_cost = mat[i], _bit_cost(mat[i])
        for d in sorted(set(int(x) for x in mat[i] if x not in (0, 1))):
            cand = gf256.gf_div(mat[i], np.uint8(d))
            cost = _bit_cost(cand)
            if cost < best_cost:
                best_row, best_cost = cand, cost
        mat[i] = best_row
    return mat


def _bit_cost(row: np.ndarray) -> int:
    return int(bitmatrix.expand_bitmatrix(row[None, :]).sum())


class ErasureCodeJerasure(MatrixErasureCode):
    def __init__(self, technique: str = "reed_sol_van",
                 device="cuda") -> None:
        super().__init__(device)
        self.technique = technique
        self.w = 8

    def init(self, profile):
        profile = dict(profile)
        technique = profile.get("technique", self.technique)
        if technique not in TECHNIQUES:
            raise ErasureCodeError(
                f"technique={technique!r} must be one of {TECHNIQUES}")
        k = self.to_int("k", profile, 7)
        m = self.to_int("m", profile, 3)
        w = self.to_int("w", profile, 8)
        if w != 8:
            raise ErasureCodeError(f"w={w}: only w=8 is implemented")
        if k + m > 256:
            raise ErasureCodeError(f"k+m={k + m} > 256 for w=8")

        if technique == "reed_sol_van":
            coding = gf256.rs_vandermonde_matrix(k, m)
        elif technique == "cauchy_orig":
            coding = gf256.cauchy_original_matrix(k, m)
        elif technique == "cauchy_good":
            coding = improve_cauchy_matrix(gf256.cauchy_original_matrix(k, m))
        else:
            if m != 2:
                raise ErasureCodeError(f"{technique} requires m=2")
            if technique == "liberation" and not _is_prime(w) and k > w:
                raise ErasureCodeError("liberation requires w prime and k<=w")
            if technique == "liber8tion" and k > 8:
                raise ErasureCodeError("liber8tion requires k<=w=8")
            coding = reed_sol_r6_matrix(k)
        self.technique = technique
        self.w = w
        profile.setdefault("plugin", "jerasure")
        profile["technique"] = technique
        profile["w"] = str(w)
        self._setup(k, m, coding, profile)


class JerasurePlugin(ErasureCodePlugin):
    def factory(self, profile, device):
        codec = ErasureCodeJerasure(device=device)
        codec.init(profile)
        return codec


def __erasure_code_init__(name, registry):
    registry.add(name, JerasurePlugin())
