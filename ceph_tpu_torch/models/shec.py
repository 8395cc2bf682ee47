"""SHEC — Shingled Erasure Code (locally-repairable layered parity).

Port of ``ceph_tpu/models/shec.py``: a matrix codec whose products run on
its torch ``device`` (kernel B1 on CUDA, ops/backend.py). Reference:
src/erasure-code/shec/ErasureCodeShec.{h,cc} (Fujitsu). Profile k, m, c
with defaults 4,3,2 (ErasureCodeShec.h:50-57). Semantics
reproduced (construction and search re-written, not translated):

- The coding matrix starts from the systematic Vandermonde RS matrix and
  each parity row keeps only a circular "shingle" window of data columns:
  row rr of a layer with (m_l, c_l) covers columns
  [rr*k/m_l, (rr+c_l)*k/m_l) mod k (zeroing loop at
  ErasureCodeShec.cc:505-521). c == m degenerates to plain RS.
- ``technique=multiple`` (default) splits parity into two layers (m1,c1) +
  (m2,c2) chosen by exhaustive search minimizing the recovery-efficiency
  metric (ErasureCodeShec.cc:418-456, 470-500); ``single`` uses one layer.
- Decode searches all parity subsets (2^m, pruned) for the smallest square
  invertible system covering the erased data columns — the combinatorial
  search of shec_make_decoding_matrix (ErasureCodeShec.cc:560-686). SHEC
  is *not* MDS: patterns with no recoverable system raise.
- Decode plans are cached per (want, avail) signature like the reference's
  ErasureCodeShecTableCache.

Local repair property: a single lost chunk is recovered from ~c*k/m data
chunks + 1 parity instead of k chunks — the storage analog of sparse
mixture routing, and the reason SHEC shines for single-failure recovery
bandwidth.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.models.matrix_codec import MatrixErasureCode
from ceph_tpu_torch.models.registry import PLUGIN_VERSION, ErasureCodePlugin
from ceph_tpu_torch.ops import gf256
from ceph_tpu_torch.utils.lru import BoundedLRU

__erasure_code_version__ = PLUGIN_VERSION


def _window_cols(rr: int, k: int, m_l: int, c_l: int) -> set[int]:
    """Columns kept for parity row rr of a layer with m_l rows, overlap c_l:
    circular [rr*k/m_l, (rr+c_l)*k/m_l)."""
    start = (rr * k) // m_l
    end = ((rr + c_l) * k) // m_l
    return {cc % k for cc in range(start, end)}


def _recovery_efficiency(k: int, m1: int, m2: int, c1: int, c2: int) -> float:
    """The r_e1 metric of shec_calc_recovery_efficiency1: average chunks
    read to recover, over parity rows and best-covering window per data
    chunk. Lower is better."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    best_cover = [10 ** 8] * k
    total = 0.0
    for m_l, c_l in ((m1, c1), (m2, c2)):
        for rr in range(m_l):
            width = ((rr + c_l) * k) // m_l - (rr * k) // m_l
            for cc in _window_cols(rr, k, m_l, c_l):
                best_cover[cc] = min(best_cover[cc], width)
            total += width
    total += sum(best_cover)
    return total / (k + m1 + m2)


class ErasureCodeShec(MatrixErasureCode):
    DEFAULT_K, DEFAULT_M, DEFAULT_C = 4, 3, 2

    def __init__(self, device="cuda") -> None:
        super().__init__(device)
        self.c = 0
        self._plan_cache: BoundedLRU = BoundedLRU(1024)

    def init(self, profile):
        profile = dict(profile)
        k = self.to_int("k", profile, self.DEFAULT_K)
        m = self.to_int("m", profile, self.DEFAULT_M)
        c = self.to_int("c", profile, self.DEFAULT_C)
        technique = profile.get("technique", "multiple")
        if technique not in ("single", "multiple"):
            raise ErasureCodeError(
                f"shec technique={technique!r} must be single|multiple")
        w = self.to_int("w", profile, 8)
        if w != 8:
            raise ErasureCodeError("shec: only w=8 is implemented")
        # parameter envelope (reference parse + TestErasureCodeShec_arguments)
        if not (0 < c <= m <= k):
            raise ErasureCodeError(
                f"shec requires 0 < c <= m <= k, got k={k} m={m} c={c}")
        if k + m > 256:
            raise ErasureCodeError(f"k+m={k + m} > 256 for w=8")
        self.c = c
        coding = self._build_matrix(k, m, c, technique)
        profile.setdefault("plugin", "shec")
        profile["technique"] = technique
        profile["c"] = str(c)
        self._setup(k, m, coding, profile)

    # -- construction ------------------------------------------------------

    @staticmethod
    def _layer_split(k: int, m: int, c: int, technique: str):
        """Choose (m1,c1,m2,c2): exhaustive search for 'multiple'
        (ErasureCodeShec.cc:470-500), trivial for 'single'."""
        if technique == "single":
            return 0, 0, m, c
        best, best_r = None, 100.0
        for c1 in range(0, c // 2 + 1):
            for m1 in range(0, m + 1):
                c2, m2 = c - c1, m - m1
                if m1 < c1 or m2 < c2:
                    continue
                if (m1 == 0) != (c1 == 0) or (m2 == 0) != (c2 == 0):
                    continue
                r = _recovery_efficiency(k, m1, m2, c1, c2)
                if r >= 0 and r < best_r - 1e-12:
                    best_r, best = r, (m1, c1, m2, c2)
        if best is None:
            raise ErasureCodeError(
                f"shec: no valid layer split for k={k} m={m} c={c}")
        m1, c1, m2, c2 = best
        return m1, c1, m2, c2

    @classmethod
    def _build_matrix(cls, k: int, m: int, c: int, technique: str) -> np.ndarray:
        m1, c1, m2, c2 = cls._layer_split(k, m, c, technique)
        mat = gf256.rs_vandermonde_matrix(k, m)
        for rr in range(m1):
            keep = _window_cols(rr, k, m1, c1)
            for cc in range(k):
                if cc not in keep:
                    mat[rr, cc] = 0
        for rr in range(m2):
            keep = _window_cols(rr, k, m2, c2)
            for cc in range(k):
                if cc not in keep:
                    mat[m1 + rr, cc] = 0
        return mat

    # -- decode plan search (shec_make_decoding_matrix) --------------------

    def _decode_plan(self, want: frozenset, avail: frozenset):
        return self._plan_cache.get_or_build(
            (want, avail), lambda: self._search_plan(want, avail))

    def _search_plan(self, want: frozenset, avail: frozenset):
        k, m = self._k, self._m
        mat = self.coding_matrix
        # erased wanted parity pulls in its data columns (.cc:531-539)
        want_data = set(i for i in want if i < k)
        for i in range(m):
            if (k + i) in want and (k + i) not in avail:
                want_data |= set(int(j) for j in np.flatnonzero(mat[i]))
        best = None  # (dup, rows, cols, parity_sel)
        min_dup, min_p = k + 1, k + 1
        for pp in range(1 << m):
            parity_sel = [i for i in range(m) if pp >> i & 1]
            if len(parity_sel) > min_p:
                continue
            if any((k + i) not in avail for i in parity_sel):
                continue
            cols = {j for j in want_data if j not in avail}
            rows: set[int] = set()
            for i in parity_sel:
                rows.add(k + i)
                nz = set(int(j) for j in np.flatnonzero(mat[i]))
                cols |= nz
                rows |= {j for j in nz if j in avail}
            if len(rows) != len(cols):
                continue
            dup = len(rows)
            if dup == 0:
                best = (0, [], [], parity_sel)
                min_dup, min_p = 0, len(parity_sel)
                break
            if dup >= min_dup:
                continue
            rlist, clist = sorted(rows), sorted(cols)
            sub = self._submatrix(rlist, clist)
            try:
                gf256.invert_matrix(sub)
            except ValueError:
                continue
            best = (dup, rlist, clist, parity_sel)
            min_dup, min_p = dup, len(parity_sel)
        if best is None:
            raise ErasureCodeError(
                f"shec: cannot recover want={sorted(want)} from "
                f"avail={sorted(avail)}", errno_=5)
        dup, rlist, clist, parity_sel = best
        # minimum chunk set: system rows + wanted available chunks (.cc:695-718)
        minimum = set(rlist)
        minimum |= {i for i in want if i in avail}
        return dup, rlist, clist, parity_sel, minimum, want_data

    def _submatrix(self, rows: list[int], cols: list[int]) -> np.ndarray:
        k = self._k
        sub = np.zeros((len(rows), len(cols)), dtype=np.uint8)
        for ri, r in enumerate(rows):
            for ci, c_ in enumerate(cols):
                if r < k:
                    sub[ri, ci] = 1 if r == c_ else 0
                else:
                    sub[ri, ci] = self.coding_matrix[r - k, c_]
        return sub

    # -- interface overrides ----------------------------------------------

    def minimum_to_decode(self, want_to_read, available):
        want = frozenset(want_to_read)
        avail = frozenset(available)
        if want <= avail:
            return {c: [(0, 1)] for c in sorted(want)}
        *_, minimum, _wd = self._decode_plan(want, avail)
        return {c: [(0, 1)] for c in sorted(minimum)}

    def decode_chunks(self, want_to_read, chunks):
        k = self._k
        want = frozenset(want_to_read)
        avail = frozenset(chunks)
        missing = [c for c in want if c not in chunks]
        if not missing:
            return {c: np.asarray(chunks[c], dtype=np.uint8) for c in want}
        dup, rows, cols, parity_sel, _min, want_data = \
            self._decode_plan(want, avail)
        out = {c: np.asarray(chunks[c], dtype=np.uint8)
               for c in want if c in chunks}
        recovered: dict[int, np.ndarray] = {
            i: np.asarray(chunks[i], dtype=np.uint8)
            for i in range(k) if i in chunks
        }
        if dup > 0:
            sub = self._submatrix(rows, cols)
            inv = gf256.invert_matrix(sub)
            b = np.stack([np.asarray(chunks[r if r < k else r], dtype=np.uint8)
                          for r in rows])
            solved = self._matvec(inv, b)  # solves for cols
            for ci, c_ in enumerate(cols):
                recovered[c_] = solved[ci]
        for c_ in missing:
            if c_ < k:
                out[c_] = recovered[c_]
            else:
                # re-encode erased wanted parity from recovered data
                row = self.coding_matrix[c_ - k][None, :]
                nz = [int(j) for j in np.flatnonzero(row[0])]
                data = np.stack([recovered[j] for j in nz])
                out[c_] = self._matvec(row[:, nz], data)[0]
        return out


class ShecPlugin(ErasureCodePlugin):
    def factory(self, profile, device):
        codec = ErasureCodeShec(device=device)
        codec.init(profile)
        return codec


def __erasure_code_init__(name, registry):
    registry.add(name, ShecPlugin())
