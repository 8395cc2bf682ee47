"""Generic systematic-matrix erasure codec — port of
``ceph_tpu/models/matrix_codec.py``.

A systematic generator G = [I_k ; C] with C an m×k GF(2^8) matrix: encode
is C (x) data, decode selects surviving rows of G, inverts, and
re-multiplies (reference decode path: src/erasure-code/isa/
ErasureCodeIsa.cc:150-310). Decode matrices are cached in an LRU keyed by
the erasure signature (ErasureCodeIsaTableCache). Chunks are numpy at this
interface; ``_matvec`` uploads to the codec's device, runs the backend
(ops/backend.py: kernel B1 on CUDA), and downloads.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ceph_tpu_torch.models.base import ErasureCode
from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.ops import backend as backend_mod
from ceph_tpu_torch.ops import gf256
from ceph_tpu_torch.utils.lru import BoundedLRU

#: default decode-table LRU depth — reference sizes it "sufficient up to
#: (12,4)" (isa/README:57-62)
DEFAULT_DECODE_CACHE = 2516


class MatrixErasureCode(ErasureCode):
    """Systematic [I; C] codec. Subclasses set self.coding_matrix in init()."""

    def __init__(self, device="cuda") -> None:
        super().__init__(device)
        self._k = 0
        self._m = 0
        self.coding_matrix: np.ndarray | None = None  # [m, k]
        self.backend = "auto"
        self._decode_cache: BoundedLRU = BoundedLRU(DEFAULT_DECODE_CACHE)

    # subclasses call this from init()
    def _setup(self, k: int, m: int, coding_matrix: np.ndarray,
               profile: Mapping[str, str]) -> None:
        if k < 1 or m < 1:
            raise ErasureCodeError(f"k={k}, m={m} must be >= 1")
        if coding_matrix.shape != (m, k):
            raise ErasureCodeError(
                f"coding matrix shape {coding_matrix.shape} != ({m},{k})")
        backend = str(profile.get("backend", "auto"))
        try:
            backend_mod.resolve_name(backend, self.device)
        except KeyError as exc:
            raise ErasureCodeError(str(exc)) from exc
        self._k, self._m = k, m
        self.coding_matrix = coding_matrix.astype(np.uint8)
        self.backend = backend
        self._profile = dict(profile)
        self._profile.setdefault("k", str(k))
        self._profile.setdefault("m", str(m))

    def get_chunk_count(self) -> int:
        return self._k + self._m

    def get_data_chunk_count(self) -> int:
        return self._k

    @property
    def generator(self) -> np.ndarray:
        return gf256.systematic_generator(self.coding_matrix)

    @property
    def resolved_backend(self) -> str:
        return backend_mod.resolve_name(self.backend, self.device)

    # -- hot paths ---------------------------------------------------------

    def _matvec(self, mat: np.ndarray, data: np.ndarray) -> np.ndarray:
        """mat (x) data on the codec's device: upload, matvec, download."""
        dev = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8))
        out = backend_mod.matvec(mat, dev.to(self.device),
                                 self.resolved_backend)
        return out.cpu().numpy()

    def encode_chunks(self, want_to_encode, chunks):
        k, n = self._k, self.get_chunk_count()
        inv_map = {self._chunk_index(i): i for i in range(n)}
        data = np.stack([
            np.asarray(chunks[self._chunk_index(i)], dtype=np.uint8)
            for i in range(k)
        ])
        parity = self._matvec(self.coding_matrix, data)
        out = {}
        for pos in want_to_encode:
            i = inv_map.get(pos, pos)
            if k <= i < n:
                out[pos] = parity[i - k]
        return out

    def decode_chunks(self, want_to_read, chunks):
        k = self._k
        have = sorted(chunks)
        want = list(want_to_read)
        missing = [c for c in want if c not in chunks]
        if not missing:
            return {c: np.asarray(chunks[c], dtype=np.uint8) for c in want}
        if len(have) < k:
            raise ErasureCodeError(
                f"cannot decode {missing} from {have}: need {k} chunks",
                errno_=5)
        present = have[:k]
        dmat = self._decode_matrix(tuple(present), tuple(missing))
        # a survivor whose decode column is all zero contributes nothing
        # over GF: don't stack (or upload) its bytes at all
        keep = [i for i in range(len(present)) if dmat[:, i].any()]
        if len(keep) < len(present):
            dmat = np.ascontiguousarray(dmat[:, keep])
            present = [present[i] for i in keep]
        if not present:
            some = np.asarray(chunks[have[0]], dtype=np.uint8)
            rec = np.zeros((len(missing), len(some)), dtype=np.uint8)
        elif ((dmat == 0) | (dmat == 1)).all():
            # XOR fast path: a decode row whose nonzero coefficients are
            # all 1 is plain GF addition, so reconstruction is a host
            # bitwise XOR of the survivor chunks — no device round trip
            data = np.stack([np.asarray(chunks[c], dtype=np.uint8)
                             for c in present])
            rec = np.stack([
                np.bitwise_xor.reduce(data[dmat[row] == 1], axis=0)
                if (dmat[row] == 1).any() else
                np.zeros_like(data[0])
                for row in range(dmat.shape[0])])
        else:
            data = np.stack([np.asarray(chunks[c], dtype=np.uint8)
                             for c in present])
            rec = self._matvec(dmat, data)
        out = {c: np.asarray(chunks[c], dtype=np.uint8)
               for c in want if c in chunks}
        for row, c in enumerate(missing):
            out[c] = rec[row]
        return out

    def verify_chunks(self, chunks: Mapping[int, np.ndarray]) -> list[int]:
        """Re-encode the data chunks and compare against the stored
        parity; returns the PARITY indices (k..n-1) that mismatch."""
        k, n = self._k, self.get_chunk_count()
        if self.chunk_mapping:
            raise ErasureCodeError(
                "verify_chunks: layered/mapped codecs have no "
                "position-wise parity check")
        missing = [i for i in range(n) if i not in chunks]
        if missing:
            raise ErasureCodeError(
                f"verify_chunks: need all {n} chunks, missing {missing}")
        data = np.stack([np.asarray(chunks[i], dtype=np.uint8)
                         for i in range(k)])
        parity = self._matvec(self.coding_matrix, data)
        return [k + j for j in range(n - k)
                if not np.array_equal(
                    parity[j], np.asarray(chunks[k + j], dtype=np.uint8))]

    def _decode_matrix(self, present: tuple, missing: tuple) -> np.ndarray:
        """LRU-cached decode matrix, keyed by the erasure signature."""
        def build() -> np.ndarray:
            if self.chunk_mapping:
                to_enc = {pos: i
                          for i, pos in enumerate(self.chunk_mapping)}
                present_e = [to_enc[p] for p in present]
                missing_e = [to_enc[p] for p in missing]
            else:
                present_e, missing_e = list(present), list(missing)
            return gf256.decode_matrix(self.generator, present_e, missing_e)

        return self._decode_cache.get_or_build((present, missing), build)
