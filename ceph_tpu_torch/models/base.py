"""Shared codec logic — port of ``ceph_tpu/models/base.py``
(semantic equivalent of ``ceph::ErasureCode``, src/erasure-code/ErasureCode.{h,cc}).

- chunk padding/alignment: ``SIMD_ALIGN = 32`` (ErasureCode.cc:31);
- ``encode_prepare`` splits + zero-pads input into k aligned chunks
  (ErasureCode.cc:137-172);
- generic ``encode`` = prepare -> ``encode_chunks`` (ErasureCode.cc:174-190);
- ``decode`` copies trivially when all wanted chunks are present, else
  calls ``decode_chunks`` (ErasureCode.cc:198-234);
- default ``minimum_to_decode`` = any k available chunks, preferring the
  wanted ones themselves (ErasureCode.cc:89-123);
- ``chunk_mapping`` remap support (ErasureCode.cc:260-279);
- profile parsing helpers to_int/to_bool (ErasureCode.cc:281-329).

Chunks are numpy arrays at this interface, as in the reference; each codec
carries the torch ``device`` its matvec runs on.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ceph_tpu_torch.models.interface import (
    ErasureCodeError,
    ErasureCodeInterface,
    ErasureCodeProfile,
)

#: Reference SIMD_ALIGN (ErasureCode.cc:31).
SIMD_ALIGN = 32


class ErasureCode(ErasureCodeInterface):
    """Base class implementing the generic split/pad/assemble machinery."""

    def __init__(self, device="cuda") -> None:
        self._profile: ErasureCodeProfile = {}
        self.chunk_mapping: list[int] = []
        self.device = torch.device(device)

    # -- profile helpers (reference: ErasureCode.cc:281-329) ---------------

    @staticmethod
    def to_int(name: str, profile: Mapping[str, str], default: int) -> int:
        val = profile.get(name, None)
        if val in (None, ""):
            return default
        try:
            return int(val)
        except (TypeError, ValueError):
            raise ErasureCodeError(f"{name}={val!r} is not a valid integer")

    @staticmethod
    def to_bool(name: str, profile: Mapping[str, str], default: bool) -> bool:
        val = profile.get(name, None)
        if val in (None, ""):
            return default
        if isinstance(val, bool):
            return val
        return str(val).lower() in ("yes", "true", "1")

    # -- geometry ----------------------------------------------------------

    @property
    def k(self) -> int:
        return self.get_data_chunk_count()

    @property
    def m(self) -> int:
        return self.get_coding_chunk_count()

    def get_profile(self) -> ErasureCodeProfile:
        return self._profile

    def get_chunk_size(self, stripe_width: int) -> int:
        """Pad so every chunk is SIMD_ALIGN-aligned."""
        k = self.get_data_chunk_count()
        alignment = k * SIMD_ALIGN
        padded = -(-stripe_width // alignment) * alignment
        return padded // k

    # -- chunk index remap (reference: ErasureCode.cc:260-279) -------------

    def _chunk_index(self, i: int) -> int:
        return self.chunk_mapping[i] if self.chunk_mapping else i

    def get_chunk_mapping(self) -> list[int]:
        return list(self.chunk_mapping)

    # -- minimum_to_decode (reference: ErasureCode.cc:89-123) --------------

    def _minimum_to_decode_chunks(
        self, want_to_read: Sequence[int], available: Sequence[int]
    ) -> list[int]:
        want = set(want_to_read)
        avail = set(available)
        if want <= avail:
            return sorted(want)
        k = self.get_data_chunk_count()
        if len(avail) < k:
            raise ErasureCodeError(
                f"cannot decode: want {sorted(want)}, only "
                f"{sorted(avail)} available, need {k}", errno_=5)
        chosen = sorted(want & avail)
        for c in sorted(avail - want):
            if len(chosen) >= k:
                break
            chosen.append(c)
        return sorted(chosen[:k])

    def minimum_to_decode(
        self, want_to_read: Sequence[int], available: Sequence[int]
    ):
        chunks = self._minimum_to_decode_chunks(want_to_read, available)
        return {c: [(0, self.get_sub_chunk_count())] for c in chunks}

    # -- encode (reference: ErasureCode.cc:137-190) ------------------------

    def encode_prepare(self, data: bytes | np.ndarray) -> np.ndarray:
        """Split + zero-pad input into a [k, chunk_size] array."""
        buf = np.frombuffer(bytes(data), dtype=np.uint8) \
            if not isinstance(data, np.ndarray) \
            else data.astype(np.uint8, copy=False).ravel()
        k = self.get_data_chunk_count()
        chunk_size = self.get_chunk_size(len(buf))
        padded = np.zeros(k * chunk_size, dtype=np.uint8)
        padded[: len(buf)] = buf
        return padded.reshape(k, chunk_size)

    def encode(self, want_to_encode, data):
        chunks = self.encode_prepare(data)
        k = self.get_data_chunk_count()
        n = self.get_chunk_count()
        chunk_map = {self._chunk_index(i): chunks[i] for i in range(k)}
        coded = self.encode_chunks(list(range(n)), chunk_map)
        chunk_map.update(coded)
        return {i: chunk_map[i] for i in want_to_encode if i in chunk_map}

    # -- decode (reference: ErasureCode.cc:198-234) ------------------------

    def decode(self, want_to_read, chunks, chunk_size):
        have = set(chunks)
        want = list(want_to_read)
        if set(want) <= have:
            return {i: np.asarray(chunks[i], dtype=np.uint8) for i in want}
        return self.decode_chunks(want, chunks)
