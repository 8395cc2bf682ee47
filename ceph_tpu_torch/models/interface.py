"""The codec contract — semantic equivalent of ``ceph::ErasureCodeInterface``.

Reference: src/erasure-code/ErasureCodeInterface.h:155-464. The chunk/stripe
model (documented there at :39-78) is preserved exactly:

- an object is striped into stripes of ``k * chunk_size`` bytes;
- each stripe is split into k data chunks, and m coding chunks are computed;
- chunk i of every stripe goes to the same shard/OSD;
- array codes (Clay) further divide chunks into ``sub_chunk_count``
  sub-chunks, and ``minimum_to_decode`` can request sub-chunk ranges
  (reference: ErasureCodeInterface.h:251-300).

Differences from the reference, deliberate:

- chunks are numpy ``uint8`` arrays (zero-copy handoff to torch tensors
  via ``torch.from_numpy``) instead of ``bufferlist``;
- profiles are ``dict[str, str]`` (the reference's ErasureCodeProfile is a
  ``map<string,string>``);
- errors raise :class:`ErasureCodeError` instead of returning -errno.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Mapping, Sequence

import numpy as np

ErasureCodeProfile = dict  # profile: str -> str, like the reference's map

#: chunk -> list of (offset, count) sub-chunk ranges to read, in units of
#: chunk_size / sub_chunk_count (reference: ErasureCodeInterface.h:280-300).
SubChunkPlan = dict


class ErasureCodeError(Exception):
    """Codec failure (invalid profile, unrecoverable erasure pattern, ...)."""

    def __init__(self, message: str, errno_: int = 22):
        super().__init__(message)
        self.errno = errno_


class ErasureCodeInterface(ABC):
    """Abstract codec contract (reference: ErasureCodeInterface.h:170-462)."""

    @abstractmethod
    def init(self, profile: ErasureCodeProfile) -> None:
        """Initialize from a profile; raises ErasureCodeError on bad params."""

    @abstractmethod
    def get_profile(self) -> ErasureCodeProfile:
        """The profile as completed by init() (defaults filled in)."""

    @abstractmethod
    def get_chunk_count(self) -> int:
        """k + m: total chunks per stripe."""

    @abstractmethod
    def get_data_chunk_count(self) -> int:
        """k: chunks that hold object data."""

    def get_coding_chunk_count(self) -> int:
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        """Array codes (Clay) divide each chunk into sub-chunks; scalar
        codes return 1 (reference: ErasureCodeInterface.h:251-259)."""
        return 1

    @abstractmethod
    def get_chunk_size(self, stripe_width: int) -> int:
        """Chunk size for an object/stripe of ``stripe_width`` bytes,
        including padding/alignment (reference: ErasureCodeInterface.h:222-245)."""

    @abstractmethod
    def minimum_to_decode(
        self, want_to_read: Sequence[int], available: Sequence[int]
    ) -> SubChunkPlan:
        """Smallest chunk set (with sub-chunk ranges) sufficient to decode
        ``want_to_read`` from ``available``.  Raises if impossible.
        Reference: ErasureCodeInterface.h:280-300."""

    def minimum_to_decode_with_cost(
        self, want_to_read: Sequence[int], available: Mapping[int, int]
    ) -> list[int]:
        """Like minimum_to_decode but pick cheapest chunks given a cost map
        (reference: ErasureCodeInterface.h:302-315). Default: sort by cost
        and take the cheapest feasible set."""
        ordered = sorted(available, key=lambda c: (available[c], c))
        plan = self.minimum_to_decode(want_to_read, ordered)
        return sorted(plan)

    @abstractmethod
    def encode(
        self, want_to_encode: Sequence[int], data: bytes | np.ndarray
    ) -> dict[int, np.ndarray]:
        """Split+pad ``data`` into k chunks, compute m coding chunks, return
        the requested subset (reference: ErasureCodeInterface.h:317-349)."""

    @abstractmethod
    def encode_chunks(
        self, want_to_encode: Sequence[int], chunks: dict[int, np.ndarray]
    ) -> dict[int, np.ndarray]:
        """Low-level: chunks already split/aligned; compute coding chunks."""

    @abstractmethod
    def decode(
        self,
        want_to_read: Sequence[int],
        chunks: Mapping[int, np.ndarray],
        chunk_size: int,
    ) -> dict[int, np.ndarray]:
        """Reconstruct the wanted chunks from the available ones
        (reference: ErasureCodeInterface.h:351-387)."""

    @abstractmethod
    def decode_chunks(
        self,
        want_to_read: Sequence[int],
        chunks: Mapping[int, np.ndarray],
    ) -> dict[int, np.ndarray]:
        """Low-level decode: all chunks same size, no padding logic."""

    def get_chunk_mapping(self) -> list[int]:
        """Optional remap: chunk i of the encoder is stored at position
        mapping[i] (reference: ErasureCodeInterface.h:389-401).  Empty list
        means identity."""
        return []

    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> np.ndarray:
        """Decode and concatenate the data chunks in order — used by the
        read path (reference: ErasureCodeInterface.h:403-416)."""
        k = self.get_data_chunk_count()
        want = list(range(k))
        some = next(iter(chunks.values()))
        decoded = self.decode(want, chunks, len(some))
        return np.concatenate([decoded[i] for i in want])

    def create_rule(self, name: str, crush_map) -> int:
        """Create a placement rule for this codec in the given CRUSH map
        (reference: ErasureCodeInterface.h:205-220; base impl
        ErasureCode.cc:53-72 uses 'indep' mode).  Implemented by the base
        class once the parallel/crush layer is present."""
        raise NotImplementedError
