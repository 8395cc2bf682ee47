"""Erasure-code codec plugins: the port of ``ceph_tpu.models`` for the
matrix codecs (jerasure, isa). Chunks are numpy at the codec interface;
each codec's matvec runs on its torch ``device`` (kernel B1 on CUDA)."""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.models.interface import (  # noqa: F401
    ErasureCodeError,
    ErasureCodeInterface,
    ErasureCodeProfile,
)
from ceph_tpu_torch.models.registry import (  # noqa: F401
    ErasureCodePluginRegistry,
    instance,
)


def from_reference_profile(profile: dict, coding_matrix: np.ndarray,
                           device="cuda"):
    """The port's codec for a reference (``ceph_tpu``) codec, given that
    codec's completed profile and its ``coding_matrix`` as numpy, so both
    packages compute with the very same matrix. The reference's
    ``backend`` key names a JAX backend and is dropped: the port picks its
    own from ``device``."""
    profile = {key: val for key, val in profile.items() if key != "backend"}
    codec = instance().factory(profile.get("plugin", "jerasure"), profile,
                               device=device)
    mat = np.asarray(coding_matrix, dtype=np.uint8)
    codec._setup(mat.shape[1], mat.shape[0], mat, codec.get_profile())
    return codec
