"""Erasure-code codec plugins: the port of ``ceph_tpu.models`` for the
matrix codecs (jerasure, isa, shec) and Clay. Chunks are numpy at the
codec interface; each codec's hot path runs on its torch ``device``
(kernel B1 on CUDA for the matrix codecs, kernels B3-B5 for Clay)."""

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


def from_reference_profile(profile: dict,
                           coding_matrix: np.ndarray | None = None,
                           device="cuda"):
    """The port's codec for a reference (``ceph_tpu``) codec, given that
    codec's completed profile and, for a matrix codec (jerasure, isa,
    shec), its ``coding_matrix`` as numpy, so both packages compute with
    the very same matrix. A Clay codec has no coding matrix: its profile
    alone fixes the code. The reference's ``backend`` key names a JAX
    backend and is dropped: the port picks its own from ``device``."""
    profile = {key: val for key, val in profile.items() if key != "backend"}
    codec = instance().factory(profile.get("plugin", "jerasure"), profile,
                               device=device)
    if coding_matrix is not None:
        mat = np.asarray(coding_matrix, dtype=np.uint8)
        codec._setup(mat.shape[1], mat.shape[0], mat, codec.get_profile())
    return codec
