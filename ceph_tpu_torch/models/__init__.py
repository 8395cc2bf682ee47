"""Erasure-code codec plugins: the port of ``ceph_tpu.models`` — the
matrix codecs (jerasure, isa, shec, example), Clay and the LRC
composition. Chunks are numpy at the codec interface; each codec's hot
path runs on its torch ``device`` (kernel B1 on CUDA for the matrix codecs
and LRC's layers, kernels B3-B5 for Clay)."""

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
    shec, example), its ``coding_matrix`` as numpy, so both packages
    compute with the very same matrix. A Clay or LRC codec has no coding
    matrix: its profile alone fixes the code. The reference's ``backend``
    key names a JAX backend and is dropped: the port picks its own from
    ``device``. Every reference codec but LRC names its ``plugin`` in its
    profile; an LRC profile is known by its ``mapping``. The reference's
    LRC writes the ``mapping`` it generated into the profile of a k/m/l
    codec, which its own ``init`` would refuse beside k, m and l, so that
    key is dropped there; the port's LRC writes it back."""
    profile = {key: val for key, val in profile.items() if key != "backend"}
    plugin = profile.get("plugin", "lrc" if "mapping" in profile
                         else "jerasure")
    if plugin == "lrc" and all(x in profile for x in ("k", "m", "l")):
        profile.pop("mapping", None)
    codec = instance().factory(plugin, profile, device=device)
    if coding_matrix is not None:
        mat = np.asarray(coding_matrix, dtype=np.uint8)
        codec._setup(mat.shape[1], mat.shape[0], mat, codec.get_profile())
    return codec
