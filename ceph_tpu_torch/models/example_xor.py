"""Example XOR codec — port of ``ceph_tpu/models/example_xor.py``.

Reference: src/test/erasure-code/ErasureCodeExample.h — a trivial k data +
1 XOR parity codec used to exercise the interface machinery itself
(TestErasureCodeExample.cc). Here it is the all-ones row of GF(2^8), so the
generic matrix machinery covers it: encode runs kernel B1 on CUDA, and
every decode takes the matrix codec's host XOR fast path.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.models.matrix_codec import MatrixErasureCode
from ceph_tpu_torch.models.registry import PLUGIN_VERSION, ErasureCodePlugin

__erasure_code_version__ = PLUGIN_VERSION


class ErasureCodeExample(MatrixErasureCode):
    """k data chunks + 1 parity chunk = XOR of the data chunks."""

    def init(self, profile):
        k = self.to_int("k", profile, 2)
        m = self.to_int("m", profile, 1)
        if m != 1:
            raise ErasureCodeError("example codec supports m=1 only")
        coding = np.ones((1, k), dtype=np.uint8)
        profile = dict(profile)
        profile["plugin"] = "example"
        self._setup(k, 1, coding, profile)


class ExamplePlugin(ErasureCodePlugin):
    def factory(self, profile, device):
        codec = ErasureCodeExample(device=device)
        codec.init(profile)
        return codec


def __erasure_code_init__(name, registry):
    registry.add(name, ExamplePlugin())
