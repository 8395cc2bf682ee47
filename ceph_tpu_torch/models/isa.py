"""ISA-L-semantics plugin — port of ``ceph_tpu/models/isa.py``.

Reference: src/erasure-code/isa/ErasureCodeIsa.{h,cc}. Defaults k=7, m=3;
``technique`` selects Vandermonde (``reed_sol_van``, gf_gen_rs_matrix —
the profile of the north-star benchmark) or Cauchy (``cauchy``,
gf_gen_cauchy1_matrix). The Vandermonde construction is only MDS inside
k<=32, m<=4 (m==4 => k<=21), checked as ErasureCodeIsa.cc:330-360 does.
"""

from __future__ import annotations

from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.models.matrix_codec import MatrixErasureCode
from ceph_tpu_torch.models.registry import PLUGIN_VERSION, ErasureCodePlugin
from ceph_tpu_torch.ops import gf256

__erasure_code_version__ = PLUGIN_VERSION


class ErasureCodeIsa(MatrixErasureCode):
    def init(self, profile):
        profile = dict(profile)
        technique = profile.get("technique", "reed_sol_van")
        k = self.to_int("k", profile, 7)
        m = self.to_int("m", profile, 3)
        if technique == "reed_sol_van":
            if k > 32 or m > 4 or (m == 4 and k > 21):
                raise ErasureCodeError(
                    f"isa reed_sol_van is MDS only for k<=32, m<=4 "
                    f"(m=4 => k<=21); got k={k}, m={m} — use technique=cauchy")
            coding = gf256.rs_matrix_isa(k, m)
        elif technique == "cauchy":
            coding = gf256.cauchy_matrix_isa(k, m)
        else:
            raise ErasureCodeError(
                f"technique={technique!r} must be reed_sol_van or cauchy")
        profile.setdefault("plugin", "isa")
        profile["technique"] = technique
        self._setup(k, m, coding, profile)


class IsaPlugin(ErasureCodePlugin):
    def factory(self, profile, device):
        codec = ErasureCodeIsa(device=device)
        codec.init(profile)
        return codec


def __erasure_code_init__(name, registry):
    registry.add(name, IsaPlugin())
