"""The port's SHEC codec (ceph_tpu_torch.models.shec) against the JAX
package's (ceph_tpu.models.shec).

Coding matrix, encode, decode of every 1- and 2-erasure pattern (a
pattern SHEC cannot recover must raise in both), ``minimum_to_decode``
and ``from_reference_profile``, over both techniques and several
(k, m, c). Tolerance 0: every result is bytes. The reference runs its
``numpy`` backend; the port runs on ``device="cpu"`` (the plain versions).
"""

import itertools

import numpy as np
import pytest

from ceph_tpu.models import ErasureCodeError as RefErasureCodeError
from ceph_tpu.models import instance as ref_instance
from ceph_tpu_torch.models import from_reference_profile, instance
from ceph_tpu_torch.models.interface import ErasureCodeError

PROFILES = [
    {"k": "4", "m": "3", "c": "2"},
    {"k": "6", "m": "3", "c": "2", "technique": "single"},
    {"k": "8", "m": "4", "c": "3"},
    {"k": "4", "m": "2", "c": "2"},
]


def _pair(profile):
    ref = ref_instance().factory("shec", dict(profile, backend="numpy"))
    port = instance().factory("shec", dict(profile), device="cpu")
    return ref, port


@pytest.mark.parametrize("profile", PROFILES,
                         ids=["-".join(p.values()) for p in PROFILES])
def test_encode_and_every_1_2_erasure_decode_match_reference(profile):
    ref, port = _pair(profile)
    assert np.array_equal(port.coding_matrix, ref.coding_matrix)
    for key in ("plugin", "technique", "c", "k", "m"):
        assert port.get_profile()[key] == ref.get_profile()[key], key
    twin = from_reference_profile(ref.get_profile(), ref.coding_matrix,
                                  device="cpu")
    assert twin.c == ref.c
    n = ref.get_chunk_count()
    data = np.random.default_rng(n).integers(
        0, 256, size=int(profile["k"]) * 512 - 7, dtype=np.uint8).tobytes()
    want = ref.encode(list(range(n)), data)
    for codec in (port, twin):
        got = codec.encode(list(range(n)), data)
        for i in range(n):
            assert np.array_equal(got[i], want[i]), i
    cs = len(want[0])
    for e in (1, 2):
        for lost in itertools.combinations(range(n), e):
            avail = {i: want[i] for i in range(n) if i not in lost}
            try:
                ref_min = ref.minimum_to_decode(list(lost), list(avail))
                ref_out = ref.decode(list(lost), avail, cs)
            except RefErasureCodeError:
                with pytest.raises(ErasureCodeError):
                    port.decode(list(lost), avail, cs)
                continue
            assert port.minimum_to_decode(list(lost), list(avail)) == ref_min
            for codec in (port, twin):
                out = codec.decode(list(lost), avail, cs)
                for i in lost:
                    assert np.array_equal(out[i], ref_out[i]), (lost, i)
                    assert np.array_equal(out[i], want[i]), (lost, i)


def test_profile_checks_match_reference():
    for bad in ({"k": "4", "m": "5", "c": "2"}, {"c": "0"},
                {"technique": "triple"}, {"w": "16"}):
        with pytest.raises(RefErasureCodeError):
            ref_instance().factory("shec", dict(bad, backend="numpy"))
        with pytest.raises(ErasureCodeError):
            instance().factory("shec", bad, device="cpu")
    port = instance().factory("shec", {}, device="cpu")
    assert (port.k, port.m, port.c) == (4, 3, 2)
    assert port.resolved_backend == "torch"
