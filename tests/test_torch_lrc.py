"""The port's LRC and example codecs (ceph_tpu_torch.models.lrc,
example_xor) against the JAX package's.

Byte-exact (tolerance 0) on inputs made with numpy seeds: the k/m/l
generation, geometry, chunk mapping and completed profile; encode, every
1- and 2-erasure decode and ``minimum_to_decode``'s read plan, for the
k=4 m=2 l=3 profile of ``tests/test_lrc.py`` and the reference's
``DEFAULT_PROFILES``, and for its explicit mapping + layers profile; the
profiles both refuse; ``example`` at k=2..8; and ``from_reference_profile``
for both plugins. The reference runs its ``numpy`` backend; the port runs
on ``device="cpu"`` (the plain versions).
"""

import itertools

import numpy as np
import pytest

from ceph_tpu.models import ErasureCodeError as RefError
from ceph_tpu.models import instance as ref_instance
from ceph_tpu.models.lrc import generate_kml as ref_generate_kml
from ceph_tpu_torch.models import from_reference_profile, instance
from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.models.lrc import generate_kml

KML = {"k": "4", "m": "2", "l": "3"}
LAYERS = {"mapping": "__DD__DD",
          "layers": '[["_cDD_cDD", {"plugin": "jerasure", '
                    '"technique": "cauchy_orig"}],'
                    ' ["cDDD____", {}], ["____cDDD", {}]]'}
PROFILES = {"kml": KML, "layers": LAYERS}


def _pair(plugin, profile):
    ref = ref_instance().factory(plugin, dict(profile, backend="numpy"))
    port = instance().factory(plugin, dict(profile), device="cpu")
    return ref, port


def _no_backend(profile):
    return {k: v for k, v in profile.items() if k != "backend"}


@pytest.mark.parametrize("k,m,l", [(4, 2, 3), (8, 4, 6), (6, 3, 3),
                                   (6, 2, 4), (8, 2, 5)])
def test_generate_kml_matches_reference(k, m, l):
    assert generate_kml(k, m, l) == ref_generate_kml(k, m, l)


@pytest.mark.parametrize("k,m,l", [(4, 2, 4), (5, 1, 3), (6, 3, 4)])
def test_generate_kml_constraints_match_reference(k, m, l):
    with pytest.raises(RefError) as ref_exc:
        ref_generate_kml(k, m, l)
    with pytest.raises(ErasureCodeError) as port_exc:
        generate_kml(k, m, l)
    assert str(port_exc.value) == str(ref_exc.value)


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_geometry_mapping_and_profile_match_reference(name):
    ref, port = _pair("lrc", PROFILES[name])
    assert port.mapping == ref.mapping
    assert port.get_chunk_count() == ref.get_chunk_count()
    assert port.get_data_chunk_count() == ref.get_data_chunk_count()
    assert port.get_chunk_mapping() == ref.get_chunk_mapping()
    assert port.get_profile() == _no_backend(ref.get_profile())
    assert [lay.mapping for lay in port.layers] == \
        [lay.mapping for lay in ref.layers]
    for a, b in zip(port.layers, ref.layers):
        assert (a.positions, a.data_pos, a.coding_pos, a.local) == \
            (b.positions, b.data_pos, b.coding_pos, b.local)
        assert np.array_equal(a.codec.coding_matrix, b.codec.coding_matrix)
        assert a.codec.device == port.device


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_encode_every_1_2_erasure_decode_and_plan_match_reference(name):
    ref, port = _pair("lrc", PROFILES[name])
    n = ref.get_chunk_count()
    data = np.random.default_rng(5).integers(
        0, 256, size=4 * 4096 - 17, dtype=np.uint8).tobytes()
    want = ref.encode(list(range(n)), data)
    got = port.encode(list(range(n)), data)
    assert sorted(got) == sorted(want) == list(range(n))
    for i in range(n):
        assert np.array_equal(got[i], want[i]), i
    cs = port.get_chunk_size(len(data))
    assert cs == ref.get_chunk_size(len(data)) == len(want[0])
    for e in (1, 2):
        for lost in itertools.combinations(range(n), e):
            avail = sorted(set(range(n)) - set(lost))
            plan = port.minimum_to_decode(list(lost), avail)
            assert plan == ref.minimum_to_decode(list(lost), avail), lost
            if e == 1 and name == "kml":
                assert len(plan) == 3, (lost, plan)  # the local group
            chunks = {i: want[i] for i in avail}
            out = port.decode(list(lost), chunks, cs)
            ref_out = ref.decode(list(lost), chunks, cs)
            for i in lost:
                assert np.array_equal(out[i], ref_out[i]), (lost, i)
                assert np.array_equal(out[i], want[i]), (lost, i)
            used = {i: want[i] for i in plan}
            out = port.decode(list(lost), used, cs)
            for i in lost:
                assert np.array_equal(out[i], want[i]), (lost, i, plan)


def test_unrecoverable_decode_and_plan_raise_as_reference():
    ref, port = _pair("lrc", KML)
    data = np.random.default_rng(6).integers(0, 256, 8192, dtype=np.uint8)
    enc = port.encode(list(range(8)), data)
    lost = (0, 1, 4, 5)
    avail = sorted(set(range(8)) - set(lost))
    for codec, exc in ((ref, RefError), (port, ErasureCodeError)):
        with pytest.raises(exc):
            codec.minimum_to_decode(list(lost), avail)
        with pytest.raises(exc):
            codec.decode_chunks(list(lost), {i: enc[i] for i in avail})
    assert port.minimum_to_decode([2], [2, 3]) == \
        ref.minimum_to_decode([2], [2, 3]) == {2: [(0, 1)]}


BAD = [{"k": "4", "m": "2"},
       {"k": "4", "m": "2", "l": "3", "mapping": "DDDD____"},
       {"mapping": "DD__", "layers": '[["DD__", {}]]'},
       {"mapping": "DD__", "layers": '[["DDc_", {}]]'},
       {"mapping": "DD__", "layers": '[["DDc", {}]]'},
       {"mapping": "DD__"},
       {"k": "4", "m": "2", "l": "4"}]


@pytest.mark.parametrize("profile", BAD, ids=[str(i) for i in range(len(BAD))])
def test_bad_profiles_refused_as_reference(profile):
    with pytest.raises(RefError) as ref_exc:
        ref_instance().factory("lrc", dict(profile, backend="numpy"))
    with pytest.raises(ErasureCodeError) as port_exc:
        instance().factory("lrc", dict(profile), device="cpu")
    assert str(port_exc.value) == str(ref_exc.value)


def test_layer_profile_as_key_value_string():
    profile = {"mapping": "DD_DD_",
               "layers": '[["DDcDDc", "technique=cauchy_good"]]'}
    ref, port = _pair("lrc", profile)
    data = np.random.default_rng(8).integers(0, 256, 4 * 1000, dtype=np.uint8)
    want = ref.encode(list(range(6)), data)
    got = port.encode(list(range(6)), data)
    for i in range(6):
        assert np.array_equal(got[i], want[i]), i


@pytest.mark.parametrize("k", range(2, 9))
def test_example_matches_reference(k):
    ref, port = _pair("example", {"k": str(k)})
    assert port.get_profile() == _no_backend(ref.get_profile())
    assert np.array_equal(port.coding_matrix, ref.coding_matrix)
    n = k + 1
    data = np.random.default_rng(k).integers(
        0, 256, size=k * 512 - 3, dtype=np.uint8).tobytes()
    want = ref.encode(list(range(n)), data)
    got = port.encode(list(range(n)), data)
    for i in range(n):
        assert np.array_equal(got[i], want[i]), i
    cs = len(want[0])
    for lost in range(n):
        avail = {i: want[i] for i in range(n) if i != lost}
        assert port.minimum_to_decode([lost], sorted(avail)) == \
            ref.minimum_to_decode([lost], sorted(avail))
        assert np.array_equal(port.decode([lost], avail, cs)[lost],
                              want[lost]), lost
    with pytest.raises(ErasureCodeError):
        instance().factory("example", {"k": str(k), "m": "2"}, device="cpu")


@pytest.mark.parametrize("plugin,profile", [("lrc", KML), ("lrc", LAYERS),
                                            ("example", {"k": "5"})],
                         ids=["lrc-kml", "lrc-layers", "example"])
def test_from_reference_profile(plugin, profile):
    ref = ref_instance().factory(plugin, dict(profile, backend="numpy"))
    twin = from_reference_profile(ref.get_profile(),
                                  getattr(ref, "coding_matrix", None),
                                  device="cpu")
    assert type(twin).__name__ == type(ref).__name__
    assert twin.get_profile() == _no_backend(ref.get_profile())
    assert twin.get_chunk_mapping() == ref.get_chunk_mapping()
    n = ref.get_chunk_count()
    data = np.random.default_rng(3).integers(0, 256, 6000, dtype=np.uint8)
    want = ref.encode(list(range(n)), data)
    got = twin.encode(list(range(n)), data)
    for i in range(n):
        assert np.array_equal(got[i], want[i]), i
