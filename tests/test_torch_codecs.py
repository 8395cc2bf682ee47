"""The port's matrix codecs (ceph_tpu_torch.models) against the JAX package's.

Each port codec is built twice — from its own registry and from the
reference codec's profile and matrix (``from_reference_profile``) — and
must give the reference's chunks byte for byte (tolerance 0): the coding
matrix, encode, and decode of every 1- and 2-erasure pattern of k=8, m=3.
The reference runs its ``jax`` backend on the CPU; the port runs on
``device="cpu"`` (the plain versions).
"""

import itertools

import numpy as np
import pytest

from ceph_tpu.models import registry as ref_registry
from ceph_tpu_torch.bench import ec_bench
from ceph_tpu_torch.models import from_reference_profile, instance
from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.models.registry import PluginLoadError

PROFILES = [
    ("isa", {"k": "8", "m": "3", "technique": "reed_sol_van"}),
    ("isa", {"k": "8", "m": "3", "technique": "cauchy"}),
    ("jerasure", {"k": "8", "m": "3", "technique": "reed_sol_van"}),
    ("jerasure", {"k": "8", "m": "3", "technique": "cauchy_good"}),
]


def _pair(plugin, profile):
    ref = ref_registry.instance().factory(
        plugin, dict(profile, plugin=plugin, backend="jax"))
    port = instance().factory(plugin, dict(profile, plugin=plugin),
                              device="cpu")
    return ref, port


@pytest.mark.parametrize("plugin,profile", PROFILES,
                         ids=[f"{p}-{q['technique']}" for p, q in PROFILES])
def test_codec_encode_and_every_1_2_erasure_decode(plugin, profile):
    ref, port = _pair(plugin, profile)
    assert np.array_equal(port.coding_matrix, ref.coding_matrix)
    twin = from_reference_profile(ref.get_profile(), ref.coding_matrix,
                                  device="cpu")
    assert twin.get_chunk_count() == ref.get_chunk_count()
    data = np.random.default_rng(7).integers(
        0, 256, size=8 * 512 - 5, dtype=np.uint8).tobytes()
    n = ref.get_chunk_count()
    want = ref.encode(list(range(n)), data)
    for codec in (port, twin):
        got = codec.encode(list(range(n)), data)
        assert sorted(got) == sorted(want)
        for i in want:
            assert np.array_equal(got[i], want[i]), i
    chunk_size = len(want[0])
    for e in (1, 2):
        for lost in itertools.combinations(range(n), e):
            avail = {i: want[i] for i in range(n) if i not in lost}
            ref_out = ref.decode(list(lost), avail, chunk_size)
            for codec in (port, twin):
                out = codec.decode(list(lost), avail, chunk_size)
                for i in lost:
                    assert np.array_equal(out[i], ref_out[i]), (lost, i)
                    assert np.array_equal(out[i], want[i]), (lost, i)


def test_minimum_to_decode_and_verify_match_reference():
    ref, port = _pair(*PROFILES[0])
    for want, avail in (([0], range(1, 11)), ([0, 9], [1, 2, 3, 4, 5, 6, 7, 8, 10]),
                        ([2], range(11))):
        assert port.minimum_to_decode(want, list(avail)) == \
            ref.minimum_to_decode(want, list(avail))
    data = np.random.default_rng(1).integers(0, 256, 8 * 64, dtype=np.uint8)
    chunks = port.encode(list(range(11)), data)
    assert port.verify_chunks(chunks) == []
    chunks[9] = chunks[9].copy()
    chunks[9][3] ^= 1
    assert port.verify_chunks(chunks) == ref.verify_chunks(chunks) == [9]
    with pytest.raises(ErasureCodeError):
        port.decode_chunks([0, 1, 2, 3], {i: chunks[i] for i in range(4, 11)})


def test_registry_failure_modes_and_profile_checks():
    with pytest.raises(PluginLoadError):
        instance().factory("no_such_plugin", {}, device="cpu")
    with pytest.raises(ErasureCodeError):
        instance().factory("isa", {"k": "30", "m": "5"}, device="cpu")
    with pytest.raises(ErasureCodeError):
        instance().factory("jerasure", {"technique": "nope"}, device="cpu")
    with pytest.raises(ErasureCodeError):
        instance().factory("isa", {"backend": "pallas"}, device="cpu")


@pytest.mark.parametrize("workload", ("encode", "decode"))
def test_ec_bench_cli_runs_on_cpu(workload, capsys):
    rc = ec_bench.main(["-p", "isa", "-P", "k=8", "-P", "m=3", "-S", "65536",
                        "-i", "2", "-w", workload, "-e", "2",
                        "--device", "cpu"])
    assert rc == 0
    elapsed, kib = capsys.readouterr().out.strip().split("\t")
    assert float(elapsed) >= 0 and int(kib) == 2 * 64
    with pytest.raises(SystemExit):
        ec_bench.main(["-p", "isa", "--device-resident", "--device", "cpu"])
