"""The port's crc32c layer against the JAX package.

``ceph_tpu_torch.ops.crc32c_torch.crc_linear_device`` (stage 1 through
kernel B2's wrapper — its plain version on CPU tensors — plus the stage-2
combine) and ``crc32c_from_linear`` are held bit-identical (tolerance 0)
to ``ceph_tpu.ops.crc32c_device.crc_linear_device`` (its XLA branch on
CPU) and to ``ceph_tpu.utils.checksum.crc32c``. The CUDA kernel is held
to the plain version by tests/test_torch_cuda.py, which needs a card.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ops import crc32c_device as ref_cd
from ceph_tpu.utils import checksum as ref_ck
from ceph_tpu_torch.ops import crc32c_cuda, crc32c_torch as ct
from ceph_tpu_torch.utils import checksum

LENGTHS = (1, 511, 512, 513, 4096 + 7)
SEEDS = (0, 0xFFFFFFFF)


def _rows(seed, n, length):
    return np.random.default_rng(seed).integers(0, 256, size=(n, length),
                                                dtype=np.uint8)


def test_host_crc32c_matches_reference():
    assert checksum.crc32c(b"123456789") == 0xE3069283
    x = _rows(0, 5, 300)
    for s in SEEDS + (0x1234,):
        want = [ref_ck.crc32c(r.tobytes(), s) for r in x]
        assert [checksum.crc32c(r, s) for r in x] == want
        assert checksum.crc32c_rows(x, s).tolist() == want


@pytest.mark.parametrize("length", LENGTHS)
def test_linear_crc_matches_jax_and_oracle(length):
    x = _rows(length, 4, length)
    lin = ct.crc_linear_device(torch.from_numpy(x))
    assert lin.dtype == torch.int64 and lin.shape == (4,)
    ref_lin = np.asarray(ref_cd.crc_linear_device(x))
    assert lin.tolist() == ref_lin.astype(np.int64).tolist()
    for s in SEEDS:
        got = [ct.crc32c_from_linear(int(v), length, s) for v in lin]
        assert got == [ref_ck.crc32c(r.tobytes(), s) for r in x], s
        assert got == [ref_cd.crc32c_from_linear(int(v), length, s)
                       for v in ref_lin]


def test_zeros_crc_and_matrices_match_reference():
    for n in (1, 5, 512, 4096, 1 << 17):
        for s in SEEDS + (0xDEADBEEF,):
            assert ct.zeros_crc(n, s) == ref_cd.zeros_crc(n, s)
    assert np.array_equal(ct._B_matrix(512), ref_cd._B_matrix(512))
    assert np.array_equal(ct._P_matrix(3, 512), ref_cd._P_matrix(3, 512))


def test_front_zero_padding_is_free():
    m = _rows(2, 1, 1000)
    padded = np.concatenate([np.zeros((1, 3096), dtype=np.uint8), m], axis=1)
    a = ct.crc_linear_device(torch.from_numpy(m))
    b = ct.crc_linear_device(torch.from_numpy(padded))
    assert a.tolist() == b.tolist()


def test_plain_rows_and_wrapper_on_cpu():
    x = _rows(3, 7, 512)
    crc32c_cuda.reset_launches()
    got = crc32c_cuda.crc_rows(torch.from_numpy(x))
    assert crc32c_cuda.launches == 0
    # L(row) = crc32c(row, 0) ^ crc32c(0^512, 0)
    want = checksum.crc32c_rows(x, 0) ^ np.uint32(ct.zeros_crc(512, 0))
    assert got.tolist() == want.astype(np.int64).tolist()
    with pytest.raises(ValueError):
        ct.crc_rows(torch.zeros((2, 100), dtype=torch.uint8))
