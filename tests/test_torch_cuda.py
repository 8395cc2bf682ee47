"""The port's CUDA kernels against their plain torch versions, on the card.

Kernel B1 (ops/gf_cuda.py) and kernel B2 (ops/crc32c_cuda.py) must equal
their plain versions byte for byte (tolerance 0), over ragged shapes,
decode matrices and the largest matrix B1 takes, and the fused flush on
CUDA must equal the fused flush on the CPU. Every test here needs an
NVIDIA GPU and skips without one.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu_torch.models import instance
from ceph_tpu_torch.ops import (crc32c_cuda, crc32c_torch, gf256, gf_cuda,
                                gf_torch)
from ceph_tpu_torch.osd import ec_util

pytestmark = pytest.mark.cuda

RAGGED_N = (1, 15, 16, 100, 4097, 1 << 20)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _bytes(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("m,k", [(1, 8), (2, 8), (3, 8), (32, 128)])
def test_gf_kernel_matches_plain(cuda, m, k):
    mat = _bytes(m * k, m, k)
    gf_cuda.reset_launches()
    for n in RAGGED_N:
        d = torch.from_numpy(_bytes(n, k, n)).to(cuda)
        got = gf_cuda.matvec_device(mat, d)
        torch.cuda.synchronize()
        assert torch.equal(got, gf_torch.matvec(mat, d)), (m, k, n)
    assert gf_cuda.launches == len(RAGGED_N)


def test_gf_kernel_decode_matrices_and_oracle(cuda):
    k, m = 8, 3
    gen = gf256.systematic_generator(gf256.rs_matrix_isa(k, m))
    d_np = _bytes(3, k, 65536 + 5)
    d = torch.from_numpy(d_np).to(cuda)
    for e in (1, 2, 3):
        for lost in itertools.combinations(range(k + m), e):
            present = [i for i in range(k + m) if i not in lost][:k]
            dmat = gf256.decode_matrix(gen, present, list(lost))
            got = gf_cuda.matvec_device(dmat, d).cpu().numpy()
            assert np.array_equal(got, gf256.gf_matvec_chunks(dmat, d_np)), \
                lost


def test_gf_kernel_rejects_what_it_does_not_take(cuda):
    d = torch.zeros((4, 64), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        gf_cuda.matvec_device(np.ones((gf_cuda.MAX_M + 1, 4), np.uint8), d)
    with pytest.raises(ValueError):
        gf_cuda.matvec_device(np.ones((2, 4), np.uint8), d.t().contiguous().t())


def test_crc_rows_kernel_matches_plain(cuda):
    crc32c_cuda.reset_launches()
    for rows in (1, 7, 1000, 65536 + 3):
        x = torch.from_numpy(_bytes(rows, rows, 512)).to(cuda)
        got = crc32c_cuda.crc_rows(x)
        torch.cuda.synchronize()
        assert torch.equal(got, crc32c_torch.crc_rows(x)), rows
    assert crc32c_cuda.launches == 4


def test_linear_crc_on_cuda_matches_host(cuda):
    from ceph_tpu_torch.utils import checksum
    for length in (1, 511, 512, 513, 4096 + 7):
        x = _bytes(length, 4, length)
        lin = crc32c_torch.crc_linear_device(
            torch.from_numpy(x).to(cuda)).cpu()
        got = [crc32c_torch.crc32c_from_linear(int(v), length, 0xFFFFFFFF)
               for v in lin]
        assert got == checksum.crc32c_rows(x, 0xFFFFFFFF).tolist(), length


def test_fused_flush_on_cuda_matches_cpu(cuda):
    profile = {"k": "8", "m": "3", "technique": "reed_sol_van"}
    on_card = instance().factory("isa", profile, device=cuda)
    on_cpu = instance().factory("isa", profile, device="cpu")
    sinfo = ec_util.StripeInfo(stripe_width=8 * 256, chunk_size=256)
    bufs = [_bytes(s, s * sinfo.stripe_width) for s in (1, 3, 2, 5, 1)]

    def flush(codec):
        b = ec_util.StripeBatcher(sinfo, codec)
        for op, buf in enumerate(bufs):
            b.append(op, buf)
        return b.flush(with_crcs=True)

    gf_cuda.reset_launches()
    crc32c_cuda.reset_launches()
    got = flush(on_card)
    assert gf_cuda.launches == 1 and crc32c_cuda.launches == 1
    for (_, shards, crcs), (_, wshards, wcrcs) in zip(got, flush(on_cpu)):
        assert crcs == wcrcs
        for i in range(11):
            assert np.array_equal(shards[i], wshards[i])
    avail = {i: np.concatenate([r[1][i] for r in got]) for i in range(2, 11)}
    out = ec_util.decode(sinfo, on_card, avail, [0, 1])
    for i in (0, 1):
        assert np.array_equal(out[i], np.concatenate([r[1][i] for r in got]))
