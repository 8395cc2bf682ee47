"""The port's GF(2^8) layer (ceph_tpu_torch.ops) against the JAX package.

Kernel B1's plain version (ops/gf_torch.py) and its wrapper on CPU tensors
are held byte-identical (tolerance 0) to ``ceph_tpu.ops.gf_jax.matvec``
(the CPU stand-in of the Pallas kernel) and to the ``gf256`` host oracle.
The CUDA kernel itself is held to the plain version by
tests/test_torch_cuda.py, which needs a card.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ops import bitmatrix as ref_bitmatrix
from ceph_tpu.ops import gf256 as ref_gf256
from ceph_tpu.ops import gf_jax
from ceph_tpu_torch.ops import backend, bitmatrix, gf256, gf_cuda, gf_torch

RAGGED_N = (1, 15, 16, 100, 4097)


def _data(seed, k, n):
    return np.random.default_rng(seed).integers(0, 256, size=(k, n),
                                                dtype=np.uint8)


def test_host_tables_and_matrices_are_the_references():
    assert np.array_equal(gf256.MUL_TABLE, ref_gf256.MUL_TABLE)
    assert np.array_equal(gf256.INV_TABLE, ref_gf256.INV_TABLE)
    for k, m in ((2, 1), (4, 2), (8, 3), (10, 4)):
        for name in ("rs_vandermonde_matrix", "rs_matrix_isa",
                     "cauchy_matrix_isa", "cauchy_original_matrix"):
            assert np.array_equal(getattr(gf256, name)(k, m),
                                  getattr(ref_gf256, name)(k, m)), (name, k, m)
    mat = gf256.rs_matrix_isa(8, 3)
    assert np.array_equal(bitmatrix.expand_bitmatrix(mat),
                          ref_bitmatrix.expand_bitmatrix(mat))
    d = _data(0, 3, 33)
    assert np.array_equal(bitmatrix.unpack_bits(d), ref_bitmatrix.unpack_bits(d))
    assert np.array_equal(bitmatrix.pack_bits(bitmatrix.unpack_bits(d)), d)


@pytest.mark.parametrize("k,m", list(itertools.product((2, 4, 8), (1, 2, 3, 4))))
def test_plain_matvec_matches_jax_and_oracle(k, m):
    mat = gf256.rs_vandermonde_matrix(k, m)
    for n in RAGGED_N:
        d = _data(k * 100 + m * 10 + n, k, n)
        got = gf_torch.matvec(mat, torch.from_numpy(d)).numpy()
        assert np.array_equal(got, gf_jax.matvec(mat, d)), (k, m, n)
        assert np.array_equal(got, ref_gf256.gf_matvec_chunks(mat, d))


@pytest.mark.parametrize("e", (1, 2, 3))
def test_plain_matvec_decode_matrices(e):
    k, m = 8, 3
    gen = gf256.systematic_generator(gf256.rs_matrix_isa(k, m))
    for lost in itertools.combinations(range(k + m), e):
        present = [i for i in range(k + m) if i not in lost][:k]
        dmat = ref_gf256.decode_matrix(gen, present, list(lost))
        assert np.array_equal(dmat, gf256.decode_matrix(gen, present,
                                                        list(lost)))
        d = _data(sum(lost), k, 777)
        got = gf_torch.matvec(dmat, torch.from_numpy(d)).numpy()
        assert np.array_equal(got, gf_jax.matvec(dmat, d)), lost


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    mat = gf256.rs_matrix_isa(8, 3)
    d = _data(5, 8, 4096 + 3)
    gf_cuda.reset_launches()
    got = gf_cuda.matvec_device(mat, torch.from_numpy(d)).numpy()
    assert np.array_equal(got, gf256.gf_matvec_chunks(mat, d))
    assert gf_cuda.launches == 0


def test_nibble_tables_emulate_kernel_arithmetic():
    """The kernel's per-byte step, lo[b & 15] ^ hi[b >> 4] from the host
    tables, reproduces the field product for every coefficient/byte."""
    coeffs = np.arange(256, dtype=np.uint8)[None, :]
    tab = gf_cuda.nibble_tables(coeffs)[0]                 # [256, 32]
    b = np.arange(256)
    for c in range(256):
        got = tab[c][b & 15] ^ tab[c][16 + (b >> 4)]
        assert np.array_equal(got, ref_gf256.MUL_TABLE[c]), c
    mat = gf256.rs_matrix_isa(8, 3)
    t = gf_cuda.nibble_tables(mat)
    assert t.shape == (3, 8, 32) and t.flags.c_contiguous


def test_backend_dispatch():
    assert backend.resolve_name("auto", "cpu") == "torch"
    assert backend.resolve_name("auto", "cuda") == "cuda"
    with pytest.raises(KeyError):
        backend.resolve_name("pallas", "cpu")
    mat = gf256.cauchy_matrix_isa(4, 2)
    d = _data(9, 4, 1000)
    want = ref_gf256.gf_matvec_chunks(mat, d)
    for name in ("auto", "torch", "numpy", "cuda"):
        got = backend.matvec(mat, torch.from_numpy(d), name).numpy()
        assert np.array_equal(got, want), name


def test_plain_version_has_no_kernel_size_limit():
    big = np.ones((gf_cuda.MAX_M + 1, 4), dtype=np.uint8)
    d = _data(1, 4, 64)
    got = gf_cuda.matvec_device(big, torch.from_numpy(d)).numpy()
    assert np.array_equal(got, ref_gf256.gf_matvec_chunks(big, d))
