"""The port's XOR-strip codec (ceph_tpu_torch.ops.gf_xor, kernel B6's host
side and plain version) against the JAX package's ``gf_xor_pallas``.

Every comparison is byte-exact (tolerance 0) on inputs made with numpy
seeds. The reference's Pallas body ``_xor_kernel`` runs through a
test-side ``pl.pallas_call`` in interpret mode with the reference's
``BlockSpec``s (``StripCodecKernel.__call__`` itself needs a TPU); the port
runs on ``device="cpu"``, where the wrapper takes the plain version.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ceph_tpu.ops import gf_xor_pallas
from ceph_tpu_torch.models import jerasure
from ceph_tpu_torch.ops import gf256, gf_xor, gf_xor_cuda, gf_xor_torch

K, M = 8, 3


def _matrices():
    gen = gf256.systematic_generator(gf256.rs_matrix_isa(K, M))
    mats = {"isa": gf256.rs_matrix_isa(K, M),
            "isa-cauchy": gf256.cauchy_matrix_isa(K, M),
            "vandermonde": gf256.rs_vandermonde_matrix(K, M),
            "cauchy_good": jerasure.improve_cauchy_matrix(
                gf256.cauchy_original_matrix(K, M))}
    for e in (1, 2, 3):
        mats[f"decode e={e}"] = gf256.decode_matrix(
            gen, list(range(e, e + K)), list(range(e)))
    return mats


MATS = _matrices()


def _bytes(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


def _interpret(mat: np.ndarray, strips: np.ndarray, sb: int = 1):
    """The reference body ``_xor_kernel`` as ``_xor_encode_padded`` calls
    it, in interpret mode."""
    kern = gf_xor_pallas.StripCodecKernel(mat)
    k8, b, _ = strips.shape
    rows = 8 * kern.m_out
    call = pl.pallas_call(
        functools.partial(gf_xor_pallas._xor_kernel, schedule=kern.schedule),
        grid=(b // sb,),
        in_specs=[pl.BlockSpec((k8, sb, 128), lambda i: (0, i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((rows, sb, 128), lambda i: (0, i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((rows, b, 128), jnp.int32),
        interpret=True)
    return np.asarray(call(jnp.asarray(strips)))


@pytest.mark.parametrize("label", sorted(MATS))
def test_schedule_matches_reference(label):
    mat = MATS[label]
    port = gf_xor.StripCodecKernel(mat, device="cpu")
    ref = gf_xor_pallas.StripCodecKernel(mat)
    assert np.array_equal(port.bmat, ref.bmat)
    assert port.schedule == ref.schedule
    assert (port.m_out, port.k_in) == (ref.m_out, ref.k_in)
    arr = gf_xor_cuda.schedule_arrays(port.schedule)
    assert arr["row_off"][-1] == len(arr["idx"]) == port.bmat.sum()
    for r, terms in enumerate(port.schedule):
        lo, hi = arr["row_off"][r], arr["row_off"][r + 1]
        assert tuple(arr["idx"][lo:hi]) == terms


def test_schedule_popcounts_of_the_strip_path():
    """XORs per word position (popcount - rows) of the matrices the card's
    strip path runs: the XOR-count bound in PERF.md."""
    pops = {label: int(gf_xor.StripCodecKernel(MATS[label], "cpu").bmat.sum())
            for label in ("isa", "vandermonde", "decode e=1", "decode e=2",
                          "decode e=3")}
    assert pops == {"isa": 401, "vandermonde": 780, "decode e=1": 64,
                    "decode e=2": 584, "decode e=3": 716}


def test_schedule_rejects_zero_row_as_reference():
    bmat = np.zeros((8, 16), dtype=np.uint8)
    bmat[:3, 1] = 1
    with pytest.raises(ValueError) as ref_exc:
        gf_xor_pallas._schedule_from_bitmatrix(bmat)
    with pytest.raises(ValueError) as port_exc:
        gf_xor._schedule_from_bitmatrix(bmat)
    assert str(port_exc.value) == str(ref_exc.value) == \
        "bit-matrix row 3 is all-zero"


@pytest.mark.parametrize("k,c", [(1, 4096), (4, 1 << 14), (8, 3 * 4096)])
def test_strip_converters_match_reference_and_torch_view_copies_nothing(k, c):
    data = _bytes(k + c, k, c)
    strips = gf_xor.to_strips(data)
    want = gf_xor_pallas.to_strips(data)
    assert strips.dtype == want.dtype == np.int32
    assert strips.shape == want.shape and np.array_equal(strips, want)
    assert np.array_equal(gf_xor.from_strips(strips),
                          gf_xor_pallas.from_strips(want))
    t = torch.from_numpy(data.copy())
    view = gf_xor.to_strips(t)
    assert view.dtype == torch.int32 and tuple(view.shape) == want.shape
    assert view.data_ptr() == t.data_ptr()
    assert np.array_equal(view.numpy(), want)
    back = gf_xor.from_strips(view)
    assert back.data_ptr() == t.data_ptr() and torch.equal(back, t)
    with pytest.raises(AssertionError):
        gf_xor.to_strips(t[:, :c - 1024].contiguous())
    with pytest.raises(ValueError):
        gf_xor.to_strips(torch.zeros((k, 2 * c), dtype=torch.uint8)[:, ::2])


@pytest.mark.parametrize("label,b", [("isa", 2), ("decode e=2", 1)])
def test_plain_matches_interpreted_reference_kernel(label, b):
    mat = MATS[label]
    strips = gf_xor.to_strips(_bytes(b, K, 4096 * b))
    want = _interpret(mat, strips)
    port = gf_xor.StripCodecKernel(mat, device="cpu")
    got = port.encode_strips(torch.from_numpy(strips))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_plain_matches_interpreted_reference_kernel_small_k():
    mat = gf256.rs_matrix_isa(4, 2)
    strips = gf_xor.to_strips(_bytes(11, 4, 3 * 4096))
    want = _interpret(mat, strips, sb=3)
    got = gf_xor_torch.xor_strips(
        gf_xor.StripCodecKernel(mat, "cpu").schedule, torch.from_numpy(strips))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (8, 3)])
def test_plain_matches_reference_oracle_encode_and_every_1_2_erasure(k, m):
    c = 8192
    data = _bytes(k + m, k, c)
    coding = gf256.rs_vandermonde_matrix(k, m)
    gen = gf256.systematic_generator(coding)
    parity = gf_xor.strip_matvec(coding, data, device="cpu")
    assert np.array_equal(parity,
                          gf_xor_pallas.strip_matvec_reference(coding, data))
    chunks = np.concatenate([data, parity], axis=0)
    n = k + m
    for r in (1, min(2, m)):
        for lost in itertools.combinations(range(n), r):
            present = [i for i in range(n) if i not in lost][:k]
            dmat = gf256.decode_matrix(gen, present, list(lost))
            rec = gf_xor.strip_matvec(dmat, chunks[present], device="cpu")
            assert np.array_equal(
                rec, gf_xor_pallas.strip_matvec_reference(dmat,
                                                          chunks[present]))
            assert np.array_equal(rec, chunks[list(lost)]), lost


def test_reference_oracle_copy_matches():
    mat = gf256.rs_matrix_isa(3, 2)
    data = _bytes(6, 3, 1 << 13)
    assert np.array_equal(gf_xor.strip_matvec_reference(mat, data),
                          gf_xor_pallas.strip_matvec_reference(mat, data))


def test_call_strip_matvec_and_kernel_cache_behave_as_reference():
    mat = MATS["isa"]
    data = _bytes(9, K, 2 * 4096)
    want = gf_xor_pallas.strip_matvec_reference(mat, data)
    kern = gf_xor.get_kernel(mat, device="cpu")
    assert kern.device == torch.device("cpu")
    out = kern(data)
    assert isinstance(out, np.ndarray) and out.dtype == np.uint8
    assert np.array_equal(out, want)
    assert np.array_equal(kern(torch.from_numpy(data)), want)
    assert np.array_equal(gf_xor.strip_matvec(mat, data, device="cpu"), want)
    # the cache is keyed by the matrix's bytes and shape (and the device),
    # like the reference's
    assert gf_xor.get_kernel(mat.copy(), "cpu") is kern
    assert gf_xor_pallas.get_kernel(mat.copy()) is \
        gf_xor_pallas.get_kernel(mat)
    assert gf_xor.get_kernel(mat[:2], "cpu") is not kern
    assert gf_xor.get_kernel(mat, "cuda") is not kern
    assert gf_xor.get_kernel(mat, "cuda").device.type == "cuda"
    assert gf_xor._kernel_cache_key.cache_info().maxsize == \
        gf_xor_pallas._kernel_cache_key.cache_info().maxsize == 512
    with pytest.raises(AssertionError):
        kern.encode_strips(torch.zeros((8, 1, 128), dtype=torch.int32))
