"""The port's block-sparse GF matvec (kernel B5's host planner and plain
version, ceph_tpu_torch.ops.gf_block_sparse*) against the JAX package's
(ceph_tpu.ops.gf_block_sparse, its Pallas kernel in interpret mode).

The plan must be the reference's exactly — ``row_order``, ``inv_order``,
each group's block ids, and the group coefficients (the reference carries
their bit-matrix expansion) — and the plain product must give the
reference's bytes. Kernel B5's flat plan arrays are replayed here by a
numpy emulation of the CUDA kernel's loop. Tolerance 0: every result is
bytes. Inputs come from numpy generators with fixed seeds.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.models import instance as ref_instance
from ceph_tpu.ops import gf256 as ref_gf256
from ceph_tpu.ops import gf_block_sparse as ref_bs
from ceph_tpu.ops.gf_pallas import _permute_bitmatrix
from ceph_tpu_torch.ops import gf256
from ceph_tpu_torch.ops import gf_block_sparse as bs
from ceph_tpu_torch.ops import gf_block_sparse_cuda, gf_block_sparse_torch


def _ref_clay(k=8, m=4, d=11):
    return ref_instance().factory("clay", {
        "k": str(k), "m": str(m), "d": str(d), "backend": "numpy"})


def _random(shape, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=shape) *
            (rng.random(shape) < density)).astype(np.uint8)


def _clay_matrices():
    c = _ref_clay()
    return {
        "decode-2": c._decode_matrix(tuple(range(2, 12)), (0, 1)),
        "decode-1": c._decode_matrix(tuple(range(1, 12)), (0,)),
        "repair": c._repair_matrix(0, tuple(range(1, 12))),
        "encode": c._encode_matrix(),
    }


def _assert_same_plan(mat):
    ref = ref_bs.plan_blocks(mat)
    got = bs.plan_blocks(mat)
    assert np.array_equal(got.row_order, ref.row_order)
    assert np.array_equal(got.inv_order, ref.inv_order)
    assert (got.m, got.k, got.kp) == (ref.m, ref.k, ref.kp)
    assert (got.occupancy, got.mac_frac, got.cost_frac) == \
        (ref.occupancy, ref.mac_frac, ref.cost_frac)
    assert got.worthwhile == ref.worthwhile
    assert len(got.groups) == len(ref.groups)
    for (occ, coef), (rocc, rbits) in zip(got.groups, ref.groups):
        assert np.array_equal(occ, rocc)
        if rbits is None:
            assert coef is None
        else:
            assert np.array_equal(
                _permute_bitmatrix(coef).astype(np.float32), rbits)


def test_plan_equals_reference_on_clay_matrices():
    mats = _clay_matrices()
    assert mats["decode-2"].shape == (128, 640)
    assert mats["decode-1"].shape == (64, 704)
    assert mats["repair"].shape == (64, 176)
    for label, mat in mats.items():
        _assert_same_plan(mat)
        assert bs.occupancy_stats(mat) == ref_bs.occupancy_stats(mat), label


@pytest.mark.parametrize("shape,density", [
    ((16, 40), 0.10),
    ((24, 33), 0.30),   # non-multiple-of-tile shapes (padding path)
    ((7, 10), 1.00),    # fully dense
    ((128, 640), 0.05),
    ((8, 16), 0.0),     # all zero: every group empty
])
def test_plan_and_plain_product_equal_reference(shape, density):
    mat = _random(shape, density, sum(shape))
    _assert_same_plan(mat)
    data = np.random.default_rng(shape[0]).integers(
        0, 256, size=(shape[1], 700), dtype=np.uint8)
    want = ref_bs.matvec(mat, data)
    assert np.array_equal(want, gf256.gf_matvec_chunks(mat, data))
    assert np.array_equal(bs.matvec(mat, data), want)
    got = bs.matvec_device(mat, torch.from_numpy(data))
    assert got.device.type == "cpu" and np.array_equal(got.numpy(), want)


def _clay_full(c, rng, size):
    n = c.k + c.m
    chunks = {i: rng.integers(0, 256, size=size, dtype=np.uint8)
              for i in range(c.k)}
    full = dict(chunks)
    full.update(c.encode_chunks(list(range(c.k, n)), chunks))
    return full


def _assert_decode_equal(c, full, size, lost):
    have = {i: v for i, v in full.items() if i not in lost}
    avail = tuple(sorted(have))
    mat = c._decode_matrix(avail, lost)
    x = c._stack(have, avail, c.sub_chunk_no, size // c.sub_chunk_no)
    want = ref_bs.matvec(mat, x)
    got = gf_block_sparse_torch.matvec(bs.plan_blocks(mat),
                                       torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want), lost
    ssc = c.sub_chunk_no
    for row, ch in enumerate(lost):
        assert np.array_equal(got[row * ssc:(row + 1) * ssc].reshape(-1),
                              full[ch]), (lost, ch)


def test_plain_b5_flagship_signatures_match_reference():
    """Data-data, data-parity and parity-parity 2-erasure signatures of
    k=8, m=4, d=11 (as the reference's own test picks them)."""
    c = _ref_clay()
    rng = np.random.default_rng(7)
    size = c.sub_chunk_no * 4
    full = _clay_full(c, rng, size)
    for lost in ((0, 1), (2, 10), (10, 11)):
        _assert_decode_equal(c, full, size, lost)


@pytest.mark.parametrize("d", [5, 4])
def test_plain_b5_every_signature_small_profile(d):
    """Every 1- and 2-erasure signature of clay k=4, m=2 (d=4 has
    virtual nodes)."""
    c = _ref_clay(k=4, m=2, d=d)
    rng = np.random.default_rng(70 + d)
    size = c.sub_chunk_no * 4
    full = _clay_full(c, rng, size)
    for e in (1, 2):
        for lost in itertools.combinations(range(6), e):
            _assert_decode_equal(c, full, size, lost)


#: the kernel's transpose: (shift, mask, word pairs) per stage
_STAGES = ((4, 0x0F0F0F0F, ((0, 4), (1, 5), (2, 6), (3, 7))),
           (2, 0x33333333, ((0, 2), (1, 3), (4, 6), (5, 7))),
           (1, 0x55555555, ((0, 1), (2, 3), (4, 5), (6, 7))))


def _transpose8(w):
    """The CUDA kernel's 12 masked swaps over 8 uint32 arrays."""
    w = list(w)
    for s, mask, pairs in _STAGES:
        for a, b in pairs:
            t = ((w[a] >> s) ^ w[b]) & np.uint32(mask)
            w[b] = w[b] ^ t
            w[a] = w[a] ^ (t << s)
    return w


def _xtime(p):
    """Planes times x modulo 0x11D."""
    h = p[7]
    return [h, p[0], p[1] ^ h, p[2] ^ h, p[3] ^ h, p[4], p[5], p[6]]


def _to_words(rows):
    """[R, N] bytes -> [R, threads, 8] uint32 words, 32 lanes a thread,
    lanes past N zero (as the kernel loads them)."""
    r, n = rows.shape
    threads = -(-n // 32)
    padded = np.zeros((r, threads * 32), dtype=np.uint8)
    padded[:, :n] = rows
    return padded.view("<u4").reshape(r, threads, 8)


def _from_words(w, n):
    """8 uint32 arrays [threads] -> the first n bytes they hold."""
    return np.stack(w, axis=1).astype("<u4").view(np.uint8).reshape(-1)[:n]


def _multiples(p):
    """x^b * planes for b = 0..7 (the kernel's ``mb``)."""
    mb = [p]
    for _ in range(7):
        mb.append(_xtime(mb[-1]))
    return mb


def _mul_add(acc, cf, p):
    """The kernel's ``mul_add``: acc[r] ^= cf[r] * p for 16 coefficient
    bytes, rows tested four at a time (one uint32 word), then one by one,
    then bit by bit."""
    mb = _multiples(p)
    cw = np.ascontiguousarray(cf).view("<u4")
    for q in range(4):
        if cw[q]:
            for j in range(4):
                c = (int(cw[q]) >> (8 * j)) & 0xFF
                for b in range(8):
                    if c >> b & 1:
                        acc[4 * q + j] = [a ^ x for a, x in
                                          zip(acc[4 * q + j], mb[b])]


def _emulate_kernel(arr, data, slices=1):
    """The CUDA kernel's loop (csrc/gf_block_sparse.cu) over its flat
    plan arrays, in numpy, all threads at once: per group, slice s takes
    every slices-th live column from the s-th; per column, transpose the
    thread's 32 bytes into bit planes and multiply-add them into the 16
    accumulator rows; the slices' accumulators are XORed together and
    each row is transposed back and written to out_row once."""
    n = data.shape[1]
    words = _to_words(data)
    threads = words.shape[1]
    out = np.full((arr["out_row"].max() + 1, n), 0xAA, dtype=np.uint8)
    off = arr["grp_off"]
    for g in range(len(off) - 1):
        parts = []
        for s in range(slices):
            acc = [[np.zeros(threads, np.uint32)] * 8 for _ in range(16)]
            for c in range(off[g] + s, off[g + 1], slices):
                p = _transpose8([words[arr["col_row"][c], :, q]
                                 for q in range(8)])
                _mul_add(acc, arr["col_coef"][c], p)
            parts.append(acc)
        for r in range(16):
            orow = arr["out_row"][g * 16 + r]
            if orow >= 0:
                w = parts[0][r]
                for acc in parts[1:]:
                    w = [a ^ x for a, x in zip(w, acc[r])]
                out[orow] = _from_words(_transpose8(w), n)
    return out


def _replay(mat, n, seed, slices=1, tile_m=bs.TILE_M):
    plan = bs.plan_blocks(mat, tile_m)
    arr = gf_block_sparse_cuda.plan_arrays(plan)
    assert arr["grp_off"][-1] == len(arr["col_row"]) == len(arr["col_coef"])
    # only live columns: each has a nonzero coefficient in its group
    assert arr["col_coef"].any(axis=1).all()
    assert arr["col_coef"].dtype == np.uint8 and \
        arr["col_coef"].shape[1:] == (16,)
    assert arr["out_row"].shape == (16 * len(plan.groups),)
    assert sorted(arr["out_row"][arr["out_row"] >= 0]) == \
        list(range(mat.shape[0]))
    data = np.random.default_rng(seed).integers(
        0, 256, size=(mat.shape[1], n), dtype=np.uint8)
    got = _emulate_kernel(arr, data, slices)
    assert np.array_equal(got, gf256.gf_matvec_chunks(mat, data))


@pytest.mark.parametrize("shape,density", [((128, 640), 0.05),
                                           ((24, 33), 0.3), ((8, 16), 0.0)])
def test_kernel_plan_arrays_replay_to_the_product(shape, density):
    _replay(_random(shape, density, 3 * sum(shape)), 97, 5)


@pytest.mark.parametrize("n", [1, 31, 33, 64])
def test_kernel_replay_ragged_tails(n):
    """Lanes past N load as zero and are never stored; N = 64 is the
    ec_util per-stripe shape, which the kernel runs in 4 column slices."""
    _replay(_clay_matrices()["decode-1"], n, n, slices=4 if n == 64 else 1)


@pytest.mark.parametrize("slices", [1, 4])
def test_kernel_replay_column_slices_and_short_groups(slices):
    """Both launch forms, on a plan of 8-row groups (padded to the
    kernel's 16 rows) as well as 16."""
    mat = _random((40, 96), 0.2, 11)
    _replay(mat, 70, 12, slices)
    _replay(mat, 70, 13, slices, tile_m=8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transpose_is_an_involution_mapping_lane_4q_s_to_bit_8s_q(seed):
    rows = np.random.default_rng(seed).integers(0, 256, size=(1, 32 * 5),
                                                dtype=np.uint8)
    words = _to_words(rows)[0]
    w = [words[:, q] for q in range(8)]
    planes = _transpose8(w)
    back = _transpose8(planes)
    assert all(np.array_equal(a, b) for a, b in zip(back, w))
    lanes = rows.reshape(5, 32)
    for i in range(8):
        for q in range(8):
            for s in range(4):
                assert np.array_equal((planes[i] >> (8 * s + q)) & 1,
                                      (lanes[:, 4 * q + s] >> i) & 1)


@pytest.mark.parametrize("high", range(16))
def test_bit_chain_multiply_equals_gf256(high):
    """The kernel's multiply (multiples x^b * data, XORed in for each set
    bit of the coefficient): 16 coefficients a case, all 256 over the
    cases, each in every row slot, against every byte value."""
    data = np.arange(256, dtype=np.uint8)[None, :]
    planes = _transpose8(list(np.moveaxis(_to_words(data)[0], 1, 0)))
    coefs = np.arange(16 * high, 16 * high + 16, dtype=np.uint8)
    for shift in range(16):
        cf = np.roll(coefs, shift)
        acc = [[np.zeros_like(planes[0])] * 8 for _ in range(16)]
        _mul_add(acc, cf, planes)
        for r in range(16):
            got = _from_words(_transpose8(acc[r]), 256)
            assert np.array_equal(got, ref_gf256.gf_mul(cf[r], data[0])), \
                (cf[r], r)


def test_matvec_runs_the_plain_version_for_cpu_tensors():
    mat = _random((32, 64), 0.2, 9)
    data = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, size=(64, 33), dtype=np.uint8))
    gf_block_sparse_cuda.reset_launches()
    got = gf_block_sparse_cuda.matvec(bs.plan_for(mat), data)
    assert gf_block_sparse_cuda.launches == 0
    assert np.array_equal(got.numpy(),
                          gf256.gf_matvec_chunks(mat, data.numpy()))
    with pytest.raises(ValueError):
        gf_block_sparse_torch.matvec(bs.plan_for(mat), data[:10])
