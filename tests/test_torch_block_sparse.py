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


def _emulate_kernel(arr, tm, tk, k, data):
    """The CUDA kernel's loop (csrc/gf_block_sparse.cu) over its flat
    plan arrays, in numpy: per group, per occupied block, per column,
    nibble-table lookups into tm accumulator rows; each row written to
    out_row once."""
    n = data.shape[1]
    out = np.full((arr["out_row"].max() + 1, n), 0xAA, dtype=np.uint8)
    lo, hi = data & 15, data >> 4
    for g in range(len(arr["grp_off"]) - 1):
        acc = np.zeros((tm, n), dtype=np.uint8)
        for b in range(arr["grp_off"][g], arr["grp_off"][g + 1]):
            c0 = arr["blk_col"][b] * tk
            for c in range(tk):
                if c0 + c >= k:
                    break
                for r in range(tm):
                    if arr["coefs"][b, r, c]:
                        t = arr["tabs"][b, r, c]
                        acc[r] ^= t[lo[c0 + c]] ^ t[16 + hi[c0 + c]]
        for r in range(tm):
            orow = arr["out_row"][g * tm + r]
            if orow >= 0:
                out[orow] = acc[r]
    return out


@pytest.mark.parametrize("shape,density", [((128, 640), 0.05),
                                           ((24, 33), 0.3), ((8, 16), 0.0)])
def test_kernel_plan_arrays_replay_to_the_product(shape, density):
    mat = _random(shape, density, 3 * sum(shape))
    plan = bs.plan_blocks(mat)
    arr = gf_block_sparse_cuda.plan_arrays(plan)
    assert arr["grp_off"][-1] == len(arr["blk_col"]) == \
        sum(len(occ) for occ, _ in plan.groups)
    data = np.random.default_rng(5).integers(
        0, 256, size=(shape[1], 97), dtype=np.uint8)
    got = _emulate_kernel(arr, plan.tile_m, plan.tile_k, plan.k, data)
    assert np.array_equal(got, gf256.gf_matvec_chunks(mat, data))


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
