"""The port's GF(2^8) layer (ceph_tpu_torch.ops) against the JAX package.

Kernel B1's plain version (ops/gf_torch.py) and its wrapper on CPU tensors
are held byte-identical (tolerance 0) to ``ceph_tpu.ops.gf_jax.matvec``
(the CPU stand-in of the Pallas kernel) and to the ``gf256`` host oracle,
and so is a numpy replay of the CUDA kernel's arithmetic (csrc/gf_matvec.cu:
transpose, multiply-by-x chain, parameter block, row-block passes, edges).
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


# -- kernel B1's arithmetic (csrc/gf_matvec.cu), replayed in numpy ---------

def _transpose8(w):
    """csrc/gf_matvec.cu's transpose8 on [..., 8] uint32 words: 12 masked
    swaps, its own inverse."""
    w = w.copy()

    def swap(a, b, s, mask):
        t = ((w[..., a] >> np.uint32(s)) ^ w[..., b]) & np.uint32(mask)
        w[..., b] ^= t
        w[..., a] ^= t << np.uint32(s)

    for q in range(4):
        swap(q, q + 4, 4, 0x0F0F0F0F)
    for a, b in ((0, 2), (1, 3), (4, 6), (5, 7)):
        swap(a, b, 2, 0x33333333)
    for q in range(0, 8, 2):
        swap(q, q + 1, 1, 0x55555555)
    return w


def _xtime8(p):
    """x * p in bit-plane form modulo 0x11d: 3 XORs, the rest renaming."""
    h = p[..., 7]
    return np.stack([h, p[..., 0], p[..., 1] ^ h, p[..., 2] ^ h,
                     p[..., 3] ^ h, p[..., 4], p[..., 5], p[..., 6]], axis=-1)


def _split_block(blk, k):
    """coef_block's two parts: mask [k, 8] uint32, steps [k]."""
    return blk[:32 * k].view("<u4").reshape(k, 8), blk[32 * k:]


def _replay_b1(mat, data, plan, vec):
    """csrc/gf_matvec.cu in numpy on the grid of ``plan``: block b runs
    pass b % passes (output rows rows*pass..) of lane tile b // passes;
    a thread's 32 lanes are the 16-byte pieces at 16t and 512 + 16t of its
    warp's 1 KiB span, loaded as 8 little-endian words (zero past N; on
    the 16-byte path a piece lies wholly in or out), transposed to bit
    planes, multiplied along the chain with the parameter block's row
    masks, and each finished row transposed back and stored where the
    lane is below N. Threads are vectorized; every lane of every output
    row must be stored exactly once."""
    m, k = mat.shape
    n = data.shape[1]
    mask, steps = _split_block(gf_cuda.coef_block(mat), k)
    rows, passes = plan.rows, plan.passes
    tiles, extra = divmod(plan.blocks, passes)
    assert extra == 0
    assert sorted((b // passes, b % passes) for b in range(plan.blocks)) == \
        [(t, p) for t in range(tiles) for p in range(passes)]
    t = np.arange(tiles * gf_cuda.THREADS)
    base = (t >> 5) * 1024 + (t & 31) * 16
    base = base[base < n]                       # threads past N return
    cols = base[:, None] + np.r_[0:16, 512:528][None, :]
    inb = cols < n
    if vec:
        assert n % 16 == 0 and inb[:, :16].all()
        assert (inb[:, 16:].all(axis=1) | ~inb[:, 16:].any(axis=1)).all()
    vals = np.where(inb[None], data[:, np.minimum(cols, n - 1)], 0)
    words = np.ascontiguousarray(vals.astype(np.uint8)).view("<u4")
    out = np.zeros((m, n), dtype=np.uint8)
    stores = np.zeros((m, n), dtype=np.int64)
    for p in range(passes):
        row0 = p * rows
        acc = np.zeros((rows,) + words.shape[1:], dtype=np.uint32)
        for j in range(k):
            if steps[j] == 0:
                continue                        # a zero column: no load
            x = _transpose8(words[j])
            for s in range(int(steps[j])):
                if s:
                    x = _xtime8(x)
                live = int(mask[j, s]) >> row0
                for r in range(rows):
                    if (live >> r) & 1:
                        acc[r] ^= x
        for r in range(rows):
            if row0 + r >= m:
                break
            y = np.ascontiguousarray(_transpose8(acc[r])).view(np.uint8)
            out[row0 + r, cols[inb]] = y[inb]
            np.add.at(stores[row0 + r], cols[inb], 1)
    assert (stores == 1).all()
    return out


def _b1_matrices(which):
    """The replay's matrices: the ISA k=8, m=3 encode, every decode
    matrix of 1, 2 or 3 erasures of it, or a random 32 x 128 one."""
    k, m = 8, 3
    isa = gf256.rs_matrix_isa(k, m)
    if which == "encode":
        return [isa]
    if which == "random 32x128":
        return [_data(32128, 32, 128)]
    e = int(which[-1])
    gen = gf256.systematic_generator(isa)
    mats = []
    for lost in itertools.combinations(range(k + m), e):
        present = [i for i in range(k + m) if i not in lost][:k]
        mats.append(gf256.decode_matrix(gen, present, list(lost)))
    return mats


B1_REPLAY_N = (1, 31, 32, 33, 4097)


@pytest.mark.parametrize("which,part", [
    ("encode", 0), ("decode e=1", 0), ("decode e=2", 0), ("decode e=3", 0),
    ("decode e=3", 1), ("decode e=3", 2), ("random 32x128", 0)])
def test_b1_bitsliced_replay_matches_jax_and_oracle(which, part):
    """The kernel's arithmetic, partition and edges (numpy replay) give
    gf_jax.matvec's and the gf256 oracle's bytes at every N of
    B1_REPLAY_N (N = 32 runs the 16-byte path, the others the byte
    path). The 165 matrices of e = 3 are
    split in three parts. gf_jax.matvec runs once per matrix at the
    largest N; a product's first n columns are those of its first n
    data columns."""
    mats = _b1_matrices(which)
    for i in range(part, len(mats), 3 if which == "decode e=3" else 1):
        mat = mats[i]
        full = _data(1000 * i + 7, mat.shape[1], max(B1_REPLAY_N))
        want_full = ref_gf256.gf_matvec_chunks(mat, full)
        assert np.array_equal(gf_jax.matvec(mat, full), want_full), (which, i)
        for n in B1_REPLAY_N:
            plan = gf_cuda.launch_plan(n, mat.shape[0])
            got = _replay_b1(mat, full[:, :n], plan, vec=n % 16 == 0)
            assert np.array_equal(got, want_full[:, :n]), (which, i, n, plan)


@pytest.mark.parametrize("m", (2, 4, 5, 16, 17, 32))
def test_b1_replay_row_blocks_and_passes(m):
    """Each row-block template and the multi-pass case: m = 2 fills the
    2-row block, 4 the 4-row block, 5 and 16 one 16-row pass, 17 and 32
    two passes (the second re-reading the data), over 16-byte and byte
    paths."""
    mat = _data(m, m, 8)
    mat[:, 3] = 0                               # a zero column is skipped
    for n in (33, 2048, 2048 + 512 + 16):
        d = _data(m + n, 8, n)
        plan = gf_cuda.launch_plan(n, m)
        assert plan.rows == (2 if m <= 2 else 4 if m <= 4 else 16)
        assert plan.passes == -(-m // plan.rows)
        got = _replay_b1(mat, d, plan, vec=n % 16 == 0)
        assert np.array_equal(got, ref_gf256.gf_matvec_chunks(mat, d)), n


def test_b1_coef_block_is_the_reference_bit_matrix():
    """Bit i of mask[j, s] is B[8i+s, 8j] of the reference's
    expand_bitmatrix, and the chain from it rebuilds every other column
    of B's 8x8 blocks; steps[j] is column j's top set bit + 1 (0 for a
    zero column, which the kernel never loads)."""
    isa = gf256.rs_matrix_isa(8, 3)
    gen = gf256.systematic_generator(isa)
    rand = _data(7, 32, 128)
    rand[:, 5] = 0
    mats = [isa, gf256.decode_matrix(gen, list(range(2, 10)), [0, 1]),
            np.ones((1, 8), np.uint8), rand]
    for mat in mats:
        m, k = mat.shape
        blk = gf_cuda.coef_block(mat)
        assert blk.dtype == np.uint8 and blk.shape == (33 * k,)
        mask, steps = _split_block(blk, k)
        ref = ref_bitmatrix.expand_bitmatrix(mat)
        bits = (mask[None, :, :] >> np.arange(m, dtype=np.uint32)[:, None,
                                                                 None]) & 1
        assert np.array_equal(bits, ref[:, 0::8].reshape(m, 8, k)
                              .transpose(0, 2, 1)), mat.shape
        assert np.array_equal(steps, [max(int(v).bit_length()
                                          for v in mat[:, j])
                                      for j in range(k)])
        # column c of block (i, j) is c_ij * x^c: the chain's c-th step
        # applied to the plane-basis vector of bit 0
        for c in range(8):
            unit = np.zeros((8,), dtype=np.uint32)
            unit[0] = 1
            for _ in range(c):
                unit = _xtime8(unit)
            col = np.zeros((m, k, 8), dtype=np.uint32)
            for s in range(8):
                chain = unit.copy()
                for _ in range(s):
                    chain = _xtime8(chain)
                on = bits[:, :, s].astype(bool)
                col[on] ^= chain
            assert np.array_equal(col.transpose(0, 2, 1).reshape(8 * m, k),
                                  ref[:, c::8]), (mat.shape, c)
    assert gf_cuda.coef_block(np.zeros((2, 3), np.uint8))[-3:].tolist() == \
        [0, 0, 0]


def test_b1_launch_plan():
    """Row block from m, passes, and one block of 256 threads per tile of
    8 Ki lanes and pass: the least grid that covers every lane, which
    the C launcher takes as it is (and refuses when it does not cover)."""
    assert gf_cuda.launch_plan(1 << 24, 3) == (4, 1, (1 << 24) // 8192)
    assert gf_cuda.launch_plan(1 << 24, 2).rows == 2
    assert gf_cuda.launch_plan(1 << 24, 1).rows == 2
    assert gf_cuda.launch_plan(1 << 24, 32) == (16, 2, 2 * (1 << 24) // 8192)
    assert gf_cuda.launch_plan(4096, 1) == (2, 1, 1)
    for n in (1, 1023, 1025, 8192, 8193, 65536 + 7, 1 << 22):
        for m in (1, 4, 5, 16, 17, 32):
            p = gf_cuda.launch_plan(n, m)
            assert p.rows in gf_cuda.ROW_BLOCKS
            assert p.blocks % p.passes == 0
            assert p.passes * p.rows >= m > (p.passes - 1) * p.rows
            tiles = p.blocks // p.passes
            assert tiles * gf_cuda.THREADS * 32 >= n > (tiles - 1) * 8192


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
