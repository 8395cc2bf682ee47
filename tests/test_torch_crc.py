"""The port's crc32c layer against the JAX package.

``ceph_tpu_torch.ops.crc32c_torch.crc_linear_device`` (stage 1 through
kernel B2's wrapper — its plain version on CPU tensors — plus the stage-2
combine) and ``crc32c_from_linear`` are held bit-identical (tolerance 0)
to ``ceph_tpu.ops.crc32c_device.crc_linear_device`` (its XLA branch on
CPU) and to ``ceph_tpu.utils.checksum.crc32c``. The CUDA kernel is held
to the plain version by tests/test_torch_cuda.py, which needs a card;
here its design (basis, tables, field cut, warp reduction, grid and
loads ahead) is replayed in numpy against both.
"""

import re

import numpy as np
import pytest
import torch

from ceph_tpu.ops import crc32c_device as ref_cd
from ceph_tpu.utils import checksum as ref_ck
from ceph_tpu_torch.ops import crc32c_cuda, crc32c_torch as ct, cuda_build
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


@pytest.mark.parametrize("length", (4095, 4096, 4097, 1024 * 5 + 3,
                                    128 << 10, (1 << 20) + 1))
def test_host_crc32c_row_parallel_matches_loop_and_reference(length):
    """From 4 KiB the host crc runs row-parallel (position tables and
    register moves across rows): equal to the table loop and to the
    reference's crc32c for every seed, with and without a partial
    leading row."""
    x = _rows(length, 1, length)[0]
    for s in SEEDS + (0x1234,):
        want = checksum.crc32c_sw(x, s)
        assert checksum.crc32c(x, s) == want
        assert checksum.crc32c(x.tobytes(), s) == want
        assert ref_ck.crc32c(x.tobytes(), s) == want


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


# -- kernel B2's design, replayed in numpy --------------------------------

def _source_default(name):
    text = (cuda_build.CSRC / "crc32c_rows.cu").read_text()
    return int(re.search(rf"#define {name} (\d+)", text).group(1))


FIELD_BITS = _source_default("B2_FIELD_BITS")
DEPTH = _source_default("B2_DEPTH")
LANE_BITS = 128                 # one lane's 16 bytes


def test_b2_constants_match_kernel_source():
    assert crc32c_cuda.ROWS == _source_default("B2_ROWS")
    assert crc32c_cuda.THREADS == _source_default("B2_THREADS")


def _field_widths(field_bits):
    return [min(field_bits, LANE_BITS - s)
            for s in range(0, LANE_BITS, field_bits)]


def _kernel_tables(field_bits):
    """[slots, 32] uint32, slot (field f, value v) at f * 2**field_bits + v,
    column = lane: what a block builds in shared memory, the field's basis
    words XORed in Gray-code order."""
    basis = crc32c_cuda.basis_words()
    widths = _field_widths(field_bits)
    out = np.zeros((((len(widths) - 1) << field_bits) + (1 << widths[-1]),
                    32), dtype=np.uint32)
    for f, wd in enumerate(widths):
        for lane in range(32):
            bp = basis[lane * LANE_BITS + f * field_bits:][:wd]
            acc = np.uint32(0)
            for v in range(1, 1 << wd):
                acc ^= bp[(v & -v).bit_length() - 1]
                out[(f << field_bits) + (v ^ (v >> 1)), lane] = acc
    return out


def _lane_slots(x, field_bits):
    """[rows, 32 lanes, fields] table slots the kernel reads: lane l's 16
    bytes as 4 little-endian words, each field brought to bit 7 by one
    shift (a funnel shift of two words where it crosses one), masked, plus
    the field's first slot."""
    w = np.ascontiguousarray(x).view("<u4").reshape(x.shape[0], 32, 4)
    w = w.astype(np.uint64)
    cols = []
    for f, wd in enumerate(_field_widths(field_bits)):
        q, off = divmod(f * field_bits, 32)
        word = w[..., q]
        if off + wd > 32:
            word = word | (w[..., q + 1] << np.uint64(32))
        u = ((word << np.uint64(7)) >> np.uint64(off)) & np.uint64(0xFFFFFFFF)
        cols.append((f << field_bits) +
                    ((u >> np.uint64(7)) & np.uint64((1 << wd) - 1)))
    return np.stack(cols, axis=-1).astype(np.int64)


def _reduce_rows(parts):
    """The warp reduction: parts [32 lanes, R] -> [32] after the halving
    exchanges (offsets 16, 8, ..., a lane keeping the upper half where its
    offset bit is set) and the butterfly over the offsets left; lane l
    then holds row l >> (5 - log2 R)."""
    a = parts.copy()
    r = a.shape[1]
    lanes = np.arange(32)
    o = 16
    while a.shape[1] > 1:
        h = a.shape[1] // 2
        up = (lanes & o) != 0
        send = np.where(up[:, None], a[:, :h], a[:, h:])
        keep = np.where(up[:, None], a[:, h:], a[:, :h])
        a = keep ^ send[lanes ^ o]
        o >>= 1
    a = a[:, 0]
    o = 16 >> (r.bit_length() - 1)
    while o >= 1:
        a = a ^ a[lanes ^ o]
        o >>= 1
    return a


def _packed(bits):
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        axis=1).astype(np.uint32)


@pytest.mark.parametrize("field_bits", (FIELD_BITS, 4, 5))
def test_b2_basis_and_tables_match_reference(field_bits):
    basis = crc32c_cuda.basis_words()
    ref_basis = _packed(ref_cd._B_matrix(512))
    assert basis.dtype == np.uint32 and np.array_equal(basis, ref_basis)
    tables = _kernel_tables(field_bits)
    widths = _field_widths(field_bits)
    assert sum(widths) == LANE_BITS
    lanes = np.arange(32)
    rng = np.random.default_rng(field_bits)
    zeros = ref_cd.zeros_crc(512, 0)
    for f, wd in enumerate(widths):
        v = np.arange(1 << wd)
        want = np.zeros((1 << wd, 32), dtype=np.uint32)
        for b in range(wd):
            word = ref_basis[lanes * LANE_BITS + f * field_bits + b]
            want ^= np.where((v[:, None] >> b) & 1 == 1, word[None, :], 0
                             ).astype(np.uint32)
        got = tables[(f << field_bits):(f << field_bits) + (1 << wd)]
        assert np.array_equal(got, want), f
        # the affine identity: L(row) = crc32c(row, 0) ^ crc32c(0^512, 0)
        for lane in (0, int(rng.integers(1, 31)), 31):
            val = int(rng.integers(1, 1 << wd))
            row = np.zeros(512 * 8, dtype=np.uint8)
            for b in range(wd):
                row[lane * LANE_BITS + f * field_bits + b] = (val >> b) & 1
            data = np.packbits(row, bitorder="little").tobytes()
            assert int(got[val, lane]) == ref_ck.crc32c(data, 0) ^ zeros


def _replay_b2(x, field_bits, rows_per_batch, depth, sms, threads):
    """Kernel B2 in numpy: the grid (one block an SM, fewer for few rows),
    each warp's batches and the rows it loads ahead, the field cut and
    table words of each lane, the warp reduction and the lanes that
    store. Checks that every row a step reads is the row loaded for it
    and that every row is stored once."""
    n = x.shape[0]
    r_, d_ = rows_per_batch, min(depth, rows_per_batch)
    tables = _kernel_tables(field_bits)
    lanes = np.arange(32)
    parts = np.bitwise_xor.reduce(
        tables[_lane_slots(x, field_bits), lanes[None, :, None]], axis=2)
    batches = -(-n // r_)
    wpb = threads // 32
    nw = min(sms, -(-batches // wpb)) * wpb
    shift = 5 - (r_.bit_length() - 1)
    out = np.full(n, -1, dtype=np.int64)
    for gw in range(nw):
        b = gw
        buf = [b * r_ + d for d in range(d_)]
        while b < batches:
            acc = np.zeros((32, r_), dtype=np.uint32)
            for j in range(r_):
                row = buf[j % d_]
                assert row == b * r_ + j
                buf[j % d_] = (b * r_ + j + d_ if j + d_ < r_
                               else (b + nw) * r_ + j + d_ - r_)
                if row < n:
                    acc[:, j] = parts[row]
            red = _reduce_rows(acc)
            for lane in range(32):
                row = b * r_ + (lane >> shift)
                if lane & (32 // r_ - 1) == 0 and row < n:
                    assert out[row] == -1
                    out[row] = red[lane]
            b += nw
    assert (out >= 0).all()
    return out


def _b2_inputs(kind):
    if kind == "random":           # not a multiple of any tile
        return _rows(10, 8 * 37 + 3, 512)
    if kind == "zeros":
        return np.zeros((17, 512), dtype=np.uint8)
    bits = np.eye(512 * 8, dtype=np.uint8)       # one bit at every column
    return np.packbits(bits, axis=1, bitorder="little")


B2_FORMS = {            # field bits, rows reduced together, depth, SMs
    "committed": (FIELD_BITS, crc32c_cuda.ROWS, DEPTH, 132),
    "committed, 3 SMs": (FIELD_BITS, crc32c_cuda.ROWS, DEPTH, 3),
    "nibbles, 32 rows": (4, 32, 4, 2),
    "5 bits, a row a warp": (5, 1, 1, 132),
}


@pytest.mark.parametrize("form", list(B2_FORMS))
@pytest.mark.parametrize("kind", ("random", "zeros", "single bits"))
def test_b2_replay_equals_plain_and_reference(form, kind):
    x = _b2_inputs(kind)
    field_bits, rows, depth, sms = B2_FORMS[form]
    got = _replay_b2(x, field_bits, rows, depth, sms, crc32c_cuda.THREADS)
    plain = ct.crc_rows(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, plain)
    ref = np.asarray(ref_cd.crc_linear_device(x)).astype(np.int64)
    assert np.array_equal(got, ref)
