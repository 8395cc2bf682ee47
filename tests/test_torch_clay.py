"""The port's Clay codec (ceph_tpu_torch.models.clay, .clay_device) against
the JAX package's (ceph_tpu.models.clay, .clay_device).

- the host tables (``trace_layered``, ``pft_coefficients``,
  ``build_encode_fast(tables_only)``, ``build_decode_tables``) equal the
  reference's;
- kernel B3's plain version against the reference ``build_encode_kernel``
  (Pallas, interpret mode), kernel B4's plain version against the
  reference ``build_transform_kernel`` (interpret mode) and
  ``build_transform``; ``build_encode_fused`` against the reference's;
- the flat tables the CUDA kernels B3 and B4 read are replayed by numpy
  emulations of the kernels' loops and must give the plain versions'
  bytes (the kernels themselves run only on the card:
  tests/test_torch_cuda.py); the bit-sliced B3 and B4 are replayed with
  their thread partitions and launch plans, B4's also against the
  reference transform;
- the codec (encode, every 1- and 2-erasure decode, single-node repair)
  on every backend route, ``ec_util`` with Clay, and
  ``from_reference_profile``, against the reference codec.

Tolerance 0: every result is bytes. Inputs come from numpy generators
with fixed seeds.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.models import clay_device as ref_cd
from ceph_tpu.models import instance as ref_instance
from ceph_tpu.osd import ec_util as ref_ec
from ceph_tpu_torch.models import clay_device as cd
from ceph_tpu_torch.models import from_reference_profile, instance
from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.ops import clay_cuda, gf256, gf_block_sparse_cuda
from ceph_tpu_torch.ops import gf_cuda, gf_torch
from ceph_tpu_torch.osd import ec_util

FLAGSHIP = dict(k=8, m=4, d=11)
VIRTUAL = dict(k=4, m=3, d=6)          # nu = 2 virtual nodes
SMALL = dict(k=4, m=2, d=5)


def _prof(profile, **extra):
    out = {str(k): str(v) for k, v in profile.items()}
    out.update({k: str(v) for k, v in extra.items()})
    return out


def ref_codec(profile, **extra):
    return ref_instance().factory(
        "clay", _prof(profile, backend="numpy", **extra))


def port_codec(profile, **extra):
    return instance().factory("clay", _prof(profile, **extra), device="cpu")


def _padded_erased(c, lost):
    erased = {c._node_id(i) for i in lost}
    for i in range(c.k + c.nu, c.q * c.t):
        if len(erased) >= c.m:
            break
        erased.add(i)
    return frozenset(erased)


def _data(c, sc, seed):
    rng = np.random.default_rng(seed)
    return {i: rng.integers(0, 256, c.sub_chunk_no * sc, dtype=np.uint8)
            for i in range(c.k)}


def _full(c, data):
    full = dict(data)
    full.update(c.encode_chunks(list(range(c.k, c.k + c.m)), data))
    return full


def _node_input(c, chunks, erased, sc):
    cin = np.zeros((c.q * c.t, c.sub_chunk_no, sc), dtype=np.uint8)
    for i, buf in chunks.items():
        if c._node_id(i) not in erased:
            cin[c._node_id(i)] = np.asarray(buf).reshape(c.sub_chunk_no, sc)
    return cin


# -- host tables ---------------------------------------------------------

def _same_levels(a, b):
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        for name in ("ident", "pair_a", "planes", "ident2", "type_c",
                     "pair_b"):
            assert getattr(la, name) == getattr(lb, name), name


def _same_tables(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        va, vb = a[key], b[key]
        if isinstance(va, list) and va and isinstance(va[0], tuple):
            assert [x[0] for x in va] == [x[0] for x in vb], key
            for (_, ta), (_, tb) in zip(va, vb):
                assert np.array_equal(ta, tb), key
        elif isinstance(va, list):
            assert len(va) == len(vb), key
            for xa, xb in zip(va, vb):
                assert np.array_equal(np.asarray(xa), np.asarray(xb)), key
        else:
            assert np.array_equal(np.asarray(va), np.asarray(vb)), key


@pytest.mark.parametrize("profile", [FLAGSHIP, VIRTUAL, SMALL],
                         ids=["k8m4d11", "k4m3d6", "k4m2d5"])
def test_host_tables_equal_reference(profile):
    ref, port = ref_codec(profile), port_codec(profile)
    assert (port.q, port.t, port.nu, port.sub_chunk_no) == \
        (ref.q, ref.t, ref.nu, ref.sub_chunk_no)
    coeffs = cd.pft_coefficients(port)
    ref_coeffs = ref_cd.pft_coefficients(ref)
    assert sorted(coeffs) == sorted(ref_coeffs)
    for key in coeffs:
        assert np.array_equal(coeffs[key], ref_coeffs[key]), key
    _same_tables(cd.build_encode_fast(port, tables_only=True).tables,
                 ref_cd.build_encode_fast(ref, tables_only=True).tables)
    qt = port.q * port.t
    sigs = [_padded_erased(port, lost) for lost in
            ([0], [0, 1], [port.k, port.k + port.m - 1])]
    if qt <= 9:
        sigs += [frozenset(er) for er in
                 itertools.combinations(range(qt), port.m)]
    for erased in sigs:
        _same_levels(cd.trace_layered(port, erased),
                     ref_cd.trace_layered(ref, erased))
        _same_tables(cd.build_decode_tables(port, erased),
                     ref_cd.build_decode_tables(ref, erased))
    coef = np.random.default_rng(1).integers(0, 256, (40, 1), np.uint8)
    bits, tab = cd._vartabs_of(coef)
    rbits, rtab = ref_cd._vartabs_of(coef)
    assert bits == rbits and np.array_equal(tab, rtab)


# -- kernel B3's plain version ------------------------------------------

@pytest.mark.parametrize("profile,sc", [(FLAGSHIP, 40), (VIRTUAL, 9)],
                         ids=["k8m4d11", "k4m3d6"])
def test_plain_b3_equals_reference_encode_kernel(profile, sc):
    ref, port = ref_codec(profile), port_codec(profile)
    data = _data(ref, sc, 23)
    x = np.stack([data[i].reshape(ref.sub_chunk_no, sc)
                  for i in range(ref.k)])
    want = np.asarray(ref_cd.build_encode_kernel(ref)(x))
    enc = cd.build_encode_kernel(port)
    clay_cuda.reset_launches()
    got = enc(torch.from_numpy(x))
    assert clay_cuda.encode_launches == 0          # CPU: plain version
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(cd.build_encode_fast(port)(
        torch.from_numpy(x)).numpy(), want)
    host = ref.encode_chunks(list(range(ref.k, ref.k + ref.m)), data)
    for p in range(ref.m):
        assert np.array_equal(want[p].reshape(-1), host[ref.k + p])


@pytest.mark.parametrize("profile,sc", [(FLAGSHIP, 40), (VIRTUAL, 9)],
                         ids=["k8m4d11", "k4m3d6"])
def test_encode_fused_equals_reference_and_fast(profile, sc):
    """The counterpart of the reference's
    ``test_encode_fused_xla_bit_exact`` (seed 29, ``ssc * sc``-byte
    chunks): the port's one-function composition, its MDS stage one
    bit-sliced ``torch.matmul``, gives the reference's
    ``build_encode_fused`` bytes, the plain B3's and the host oracle's.
    No kernel launches: it is plain torch on either device."""
    ref, port = ref_codec(profile), port_codec(profile)
    rng = np.random.default_rng(29)
    ssc, k, m = ref.sub_chunk_no, ref.k, ref.m
    data = {i: rng.integers(0, 256, ssc * sc, dtype=np.uint8)
            for i in range(k)}
    x = np.stack([data[i].reshape(ssc, sc) for i in range(k)])
    want = np.asarray(ref_cd.build_encode_fused(ref)(x))
    fused = cd.build_encode_fused(port)
    clay_cuda.reset_launches()
    got = fused(torch.from_numpy(x))
    assert clay_cuda.encode_launches == 0
    assert got.dtype == torch.uint8 and got.shape == (m, ssc, sc)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, cd.build_encode_fast(port)(torch.from_numpy(x)))
    host = ref.encode_chunks(list(range(k, k + m)), data)
    for p in range(m):
        assert np.array_equal(want[p].reshape(-1), np.asarray(host[k + p]))


def _mul(c, v):
    return gf256.MUL_TABLE[int(c)][v]


def _emulate_encode(arr, x):
    """csrc/clay_encode.cu's loops over its tables, in numpy (lanes
    vectorized): u_d per plane, its MDS product into u_p, then the
    recouple reading u_p across planes."""
    kk, ssc, m = arr["kk"], arr["ssc"], arr["m"]
    L = x.shape[1]

    def term(c, row):
        if c == 0 or row < 0:
            return np.zeros(L, dtype=np.uint8)
        return _mul(c, x[row])

    up = np.zeros((m * ssc, L), dtype=np.uint8)
    for z in range(ssc):
        for j in range(kk):
            f = j * ssc + z
            ud = term(arr["a1"][f], arr["ps_row"][f]) ^ \
                term(arr["a2"][f], arr["pa_row"][f])
            for i in range(m):
                up[i * ssc + z] ^= _mul(arr["dmat"][i, j], ud)
    out = np.empty((m * ssc, L), dtype=np.uint8)
    for r in range(m * ssc):
        v = term(arr["b1"][r], arr["pc_row"][r]) ^ _mul(arr["b2"][r], up[r])
        if arr["b3"][r]:
            v ^= _mul(arr["b3"][r], up[arr["pu"][r]])
        out[r] = v
    return out


@pytest.mark.parametrize("profile", [FLAGSHIP, VIRTUAL, SMALL],
                         ids=["k8m4d11", "k4m3d6", "k4m2d5"])
def test_b3_kernel_tables_replay_to_plain(profile):
    port = port_codec(profile)
    sc = 7
    data = _data(port, sc, 5)
    x = np.stack([data[i].reshape(port.sub_chunk_no, sc)
                  for i in range(port.k)])
    fast = cd.build_encode_fast(port)
    want = fast(torch.from_numpy(x)).numpy()
    arr = cd.encode_kernel_arrays(fast.tables)
    got = _emulate_encode(arr, x.reshape(-1, sc))
    assert np.array_equal(got.reshape(want.shape), want)


def _transpose8(w):
    """csrc/clay_encode.cu's transpose8 on [..., 8] uint32 words: 12 masked
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


def _mul_acc(acc, x, c, nb):
    """acc ^= c * x along the chain, one masked XOR per bit 0..nb of c."""
    for b in range(8):
        if b > nb:
            break
        if b:
            x = _xtime8(x)
        acc ^= x & np.uint32(0xFFFFFFFF if (int(c) >> b) & 1 else 0)
    return acc


def _emulate_bitsliced(arr, x, plan):
    """csrc/clay_encode.cu in numpy, form and tile from ``plan``
    (clay_cuda.launch_plan): its items, loads (32 lanes per group, zero
    past L), bit-plane arithmetic, u_p in the kernel's shared-memory
    layout [word][row][group] (the short form XOR-reducing the MDS terms
    into it), recouple and stores. Lanes are vectorized over the blocks,
    the thread partition is replayed item by item."""
    kk, ssc, m = arr["kk"], arr["ssc"], arr["m"]
    rows, L = m * ssc, x.shape[1]
    g_n, blocks = plan.groups, plan.blocks
    nb = {name: clay_cuda._top_bit(arr[name])
          for name in ("a1", "a2", "dmat", "b1", "b2", "b3")}
    pad = np.zeros((x.shape[0], blocks * g_n * 32), dtype=np.uint8)
    pad[:, :L] = x
    words = pad.view("<u4").reshape(x.shape[0], blocks, g_n, 8)
    up = np.zeros((blocks, 8 * rows * g_n), dtype=np.uint32)

    def row_term(acc, c, bits, row, g):
        if c == 0 or row < 0:
            return acc
        return _mul_acc(acc, _transpose8(words[row, :, g]), c, bits)

    pg = ssc * g_n
    items = pg * kk if plan.split else pg
    seen = set()
    for t in range(plan.threads):
        for it in range(t, items, plan.threads):
            j0 = it // pg if plan.split else 0
            zg = it - j0 * pg if plan.split else it
            z, g = divmod(zg, g_n)
            for j in range(j0, j0 + 1 if plan.split else kk):
                assert (j, z, g) not in seen
                seen.add((j, z, g))
            for i0 in range(0, m, 4):
                acc = np.zeros((4, blocks, 8), dtype=np.uint32)
                for j in range(j0, j0 + 1 if plan.split else kk):
                    f = j * ssc + z
                    ud = np.zeros((blocks, 8), dtype=np.uint32)
                    ud = row_term(ud, arr["a1"][f], nb["a1"],
                                  arr["ps_row"][f], g)
                    ud = row_term(ud, arr["a2"][f], nb["a2"],
                                  arr["pa_row"][f], g)
                    for b in range(nb["dmat"] + 1):
                        if b:
                            ud = _xtime8(ud)
                        for ii in range(4):
                            i = i0 + ii
                            c = int(arr["dmat"][i, j]) if i < m else 0
                            if (c >> b) & 1:
                                acc[ii] ^= ud
                for ii in range(min(4, m - i0)):
                    for w in range(8):
                        idx = (w * rows + (i0 + ii) * ssc + z) * g_n + g
                        if plan.split:
                            up[:, idx] ^= acc[ii][:, w]
                        else:
                            up[:, idx] = acc[ii][:, w]
    assert len(seen) == kk * ssc * g_n
    out = np.zeros((rows, blocks, g_n, 8), dtype=np.uint32)
    done = set()
    for t in range(plan.threads):
        for it in range(t, rows * g_n, plan.threads):
            r, g = divmod(it, g_n)
            done.add((r, g))
            v = np.zeros((blocks, 8), dtype=np.uint32)
            v = row_term(v, arr["b1"][r], nb["b1"], arr["pc_row"][r], g)
            xr = np.stack([up[:, (w * rows + r) * g_n + g]
                           for w in range(8)], axis=-1)
            v = _mul_acc(v, xr, arr["b2"][r], nb["b2"])
            if arr["b3"][r]:
                r3 = arr["pu"][r]
                x3 = np.stack([up[:, (w * rows + r3) * g_n + g]
                               for w in range(8)], axis=-1)
                v = _mul_acc(v, x3, arr["b3"][r], nb["b3"])
            out[r, :, g] = _transpose8(v)
    assert len(done) == rows * g_n
    return out.reshape(rows, -1).view(np.uint8)[:, :L]


#: ragged lane counts around both forms' tiles: the short form's 64 lanes
#: and the full form's 256 (k=8,m=4,d=11 at G=8)
REPLAY_L = (1, 63, 64, 65, 255, 256, 257)


@pytest.mark.parametrize("form", ["full", "short"])
@pytest.mark.parametrize("profile", [FLAGSHIP, VIRTUAL, SMALL],
                         ids=["k8m4d11", "k4m3d6", "k4m2d5"])
def test_b3_bitsliced_replay_equals_plain_and_reference(profile, form):
    """The bit-sliced kernel's arithmetic and partition, replayed on the
    CPU, gives build_encode_fast's and the reference codec's bytes."""
    ref, port = ref_codec(profile), port_codec(profile)
    fast = cd.build_encode_fast(port)
    arr = cd.encode_kernel_arrays(fast.tables)
    # sms=1 always takes the full form, a huge SM count the short one
    sms = 1 if form == "full" else 1 << 30
    for L in REPLAY_L:
        data = _data(ref, L, 100 + L)
        x = np.stack([data[i].reshape(port.sub_chunk_no, L)
                      for i in range(port.k)])
        plan = clay_cuda.launch_plan(L, port.m, port.sub_chunk_no,
                                     arr["kk"], sms)
        assert plan.split == (form == "short")
        got = _emulate_bitsliced(arr, x.reshape(-1, L), plan)
        want = fast(torch.from_numpy(x)).numpy()
        assert np.array_equal(got.reshape(want.shape), want), L
        host = ref.encode_chunks(list(range(ref.k, ref.k + ref.m)), data)
        for p in range(ref.m):
            assert np.array_equal(got[p * port.sub_chunk_no:
                                      (p + 1) * port.sub_chunk_no]
                                  .reshape(-1), host[ref.k + p]), (L, p)


def test_b3_bitsliced_helpers_match_gf_arithmetic():
    """The transpose is its own inverse and maps byte lanes to bit planes;
    the chain and masked multiply equal GF(2^8) products lane by lane."""
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, (5, 32), dtype=np.uint8)
    w = raw.view("<u4").reshape(5, 8)
    planes = _transpose8(w)
    assert np.array_equal(_transpose8(planes), w)
    for lane in range(32):
        q, s = divmod(lane, 4)
        bits = (planes >> np.uint32(8 * s + q)) & np.uint32(1)
        want = (raw[:, lane, None] >> np.arange(8)) & 1
        assert np.array_equal(bits, want.astype(np.uint32)), lane
    for c in (1, 2, 3, 0x1d, 0x80, 231, 255):
        acc = _mul_acc(np.zeros_like(planes), planes, c,
                       clay_cuda._top_bit(np.array([c], np.uint8)))
        got = _transpose8(acc).reshape(5, 8).view(np.uint8)
        assert np.array_equal(got, _mul(c, raw)), c


def test_b3_launch_plan_picks_form_and_refuses_oversize():
    """Full form where its grid fills the card, short form below; a
    profile whose u_p exceeds a block's shared memory is refused."""
    full = clay_cuda.launch_plan(1 << 18, 4, 64, 8, 132)
    assert (full.split, full.groups, full.threads, full.blocks,
            full.smem) == (False, 8, 256, 1024, 64 * 1024)
    short = clay_cuda.launch_plan(64, 4, 64, 8, 132)
    assert (short.split, short.groups, short.threads, short.blocks,
            short.smem) == (True, 2, 1024, 1, 16 * 1024)
    assert clay_cuda.launch_plan(4097, 2, 8, 4, 132).threads == 64
    with pytest.raises(ValueError):
        clay_cuda.launch_plan(64, 4, clay_cuda.MAX_SMEM // 128 + 1, 8, 132)


# -- kernel B4's plain version ------------------------------------------

def test_plain_b4_equals_reference_transform_kernel():
    """The reference's Pallas decode kernel in interpret mode, k=4, m=2,
    L=32."""
    ref, port = ref_codec(SMALL), port_codec(SMALL)
    sc = 32
    full = _full(ref, _data(ref, sc, 37))
    for lost in ([0, 1], [2, 5]):
        erased = _padded_erased(ref, lost)
        chunks = {i: b for i, b in full.items() if i not in lost}
        cin = _node_input(ref, chunks, erased, sc)
        want = np.asarray(ref_cd.build_transform_kernel(ref, erased)(cin))
        got = cd.build_transform_kernel(port, erased)(
            torch.from_numpy(cin)).numpy()
        assert np.array_equal(got, want), lost
        er = sorted(erased)
        for ch in lost:
            assert np.array_equal(
                got[er.index(ref._node_id(ch))].reshape(-1), full[ch])


@pytest.mark.parametrize("lost", [[0, 1], [0, 9], [3], [0, 5, 8, 11]])
def test_plain_b4_equals_reference_transform_flagship(lost):
    ref, port = ref_codec(FLAGSHIP), port_codec(FLAGSHIP)
    sc = 5
    full = _full(ref, _data(ref, sc, 41))
    erased = _padded_erased(ref, lost)
    chunks = {i: b for i, b in full.items() if i not in lost}
    cin = _node_input(ref, chunks, erased, sc)
    want = np.asarray(ref_cd.ClayDeviceCodec(ref).transform(erased, cin))
    got = cd.ClayDeviceCodec(port).transform(erased, cin).numpy()
    assert np.array_equal(got, want)
    for ch in lost:
        assert np.array_equal(got[ref._node_id(ch)].reshape(-1), full[ch])


def _emulate_transform(arr, cin):
    """csrc/clay_transform.cu's phases over its tables, in numpy (lanes
    vectorized), each phase updating its array in place as the kernel's
    threads do."""
    qt, ssc, kk, e = arr["qt"], arr["ssc"], arr["kk"], arr["e"]
    flat = cin.reshape(qt * ssc, -1)
    cz = np.where(np.repeat(arr["load"], ssc)[:, None] == 1, flat, 0)
    cz = cz.astype(np.uint8)
    u = np.zeros_like(cz)
    for li in range(arr["n_levels"]):
        for r in arr["u_rows"][arr["u_off"][li]:arr["u_off"][li + 1]]:
            u[r] = _mul(arr["a1"][r], cz[r]) ^ \
                _mul(arr["a2"][r], cz[arr["pair"][r]])
        for z in arr["planes"][arr["p_off"][li]:arr["p_off"][li + 1]]:
            for j in range(e):
                acc = np.zeros(cz.shape[1], dtype=np.uint8)
                for c in range(kk):
                    acc ^= _mul(arr["dmat"][j, c],
                                u[arr["intact"][c] * ssc + z])
                u[arr["er"][j] * ssc + z] = acc
        for r in arr["c_rows"][arr["c_off"][li]:arr["c_off"][li + 1]]:
            p = arr["p2"][r]
            cz[r] = _mul(arr["b1"][r], cz[p]) ^ _mul(arr["b2"][r], u[r]) ^ \
                _mul(arr["b3"][r], u[p])
    return np.stack([cz[n * ssc:(n + 1) * ssc] for n in arr["er"]])


@pytest.mark.parametrize("profile,lost", [
    (FLAGSHIP, [0, 1]), (FLAGSHIP, [3]), (FLAGSHIP, [0, 5, 8, 11]),
    (VIRTUAL, [0, 1, 2]), (VIRTUAL, [4, 6]), (SMALL, [1, 4]), (SMALL, [5]),
])
def test_b4_kernel_tables_replay_to_plain(profile, lost):
    port = port_codec(profile)
    sc = 3
    full = _full(port, _data(port, sc, 43))
    erased = _padded_erased(port, lost)
    chunks = {i: b for i, b in full.items() if i not in lost}
    cin = _node_input(port, chunks, erased, sc)
    want = cd.build_transform_kernel(port, erased)(
        torch.from_numpy(cin)).numpy()
    arr = cd.transform_kernel_arrays(port, erased)
    assert np.array_equal(_emulate_transform(arr, cin), want)
    er = sorted(erased)
    for ch in lost:
        assert np.array_equal(want[er.index(port._node_id(ch))].reshape(-1),
                              full[ch])


def _mul_uniform(acc, x, c):
    """acc ^= c * x along the chain, a branch per set bit of c (c the same
    for the whole warp)."""
    for b in range(8):
        if int(c) >> b == 0:
            break
        if b:
            x = _xtime8(x)
        if (int(c) >> b) & 1:
            acc = acc ^ x
    return acc


def _emulate_transform_bitsliced(arr, cin, plan):
    """csrc/clay_transform.cu (bit-sliced) in numpy, tile and block size
    from ``plan`` (clay_cuda.transform_plan), phase-1 and phase-2 items
    from clay_cuda.transform_items: the load (32 lanes per group, zero past
    L, surviving rows transposed once, erased C and U zero), the three
    phases of every level with their thread partitions replayed warp by
    warp and item by item (phases 1 and 2 in whole warps, each coefficient
    masked up to the highest set bit over the warp's; MDS items per erased
    row padded to whole warps, j uniform in each and dmat's bits applied by
    uniform branches), the state in the kernel's
    shared-memory layout ((row, group) as two swizzled 16-byte halves), and
    phase 2's stores of each erased row (to its item's output row) as it
    computes it. Lanes are vectorized over the blocks. Within a phase no item
    reads a row another item writes (other than C read times a zero
    coefficient, which the kernel replaces by the item's own row), and no
    row is written twice."""
    qt, ssc, kk, e = arr["qt"], arr["ssc"], arr["kk"], arr["e"]
    R, L = qt * ssc, cin.shape[-1]
    G, T, blocks = plan.groups, plan.threads, plan.blocks
    assert T % 32 == 0 and blocks * G * 32 >= L > (blocks - 1) * G * 32
    assert plan.smem == 2 * R * 32 * G
    u_items, c_items = clay_cuda.transform_items(arr)
    pad = np.zeros((R, blocks * G * 32), dtype=np.uint8)
    pad[:, :L] = cin.reshape(R, L)
    words = pad.view("<u4").reshape(R, blocks, G, 8)
    # [blocks, R*G*2 halves, 4 words], half h of (row, group) i at 2i + h
    # ^ (bit 2 of i)
    cs = np.zeros((blocks, 2 * R * G, 4), dtype=np.uint32)
    us = np.zeros_like(cs)

    def slot(r, g, h):
        i = r * G + g
        return 2 * i + (h ^ ((i >> 2) & 1))

    def get(s, r, g):
        return np.concatenate([s[:, slot(r, g, 0)], s[:, slot(r, g, 1)]],
                              axis=-1)

    def put(s, r, g, x):
        s[:, slot(r, g, 0)], s[:, slot(r, g, 1)] = x[:, :4], x[:, 4:]

    def warps(n):
        """Items 0..n-1 as the block's warps take them: thread t the items
        t, t + T, ...; a warp's 32 threads 32 consecutive items."""
        for w0 in range(0, T, 32):
            for base in range(w0, n, T):
                yield range(base, min(base + 32, n))

    class Phase:
        """Reads and writes of one phase, by (array, row, group) and
        item."""

        def __init__(self):
            self.reads, self.writes = {}, {}

        def read(self, s, r, g, it):
            self.reads.setdefault((s, r, g), set()).add(it)

        def write(self, s, r, g, it):
            assert (s, r, g) not in self.writes
            self.writes[(s, r, g)] = it

        def check(self):
            for key, it in self.writes.items():
                assert self.reads.get(key, {it}) <= {it}, key

    def zero():
        return np.zeros((blocks, 8), dtype=np.uint32)

    def items_phase(items, off, li, body):
        """One phase-1 or phase-2 pass: body(item, it, tops) per live lane,
        tops the highest set bit of each coefficient over the warp's."""
        n = (off[li + 1] - off[li]) * G
        lvl = items[off[li]:off[li + 1]]
        for warp in warps(n):
            top = np.bitwise_or.reduce([lvl[it // G][2] for it in warp])
            tops = [int((top >> (8 * t)) & 0xFF).bit_length() - 1
                    for t in range(3)]
            for it in warp:
                body(lvl[it // G], it, tops)

    done = set()
    for warp in warps(R * G):
        for it in warp:
            r, g = divmod(it, G)
            done.add(it)
            put(us, r, g, zero())
            put(cs, r, g, _transpose8(words[r, :, g])
                if arr["load"][r // ssc] else zero())
    assert done == set(range(R * G))
    out = np.zeros((e * ssc, blocks, G, 8), dtype=np.uint32)
    stored = set()
    for li in range(arr["n_levels"]):
        ph = Phase()

        def phase1(t, it, tops):
            r, pair, k = int(t[0]), int(t[1]), int(t[2])
            g = it % G
            ph.read("C", r, g, it)
            v = _mul_acc(zero(), get(cs, r, g), k & 0xFF, tops[0])
            if k >> 8:
                ph.read("C", pair, g, it)
                v = _mul_acc(v, get(cs, pair, g), k >> 8, tops[1])
            ph.write("U", r, g, it)
            put(us, r, g, v)

        items_phase(u_items, arr["u_off"], li, phase1)
        ph.check()
        ph = Phase()
        p0, p1 = arr["p_off"][li], arr["p_off"][li + 1]
        n_p = (p1 - p0) * G
        seg = (n_p + 31) // 32 * 32
        for warp in warps(e * seg):
            j = warp[0] // seg
            for it in warp:
                pg = it - j * seg
                assert 0 <= pg < seg
                if pg >= n_p:
                    continue
                g = pg % G
                z = arr["planes"][p0 + pg // G]
                acc = zero()
                for c in range(kk):
                    r = arr["intact"][c] * ssc + z
                    ph.read("U", r, g, it)
                    acc = _mul_uniform(acc, get(us, r, g), arr["dmat"][j, c])
                ph.write("U", arr["er"][j] * ssc + z, g, it)
                put(us, arr["er"][j] * ssc + z, g, acc)
        ph.check()
        ph = Phase()

        def phase2(t, it, tops):
            r, pr, k = int(t[0]), int(t[1]), int(t[2])
            k1, k2, k3 = k & 0xFF, (k >> 8) & 0xFF, k >> 16
            g = it % G
            v = zero()
            if k1:
                ph.read("C", pr, g, it)
                v = _mul_acc(v, get(cs, pr, g), k1, tops[0])
            if k2:
                ph.read("U", r, g, it)
                v = _mul_acc(v, get(us, r, g), k2, tops[1])
            if k3:
                ph.read("U", pr, g, it)
                v = _mul_acc(v, get(us, pr, g), k3, tops[2])
            ph.write("C", r, g, it)
            put(cs, r, g, v)
            assert (t[3], g) not in stored
            stored.add((t[3], g))
            out[t[3], :, g] = _transpose8(v)

        items_phase(c_items, arr["c_off"], li, phase2)
        ph.check()
    assert len(stored) == e * ssc * G
    return out.reshape(e * ssc, -1).view(np.uint8)[:, :L].reshape(
        e, ssc, L)


#: ragged lane counts: one lane; 70 lanes, 2 blocks of 2 lane groups (the
#: committed plan), the last past L, and one block of 4 groups
B4_REPLAY_L = (1, 70)


@pytest.mark.parametrize("profile,lost", [
    (FLAGSHIP, [0, 1]), (FLAGSHIP, [3]), (FLAGSHIP, [0, 5, 8, 11]),
    (VIRTUAL, [0, 1, 2]), (VIRTUAL, [4, 6]), (SMALL, [1, 4]), (SMALL, [5]),
])
def test_b4_bitsliced_replay_equals_plain_and_reference(profile, lost):
    """The bit-sliced kernel's arithmetic and thread partition, replayed
    on the CPU under the committed plan and under 4 lane groups in blocks
    of 128 threads, gives build_transform's and the reference transform's
    bytes, and recovers the lost chunks."""
    ref, port = ref_codec(profile), port_codec(profile)
    erased = _padded_erased(port, lost)
    arr = cd.transform_kernel_arrays(port, erased)
    plain = cd.build_transform(port, erased)
    er = sorted(erased)
    for L in B4_REPLAY_L:
        full = _full(port, _data(port, L, 47 + L))
        chunks = {i: b for i, b in full.items() if i not in lost}
        cin = _node_input(port, chunks, erased, L)
        want = plain(torch.from_numpy(cin)).numpy()[er]
        ref_out = np.asarray(ref_cd.ClayDeviceCodec(ref).transform(
            erased, cin))[er]
        assert np.array_equal(want, ref_out), L
        for plan in (clay_cuda.transform_plan(L, arr["qt"], arr["ssc"], 0),
                     clay_cuda.transform_plan(L, arr["qt"], arr["ssc"], 0,
                                              groups=4, threads=128)):
            got = _emulate_transform_bitsliced(arr, cin, plan)
            assert np.array_equal(got, want), (L, plan)
        for ch in lost:
            assert np.array_equal(got[er.index(port._node_id(ch))]
                                  .reshape(-1), full[ch]), (L, ch)


def test_b4_transform_plan_least_grid_and_refuses_oversize():
    """transform_plan covers L with the least grid of its tile, 256 threads
    a lane group unless told otherwise, halves the tile where the grid
    would leave SMs idle or the state would not fit a block, and refuses a
    signature whose state per lane group exceeds a block's shared
    memory."""
    state = 64 * 12 * 64              # k=8,m=4,d=11: C and U, 48 KiB
    for L in (1, 31, 32, 33, 4097, 1 << 18):
        for sms in (0, 132):
            plan = clay_cuda.transform_plan(L, 12, 64, sms)
            tile = 32 * plan.groups
            assert plan.blocks * tile >= L > (plan.blocks - 1) * tile, L
            assert plan.smem == state * plan.groups <= clay_cuda.MAX_SMEM
            assert plan.threads == 256 * plan.groups
    assert clay_cuda.transform_plan(1 << 18, 12, 64, 132) == \
        clay_cuda.TransformPlan(2, 512, 4096, 2 * state)
    # 64 blocks of 2 groups would idle SMs of 132; sms=0 keeps the tile
    assert clay_cuda.transform_plan(4096, 12, 64, 132) == \
        clay_cuda.TransformPlan(1, 256, 128, state)
    assert clay_cuda.transform_plan(4096, 12, 64, 0) == \
        clay_cuda.TransformPlan(2, 512, 64, 2 * state)
    # 8 groups of 48 KiB exceed a block
    assert clay_cuda.transform_plan(1 << 18, 12, 64, 0, groups=8,
                                    threads=512).groups == 4
    assert clay_cuda.transform_plan(4097, 6, 8, 64, groups=4,
                                    threads=128) == \
        clay_cuda.TransformPlan(2, 128, 65, 2 * 64 * 48)
    with pytest.raises(ValueError):
        clay_cuda.transform_plan(64, 12, clay_cuda.MAX_SMEM // 768 + 1, 132)


def test_b4_transform_items_keep_levels_and_rows():
    """transform_items keeps each level's phase-1 and phase-2 rows (in
    coefficient order) with their partners and coefficients, and gives
    each phase-2 row (an erased node's, every one once) its output row."""
    port = port_codec(FLAGSHIP)
    arr = cd.transform_kernel_arrays(port, _padded_erased(port, [0, 1]))
    u_items, c_items = clay_cuda.transform_items(arr)
    for items, rows, off, partner, names in (
            (u_items, arr["u_rows"], arr["u_off"], arr["pair"],
             ("a1", "a2")),
            (c_items, arr["c_rows"], arr["c_off"], arr["p2"],
             ("b1", "b2", "b3"))):
        assert items.shape == (len(rows), 4) and items.dtype == np.int32
        for li in range(arr["n_levels"]):
            lvl = items[off[li]:off[li + 1]]
            assert sorted(lvl[:, 0]) == sorted(rows[off[li]:off[li + 1]])
            assert (np.diff(lvl[:, 2]) >= 0).all()
        r = items[:, 0]
        assert np.array_equal(items[:, 1], partner[r])
        assert np.array_equal(items[:, 2], sum(
            arr[name][r].astype(np.int32) << (8 * i)
            for i, name in enumerate(names)))
    assert not u_items[:, 3].any()
    # by_coef=False: the same items in the lists' own order
    for items, ordered, rows in zip(
            clay_cuda.transform_items(arr, by_coef=False),
            (u_items, c_items), (arr["u_rows"], arr["c_rows"])):
        assert np.array_equal(items[:, 0], rows)
        assert sorted(map(tuple, items)) == sorted(map(tuple, ordered))
    er, ssc = list(arr["er"]), arr["ssc"]
    assert sorted(c_items[:, 3]) == list(range(len(er) * ssc))
    assert np.array_equal(c_items[:, 3], [er.index(r // ssc) * ssc + r % ssc
                                          for r in c_items[:, 0]])


# -- the codec ----------------------------------------------------------

ROUTES = {
    "torch": {},
    "numpy": {"backend": "numpy"},
    # the cuda route on CPU tensors: every wrapper runs its plain version
    "cuda-wrappers": {"backend": "cuda"},
    "decode_kernel": {"backend": "cuda", "decode_kernel": "true"},
    "sparse-always": {"backend": "cuda"},
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_codec_matches_reference_every_1_2_erasure_and_repair(
        route, monkeypatch):
    if route == "sparse-always":
        monkeypatch.setenv("CEPH_TPU_CLAY_SPARSE", "always")
    ref = ref_codec(SMALL)
    port = port_codec(SMALL, **ROUTES[route])
    n = port.get_chunk_count()
    data = np.random.default_rng(42).integers(
        0, 256, size=4 * 1000 + 3, dtype=np.uint8).tobytes()
    want = ref.encode(list(range(n)), data)
    gf_block_sparse_cuda.reset_launches()
    clay_cuda.reset_launches()
    gf_cuda.reset_launches()
    got = port.encode(list(range(n)), data)
    for i in range(n):
        assert np.array_equal(got[i], want[i]), i
    cs = len(want[0])
    assert cs == port.get_chunk_size(len(data))
    for e in (1, 2):
        for lost in itertools.combinations(range(n), e):
            avail = {i: want[i] for i in range(n) if i not in lost}
            assert port.minimum_to_decode(list(lost), list(avail)) == \
                ref.minimum_to_decode(list(lost), list(avail))
            out = port.decode(list(lost), avail, cs)
            for i in lost:
                assert np.array_equal(out[i], want[i]), (route, lost, i)
    # single-node repair from d helpers' sub-chunk ranges
    sc = cs // port.sub_chunk_no
    for lost in range(n):
        avail = [i for i in range(n) if i != lost]
        plan = port.minimum_to_decode([lost], avail)
        assert plan == ref.minimum_to_decode([lost], avail)
        assert len(plan) == port.d
        helpers = {c: np.concatenate([want[c][o * sc:(o + cnt) * sc]
                                      for o, cnt in ranges])
                   for c, ranges in plan.items()}
        assert len(next(iter(helpers.values()))) == \
            cs // port.q
        out = port.decode([lost], helpers, cs)
        assert np.array_equal(out[lost], want[lost]), (route, lost)
        assert np.array_equal(
            out[lost], ref.decode([lost], helpers, cs)[lost])
    # no kernel launches on CPU tensors, whatever the route
    assert clay_cuda.encode_launches == clay_cuda.transform_launches == 0
    assert gf_block_sparse_cuda.launches == gf_cuda.launches == 0
    if route == "sparse-always":
        assert all(fn.path == "sparse" for key, fn in port._lin_cache.items()
                   if key[0] == "sparse")
    if route == "decode_kernel":
        assert any(key[0] == "ker" for key in port._lin_cache)


def test_decode_matvec_calibration_modes(monkeypatch):
    port = port_codec(SMALL, backend="cuda")
    mat = port._decode_matrix((0, 2, 4, 5), (1, 3))
    x = np.random.default_rng(11).integers(
        0, 256, size=(mat.shape[1], 512), dtype=np.uint8)
    want = gf256.gf_matvec_chunks(mat, x)
    for mode, path in (("never", "dense"), ("always", "sparse"),
                       ("auto", "dense")):
        monkeypatch.setenv("CEPH_TPU_CLAY_SPARSE", mode)
        fn = cd.build_decode_matvec(port, mat)
        assert fn.path == path, mode
        assert np.array_equal(fn(torch.from_numpy(x)).numpy(), want)
    # a CPU codec never times anything: dense, with the plan's cost noted
    assert fn.measured["skipped"] is True


def test_backend_routes_oversized_matrices_to_the_counted_dense_product():
    from ceph_tpu_torch.ops import backend
    big = np.random.default_rng(3).integers(0, 256, (64, 176), np.uint8)
    x = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (176, 50), dtype=np.uint8))
    gf_torch.reset_dense_calls()
    gf_cuda.reset_launches()
    got = backend.matvec(big, x, "cuda")
    assert gf_torch.dense_calls == 1 and gf_cuda.launches == 0
    assert np.array_equal(got.numpy(), gf256.gf_matvec_chunks(big, x.numpy()))
    small = big[:gf_cuda.MAX_M, :gf_cuda.MAX_K]
    backend.matvec(small, x[:gf_cuda.MAX_K], "cuda")
    assert gf_torch.dense_calls == 1


def test_profile_checks_and_geometry():
    port = port_codec(FLAGSHIP)
    assert (port.q, port.t, port.nu, port.sub_chunk_no) == (4, 3, 0, 64)
    assert port.get_profile()["scalar_mds"] == "jerasure"
    for bad in ({"k": "1"}, {"k": "4", "m": "2", "d": "7"},
                {"scalar_mds": "lrc"}, {"backend": "pallas"}):
        with pytest.raises(ErasureCodeError):
            instance().factory("clay", bad, device="cpu")
    with pytest.raises(ErasureCodeError):
        port.decode_chunks([0], {i: np.zeros(64, np.uint8)
                                 for i in range(7, 12)})


def test_scalar_mds_isa_and_shec_match_reference():
    for mds in ("isa", "shec"):
        ref = ref_codec(SMALL, scalar_mds=mds)
        port = port_codec(SMALL, scalar_mds=mds)
        data = np.random.default_rng(8).integers(
            0, 256, size=4 * 256, dtype=np.uint8).tobytes()
        want = ref.encode(list(range(6)), data)
        got = port.encode(list(range(6)), data)
        for i in range(6):
            assert np.array_equal(got[i], want[i]), (mds, i)
        avail = {i: want[i] for i in range(2, 6)}
        out = port.decode([0, 1], avail, len(want[0]))
        assert np.array_equal(out[0], want[0]) and \
            np.array_equal(out[1], want[1])


def test_ec_util_with_clay_matches_reference():
    ref = ref_codec(SMALL)
    port = from_reference_profile(ref.get_profile(), device="cpu")
    assert port.get_profile()["plugin"] == "clay"
    assert (port.k, port.m, port.d) == (ref.k, ref.m, ref.d)
    chunk = 256
    sinfo = ec_util.StripeInfo(stripe_width=4 * chunk, chunk_size=chunk)
    ref_sinfo = ref_ec.StripeInfo(stripe_width=4 * chunk, chunk_size=chunk)
    data = np.random.default_rng(13).integers(
        0, 256, size=5 * sinfo.stripe_width, dtype=np.uint8)
    shards = ec_util.encode(sinfo, port, data)
    ref_shards = ref_ec.encode(ref_sinfo, ref, data)
    for i in range(6):
        assert np.array_equal(shards[i], ref_shards[i]), i
    for lost in ((0,), (5,), (0, 1), (2, 4)):
        avail = {i: shards[i] for i in range(6) if i not in lost}
        got = ec_util.decode(sinfo, port, avail, list(lost))
        want = ref_ec.decode(ref_sinfo, ref, avail, list(lost))
        for i in lost:
            assert np.array_equal(got[i], want[i]), (lost, i)
            assert np.array_equal(got[i], shards[i]), (lost, i)


@pytest.mark.parametrize("workload", ("encode", "decode"))
def test_ec_bench_cli_runs_clay_on_cpu(workload, capsys):
    from ceph_tpu_torch.bench import ec_bench
    rc = ec_bench.main(["-p", "clay", "-P", "k=4", "-P", "m=2", "-P", "d=5",
                        "-S", "8192", "-i", "2", "-w", workload, "-e", "2",
                        "--device", "cpu"])
    assert rc == 0
    elapsed, kib = capsys.readouterr().out.strip().split("\t")
    assert float(elapsed) >= 0 and int(kib) == 2 * 8
    with pytest.raises(SystemExit):
        ec_bench.main(["-p", "clay", "--device-resident", "--device", "cpu"])
