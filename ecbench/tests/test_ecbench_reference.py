"""The benchmark's plain reference against known answers (CPU).

    python -m pytest ecbench/tests -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ecbench.reference import clay, crc32c, gf256, rs


def test_gf_products_known_answers():
    assert gf256.mul(2, 0x80) == 0x1D          # x * x^7 = x^8 = 0x1D
    assert gf256.mul(3, 7) == 9                # (x+1)(x^2+x+1) = x^3+1
    tbl = gf256.mul_table()
    assert np.array_equal(tbl, tbl.T)
    assert (tbl[1] == np.arange(256)).all() and not tbl[0].any()
    for a in range(1, 256):
        assert gf256.mul(a, gf256.inverse(a)) == 1
    assert gf256.power(2, 255) == 1 and gf256.power(2, 8) == 0x1D


def test_gf_matrix_inverse_and_matvec():
    rng = np.random.default_rng(3)
    mat = clay.vandermonde_coding(4, 4)
    inv = gf256.mat_inverse(mat)
    field = gf256.Field("cpu")
    x = torch.from_numpy(rng.integers(0, 256, (4, 33), dtype=np.uint8))
    assert torch.equal(field.matvec(inv, field.matvec(mat, x)), x)
    want = np.zeros((4, 33), dtype=np.uint8)
    for r in range(4):
        for c in range(4):
            want[r] ^= np.array([gf256.mul(int(mat[r, c]), int(v))
                                 for v in x[c]], dtype=np.uint8)
    assert np.array_equal(field.matvec(mat, x).numpy(), want)


def _crc32c_bitwise(data: bytes) -> int:
    c = 0xFFFFFFFF
    for byte in data:
        c ^= byte
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
    return c ^ 0xFFFFFFFF


@pytest.mark.parametrize("data", [b"123456789", b"a", bytes(32),
                                  bytes(range(256)) * 5])
def test_crc32c_known_answers(data):
    assert crc32c.crc32c(data) == _crc32c_bitwise(data)
    if data == b"123456789":
        assert crc32c.crc32c(data) == 0xE3069283


def test_crc_register_is_linear_and_front_pad_free():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(0, 256, (3, 1500), dtype=np.uint8))
    b = torch.from_numpy(rng.integers(0, 256, (3, 1500), dtype=np.uint8))
    ra, rb = crc32c.register(a), crc32c.register(b)
    assert torch.equal(crc32c.register(a ^ b), ra ^ rb)
    padded = torch.nn.functional.pad(a, (700, 0))
    assert torch.equal(crc32c.register(padded), ra)
    assert not crc32c.register(torch.zeros((2, 4096), dtype=torch.uint8)) \
        .any()
    # the register is crc32c(M) ^ crc32c(zeros of len(M))
    row = bytes(a[0].tolist())
    assert int(ra[0]) == _crc32c_bitwise(row) ^ _crc32c_bitwise(bytes(1500))


def test_isa_matrix_and_segment_crcs():
    mat = rs.isa_rs_matrix(8, 3)
    assert (mat[0] == 1).all()
    assert mat[1].tolist() == [1, 2, 4, 8, 16, 32, 64, 128]
    assert mat[2].tolist()[:4] == [1, 4, 16, 64]
    rng = np.random.default_rng(9)
    field = gf256.Field("cpu")
    data = torch.from_numpy(rng.integers(0, 256, (8, 4 * 1024),
                                         dtype=np.uint8))
    par = rs.parity(field, 8, 3, data)
    lin = rs.segment_crcs(data, par, 1024)
    shards = torch.cat([data, par])
    for op in range(4):
        for s in range(11):
            seg = bytes(shards[s, op * 1024:(op + 1) * 1024].tolist())
            assert int(lin[op, s]) == \
                _crc32c_bitwise(seg) ^ _crc32c_bitwise(bytes(1024))


@pytest.mark.parametrize("k,m", [(2, 2), (4, 2), (3, 3)])
def test_clay_with_one_plane_is_the_scalar_code(k, m):
    """With d = k the coupling is trivial (q = 1, one sub-chunk): Clay's
    parity is the scalar MDS code's, worked out by the reference GF."""
    code = clay.ClayCode(k, m, k, "cpu")
    assert code.ssc == 1
    rng = np.random.default_rng(k * 10 + m)
    data = torch.from_numpy(rng.integers(0, 256, (k, 1, 64), dtype=np.uint8))
    want = gf256.Field("cpu").matvec(clay.vandermonde_coding(k, m), data[:, 0])
    assert torch.equal(code.encode(data)[:, 0], want)


def test_clay_encode_is_linear_and_systematic_inner_codes():
    code = clay.ClayCode(4, 2, 5, "cpu")
    assert (code.q, code.t, code.ssc, code.nu) == (2, 3, 8, 0)
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.integers(0, 256, (4, 8, 24), dtype=np.uint8))
    b = torch.from_numpy(rng.integers(0, 256, (4, 8, 24), dtype=np.uint8))
    assert torch.equal(code.encode(a ^ b), code.encode(a) ^ code.encode(b))
    assert not code.encode(torch.zeros_like(a)).any()
    assert np.array_equal(code.pft_gen[:2], np.eye(2, dtype=np.uint8))


@pytest.mark.parametrize("k,m,d", [(4, 2, 5), (5, 3, 7), (8, 4, 11)])
def test_clay_reference_agrees_with_the_port_host_encoder(k, m, d):
    """The frozen encoder gives the port's host (plane-by-plane) encoder's
    bytes, virtual nodes (nu > 0) included."""
    from ceph_tpu_torch.models import instance

    codec = instance().factory("clay", {"k": str(k), "m": str(m),
                                        "d": str(d)}, device="cpu")
    code = clay.ClayCode(k, m, d, "cpu")
    rng = np.random.default_rng(d)
    data = torch.from_numpy(rng.integers(0, 256, (k, code.ssc, 8),
                                         dtype=np.uint8))
    port = codec._encode_chunks_host(
        list(range(k, k + m)),
        {i: data[i].numpy().reshape(-1) for i in range(k)})
    par = code.encode(data)
    for j in range(m):
        assert np.array_equal(port[k + j], par[j].numpy().reshape(-1))
