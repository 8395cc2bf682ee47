"""The slice as a whole: the port's fused encode + crc flush and the
degraded read (ceph_tpu_torch.osd.ec_util) against the JAX package.

A ragged op mix through ``StripeBatcher.flush(with_crcs=True)`` must give
exactly the reference's ``(op_id, shards, crcs)`` — the reference running
``_flush_device_fused_async`` on its ``jax`` backend with
CEPH_TPU_FUSE_CRC=1 — and the crcs must fold into the same HashInfo as
host hashing. Tolerance 0 throughout.
"""

import itertools

import numpy as np
import pytest

from ceph_tpu.models import registry as ref_registry
from ceph_tpu.osd import ec_util as ref_ec
from ceph_tpu_torch.models import from_reference_profile
from ceph_tpu_torch.ops import crc32c_cuda, gf_cuda
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.utils import checksum

K, M = 8, 3


@pytest.fixture
def codecs(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_FUSE_CRC", "1")
    ref = ref_registry.instance().factory(
        "isa", {"plugin": "isa", "k": str(K), "m": str(M), "backend": "jax"})
    port = from_reference_profile(ref.get_profile(), ref.coding_matrix,
                                  device="cpu")
    return ref, port


def _ops(sinfo, stripes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=s * sinfo.stripe_width, dtype=np.uint8)
            for s in stripes]


def _flush(batcher_cls, sinfo, codec, bufs, **kw):
    b = batcher_cls(sinfo, codec)
    for op, buf in enumerate(bufs):
        b.append(f"op{op}", buf)
    return b.flush(**kw)


# ragged mixes: segment lengths not multiples of 512, unequal, one op
# spanning more than the others put together
MIXES = [
    (256, (1, 3, 2, 5, 1)),
    (4096, (2, 1)),
    (160, (7,)),
]


@pytest.mark.parametrize("chunk,stripes", MIXES)
def test_fused_flush_matches_reference(codecs, chunk, stripes):
    ref, port = codecs
    sinfo = ec_util.StripeInfo(stripe_width=K * chunk, chunk_size=chunk)
    ref_sinfo = ref_ec.StripeInfo(stripe_width=K * chunk, chunk_size=chunk)
    bufs = _ops(sinfo, stripes, chunk)
    got = _flush(ec_util.StripeBatcher, sinfo, port, bufs, with_crcs=True)
    want = _flush(ref_ec.StripeBatcher, ref_sinfo, ref, bufs,
                  with_crcs=True)
    assert [r[0] for r in got] == [r[0] for r in want]
    for (op, shards, crcs), (_, rshards, rcrcs) in zip(got, want):
        assert rcrcs is not None and crcs is not None
        assert crcs == rcrcs, op
        assert sorted(shards) == sorted(rshards) == list(range(K + M))
        for i in shards:
            assert np.array_equal(shards[i], rshards[i]), (op, i)
        # the crcs fold into the hinfo host hashing builds
        hi, ref_hi = ec_util.HashInfo(K + M), ref_ec.HashInfo(K + M)
        hi.append_linear(0, crcs, len(shards[0]))
        ref_hi.append(0, rshards)
        assert hi.to_dict() == ref_hi.to_dict(), op


def test_append_linear_cumulative_matches_reference(codecs):
    ref, port = codecs
    sinfo = ec_util.StripeInfo(stripe_width=K * 96, chunk_size=96)
    hi, ref_hi = ec_util.HashInfo(K + M), ref_ec.HashInfo(K + M)
    off = 0
    for seed, stripes in enumerate(((2,), (1,), (4,))):
        (_, shards, crcs), = _flush(ec_util.StripeBatcher, sinfo, port,
                                    _ops(sinfo, stripes, seed),
                                    with_crcs=True)
        hi.append_linear(off, crcs, len(shards[0]))
        ref_hi.append(off, shards)
        off += len(shards[0])
    assert hi.to_dict() == ref_hi.to_dict()
    with pytest.raises(ValueError):
        hi.append_linear(0, crcs, 96)


def test_decode_and_encode_match_reference(codecs):
    ref, port = codecs
    chunk = 128
    sinfo = ec_util.StripeInfo(stripe_width=K * chunk, chunk_size=chunk)
    ref_sinfo = ref_ec.StripeInfo(stripe_width=K * chunk, chunk_size=chunk)
    data = _ops(sinfo, (6,), 11)[0]
    shards = ec_util.encode(sinfo, port, data)
    ref_shards = ref_ec.encode(ref_sinfo, ref, data)
    for i in range(K + M):
        assert np.array_equal(shards[i], ref_shards[i]), i
    for lost in list(itertools.combinations(range(K), 1)) + \
            [(0, 1), (2, 9), (8, 10)]:
        avail = {i: shards[i] for i in range(K + M) if i not in lost}
        got = ec_util.decode(sinfo, port, avail, list(lost))
        want = ref_ec.decode(ref_sinfo, ref, avail, list(lost))
        for i in lost:
            assert np.array_equal(got[i], want[i]), (lost, i)
            assert np.array_equal(got[i], shards[i]), (lost, i)


def test_gates_and_plain_routes(codecs, monkeypatch):
    ref, port = codecs
    assert ec_util.fuse_crc_policy(port) and ref_ec.fuse_crc_policy(ref)
    assert ec_util.device_decodable(port) and ec_util.host_flushable(port)
    monkeypatch.delenv("CEPH_TPU_FUSE_CRC")
    assert not ec_util.fuse_crc_policy(port)
    numpy_port = from_reference_profile(
        dict(ref.get_profile(), backend="jax"), ref.coding_matrix,
        device="cpu")
    numpy_port.backend = "numpy"
    assert not ec_util._device_fusable(numpy_port)
    sinfo = ec_util.StripeInfo(stripe_width=K * 64, chunk_size=64)
    bufs = _ops(sinfo, (1, 2), 5)
    fused = _flush(ec_util.StripeBatcher, sinfo, port, bufs, with_crcs=True)
    # a codec that cannot fuse flushes plainly, with no crcs
    plain = _flush(ec_util.StripeBatcher, sinfo, numpy_port, bufs,
                   with_crcs=True)
    host = ec_util.flush_host_async(sinfo, port, ["op0", "op1"], bufs)()
    for a, b, c in zip(fused, plain, host):
        assert b[2] is None and c[2] is None and a[2] is not None
        for i in range(K + M):
            assert np.array_equal(a[1][i], b[1][i])
            assert np.array_equal(a[1][i], c[1][i])
    # working-set guard: too large an op mix takes the plain flush
    monkeypatch.setattr(ec_util, "_FUSE_CRC_MAX_SEG_BYTES", 1024)
    guarded = _flush(ec_util.StripeBatcher, sinfo, port, bufs,
                     with_crcs=True)
    assert [r[2] for r in guarded] == [None, None]
    with pytest.raises(NotImplementedError):
        ec_util.StripeBatcher(sinfo, port, mesh=object())


def test_cpu_flush_launches_no_kernel(codecs):
    _, port = codecs
    sinfo = ec_util.StripeInfo(stripe_width=K * 64, chunk_size=64)
    gf_cuda.reset_launches()
    crc32c_cuda.reset_launches()
    results = _flush(ec_util.StripeBatcher, sinfo, port,
                     _ops(sinfo, (3,), 2), with_crcs=True)
    assert gf_cuda.launches == crc32c_cuda.launches == 0
    (_, shards, crcs), = results
    zeros = np.zeros(len(shards[0]), np.uint8)
    for i in range(K + M):
        # linear part: crc32c(M, 0) ^ crc32c(0^len, 0)
        assert crcs[i] == \
            checksum.crc32c(shards[i]) ^ checksum.crc32c(zeros)


# -- the batcher hooks the device engine uses ----------------------------

def _preconcat_flush(batcher_cls, sinfo, codec, batch, bounds, **kw):
    """Append adjacent views of ``batch`` and hand ``batch`` itself over
    with ``set_preconcat``."""
    b = batcher_cls(sinfo, codec)
    for op, (lo, hi) in enumerate(bounds):
        b.append(f"op{op}", batch[lo:hi])
    b.set_preconcat(batch)
    return b.flush(**kw)


def _assert_same(got, want):
    assert [r[0] for r in got] == [r[0] for r in want]
    for (op, shards, crcs), (_, rshards, rcrcs) in zip(got, want):
        assert crcs == rcrcs, op
        assert sorted(shards) == sorted(rshards)
        for i in shards:
            assert np.array_equal(shards[i], rshards[i]), (op, i)


@pytest.mark.parametrize("with_crcs", [True, False],
                         ids=["fused", "plain"])
def test_set_preconcat_matches_reference(codecs, monkeypatch, with_crcs):
    """A preconcatenated batch gives the reference's results for the
    same batch, on the fused and the plain route; the port's flush does
    not concatenate at all then (np.concatenate raising changes
    nothing), and a preconcat of the wrong length is dropped and the
    buffers concatenated again."""
    ref, port = codecs
    chunk = 256
    sinfo = ec_util.StripeInfo(stripe_width=K * chunk, chunk_size=chunk)
    ref_sinfo = ref_ec.StripeInfo(stripe_width=K * chunk, chunk_size=chunk)
    bufs = _ops(sinfo, (2, 1, 3), 21)
    batch = np.concatenate(bufs)
    ends = np.cumsum([0] + [len(b) for b in bufs])
    bounds = list(zip(ends[:-1], ends[1:]))
    want = _preconcat_flush(ref_ec.StripeBatcher, ref_sinfo, ref, batch,
                            bounds, with_crcs=with_crcs)
    assert (want[0][2] is not None) == with_crcs
    got = _preconcat_flush(ec_util.StripeBatcher, sinfo, port, batch,
                           bounds, with_crcs=with_crcs)
    _assert_same(got, want)

    def no_concat(*a, **k):
        raise AssertionError("np.concatenate called despite preconcat")

    with monkeypatch.context() as mp:
        mp.setattr(np, "concatenate", no_concat)
        got = _preconcat_flush(ec_util.StripeBatcher, sinfo, port, batch,
                               bounds, with_crcs=with_crcs)
    _assert_same(got, want)
    # a preconcat one stripe short breaks the contract: concatenate again
    concatenated = []
    real = np.concatenate

    def counting(*a, **k):
        concatenated.append(1)
        return real(*a, **k)

    b = ec_util.StripeBatcher(sinfo, port)
    for op, (lo, hi) in enumerate(bounds):
        b.append(f"op{op}", batch[lo:hi])
    b.set_preconcat(batch[:-sinfo.stripe_width])
    with monkeypatch.context() as mp:
        mp.setattr(np, "concatenate", counting)
        got = b.flush(with_crcs=with_crcs)
    assert concatenated
    _assert_same(got, want)


XOR_PROFILES = [("isa", 8, 3), ("isa", 4, 1), ("jerasure", 2, 1)]


@pytest.mark.parametrize("plugin,k,m", XOR_PROFILES,
                         ids=[f"{p}-{k}-{m}" for p, k, m in XOR_PROFILES])
def test_xor_decodable_matches_reference(plugin, k, m):
    """Over every single and double erasure (the cases of
    tests/test_read_path.py:120), and with nothing missing."""
    ref = ref_registry.instance().factory(
        plugin, {"plugin": plugin, "k": str(k), "m": str(m),
                 "backend": "numpy"})
    port = from_reference_profile(ref.get_profile(), ref.coding_matrix,
                                  device="cpu")
    n = k + m
    chunk = np.zeros(64, np.uint8)
    seen = set()
    for e in (1, 2):
        for lost in itertools.combinations(range(n), e):
            shards = {i: chunk for i in range(n) if i not in lost}
            got = ec_util.xor_decodable(port, shards, list(lost))
            assert got == ref_ec.xor_decodable(ref, shards, list(lost)), \
                lost
            seen.add(got)
    assert not ec_util.xor_decodable(port, {i: chunk for i in range(n)}, [])
    assert not ec_util.xor_decodable(object(), {0: chunk}, [1])
    if (plugin, k, m) == ("isa", 8, 3):
        assert seen == {True, False}


def test_on_fallback_accepted_never_called(codecs, monkeypatch):
    """The port keeps the reference's ``on_fallback`` argument but has no
    fallback: the fused, plain and guarded routes never call it, and a
    failed fused flush raises instead."""
    _, port = codecs
    calls = []
    sinfo = ec_util.StripeInfo(stripe_width=K * 64, chunk_size=64)
    bufs = _ops(sinfo, (1, 2), 9)

    def flush(**kw):
        b = ec_util.StripeBatcher(sinfo, port,
                                  on_fallback=lambda *a: calls.append(a))
        assert b.on_fallback is not None
        for op, buf in enumerate(bufs):
            b.append(op, buf)
        return b.flush(**kw)

    assert flush(with_crcs=True)[0][2] is not None
    assert flush(with_crcs=False)[0][2] is None
    with monkeypatch.context() as mp:
        mp.setattr(ec_util, "_FUSE_CRC_MAX_SEG_BYTES", 1024)
        assert flush(with_crcs=True)[0][2] is None

    def boom(*a, **k):
        raise RuntimeError("poisoned fused path")

    monkeypatch.setattr(ec_util, "_flush_device_fused_async", boom)
    with pytest.raises(RuntimeError):
        flush(with_crcs=True)
    assert calls == []


def test_fused_fits_edge_unchanged(codecs, monkeypatch):
    """The working-set guard keeps the reference's limit and its
    inclusive edge: nops_b * n_chunks * lmax_b <= limit fuses."""
    _, port = codecs
    assert ec_util._FUSE_CRC_MAX_SEG_BYTES == ref_ec._FUSE_CRC_MAX_SEG_BYTES
    sinfo = ec_util.StripeInfo(stripe_width=K * 4096, chunk_size=4096)
    one, two = _ops(sinfo, (1, 1), 3)
    monkeypatch.setattr(ec_util, "_FUSE_CRC_MAX_SEG_BYTES",
                        (K + M) * 4096)
    assert ec_util._fused_fits(sinfo, port, [one])
    assert not ec_util._fused_fits(sinfo, port, [one, two])
    big = np.zeros(2 * sinfo.stripe_width, np.uint8)
    assert not ec_util._fused_fits(sinfo, port, [big])
    monkeypatch.setattr(ec_util, "_FUSE_CRC_MAX_SEG_BYTES",
                        2 * (K + M) * 8192)
    assert ec_util._fused_fits(sinfo, port, [big, one])


def test_fused_flush_exposes_its_device_step(codecs):
    """``finalize.fused_fn(*finalize.staged)`` is exactly the launch's
    device step: it gives the flush's parity and linear crcs again."""
    _, port = codecs
    sinfo = ec_util.StripeInfo(stripe_width=K * 256, chunk_size=256)
    bufs = _ops(sinfo, (3, 1, 2), 4)
    fin = ec_util._flush_device_fused_async(sinfo, port, [0, 1, 2], bufs)
    assert set(fin.host_split) == {"upload_s", "transpose_s", "launch_s"}
    results = fin()
    assert {"alloc_s", "wait_s", "split_s"} <= set(fin.host_split)
    parity, lin = fin.fused_fn(*fin.staged)
    ln = 0
    for op, shards, crcs in results:
        assert crcs == {i: int(lin[op, i]) for i in range(K + M)}
        cur = len(shards[0])
        for j in range(M):
            assert np.array_equal(parity[j, ln:ln + cur].numpy(),
                                  shards[K + j])
        ln += cur
