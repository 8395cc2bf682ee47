"""The port's cost model (``ceph_tpu_torch/ops/cost_model.py``) against
the reference's (``ceph_tpu/ops/cost_model.py``), on the CPU.

The reference asks XLA for a compiled program's cost; the port counts its
programs' costs analytically. What must agree: the peaks and the roofline
for the same inputs (with the env peaks pinned, and the CPU entry without
them), the bench payload's key set, and the fused flush's entry in
``costs_by_signature`` under the reference's signature string (the
reference names its ``jax`` backend where the port names ``torch``).
The port's fused-flush bytes are the hand count of its data in and its
parity and crc parts out. Tolerance 0.
"""

import numpy as np
import pytest

from ceph_tpu.models import registry as ref_registry
from ceph_tpu.ops import cost_model as ref_cm
from ceph_tpu.osd import ec_util as ref_ec
from ceph_tpu.utils.device_telemetry import telemetry as ref_telemetry
from ceph_tpu_torch.models import from_reference_profile
from ceph_tpu_torch.ops import cost_model as cm
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.utils.device_telemetry import telemetry

K, M = 8, 3

#: (flops, bytes_accessed, traffic_bytes)
ROOFLINE_CASES = [
    (1e9, 2e9, 1e9), (0.0, 4096.0, 4096.0), (3e12, None, 1e6),
    (None, None, 1.0), (128 * 3 * 8 * 16 << 20, 11 * 16 << 20, 8 * 16 << 20),
]


@pytest.mark.parametrize("pinned", [None, ("900", "60"), ("3350", "1979")])
def test_peaks_and_roofline_equal_reference(monkeypatch, pinned):
    """Pinned, both read the env; unpinned on the CPU, both take the
    reference's CPU entry."""
    if pinned is None:
        monkeypatch.delenv("CEPH_TPU_PEAK_HBM_GBPS", raising=False)
        monkeypatch.delenv("CEPH_TPU_PEAK_TFLOPS", raising=False)
    else:
        monkeypatch.setenv("CEPH_TPU_PEAK_HBM_GBPS", pinned[0])
        monkeypatch.setenv("CEPH_TPU_PEAK_TFLOPS", pinned[1])
    assert cm.peaks("cpu") == ref_cm.peaks()
    assert cm.peaks() == ref_cm.peaks()
    for flops, nbytes, traffic in ROOFLINE_CASES:
        assert cm.roofline_gbps(flops, nbytes, traffic) == \
            ref_cm.roofline_gbps(flops, nbytes, traffic)


def test_peaks_on_the_card_are_the_h100_rates(monkeypatch):
    """On ``cuda``: the card's memory rate (here the published one, as a
    card that reports no clock gives) and the dense int8 rate; the env
    overrides them."""
    monkeypatch.delenv("CEPH_TPU_PEAK_HBM_GBPS", raising=False)
    monkeypatch.delenv("CEPH_TPU_PEAK_TFLOPS", raising=False)
    monkeypatch.setattr(cm, "hbm_rate",
                        lambda: (cm.H100_HBM_BYTES_PER_S, "published"))
    assert cm.peaks("cuda") == (3350.0, 1979.0)
    monkeypatch.setenv("CEPH_TPU_PEAK_HBM_GBPS", "2000")
    assert cm.peaks("cuda") == (2000.0, 1979.0)


def test_bench_fields_key_set_equals_reference():
    import jax.numpy as jnp

    def ref_fn(x):
        return (x * 3 + 1).sum()

    want = ref_cm.bench_fields(ref_fn, (jnp.ones((1024,), jnp.float32),),
                               4096.0)
    got = cm.bench_fields(ec_util.fused_step,
                          (np.zeros((M, K), np.uint8),
                           np.zeros((K, 4096), np.uint8), [512] * 8, 512,
                           "torch"), 8 * 4096)
    assert set(got) == set(want) == {"cost_flops", "cost_bytes",
                                     "roofline_GBps"}
    # a program that states no cost gives the empty payload, as the
    # reference's does when XLA cannot say
    assert cm.bench_fields(lambda x: x, (1,), 1.0) == {}
    assert cm.analyze(lambda x: x, 1) is None


def test_fused_flush_cost_is_the_hand_count():
    m, k, n, nops, lmax = M, K, 3 * 4096, 3, 4096
    cost = cm.fused_flush(m, k, n, nops, lmax)
    # data in; parity and one int64 crc part a segment out
    assert cost["bytes_accessed"] == k * n + m * n + nops * (k + m) * 8
    # GF products as 8x8 bit-matrix products, every 512-byte row's crc
    rows = nops * (k + m) * lmax // 512
    assert cost["flops"] == 128 * m * k * n + 2 * 4096 * 32 * rows


@pytest.mark.parametrize("chunk,stripes", [(512, (2, 1, 3)), (160, (5,))])
def test_fused_flush_fills_costs_by_signature(monkeypatch, chunk, stripes):
    """Under CEPH_TPU_COST_ANALYSIS both packages' fused flushes record a
    cost under the same signature string, the port's bytes the hand count
    of this flush."""
    monkeypatch.setenv("CEPH_TPU_FUSE_CRC", "1")
    monkeypatch.setenv("CEPH_TPU_COST_ANALYSIS", "1")
    # both packages record a signature's cost once a process (the
    # reference when it builds a new jit program, keyed by the matrix and
    # the pow2 buckets; the port when it first meets the signature): an
    # earlier k=8,m=3 fused flush in this worker would leave nothing new
    # to record, so the caches and the tables start empty here
    monkeypatch.setattr(ref_ec, "_fused_cache", {})
    monkeypatch.setattr(ec_util, "_costed_signatures", set())
    monkeypatch.setattr(ref_telemetry(), "_costs", {})
    monkeypatch.setattr(telemetry(), "_costs", {})
    ref = ref_registry.instance().factory(
        "isa", {"plugin": "isa", "k": str(K), "m": str(M), "backend": "jax"})
    port = from_reference_profile(ref.get_profile(), ref.coding_matrix,
                                  device="cpu")
    sinfo = ec_util.StripeInfo(stripe_width=K * chunk, chunk_size=chunk)
    ref_sinfo = ref_ec.StripeInfo(stripe_width=K * chunk, chunk_size=chunk)
    rng = np.random.default_rng(chunk)
    bufs = [rng.integers(0, 256, s * K * chunk, dtype=np.uint8)
            for s in stripes]
    before = set(telemetry().snapshot()["costs_by_signature"])
    ref_before = set(ref_telemetry().snapshot()["costs_by_signature"])
    for cls, si, codec in ((ec_util.StripeBatcher, sinfo, port),
                           (ref_ec.StripeBatcher, ref_sinfo, ref)):
        b = cls(si, codec)
        for i, buf in enumerate(bufs):
            b.append(i, buf)
        b.flush(with_crcs=True)
    new = set(telemetry().snapshot()["costs_by_signature"]) - before
    ref_new = set(ref_telemetry().snapshot()["costs_by_signature"]) - \
        ref_before
    assert len(ref_new) == 1 and \
        new == {s.replace("[jax", "[torch") for s in ref_new}
    cost = telemetry().snapshot()["costs_by_signature"][new.pop()]
    n = sum(stripes) * chunk
    assert cost["bytes_accessed"] == \
        K * n + M * n + len(stripes) * (K + M) * 8
    assert set(cost) == set(ref_telemetry().snapshot()[
        "costs_by_signature"][ref_new.pop()])
