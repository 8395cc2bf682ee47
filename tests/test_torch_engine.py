"""The port's device engine (ceph_tpu_torch.osd.device_engine) against the
reference engine's contracts and bytes.

The ordering and drain gates are the cluster-free ones of the reference's
tests/test_engine_pipeline.py, tests/test_device_path.py and
tests/test_device_telemetry.py, each against the port's engine and, where
the reference fakes its device, the port's own fake fused flush (whose
``finalize`` blocks until ``launch + DEVICE_S``). A threaded burst of
ragged ops then holds the port's engine against the reference's engine
byte for byte (shards and linear crcs, tolerance 0), on the fused route
and on the host route.

One deliberate deviation: the reference's fused flush falls back to the
plain flush when it fails (and counts ``device_fused_fallbacks``); the
port's raises, so a poisoned fused flush reaches the op's continuation as
``err`` and counts ``errors``.
"""

import contextlib
import os
import threading
import time

import numpy as np
import pytest

from ceph_tpu.models import registry as ref_registry
from ceph_tpu.osd import device_engine as ref_de
from ceph_tpu.osd import ec_util as ref_ec
from ceph_tpu_torch.models import from_reference_profile, instance
from ceph_tpu_torch.osd import device_engine as de
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.device_engine import DeviceEncodeEngine
from ceph_tpu_torch.osd.ec_util import StripeInfo
from ceph_tpu_torch.utils.device_telemetry import telemetry


@pytest.fixture(autouse=True)
def _pin_device_route(monkeypatch):
    """These tests pin the DEVICE launch pipeline; keep the tiny test
    flushes off the small-flush host route (the burst's host-route case
    clears it again)."""
    monkeypatch.setenv("CEPH_TPU_HOST_FLUSH_BYTES", "0")


def _codec(backend="numpy", k=2, m=1):
    """A port jerasure codec on the CPU: ``torch`` fuses (the plain
    versions of B1 and B2), ``numpy`` takes the plain flush."""
    return instance().factory(
        "jerasure", {"plugin": "jerasure", "k": str(k), "m": str(m),
                     "backend": backend}, device="cpu")


#: seconds the fake device "computes" per batch
DEVICE_S = 0.1


def _fake_device(monkeypatch, launches: list):
    """Replace the fused flush with a device that computes every batch in
    DEVICE_S, concurrently (finalize blocks until its own launch
    deadline); ``launches`` gets (launch time, window slot)."""

    real_encode = ec_util.encode    # survives later encode poisoning
    slot_now = [None]

    @contextlib.contextmanager
    def launch_context(codec, slot):
        slot_now[0] = slot        # the engine's launch of this slot
        yield

    def fake_async(sinfo, codec, ops, bufs, batch=None):
        t_launch = time.perf_counter()
        launches.append((t_launch, slot_now[0]))
        host = _codec(k=codec.get_data_chunk_count(),
                      m=codec.get_chunk_count()
                      - codec.get_data_chunk_count())
        cs, sw = sinfo.chunk_size, sinfo.stripe_width

        def finalize():
            wait = t_launch + DEVICE_S - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            shards = real_encode(sinfo, host, np.concatenate(bufs))
            out = []
            off = 0
            for op_id, buf in zip(ops, bufs):
                nchunk = len(buf) // sw * cs
                out.append((op_id,
                            {i: v[off:off + nchunk]
                             for i, v in shards.items()}, None))
                off += nchunk
            return out

        return finalize

    monkeypatch.setenv("CEPH_TPU_FUSE_CRC", "1")
    monkeypatch.setattr(ec_util, "_flush_device_fused_async", fake_async)
    monkeypatch.setattr(de, "_launch_context", launch_context)


def _burst(window: int, monkeypatch, n_ops: int = 8):
    """Stage ``n_ops`` single-op flushes; returns (wall_s, order, stats,
    launches)."""
    launches: list = []
    _fake_device(monkeypatch, launches)
    codec = _codec(backend="torch")
    sinfo = StripeInfo(stripe_width=2 * 1024, chunk_size=1024)
    data = np.zeros(2048, dtype=np.uint8)
    done: list = []
    all_done = threading.Event()
    # flush_bytes == payload: every op flushes (and launches) alone
    eng = DeviceEncodeEngine(lambda k, f: f(), flush_bytes=2048,
                             window=window)
    try:
        t0 = time.perf_counter()
        for i in range(n_ops):
            def cont(i=i):
                def fn(shards, crcs, err):
                    assert err is None, err
                    done.append(i)
                    if len(done) == n_ops:
                        all_done.set()
                return fn
            eng.stage_encode("pgA", codec, sinfo, data, cont())
        assert all_done.wait(30), done
        wall = time.perf_counter() - t0
    finally:
        eng.stop()
    return wall, done, dict(eng.stats), launches


def test_pipelined_burst_overlaps_and_beats_serial(monkeypatch):
    """An 8-flush burst through the pipelined engine reaches in-flight
    depth >= 2 and a lower wall clock than the same burst with window=1
    (the serial engine); launch n runs on window slot n % window. The
    wall-clock bar gets one retry on a box of <= 2 cores, as the
    reference's does."""
    telemetry().reset()
    attempts = 1 if len(os.sched_getaffinity(0)) > 2 else 2
    for attempt in range(attempts):
        wall_serial, order_serial, stats_serial, l_serial = \
            _burst(1, monkeypatch)
        wall_piped, order_piped, stats_piped, l_piped = \
            _burst(3, monkeypatch)
        assert order_serial == list(range(8))
        assert order_piped == list(range(8))
        assert stats_piped["max_inflight_depth"] >= 2, stats_piped
        assert stats_serial["max_inflight_depth"] == 1, stats_serial
        assert stats_piped["flushes"] == 8 and \
            stats_serial["flushes"] == 8
        assert [s for _t, s in l_piped] == [n % 3 for n in range(8)]
        assert [s for _t, s in l_serial] == [0] * 8
        if wall_piped < wall_serial:
            break
        if attempt == attempts - 1:
            raise AssertionError(
                f"pipelined burst never beat serial: "
                f"{wall_piped:.3f}s vs {wall_serial:.3f}s")
    counters = telemetry().snapshot()["counters"]
    depth_hist = counters["engine_inflight_depth"]
    assert sum(depth_hist[2:]) > 0, depth_hist
    assert sum(counters["engine_overlap_pct"]) >= 8


def test_barrier_sees_all_prior_flushes_retired(monkeypatch):
    """A barrier's fn runs only after every previously staged op's
    continuation, on the same key, under the in-flight window."""
    launches: list = []
    _fake_device(monkeypatch, launches)
    codec = _codec(backend="torch")
    sinfo = StripeInfo(stripe_width=2 * 1024, chunk_size=1024)
    data = np.zeros(2048, dtype=np.uint8)
    order: list = []
    done = threading.Event()
    eng = DeviceEncodeEngine(lambda k, f: f(), flush_bytes=2048,
                             window=3)
    try:
        for i in range(1, 4):
            eng.stage_encode(
                "A", codec, sinfo, data,
                lambda s, c, e, i=i: order.append(f"e{i}"))
        eng.stage_barrier("A", lambda: order.append("b1"))
        eng.stage_encode("A", codec, sinfo, data,
                         lambda s, c, e: order.append("e4"))
        eng.stage_barrier(
            "A", lambda: (order.append("b2"), done.set()))
        assert done.wait(30), order
    finally:
        eng.stop()
    assert order == ["e1", "e2", "e3", "b1", "e4", "b2"], order


def test_decode_sync_correct_while_window_full(monkeypatch):
    """A blocking decode issued while encode batches are in flight
    returns bit-exact data."""
    launches: list = []
    _fake_device(monkeypatch, launches)
    codec = _codec(backend="torch")
    host = _codec()
    sinfo = StripeInfo(stripe_width=2 * 1024, chunk_size=1024)
    rng = np.random.default_rng(4)
    payload = rng.integers(0, 256, 4096, dtype=np.uint8)
    full = ec_util.encode(sinfo, host, payload)
    eng = DeviceEncodeEngine(lambda k, f: f(), flush_bytes=2048,
                             window=3)
    try:
        for _ in range(4):
            eng.stage_encode("A", codec, sinfo,
                             np.zeros(2048, dtype=np.uint8),
                             lambda s, c, e: None)
        out = eng.decode_sync("A", codec, sinfo,
                              {0: full[0], 2: full[2]}, [0, 1])
        assert out is not None
        assert np.array_equal(np.asarray(out[1]), full[1])
    finally:
        eng.stop()


def test_stop_drains_window(monkeypatch):
    """stop() retires every in-flight batch AND flushes everything staged
    before it, including ops queued while the engine was mid-drain."""
    launches: list = []
    _fake_device(monkeypatch, launches)
    codec = _codec(backend="torch")
    sinfo = StripeInfo(stripe_width=2 * 1024, chunk_size=1024)
    done: list = []
    eng = DeviceEncodeEngine(lambda k, f: f(), flush_bytes=2048,
                             window=4)
    eng.stage_encode("A", codec, sinfo,
                     np.zeros(2048, dtype=np.uint8),
                     lambda s, c, e: done.append(0))
    time.sleep(DEVICE_S / 2)
    for i in range(1, 4):
        eng.stage_encode("A", codec, sinfo,
                         np.zeros(2048, dtype=np.uint8),
                         lambda s, c, e, i=i: done.append(i))
    eng.stop()
    assert done == [0, 1, 2, 3], done


def test_launch_failure_drains_older_batches_first(monkeypatch):
    """A failed launch's error continuation does not overtake OLDER
    in-flight batches' continuations (per-PG order)."""
    launches: list = []
    _fake_device(monkeypatch, launches)
    codec = _codec(backend="torch")
    sinfo = StripeInfo(stripe_width=2 * 1024, chunk_size=1024)
    order: list = []
    done = threading.Event()

    orig = ec_util._flush_device_fused_async
    calls = {"n": 0}

    def flaky(sinfo_, codec_, ops, bufs, **kw):
        calls["n"] += 1
        if calls["n"] == 2:            # second batch's launch dies
            raise RuntimeError("injected launch fault")
        return orig(sinfo_, codec_, ops, bufs, **kw)

    monkeypatch.setattr(ec_util, "_flush_device_fused_async", flaky)
    eng = DeviceEncodeEngine(lambda k, f: f(), flush_bytes=2048,
                             window=3)
    try:
        eng.stage_encode("A", codec, sinfo,
                         np.zeros(2048, dtype=np.uint8),
                         lambda s, c, e: order.append(("ok1", e)))
        eng.stage_encode("A", codec, sinfo,
                         np.zeros(2048, dtype=np.uint8),
                         lambda s, c, e: (order.append(("bad", e)),
                                          done.set()))
        assert done.wait(30), order
    finally:
        eng.stop()
    assert [tag for tag, _e in order] == ["ok1", "bad"], order
    assert order[0][1] is None
    assert isinstance(order[1][1], RuntimeError)
    assert eng.stats["errors"] == 1


def test_ordering_across_100_fused_flushes(monkeypatch):
    """100 same-signature flushes through the pipelined engine complete
    in staging order, each on the fused route (linear crcs present) and
    equal to the host encode."""
    monkeypatch.setenv("CEPH_TPU_FUSE_CRC", "1")
    codec = _codec(backend="torch")
    host = _codec()
    sinfo = StripeInfo(stripe_width=2 * 1024, chunk_size=1024)
    rng = np.random.default_rng(7)
    data = [rng.integers(0, 256, 2048, dtype=np.uint8)
            for _ in range(100)]
    done: list = []
    all_done = threading.Event()
    eng = DeviceEncodeEngine(lambda k, f: f(), flush_bytes=2048,
                             window=3)
    try:
        for i in range(100):
            eng.stage_encode(
                "A", codec, sinfo, data[i],
                lambda s, c, e, i=i: (done.append((i, s, c, e)),
                                      all_done.set()
                                      if len(done) == 100 else None))
        assert all_done.wait(120), len(done)
    finally:
        eng.stop()
    assert [i for i, *_ in done] == list(range(100))
    for i, shards, crcs, err in done:
        assert err is None and crcs is not None, i
        ref = ec_util.encode(sinfo, host, data[i])
        for pos in ref:
            assert np.array_equal(shards[pos], ref[pos]), (i, pos)
    assert eng.stats["flushes"] == 100
    assert eng.stats["host_flushes"] == 0


def test_hbm_gauges_reconcile_to_zero(monkeypatch):
    """The live HBM gauges (staged / in-window) read exactly zero once a
    burst drains, and the retired counter accounts every byte."""
    telemetry().reset()
    _wall, order, _stats, _l = _burst(3, monkeypatch)
    assert order == list(range(8))
    tel = telemetry()
    assert tel.hbm_live_bytes() == 0
    assert tel.perf.get("hbm_staged_bytes") == 0
    assert tel.perf.get("hbm_inflight_bytes") == 0
    assert tel.perf.get("hbm_live_bytes") == 0
    assert tel.perf.get("hbm_retired_bytes") == 8 * 2048
    assert tel.perf.get("hbm_peak_live_bytes") >= 2048
    telemetry().reset()


def test_hbm_gauges_reconcile_on_launch_failure(monkeypatch):
    """A batch whose launch dies leaves nothing behind in the live
    gauges (its bytes count as retired)."""
    telemetry().reset()
    codec = _codec(backend="torch")
    sinfo = StripeInfo(stripe_width=2 * 1024, chunk_size=1024)
    done = threading.Event()
    monkeypatch.setenv("CEPH_TPU_FUSE_CRC", "1")
    monkeypatch.setattr(
        ec_util, "_flush_device_fused_async",
        lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("injected launch fault")))
    eng = DeviceEncodeEngine(lambda k, f: f(), flush_bytes=2048,
                             window=3)
    try:
        eng.stage_encode("A", codec, sinfo,
                         np.zeros(2048, dtype=np.uint8),
                         lambda s, c, e: done.set())
        assert done.wait(30)
    finally:
        eng.stop()
    tel = telemetry()
    assert tel.hbm_live_bytes() == 0
    assert tel.perf.get("hbm_retired_bytes") == 2048
    telemetry().reset()


def test_shared_engine_shutdown_drain_multiple_attachments():
    """With ONE engine serving several OSDs, a detaching attachment
    drains its own staged work, later attachments keep the engine alive,
    and the LAST detach stops it and releases the process-wide
    instance."""
    codec = _codec()
    sinfo = StripeInfo(stripe_width=2 * 1024, chunk_size=1024)
    done_a: list = []
    done_b: list = []
    h1 = de.shared_engine_attach(lambda k, fn: fn())
    h2 = de.shared_engine_attach(lambda k, fn: fn())
    try:
        assert h1.engine is h2.engine
        for i in range(4):
            h1.stage_encode(f"pg{i}", codec, sinfo,
                            np.zeros(2048, dtype=np.uint8),
                            lambda s, c, e, i=i: done_a.append((i, e)))
            h2.stage_encode(f"pg{i}", codec, sinfo,
                            np.zeros(2048, dtype=np.uint8),
                            lambda s, c, e, i=i: done_b.append((i, e)))
        h1.stop()
        assert [i for i, _ in done_a] == [0, 1, 2, 3]
        assert all(e is None for _, e in done_a)
        assert h1.engine._running
        h2.stage_encode("pg9", codec, sinfo,
                        np.zeros(2048, dtype=np.uint8),
                        lambda s, c, e: done_b.append((9, e)))
        h2.stop()
        assert [i for i, _ in done_b] == [0, 1, 2, 3, 9]
        assert all(e is None for _, e in done_b)
        assert not h2.engine._running
        assert de._shared_engine is None
    finally:
        h1.stop()
        h2.stop()


# -- the device stripe-batch path (tests/test_device_path.py) -----------

def _gate_first_matvec(codec):
    """Hold the codec's first host matvec until released: (entered,
    release, calls)."""
    in_first = threading.Event()
    release = threading.Event()
    orig = codec._matvec
    calls = []

    def gated(mat, data):
        calls.append(mat.shape)
        if len(calls) == 1:
            in_first.set()
            release.wait(10)
        return orig(mat, data)

    codec._matvec = gated
    return in_first, release, calls


def _wait_for(pred, seconds=10.0):
    deadline = time.monotonic() + seconds
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)


def test_engine_batches_while_busy():
    """Ops staged while the device is busy coalesce into ONE launch;
    per-key continuation order is staging order; bytes equal a solo host
    encode."""
    codec = _codec()
    sinfo = StripeInfo(stripe_width=2 * 1024, chunk_size=1024)
    in_first, release, _calls = _gate_first_matvec(codec)
    done = []
    eng = DeviceEncodeEngine(lambda key, fn: fn())
    try:
        rng = np.random.default_rng(0)
        payloads = [rng.integers(0, 256, 2048, dtype=np.uint8)
                    for _ in range(16)]

        def cont(i):
            def fn(shards, crcs, err):
                assert err is None
                done.append((i, shards))
            return fn

        eng.stage_encode("pg0", codec, sinfo, payloads[0], cont(0))
        assert in_first.wait(10)          # engine busy in launch 1
        for i in range(1, 16):
            eng.stage_encode(f"pg{i % 4}", codec, sinfo, payloads[i],
                             cont(i))
        release.set()
        _wait_for(lambda: len(done) >= 16)
        assert len(done) == 16
        assert eng.stats["flushes"] == 2, eng.stats
        assert eng.stats["max_batch_ops"] == 15, eng.stats
        by_key: dict[int, list[int]] = {}
        for i, _ in done:
            by_key.setdefault(i % 4, []).append(i)
        for key, seq in by_key.items():
            assert seq == sorted(seq), (key, seq)
        for i, shards in done:
            ref = ec_util.encode(sinfo, _codec(), payloads[i])
            for pos in ref:
                assert np.array_equal(shards[pos], ref[pos]), (i, pos)
    finally:
        eng.stop()


def test_engine_barrier_ordering_and_error():
    """Barrier order, and a device fault reaches the continuation as err
    without wedging the engine."""
    codec = _codec()
    sinfo = StripeInfo(stripe_width=2 * 1024, chunk_size=1024)
    order = []
    eng = DeviceEncodeEngine(lambda key, fn: fn())
    try:
        data = np.zeros(2048, dtype=np.uint8)
        eng.stage_encode("A", codec, sinfo, data,
                         lambda s, c, e: order.append("e1"))
        eng.stage_barrier("A", lambda: order.append("b1"))
        eng.stage_encode("A", codec, sinfo, data,
                         lambda s, c, e: order.append("e2"))
        _wait_for(lambda: len(order) >= 3)
        assert order == ["e1", "b1", "e2"]
        bad = _codec()
        bad._matvec = lambda mat, d: (_ for _ in ()).throw(
            RuntimeError("injected device fault"))
        got = []
        eng.stage_encode("A", bad, sinfo, data,
                         lambda s, c, e: got.append((s, e)))
        _wait_for(lambda: bool(got))
        assert got and got[0][0] is None
        assert isinstance(got[0][1], RuntimeError)
        assert eng.stats["errors"] == 1
    finally:
        eng.stop()


def test_poisoned_fused_flush_reaches_continuation_as_error(monkeypatch):
    """The port's counterpart of the reference's
    test_poisoned_fused_flush_completes_and_counts, a deliberate
    deviation: the port's fused flush has no plain fallback, so a broken
    fused path reaches the op's continuation as ``err`` and counts
    ``errors``; ``device_fused_fallbacks`` stays 0, and the engine keeps
    completing later writes."""
    monkeypatch.setenv("CEPH_TPU_FUSE_CRC", "1")

    def boom(*a, **k):
        raise RuntimeError("poisoned fused path")

    real = ec_util._flush_device_fused_async
    monkeypatch.setattr(ec_util, "_flush_device_fused_async", boom)
    codec = _codec(backend="torch")
    sinfo = StripeInfo(stripe_width=2 * 1024, chunk_size=1024)
    eng = DeviceEncodeEngine(lambda key, fn: fn())
    try:
        rng = np.random.default_rng(3)
        payload = rng.integers(0, 256, 4096, dtype=np.uint8)
        got = []
        eng.stage_encode("pg0", codec, sinfo, payload,
                         lambda s, c, e: got.append((s, c, e)))
        _wait_for(lambda: bool(got), 15)
        assert got, "write never completed"
        shards, crcs, err = got[0]
        assert shards is None and crcs is None
        assert isinstance(err, RuntimeError)
        assert eng.stats["errors"] == 1, eng.stats
        assert eng.stats["device_fused_fallbacks"] == 0, eng.stats
        monkeypatch.setattr(ec_util, "_flush_device_fused_async", real)
        got.clear()
        eng.stage_encode("pg0", codec, sinfo, payload,
                         lambda s, c, e: got.append((s, c, e)))
        _wait_for(lambda: bool(got), 15)
        assert got and got[0][2] is None and got[0][1] is not None
        ref = ec_util.encode(sinfo, _codec(), payload)
        for pos in ref:
            assert np.array_equal(np.asarray(got[0][0][pos]), ref[pos])
        assert eng.stats["errors"] == 1
    finally:
        eng.stop()


def test_engine_double_buffers_fused_launches(monkeypatch):
    """Batch N+1 LAUNCHES before batch N's results are finalized, while
    continuations still dispatch in batch order. Batch 0's finalize waits
    (up to 10 s) for launch 1 before it records itself, so the order
    does not hang on which thread the scheduler runs first; a serial
    engine launches batch 1 only after that wait ran out."""
    monkeypatch.setenv("CEPH_TPU_FUSE_CRC", "1")
    order: list[str] = []
    first_entered = threading.Event()
    go = threading.Event()
    second_launched = threading.Event()

    def fake_async(sinfo, codec, ops, bufs, batch=None):
        n = sum(1 for e in order if e.startswith("launch"))
        order.append(f"launch{n}")
        if n == 0:
            first_entered.set()
            go.wait(10)        # hold the engine inside launch 0
        else:
            second_launched.set()

        def finalize():
            if n == 0:
                second_launched.wait(10)
            order.append(f"fin{n}")
            out = []
            cs, sw = sinfo.chunk_size, sinfo.stripe_width
            shards = ec_util.encode(sinfo, _codec(),
                                    np.concatenate(bufs))
            off = 0
            for op_id, buf in zip(ops, bufs):
                nchunk = len(buf) // sw * cs
                out.append((op_id,
                            {i: v[off:off + nchunk]
                             for i, v in shards.items()}, None))
                off += nchunk
            return out

        return finalize

    monkeypatch.setattr(ec_util, "_flush_device_fused_async", fake_async)
    codec = _codec(backend="torch")
    sinfo = StripeInfo(stripe_width=2 * 1024, chunk_size=1024)
    done = []
    eng = DeviceEncodeEngine(lambda k, f: f(), flush_bytes=4096)
    try:
        data = np.zeros(4096, dtype=np.uint8)   # one op = threshold
        eng.stage_encode("A", codec, sinfo, data,
                         lambda s, c, e: done.append((1, e)))
        assert first_entered.wait(10)
        eng.stage_encode("A", codec, sinfo, data,
                         lambda s, c, e: done.append((2, e)))
        go.set()
        _wait_for(lambda: len(done) >= 2)
        assert [d[0] for d in done] == [1, 2], done
        assert all(e is None for _, e in done), done
        assert order == ["launch0", "launch1", "fin0", "fin1"], order
        assert eng.stats["flushes"] == 2
    finally:
        eng.stop()


def test_engine_decode_batches_by_signature():
    """Concurrent reconstructs with the same erasure signature coalesce
    into ONE flush; different signatures flush separately; results are
    bit-exact."""
    codec = _codec(k=4, m=2)
    sinfo = StripeInfo(stripe_width=4 * 1024, chunk_size=1024)
    in_first, release, _calls = _gate_first_matvec(codec)
    eng = DeviceEncodeEngine(lambda key, fn: fn())
    try:
        rng = np.random.default_rng(1)
        host = _codec(k=4, m=2)
        payloads = [rng.integers(0, 256, 8192, dtype=np.uint8)
                    for _ in range(9)]
        full = [ec_util.encode(sinfo, host, p) for p in payloads]
        eng.stage_encode("pgX", codec, sinfo, payloads[0],
                         lambda s, c, e: None)
        assert in_first.wait(10)
        results: dict[int, dict] = {}
        done = threading.Event()

        def mk(i):
            def cont(out, err):
                assert err is None, err
                results[i] = out
                if len(results) == 8:
                    done.set()
            return cont

        for i in range(8):
            shards = dict(full[i])
            if i < 6:
                del shards[1]            # signature A: lost chunk 1
            else:
                del shards[0]
                del shards[3]            # signature B: lost 0 and 3
            eng.stage_decode(f"pg{i}", codec, sinfo, shards,
                             [0, 1, 2, 3], mk(i))
        release.set()
        assert done.wait(15)
        assert eng.stats["decode_flushes"] == 2, eng.stats
        assert eng.stats["decode_ops"] == 8
        assert eng.stats["max_decode_batch_ops"] == 6, eng.stats
        for i in range(8):
            for c in range(4):
                assert np.array_equal(
                    np.asarray(results[i][c]), full[i][c]), (i, c)
    finally:
        eng.stop()


def test_engine_decode_sync_and_error():
    """decode_sync returns bit-exact data; a device fault surfaces as
    None and counts decode_errors, and never wedges the engine. The
    signature (k=4, m=2, data chunks 0 and 1 lost) is not XOR-decodable,
    so the decode reaches the codec's device matvec."""
    codec = _codec(k=4, m=2)
    sinfo = StripeInfo(stripe_width=4 * 1024, chunk_size=1024)
    eng = DeviceEncodeEngine(lambda key, fn: fn())
    try:
        rng = np.random.default_rng(2)
        payload = rng.integers(0, 256, 8192, dtype=np.uint8)
        full = ec_util.encode(sinfo, _codec(k=4, m=2), payload)
        shards = {i: full[i] for i in (2, 3, 4, 5)}
        assert not ec_util.xor_decodable(codec, shards, [0, 1])
        out = eng.decode_sync("pg0", codec, sinfo, shards, [0, 1])
        assert out is not None
        for c in (0, 1):
            assert np.array_equal(np.asarray(out[c]), full[c])
        bad = _codec(k=4, m=2)
        bad._matvec = lambda m, d: (_ for _ in ()).throw(
            RuntimeError("injected decode fault"))
        assert eng.decode_sync("pg0", bad, sinfo, shards, [0, 1]) is None
        assert eng.stats["decode_errors"] == 1
        out2 = eng.decode_sync("pg0", codec, sinfo, shards, [1])
        assert out2 is not None and \
            np.array_equal(np.asarray(out2[1]), full[1])
    finally:
        eng.stop()


def test_counters_across_staged_encode_decode_round_trip():
    """A staged encode + signature-batched decode round trip moves the
    always-on counters as the scripted flush pattern says
    (tests/test_device_telemetry.py:113)."""
    def counters():
        return telemetry().snapshot()["counters"]

    codec = _codec(k=2, m=1)
    sinfo = StripeInfo(stripe_width=2 * 1024, chunk_size=1024)
    in_first, release, _calls = _gate_first_matvec(codec)
    before = counters()
    eng = DeviceEncodeEngine(lambda key, fn: fn())
    try:
        rng = np.random.default_rng(0)
        payloads = [rng.integers(0, 256, 2048, dtype=np.uint8)
                    for _ in range(6)]
        done = []
        eng.stage_encode("pg0", codec, sinfo, payloads[0],
                         lambda s, c, e: done.append(e))
        assert in_first.wait(10)      # flush 1 (1 op) holds the gate
        for p in payloads[1:]:        # flush 2 accumulates 5 ops
            eng.stage_encode("pg1", codec, sinfo, p,
                             lambda s, c, e: done.append(e))
        release.set()
        _wait_for(lambda: len(done) >= 6)
        assert len(done) == 6 and all(e is None for e in done)
        host = _codec(k=2, m=1)
        full = ec_util.encode(sinfo, host, payloads[0])
        out = eng.decode_sync("pg0", codec, sinfo,
                              {0: full[0], 2: full[2]}, [0, 1])
        assert out is not None and \
            np.array_equal(np.asarray(out[1]), full[1])
    finally:
        eng.stop()
    after = counters()
    d_occ = [a - b for a, b in zip(after["encode_batch_ops"],
                                   before["encode_batch_ops"])]
    assert d_occ[1] == 1 and d_occ[3] == 1 and sum(d_occ) == 2, d_occ
    d_dec = [a - b for a, b in zip(after["decode_batch_ops"],
                                   before["decode_batch_ops"])]
    assert d_dec[1] == 1 and sum(d_dec) == 1, d_dec
    assert after["bytes_encoded"] - before["bytes_encoded"] == 2048 * 6
    assert after["bytes_decoded"] > before["bytes_decoded"]
    assert after["encode_queue_wait"]["avgcount"] - \
        before["encode_queue_wait"]["avgcount"] == 6
    assert after["decode_queue_wait"]["avgcount"] - \
        before["decode_queue_wait"]["avgcount"] == 1
    assert after["flush_device_time"]["avgcount"] - \
        before["flush_device_time"]["avgcount"] == 2
    assert after["decode_flush_device_time"]["avgcount"] - \
        before["decode_flush_device_time"]["avgcount"] == 1
    d_bytes = [a - b for a, b in zip(after["flush_bytes"],
                                     before["flush_bytes"])]
    # flush sizes: 2048 (bucket 12) and 5*2048 = 10240 (bucket 14)
    assert d_bytes[12] == 1 and d_bytes[14] == 1, d_bytes


def test_knobs_resolve_argument_then_env_then_default(monkeypatch):
    monkeypatch.delenv("CEPH_TPU_HOST_FLUSH_BYTES")
    for name in ("CEPH_TPU_ENGINE_FLUSH_BYTES", "CEPH_TPU_ENGINE_WINDOW"):
        monkeypatch.delenv(name, raising=False)
    eng = DeviceEncodeEngine(lambda k, f: f())
    assert (eng._flush_bytes, eng._window, eng._host_flush_bytes) == \
        (64 << 20, 3, 512 << 10)
    eng.stop()
    monkeypatch.setenv("CEPH_TPU_ENGINE_FLUSH_BYTES", "4096")
    monkeypatch.setenv("CEPH_TPU_ENGINE_WINDOW", "2")
    monkeypatch.setenv("CEPH_TPU_HOST_FLUSH_BYTES", "0")
    eng = DeviceEncodeEngine(lambda k, f: f())
    assert (eng._flush_bytes, eng._window, eng._host_flush_bytes) == \
        (4096, 2, 0)
    eng.stop()
    eng = DeviceEncodeEngine(lambda k, f: f(), flush_bytes=8192, window=5,
                             host_flush_bytes=7)
    assert (eng._flush_bytes, eng._window, eng._host_flush_bytes) == \
        (8192, 5, 7)
    eng.stop()


# -- the threaded burst against the reference engine ---------------------

CHUNK = 1024
N_OPS = 32
PRODUCERS = 4

#: (route, engine flush_bytes). ``fused``: multi-op flushes, every one on
#: the fused route (all mixes here fit the working-set limit); ``edge``:
#: one op a flush with the working-set limit lowered to the bucket of a
#: 4-stripe op, so ops of 1-4 stripes sit at or under the edge and fuse,
#: and ops of 5-8 stripes are past it and take the plain flush; ``host``:
#: the default small-flush host route (flushes stay under 512 KiB).
BURSTS = [("fused", 16 << 10), ("edge", 1), ("host", 16 << 10)]


def _burst_ops(k: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    stripes = rng.integers(1, 9, N_OPS)
    stripes[:2] = (4, 8)
    return [rng.integers(0, 256, int(s) * k * CHUNK, dtype=np.uint8)
            for s in stripes]


def _run_threaded(engine_cls, codec, sinfo, ops, flush_bytes):
    """Stage ``ops`` from PRODUCERS threads (thread t takes ops t, t+4,
    ... under key pg<t>); returns ({op: (shards, crcs, err)}, {key:
    continuation order}, stats)."""
    eng = engine_cls(lambda key, fn: fn(), flush_bytes=flush_bytes,
                     window=3)
    out: dict = {}
    order = {t: [] for t in range(PRODUCERS)}
    lock = threading.Lock()
    done = threading.Event()

    def producer(t):
        for i in range(t, len(ops), PRODUCERS):
            def cont(s, c, e, i=i):
                with lock:
                    out[i] = (s, c, e)
                    order[t].append(i)
                    if len(out) == len(ops):
                        done.set()
            eng.stage_encode(f"pg{t}", codec, sinfo, ops[i], cont)

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(PRODUCERS)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert done.wait(300), len(out)
    finally:
        eng.stop()
    return out, order, dict(eng.stats)


@pytest.mark.parametrize("route,flush_bytes", BURSTS,
                         ids=[b[0] for b in BURSTS])
@pytest.mark.parametrize("plugin,k,m", [("isa", 8, 3), ("jerasure", 4, 2)])
def test_threaded_burst_matches_reference_engine(monkeypatch, plugin, k, m,
                                                 route, flush_bytes):
    """4 producer threads, 32 ragged ops of 1-8 stripes: every op's
    shards and linear crcs from the port's engine equal the reference
    engine's (tolerance 0), and each key's continuations come in staging
    order on both."""
    monkeypatch.setenv("CEPH_TPU_FUSE_CRC", "1")
    if route == "host":
        monkeypatch.delenv("CEPH_TPU_HOST_FLUSH_BYTES")
    n = k + m
    if route == "edge":
        limit = n * 4 * CHUNK          # the 4-stripe op's bucket, exactly
        monkeypatch.setattr(ec_util, "_FUSE_CRC_MAX_SEG_BYTES", limit)
        monkeypatch.setattr(ref_ec, "_FUSE_CRC_MAX_SEG_BYTES", limit)
    ref = ref_registry.instance().factory(
        plugin, {"plugin": plugin, "k": str(k), "m": str(m),
                 "backend": "jax"})
    port = from_reference_profile(ref.get_profile(), ref.coding_matrix,
                                  device="cpu")
    sinfo = StripeInfo(stripe_width=k * CHUNK, chunk_size=CHUNK)
    ref_sinfo = ref_ec.StripeInfo(stripe_width=k * CHUNK, chunk_size=CHUNK)
    ops = _burst_ops(k, seed=k * 10 + m)
    got, order, stats = _run_threaded(DeviceEncodeEngine, port, sinfo, ops,
                                      flush_bytes)
    want, ref_order, ref_stats = _run_threaded(
        ref_de.DeviceEncodeEngine, ref, ref_sinfo, ops, flush_bytes)
    for t in range(PRODUCERS):
        assert order[t] == ref_order[t] == list(range(t, N_OPS, PRODUCERS))
    for i, buf in enumerate(ops):
        shards, crcs, err = got[i]
        rshards, rcrcs, rerr = want[i]
        assert err is None and rerr is None, (i, err, rerr)
        assert crcs == rcrcs, i
        fused = route == "fused" or \
            (route == "edge" and len(buf) <= 4 * k * CHUNK)
        assert (crcs is not None) == fused, (i, len(buf))
        assert sorted(shards) == sorted(rshards) == list(range(n))
        for pos in range(n):
            assert np.array_equal(np.asarray(shards[pos]),
                                  np.asarray(rshards[pos])), (i, pos)
    assert stats["errors"] == ref_stats["errors"] == 0
    assert stats["ops"] == N_OPS
    assert (stats["host_flushes"] > 0) == (route == "host")
    assert stats["device_fused_fallbacks"] == 0


def test_engine_loop_runs_the_flush_device_step_on_cpu():
    """The engine-capacity harness gates the fused flush's exposed device
    step against the host oracles and times both legs (plain versions on
    the CPU, at a small shape)."""
    from ceph_tpu_torch.bench import engine_loop
    out = engine_loop.run(nops=3, op_bytes=64 << 10, device="cpu",
                          rounds=1, target_wall=0.01, time_budget=0.5)
    assert out["metric"] == "engine_closed_loop_GBps"
    assert out["value"] > 0 and out["chained_GBps"] > 0
    assert out["batch_mb"] == 3 * (64 << 10) / 1e6
    assert "projection_GBps" not in out


@pytest.mark.parametrize("workers", [1, 2])
def test_engine_callers_drain_on_cpu(monkeypatch, workers):
    """The caller-count harness drives phase 5b's held drain through the
    fused route (plain versions on the CPU, 2 flushes of 4 x 64 KiB),
    checks stored shards against the host oracle, and reports each
    flush's host split."""
    from ceph_tpu_torch.bench import engine_callers
    monkeypatch.setenv("CEPH_TPU_HOST_FLUSH_BYTES", "0")
    monkeypatch.setenv("CEPH_TPU_FUSE_CRC", "1")
    out = engine_callers.trial(workers, flushes=2, objects=4,
                               object_bytes=64 << 10, device="cpu")
    assert out["workers"] == workers and out["flushes"] == 2
    assert out["max_inflight_depth"] >= 1 and out["drain_s"] > 0
    assert sorted(out["split_ms"]) == ["alloc", "launch", "upload", "wait"]
    assert all(len(v) == 2 for v in out["split_ms"].values())


def test_stager_sizes_segments_by_load():
    """Under light load a segment starts small and doubles as ops land,
    as the reference's buffer does, so a 4 KiB op holds no flush-sized
    block; once a segment has filled to the flush threshold (a backlog),
    the next one opens at that size at once. A cut inside a segment
    moves its tail into a small buffer again."""
    codec = _codec()
    seg = 4 * de._ConcatStager._MIN_CAP
    stager = de._ConcatStager(seg_bytes=seg)
    small = np.arange(4096, dtype=np.uint8)
    with stager.lock:
        stager.append_locked(codec, 0, small)
    (first,) = stager._by_codec[(id(codec), 0)]
    assert len(first["np"]) == de._ConcatStager._MIN_CAP
    op = np.full(seg // 4, 7, dtype=np.uint8)
    with stager.lock:
        for _ in range(4):                   # fills and closes segment 1
            stager.append_locked(codec, 0, op)
        stager.append_locked(codec, 0, small)
    segs = stager._by_codec[(id(codec), 0)]
    assert len(segs) == 2 and len(segs[1]["np"]) == seg
    batch, views = stager.take(codec, 0, 3)   # a cut inside segment 1
    assert len(batch) == 4096 + 2 * (seg // 4)
    assert np.array_equal(views[0], small)
    tail = stager._by_codec[(id(codec), 0)][0]
    assert len(tail["np"]) == 2 * (seg // 4) == tail["used"]


def test_stager_segments_backlog_by_flush():
    """The stager closes a buffer at the engine's flush threshold: a
    backlog taken a flush at a time is handed over without copies; a
    take inside a segment relocates only that segment's later ops; a
    take across segments joins them. Every view holds its op's bytes."""
    codec = _codec()
    stager = de._ConcatStager(seg_bytes=4096)
    rng = np.random.default_rng(5)
    ops = [rng.integers(0, 256, 1024, dtype=np.uint8) for _ in range(12)]
    with stager.lock:
        for op in ops:
            stager.append_locked(codec, 0, op)
    batch, views = stager.take(codec, 0, 4)        # one whole segment
    assert stager.stats["relocated_bytes"] == stager.stats["joined_bytes"] \
        == 0
    assert np.array_equal(batch, np.concatenate(ops[:4]))
    batch, views = stager.take(codec, 0, 2)        # inside segment 2
    assert stager.stats["relocated_bytes"] == 2048
    batch, views = stager.take(codec, 0, 4)        # across segments
    assert stager.stats["joined_bytes"] == 4096
    assert np.array_equal(batch, np.concatenate(ops[6:10]))
    assert all(np.array_equal(v, o) for v, o in zip(views, ops[6:10]))
    batch, views = stager.take(codec, 0, 2)
    assert [np.array_equal(v, o) for v, o in zip(views, ops[10:])] == \
        [True, True]
