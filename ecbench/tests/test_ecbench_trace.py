"""The readers of a traced stretch, on a made-up trace (CPU).

    python -m pytest ecbench/tests -q
"""

from __future__ import annotations

from pathlib import Path

import pytest

from ecbench import run, trace, yardstick

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _card_trace():
    """Two calls bounded by two syncs: window 1000-1600 us; B1 100 us and
    B2 50 us a call, a copy 150 us, so the card is busy 450 of 600 us."""
    return [
        _ev("cuda_runtime", "cudaDeviceSynchronize", 900.0, 100.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1000.0, 10.0),
        _ev("kernel", "void gf_matvec_kernel<4, true>(Params)", 1010.0, 100.0),
        _ev("kernel", "crc32c_rows_kernel(uint4 const*)", 1110.0, 50.0),
        _ev("kernel", "direct_copy_kernel", 1160.0, 150.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1400.0, 10.0),
        _ev("kernel", "void gf_matvec_kernel<4, true>(Params)", 1410.0, 100.0),
        _ev("kernel", "crc32c_rows_kernel(uint4 const*)", 1510.0, 50.0),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 1560.0, 40.0),
        _ev("kernel", "outside the window", 1700.0, 10.0),
    ]


def _view():
    yard = {"step": 335_000_000, "b1": 335_000_000, "b2": 167_500_000}
    return trace.view_from_events(_card_trace(), calls=2, yard=yard,
                                  enqueue_us=12.5)


def _read(name, view):
    mod = run.load_module(METRICS / f"{name}.py", f"t_{name}")
    return mod.read(view)


def test_window_busy_and_breakdown():
    view = _view()
    assert view.window == (1000.0, 1600.0)
    assert view.busy_s() == pytest.approx(450e-6)
    assert view.window_s == pytest.approx(600e-6)
    br = view.breakdown()
    assert br["device_ops"][0] == ["void gf_matvec_kernel<4, true>(Params)",
                                   pytest.approx(200e-6)]
    gaps = dict(br["idle_gaps"])
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(150e-6)


def test_metric_readers_on_a_made_up_trace():
    view = _view()
    # 335 MB a call at 3.35e12 B/s is 0.1 ms; the step takes 0.225 ms
    assert yardstick.bound_s(335_000_000) == pytest.approx(1e-4)
    assert _read("fused_step_roofline_pct.flush", view) == \
        pytest.approx(100 * 100 / 225)
    assert _read("b1_roofline_pct.flush", view) == pytest.approx(100.0)
    assert _read("b2_roofline_pct.flush", view) == pytest.approx(100.0)
    assert _read("layout_share_pct.flush", view) == \
        pytest.approx(100 * 150 / 450)
    assert _read("device_idle_pct.flush", view) == pytest.approx(25.0)
    assert _read("enqueue_us.flush", view) == 12.5
    assert _read("b3_roofline_pct.encode", view) is None
    assert _read("repair_roofline_pct.decode", view) is None
