"""The comparison that decides ``correct`` has to fail.

- On the CPU, at a size a test run holds: a whole run with the timed path
  broken underneath (an answer altered where it is produced; half of the
  batch left out; a step that hands back its first answer again, whatever
  it was given) comes out not correct. A cell on one card has no exchange
  between chips to leave out.
- On the card (``-m cuda``), at each cell's own size on three seeds: the
  control, the plain reference put in the program's place with one of the
  configuration's guarantees broken, comes out not correct.

    python -m pytest ecbench/tests -q            # the CPU part
    python -m pytest ecbench/tests -q -m cuda    # on the card
"""

from __future__ import annotations

import time

import pytest
import torch

from ecbench import run
from ecbench.reference import gf256, rs
from ecbench.reference.clay import ClayCode
from ecbench.tests.test_ecbench_harness import BENCH, CELLS, cpu_run


def _flip(out):
    if isinstance(out, tuple):
        out[0].view(-1)[0] ^= 1
    else:
        out.view(-1)[0] ^= 1
    return out


def _flip_crc(out):
    if isinstance(out, tuple):
        out[1].view(-1)[0] ^= 1
    else:
        out.view(-1)[0] ^= 1
    return out


def _half(out):
    """Everything past the first half of the objects left unencoded."""
    if isinstance(out, tuple):
        parity, lin = out
        parity[:, parity.shape[1] // 2:] = 0
        lin[lin.shape[0] // 2:] = 0
        return out
    out[..., out.shape[-1] // 2:] = 0
    return out


FAULTS = {"answer_altered": _flip, "crc_altered": _flip_crc,
          "half_the_batch": _half}


def _breaking(fault):
    def wrap(work):
        call = work.call
        work.call = lambda slot: fault(call(slot))
    return wrap


def _stale(work):
    """Every call hands back the answer of the first call it made."""
    call, first = work.call, []

    def stale(slot):
        if not first:
            first.append(call(slot))
        return first[0]
    work.call = stale


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS) + ["state_unchanged"])
def test_a_broken_timed_path_is_not_correct(name, fault):
    wrap = _stale if fault == "state_unchanged" else _breaking(FAULTS[fault])
    result = cpu_run(name, wrap=wrap)
    assert result["correct"] is False
    assert result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("lost", [0, 11])
def test_a_fault_in_one_repair_signature_is_not_correct(lost):
    """An answer altered only where one lost chunk is rebuilt: every
    signature is among the checked calls, so every seed catches it."""
    def wrap(work):
        call = work.call
        work.call = lambda slot: (_flip(call(slot)) if work.lost[slot] == lost
                                  else call(slot))
    for seed in (11, 2**31 + 3, 4_000_000_007):
        result = cpu_run("clay_k8m4d11.repair_batch", seed=seed, wrap=wrap)
        assert result["correct"] is False
        assert result["checks"]["chunk_bytes_wrong"]["value"] > 0
        assert result["checks"]["signatures_unchecked"]["value"] == 0


# -- the control, on the card ------------------------------------------

def _rs_control(work):
    """Parity with its last row never computed: a k=8,m=2 code where the
    configuration promises that any 3 chunks can be lost."""
    field = gf256.Field(work.ring[0].device)

    def control(slot):
        data = work.ring[slot]
        par = rs.parity(field, work.k, work.m, data)
        par[-1] = 0
        return par, rs.segment_crcs(data, par, work.op_shard_bytes)
    work.call = control


def _clay_encode_control(work):
    """The last parity chunk never computed."""
    g = work.geo
    code = ClayCode(g["k"], g["m"], g["d"], work.ring[0].device)

    def control(slot):
        par = code.encode(work.ring[slot])
        par[-1] = 0
        return par
    work.call = control


def _clay_repair_control(work):
    """Only the lost chunk's own repair planes rebuilt (the sub-chunks
    its helpers send for the same planes), the rest left unrebuilt."""
    g = work.geo
    code = ClayCode(g["k"], g["m"], g["d"], work.data[0].device)
    q = g["d"] - g["k"] + 1
    cache = {}

    def control(slot):
        if slot not in cache:
            data, lost = work.data[slot], work.lost[slot]
            chunk = (data[lost] if lost < g["k"] else
                     code.encode(data)[lost - g["k"]]).clone()
            chunk[g["ssc"] // q:] = 0
            cache[slot] = chunk
        return cache[slot].clone()
    work.call = control


CONTROLS = {"rs_k8m3.encode_batch": _rs_control,
            "clay_k8m4d11.encode_batch": _clay_encode_control,
            "clay_k8m4d11.repair_batch": _clay_repair_control}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3400000001, 3400000002, 3400000003])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_the_cell_size(card, name, seed):
    result = run.run_cell(name, seed, 2.0, False, time.perf_counter(),
                          bench=BENCH, wrap=CONTROLS[name])
    print(name, seed, result["checks"], result["failed"])
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
