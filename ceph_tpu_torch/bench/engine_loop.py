"""Closed-loop engine-capacity harness — port of
``ceph_tpu/bench/engine_loop.py``.

What it measures: the EXACT device step the engine's fused flush launches
(``ec_util.fused_step``, exposed as ``finalize.fused_fn`` with its staged
inputs ``finalize.staged``: RS parity by kernel B1 and every op's
per-shard linear crc by kernel B2 + the stage-2 combine), at the reference
harness's batch shape, with the data already on the card and no per-op
host round trip:

- ``pipelined``: N back-to-back launches of the step on the staged device
  inputs, then one ``torch.cuda.synchronize`` — the closed loop an engine
  drives, launch cost included, the result download excluded;
- ``chained``: the same launches with a carry dependency (row 0 of the
  data XORed with parity row 0 and a byte of the crcs), timed with CUDA
  events by the slope between two chain lengths (``bench/measure.py``).

Both consume parity AND crcs. The parity is gated against the host GF
oracle and op 0's crcs against the host crc32c first. Prints one JSON
line with the card's name and power limit:

    python -m ceph_tpu_torch.bench.engine_loop [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ceph_tpu_torch.bench.measure import stable_best_slope
from ceph_tpu_torch.models import instance
from ceph_tpu_torch.ops import crc32c_torch, gf256
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.utils import checksum


def nvidia_smi_line() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(k: int = 8, m: int = 3, nops: int = 16,
        op_bytes: int = 4 << 20, chunk_size: int = 4096,
        device="cuda", rounds: int = 8, target_wall: float = 1.0,
        time_budget: float = 60.0) -> dict:
    device = torch.device(device)
    codec = instance().factory(
        "isa", {"k": str(k), "m": str(m), "technique": "reed_sol_van"},
        device=device)
    sinfo = ec_util.StripeInfo(k * chunk_size, chunk_size)
    rng = np.random.default_rng(7)
    bufs = [rng.integers(0, 256, size=op_bytes, dtype=np.uint8)
            for _ in range(nops)]

    # the engine's fused flush at this shape, exposing the device step it
    # launched; gate it against the host oracles
    fin = ec_util._flush_device_fused_async(sinfo, codec, list(range(nops)),
                                            bufs)
    results = fin()
    data = np.stack([np.concatenate([r[1][i] for r in results])
                     for i in range(k)])
    parity = np.stack([np.concatenate([r[1][k + j] for r in results])
                       for j in range(m)])
    assert np.array_equal(parity,
                          gf256.gf_matvec_chunks(codec.coding_matrix, data)), \
        "device fused parity is not bit-exact vs the host codec"
    _op, shards0, crcs0 = results[0]
    seg = np.stack([shards0[i] for i in range(k + m)])
    host = checksum.crc32c_rows(seg, 0) ^ \
        np.uint32(crc32c_torch.zeros_crc(seg.shape[1], 0))
    assert [crcs0[i] for i in range(k + m)] == host.tolist(), \
        "device fused crcs are not bit-exact vs the host crc32c"
    fn = fin.fused_fn
    mat, ddata, lens, lmax, backend = fin.staged
    batch_bytes = int(ddata.shape[0]) * int(ddata.shape[1])

    # -- A: pipelined launches (launch cost included) ----------------------
    def pipelined_round(n_launches: int) -> float:
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n_launches):
            fn(mat, ddata, lens, lmax, backend)
        _sync(device)
        return time.perf_counter() - t0

    n_launches = 4
    while pipelined_round(n_launches) < target_wall and n_launches < 4096:
        n_launches *= 2
    best = min(pipelined_round(n_launches) for _ in range(rounds))
    per_launch = best / n_launches

    # -- B: chained launches (carry dependency, slope by CUDA events) ------
    def step(dd):
        par, lin = fn(mat, dd, lens, lmax, backend)
        byte = (lin.sum() & 0xFF).to(torch.uint8)
        dd[0:1] ^= par[0:1] ^ byte
        return dd

    slope, spread_pct, samples, contended = stable_best_slope(
        step, ddata.clone(),
        min_traffic_bytes=batch_bytes * (k + m) // k,
        time_budget=time_budget, stable_n=5)

    return {
        "metric": "engine_closed_loop_GBps",
        "value": batch_bytes / per_launch / 1e9,
        "unit": "GB/s",
        "chained_GBps": batch_bytes / slope / 1e9,
        "batch_mb": batch_bytes / 1e6,
        "per_launch_ms": per_launch * 1e3,
        "chained_ms": slope * 1e3,
        "n_launches": n_launches,
        "chained_spread_pct": spread_pct,
        "chained_samples": samples,
        "chained_contended": contended,
        "k": k, "m": m, "nops": nops,
        "device": str(device),
        "card": torch.cuda.get_device_name(device)
        if device.type == "cuda" else None,
        "nvidia_smi": nvidia_smi_line() if device.type == "cuda" else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="engine_loop")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
