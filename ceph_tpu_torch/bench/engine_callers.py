"""How the callers' continuations shape the engine's launch window:
``chip_smoke.py`` phase 5b's drain burst with its per-key executor at
several worker counts.

Each trial runs in a fresh process, as phase 5b runs in a fresh
``chip_smoke.py``: a warm-up burst of the drain's size, then the drain
(``flushes`` x ``objects`` objects staged from 4 producers while a
``run_sync`` holds a ``DeviceEncodeEngine(window=3)``, then released;
each continuation copies its op's data and parity shards into a host
store). The first and the last op's stored parity are checked against the
host GF oracle. One JSON line a trial: the worker count, the drain wall,
the window's deepest point, each flush's host split in ms (upload, launch
of the device step, allocation of the pinned outputs, device wait), and
the pinned host blocks PyTorch allocated during the drain
(``torch.cuda.host_memory_stats``, where the build has it). The card's
name and power limit come first:

    python -m ceph_tpu_torch.bench.engine_callers [--workers 4 2]
        [--trials 3] [--device cuda|cpu]

Run it from the repo root (it drives ``chip_smoke.py``'s burst).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ceph_tpu_torch.bench.engine_loop import nvidia_smi_line
from ceph_tpu_torch.models import instance
from ceph_tpu_torch.ops import gf256
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.device_engine import DeviceEncodeEngine

_ROOT = Path(__file__).resolve().parents[2]


def _host_blocks() -> int | None:
    """Pinned host blocks PyTorch's caching host allocator has made."""
    try:
        return int(torch.cuda.host_memory_stats()["num_host_alloc"])
    except (AttributeError, KeyError, RuntimeError):
        return None


def trial(workers: int, flushes: int = 8, objects: int = 128,
          object_bytes: int = 1 << 20, device: str = "cuda") -> dict:
    """One warm-up burst and one timed drain with ``workers``
    continuation workers; see the module docstring."""
    sys.path.insert(0, str(_ROOT))
    import chip_smoke as cs
    dev = torch.device(device)
    if dev.type == "cuda":
        from ceph_tpu_torch.ops import cuda_build
        cuda_build.build_all(["gf_matvec", "crc32c_rows"])
    k, m = cs.K, cs.M
    codec = instance().factory(
        "isa", {"k": str(k), "m": str(m), "technique": "reed_sol_van"},
        device=dev)
    sinfo = ec_util.StripeInfo(stripe_width=k * cs.CHUNK,
                               chunk_size=cs.CHUNK)
    n_obj = flushes * objects
    data = np.random.default_rng(cs.SEED + 11).integers(
        0, 256, n_obj * object_bytes, dtype=np.uint8)
    objs = [data[i * object_bytes:(i + 1) * object_bytes]
            for i in range(n_obj)]
    seg = object_bytes // k

    def landing():
        return (np.ones((n_obj, k, seg), np.uint8),
                np.ones((n_obj, m, seg), np.uint8))

    executor = cs.KeyedExecutor(workers)

    def engine():
        return DeviceEncodeEngine(executor.dispatch,
                                  flush_bytes=objects * object_bytes,
                                  window=cs.ENGINE_WINDOW)
    try:
        warm = engine()
        try:
            cs._engine_burst(warm, codec, sinfo, objs, cs.ENGINE_PRODUCERS,
                             store=landing())
        finally:
            warm.stop()
        store = landing()
        before = _host_blocks()
        with cs._captured_splits() as splits:
            eng = engine()
            try:
                wall, out, *_ = cs._engine_burst(
                    eng, codec, sinfo, objs, cs.ENGINE_PRODUCERS,
                    store=store)
                stats = dict(eng.stats)
            finally:
                eng.stop()
        after = _host_blocks()
    finally:
        executor.stop()
    cs.check(all(err is None for _crcs, err in out.values()),
             "an op of the drain failed")
    for o in (0, n_obj - 1):
        dsh = np.ascontiguousarray(
            objs[o].reshape(-1, k, cs.CHUNK).transpose(1, 0, 2)
            .reshape(k, seg))
        cs.check(np.array_equal(store[0][o], dsh) and np.array_equal(
            store[1][o], gf256.gf_matvec_chunks(codec.coding_matrix, dsh)),
            f"op {o}'s stored shards vs the host oracle")
    return {"workers": workers, "flushes": stats["flushes"],
            "drain_s": wall, "drain_GBps": n_obj * object_bytes / wall / 1e9,
            "max_inflight_depth": stats["max_inflight_depth"],
            "split_ms": {key[:-2]: [sp[key] * 1e3 for sp in splits]
                         for key in ("upload_s", "launch_s", "alloc_s",
                                     "wait_s")},
            "host_blocks_allocated": None if before is None
            else after - before}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, nargs="+", default=[4, 2])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print(json.dumps(trial(args.child, device=args.device)), flush=True)
        return 0
    print(json.dumps({"card": nvidia_smi_line()}), flush=True)
    rc = 0
    for _ in range(args.trials):
        for w in args.workers:
            rc |= subprocess.run(
                [sys.executable, "-m", "ceph_tpu_torch.bench.engine_callers",
                 "--child", str(w), "--device", args.device],
                cwd=_ROOT, timeout=600).returncode
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
