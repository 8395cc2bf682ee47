#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``ceph_tpu_torch``) on one GPU.

Run from the repository root, with one NVIDIA H100 visible:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, ``nvidia-smi`` name and power limit, and the
   device-memory rate read from the card;
2. build: kernels B1 (csrc/gf_matvec.cu) and B2 (csrc/crc32c_rows.cu),
   one ``nvcc`` each, started together, into ``build/torch_ext/``;
3. kernels: each kernel against its plain torch version on the card,
   byte-exact, over ragged shapes, decode matrices and a 32x128 matrix;
4. main path, at the north-star benchmark's size (bench.py:47-49): the
   ISA ``reed_sol_van`` k=8, m=3 codec, 128 objects of 1 MiB (128 MiB per
   flush), stripe unit 4096 B. ``StripeBatcher.flush(with_crcs=True)`` on
   CUDA, then a degraded read erasing 1 and then 2 data shards through
   ``ec_util.decode``. Parity is checked byte-exact against the host GF
   oracle, every op's per-shard crc against the host crc32c (all 1408
   segments), and the reads against the data. Kernel launch counts are
   zeroed before and read after this phase;
5. times on the card (CUDA events; warm-up, then the median of several
   runs): B1 encode and e=1/e=2 decode on a resident [8, 16 Mi] batch, B2
   on the main path's rows, each beside its plain version and its bound,
   and the fused flush's wall time, with a torch.profiler breakdown of
   one flush (device busy share, top device and host entries).

Then the ``kernels`` summary line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any mismatch, missing GPU, failed build
or failed launch raises and exits non-zero before the last line.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: published peaks of one H100 SXM (NVIDIA data sheet): device memory,
#: used only if the card does not report its memory clock and bus, and
#: the dense int8 tensor rate that bounds the bit-matrix formulation
H100_HBM_BYTES_PER_S = 3.35e12
H100_INT8_OPS_PER_S = 1979e12

K, M = 8, 3
OBJECT_BYTES = 1 << 20
OBJECTS = 128
CHUNK = 4096                       # osd_pool_erasure_code_stripe_unit default
RESIDENT_LANES = OBJECTS * OBJECT_BYTES // K     # 16 Mi bytes per shard
SEED = 20261016


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.strip().splitlines()[0]


def hbm_rate() -> tuple[float, str]:
    """Peak device-memory bytes/s from the card's memory clock and bus
    width (cuDeviceGetAttribute 36 and 37; double data rate)."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        dev, clk, bus = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = lib.cuDeviceGet(ctypes.byref(dev), torch.cuda.current_device())
        rc |= lib.cuDeviceGetAttribute(ctypes.byref(clk), 36, dev)
        rc |= lib.cuDeviceGetAttribute(ctypes.byref(bus), 37, dev)
        if rc == 0 and clk.value > 0 and bus.value > 0:
            return (2.0 * clk.value * 1e3 * bus.value / 8,
                    f"card: {clk.value} kHz x {bus.value} bit x 2")
    except OSError:
        pass
    return H100_HBM_BYTES_PER_S, "published H100 SXM peak"


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def flush_profile(flush) -> dict:
    """Where one fused flush's wall time goes: torch.profiler over one
    flush; device busy = the sum of device-side activity (kernels and
    copies, one stream, so no overlap), host = top CPU ops by self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        flush()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    dev = [e for e in avgs if e.device_type == DeviceType.CUDA]
    host = [e for e in avgs if e.device_type == DeviceType.CPU]
    busy_us = sum(e.self_device_time_total for e in dev)

    def top(events, attr):
        events = sorted(events, key=lambda e: -getattr(e, attr))[:8]
        return [[e.key[:70], getattr(e, attr) / 1e3, e.count]
                for e in events]

    return {"phase": "flush_profile", "wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "top_device_ms": top(dev, "self_device_time_total"),
            "top_host_self_ms": top(host, "self_cpu_time_total")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from ceph_tpu_torch.bench.ec_bench import time_cuda
    from ceph_tpu_torch.models import instance
    from ceph_tpu_torch.ops import (crc32c_cuda, crc32c_torch, cuda_build,
                                    gf256, gf_cuda, gf_torch)
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.utils import checksum

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device -----------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    hbm, hbm_src = hbm_rate()
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "hbm_bytes_per_s": hbm, "hbm_source": hbm_src,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build_all(["gf_matvec", "crc32c_rows"])
    build_s = time.perf_counter() - t0
    for kname, log in logs.items():
        print(f"--- nvcc {kname} ---\n{log}", file=sys.stderr)
    emit({"phase": "build", "seconds": build_s, "kernels": sorted(logs),
          "dir": str(cuda_build.BUILD_DIR)})

    # -- 3. kernels against their plain versions -------------------------
    rng = np.random.default_rng(SEED)
    isa = gf256.rs_matrix_isa(K, M)
    gen = gf256.systematic_generator(isa)
    mats = {f"encode m={mm}": gf256.rs_matrix_isa(K, mm) for mm in (1, 2, 3)}
    for e in (1, 2, 3):
        mats[f"decode e={e}"] = gf256.decode_matrix(
            gen, list(range(e, e + K)), list(range(e)))
    mats["random 32x128"] = rng.integers(0, 256, (32, 128), dtype=np.uint8)
    b1_err, b1_cases = 0, 0
    for label, mat in mats.items():
        kk = mat.shape[1]
        for n in (1, 15, 16, 4097, 65536 + 7, 1 << 20):
            d = torch.randint(0, 256, (kk, n), dtype=torch.uint8, device=dev)
            got = gf_cuda.matvec_device(mat, d)
            torch.cuda.synchronize()
            err = max_err(got, gf_torch.matvec(mat, d))
            check(err == 0, f"B1 {label} N={n} differs from plain")
            b1_err, b1_cases = max(b1_err, err), b1_cases + 1
    small = rng.integers(0, 256, (K, 4099), dtype=np.uint8)
    check(np.array_equal(
        gf_cuda.matvec_device(isa, torch.from_numpy(small).to(dev)).cpu()
        .numpy(), gf256.gf_matvec_chunks(isa, small)), "B1 vs host oracle")
    main_rows = OBJECTS * (K + M) * (OBJECT_BYTES // K) // 512
    b2_err, b2_cases = 0, 0
    for rows in (1, 7, 1000, 65536 + 3, main_rows):
        x = torch.randint(0, 256, (rows, 512), dtype=torch.uint8, device=dev)
        got = crc32c_cuda.crc_rows(x)
        torch.cuda.synchronize()
        err = max_err(got, crc32c_torch.crc_rows(x))
        check(err == 0, f"B2 rows={rows} differs from plain")
        b2_err, b2_cases = max(b2_err, err), b2_cases + 1
    xs = rng.integers(0, 256, (33, 512), dtype=np.uint8)
    want = checksum.crc32c_rows(xs, 0) ^ np.uint32(crc32c_torch.zeros_crc(512, 0))
    check(crc32c_cuda.crc_rows(torch.from_numpy(xs).to(dev)).cpu().tolist()
          == want.astype(np.int64).tolist(), "B2 vs host oracle")
    emit({"phase": "kernels", "gf_matvec_cases": b1_cases,
          "gf_matvec_max_abs_err": b1_err, "crc32c_rows_cases": b2_cases,
          "crc32c_rows_max_abs_err": b2_err, "tolerance": 0})

    # -- 4. main path ----------------------------------------------------
    codec = instance().factory(
        "isa", {"k": str(K), "m": str(M), "technique": "reed_sol_van"},
        device=dev)
    check(codec.resolved_backend == "cuda", "codec does not resolve to B1")
    sinfo = ec_util.StripeInfo(stripe_width=K * CHUNK, chunk_size=CHUNK)
    batch = rng.integers(0, 256, OBJECTS * OBJECT_BYTES, dtype=np.uint8)
    bufs = [batch[i * OBJECT_BYTES:(i + 1) * OBJECT_BYTES]
            for i in range(OBJECTS)]

    def flush():
        b = ec_util.StripeBatcher(sinfo, codec)
        for op, buf in enumerate(bufs):
            b.append(op, buf)
        return b.flush(with_crcs=True)

    gf_cuda.reset_launches()
    crc32c_cuda.reset_launches()
    t0 = time.perf_counter()
    results = flush()
    first_flush_s = time.perf_counter() - t0
    flush_launches = {"gf_matvec": gf_cuda.launches,
                      "crc32c_rows": crc32c_cuda.launches}
    streams = {i: np.concatenate([r[1][i] for r in results])
               for i in range(K + M)}
    reads = {}
    for lost in ([0], [0, 1]):
        avail = {i: streams[i] for i in range(K + M) if i not in lost}
        t0 = time.perf_counter()
        out = ec_util.decode(sinfo, codec, avail, lost)
        reads[f"e={len(lost)}"] = time.perf_counter() - t0
        for i in lost:
            check(np.array_equal(out[i], streams[i]),
                  f"degraded read of shard {i} with {lost} lost")
    launches = {"gf_matvec": gf_cuda.launches,
                "crc32c_rows": crc32c_cuda.launches}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")

    check([r[0] for r in results] == list(range(OBJECTS)), "op order")
    data_shards = np.ascontiguousarray(
        batch.reshape(-1, K, CHUNK).transpose(1, 0, 2).reshape(K, -1))
    host_parity = gf256.gf_matvec_chunks(isa, data_shards)
    for i in range(K):
        check(np.array_equal(streams[i], data_shards[i]), f"data shard {i}")
    for j in range(M):
        check(np.array_equal(streams[K + j], host_parity[j]),
              f"parity shard {K + j} vs host oracle")
    seg = OBJECT_BYTES // K
    segs = np.stack([streams[i][o * seg:(o + 1) * seg]
                     for o in range(OBJECTS) for i in range(K + M)])
    host_crcs = checksum.crc32c_rows(segs, ec_util.HINFO_SEED)
    got_crcs = []
    for _op, shards, crcs in results:
        check(crcs is not None, "fused flush returned no crcs")
        hi = ec_util.HashInfo(K + M)
        hi.append_linear(0, crcs, len(shards[0]))
        got_crcs += [hi.get_chunk_hash(i) for i in range(K + M)]
    check(got_crcs == host_crcs.tolist(), "shard crcs vs host crc32c")
    emit({"phase": "main_path", "profile": "isa reed_sol_van k=8 m=3",
          "objects": OBJECTS, "object_bytes": OBJECT_BYTES,
          "chunk_size": CHUNK, "flush_bytes": OBJECTS * OBJECT_BYTES,
          "crc_segments_checked": len(got_crcs), "flush_launches":
          flush_launches, "launches": launches,
          "first_flush_s": first_flush_s, "degraded_read_s": reads,
          "ok": True})

    # -- 5. times ----------------------------------------------------------
    gen_t = torch.Generator(device=dev)
    gen_t.manual_seed(SEED)
    data = torch.randint(0, 256, (K, RESIDENT_LANES), dtype=torch.uint8,
                         device=dev, generator=gen_t)
    timings = {}
    for label, mat in (("encode", isa),
                       ("decode e=1", gf256.decode_matrix(
                           gen, list(range(1, K + 1)), [0])),
                       ("decode e=2", gf256.decode_matrix(
                           gen, list(range(2, K + 2)), [0, 1]))):
        s = time_cuda(lambda: gf_cuda.matvec_device(mat, data), 20)
        check(torch.equal(gf_cuda.matvec_device(mat, data),
                          gf_torch.matvec(mat, data)), f"B1 {label} resident")
        timings[label] = {"ms": s * 1e3,
                          "GBps": K * RESIDENT_LANES / s / 1e9}
    plain_b1 = time_cuda(lambda: gf_torch.matvec(isa, data), 2, 3)
    n = RESIDENT_LANES
    b1_bound_bytes = (K + M) * n / hbm
    b1_bound_ops = 2 * 8 * M * 8 * K * n / H100_INT8_OPS_PER_S
    del data
    rows_x = torch.randint(0, 256, (main_rows, 512), dtype=torch.uint8,
                           device=dev, generator=gen_t)
    b2_s = time_cuda(lambda: crc32c_cuda.crc_rows(rows_x), 20)
    plain_b2 = time_cuda(lambda: crc32c_torch.crc_rows(rows_x), 2, 3)
    b2_bound_bytes = main_rows * (512 + 4) / hbm
    b2_bound_ops = 2 * 4096 * 32 * main_rows / H100_INT8_OPS_PER_S
    del rows_x
    walls = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(3):
        t0 = time.perf_counter()
        flush()
        walls.append(time.perf_counter() - t0)
    flush_s = statistics.median(walls)
    emit(flush_profile(flush))
    emit({"phase": "times", "card": smi,
          "b1_resident_bytes": K * RESIDENT_LANES, "b1": timings,
          "b1_plain_ms": plain_b1 * 1e3,
          "b1_bound_ms": max(b1_bound_bytes, b1_bound_ops) * 1e3,
          "b2_rows": main_rows, "b2_ms": b2_s * 1e3,
          "b2_GBps": main_rows * 512 / b2_s / 1e9,
          "b2_plain_ms": plain_b2 * 1e3,
          "b2_bound_ms": max(b2_bound_bytes, b2_bound_ops) * 1e3,
          "fused_flush_s": flush_s, "fused_flush_runs_s": walls,
          "fused_flush_GBps": OBJECTS * OBJECT_BYTES / flush_s / 1e9,
          "fused_flush_peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})

    # -- 6. summary --------------------------------------------------------
    emit({"kernels": [
        {"name": "gf_matvec (B1)", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/gf_matvec.cu",
         "replaces": "ceph_tpu/ops/gf_pallas.py:71",
         "launches": launches["gf_matvec"], "max_abs_err": b1_err,
         "ms": timings["encode"]["ms"], "plain_ms": plain_b1 * 1e3,
         "bound_ms": max(b1_bound_bytes, b1_bound_ops) * 1e3,
         "bound_by": "bytes" if b1_bound_bytes >= b1_bound_ops
         else "operations",
         "library_ms": None, "pass": True},
        {"name": "crc32c_rows (B2)", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/crc32c_rows.cu",
         "replaces": "ceph_tpu/ops/crc32c_device.py:165",
         "launches": launches["crc32c_rows"], "max_abs_err": b2_err,
         "ms": b2_s * 1e3, "plain_ms": plain_b2 * 1e3,
         "bound_ms": max(b2_bound_bytes, b2_bound_ops) * 1e3,
         "bound_by": "bytes" if b2_bound_bytes >= b2_bound_ops
         else "operations",
         "library_ms": None, "pass": True},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
