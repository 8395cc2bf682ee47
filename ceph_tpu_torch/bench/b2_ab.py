"""A/B of kernel B2 builds on one card.

    python -m ceph_tpu_torch.bench.b2_ab [SOURCE.cu[@NAME=VALUE,...] ...]
        [--rowwise OLD.cu ...] [--rows N]

Builds each source (default: ``csrc/crc32c_rows.cu``; every source must
keep that file's C interface, ``crc32c_rows_launch(x, basis, out, rows,
stream)`` writing int64; ``@NAME=VALUE`` builds a copy under
``build/ab/`` with those macros defined first, e.g.
``csrc/crc32c_rows.cu@B2_FIELD_BITS=4`` for nibble tables, ``B2_ROWS``
rows reduced together, ``B2_DEPTH`` rows loaded ahead, ``B2_THREADS`` the
block size, ``B2_SKIP=1`` / ``2`` the kernel without its table build /
lookups for a time split, output wrong and not held against plain;
``bench/b2_candidates/`` holds the other designs) and each
``--rowwise`` source (the C interface of the thread-per-row design B2 had
before, ``crc32c_rows_launch(x, out, rows, stream)`` writing uint32 that
its wrapper widened to int64 with two elementwise kernels, e.g. ``git
show e96d0eb:ceph_tpu_torch/csrc/crc32c_rows.cu > build/ab/rowwise.cu``)
with the port's nvcc flags, all at once, and reports each build's ptxas
registers and spills, its SASS instruction mix (``b5_ab.build``) and its
registers, stack and local memory (``b1_ab.res_usage``).

Then on [rows, 512] random bytes (default 360,448 rows, the fused
flush's: 128 ops x 11 shards x 128 KiB) it holds each build against the
plain version (``crc32c_torch.crc_rows``) byte for byte and times it,
calling each build's launcher directly into a preallocated output (and
the rowwise builds' widening after it): CUDA events around back-to-back
calls (host launch included), torch.profiler's device time of the kernel
alone (``crc32c_rows_kernel``) and of every kernel of the call. The
builds are timed in turns, v1..vn then vn..v1, so that they are compared
within one run on one card. Prints one JSON line; exits 1 if a build
disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ceph_tpu_torch.bench.b1_ab import res_usage
from ceph_tpu_torch.bench.b4_ab import with_macros
from ceph_tpu_torch.bench.b5_ab import build, device_ms
from ceph_tpu_torch.bench.ec_bench import time_cuda
from ceph_tpu_torch.ops import crc32c_cuda, crc32c_torch, cuda_build

#: the fused flush's stage-1 rows: 128 ops x 11 shards x 128 KiB / 512
MAIN_ROWS = 128 * 11 * (128 << 10) // 512


def _runner(lib: ctypes.CDLL, rowwise: bool, x: torch.Tensor):
    """A call of one build's launcher on x -> [rows] int64."""
    dev = x.device
    rows = x.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = lib.crc32c_rows_launch
    fn.restype = ctypes.c_int
    if rowwise:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        out = torch.empty(rows, dtype=torch.int32, device=dev)

        def run() -> torch.Tensor:
            cuda_build.check(lib, fn(x.data_ptr(), out.data_ptr(), rows,
                                     stream), "rowwise launch")
            return out.to(torch.int64) & 0xFFFFFFFF
        return run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    basis = crc32c_cuda._basis().on(dev)["basis"]
    out = torch.empty(rows, dtype=torch.int64, device=dev)

    def run() -> torch.Tensor:
        cuda_build.check(lib, fn(x.data_ptr(), basis.data_ptr(),
                                 out.data_ptr(), rows, stream),
                         "crc32c_rows launch")
        return out
    return run


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m ceph_tpu_torch.bench.b2_ab")
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--rowwise", action="append", default=[], type=Path)
    ap.add_argument("--rows", type=int, default=MAIN_ROWS)
    args = ap.parse_args(argv)
    specs = args.sources or ([] if args.rowwise else
                             [str(cuda_build.CSRC / "crc32c_rows.cu")])
    sources = [with_macros(s) for s in specs]
    builds = build(sources + args.rowwise)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randint(0, 256, (args.rows, crc32c_torch.ROW_BYTES),
                      dtype=torch.uint8, device=dev, generator=gen)
    want = crc32c_torch.crc_rows(x)
    order = sources + args.rowwise
    runs = {src: _runner(builds[src]["lib"], src in args.rowwise, x)
            for src in order}
    times: dict[str, list] = {}
    ok = True
    # a B2_SKIP build leaves out part of the work, its output is wrong
    split = {src for src, spec in zip(sources, specs) if "B2_SKIP" in spec}
    for src in order + order[::-1]:
        run = runs[src]
        same = torch.equal(run(), want)
        ok &= same or src in split
        times.setdefault(str(src), []).append([
            time_cuda(run, 20) * 1e3,
            device_ms(run, kernel="crc32c_rows_kernel"),
            device_ms(run, kernel=""), same])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "card": smi, "rows": args.rows,
        "columns": ["events_ms", "device_ms", "device_all_ms", "equal"],
        "builds": {str(s): {"ptxas": b["ptxas"], "sass": b["sass"],
                            "resources": res_usage(Path(b["lib"]._name)),
                            "interface": "rowwise" if s in args.rowwise
                            else "basis"}
                   for s, b in builds.items()},
        "times": times, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
