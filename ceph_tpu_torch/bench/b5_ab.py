"""A/B of kernel B5 builds on one card.

    python -m ceph_tpu_torch.bench.b5_ab [SOURCE.cu ...]

Builds each source (default: ``csrc/gf_block_sparse.cu``; every source
must keep that file's C interface and read the plan arrays of
``ops/gf_block_sparse_cuda.plan_arrays``) with the port's nvcc flags,
all at once, and reports each build's ptxas registers and spills and its
SASS instruction mix per kernel. Then, at the Clay k=8,m=4,d=11 matrices
that B5 runs on the main path (decode-2, decode-1, repair) and at the
lane counts it runs them at (262,144 full size, 32,768 the calibration
sample, 64 an ec_util per-stripe call), it holds every build against the
plain version byte for byte and times it through the wrapper: CUDA
events around back-to-back calls (host launch included) and
torch.profiler's device time of the kernel alone. The builds are timed
in turns, v1..vn then vn..v1, so that they are compared within one run
on one card. Prints one JSON line; exits 1 if a build disagrees.
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from ceph_tpu_torch.bench.ec_bench import time_cuda
from ceph_tpu_torch.models import instance
from ceph_tpu_torch.ops import (cuda_build, gf_block_sparse,
                                gf_block_sparse_cuda, gf_block_sparse_torch)

LANES = (1 << 18, 1 << 15, 64)


def build(sources: list[Path]) -> dict[Path, dict]:
    """source -> {"lib", "ptxas", "sass"}, one nvcc per source in
    parallel."""
    out_dir = cuda_build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, src in enumerate(sources):
        so = out_dir / f"b5_{i}_{src.stem}.so"
        procs[src] = so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    builds = {}
    for src, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise cuda_build.KernelBuildError(f"{src}: nvcc exit "
                                              f"{proc.returncode}\n{log}")
        builds[src] = {"lib": ctypes.CDLL(str(so)),
                       "ptxas": [line.strip() for line in log.splitlines()
                                 if "registers" in line or "spill" in line],
                       "sass": sass_mix(so)}
    return builds


def sass_mix(so: Path) -> dict[str, dict[str, int]]:
    """Per kernel, its static SASS instruction count by opcode (the ten
    most frequent), from ``cuobjdump -sass``."""
    cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    mix: dict[str, collections.Counter] = {}
    fn = None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            mix[fn] = collections.Counter()
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                      line)
        if fn and op:
            mix[fn][op.group(1)] += 1
    return {fn: dict(c.most_common(10)) for fn, c in mix.items()}


def device_ms(fn, calls: int = 10,
              kernel: str = "gf_block_sparse_kernel") -> float:
    """torch.profiler's device time per call of ``fn`` of the kernels whose
    name contains ``kernel`` (default B5's). A profiling session that
    records none of them (the profiler on the card has been seen to
    return an empty session) is repeated, twice at most; then it raises."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if kernel in e.key)
        if us > 0:
            return us / 1e3 / calls
    raise RuntimeError(f"torch.profiler recorded no {kernel} launch")


def main(argv: list[str]) -> int:
    sources = [Path(a) for a in argv] or [
        cuda_build.CSRC / "gf_block_sparse.cu"]
    builds = build(sources)
    host = instance().factory("clay", {"k": "8", "m": "4", "d": "11",
                                       "backend": "numpy"}, device="cpu")
    mats = {"decode-2": host._decode_matrix(tuple(range(2, 12)), (0, 1)),
            "decode-1": host._decode_matrix(tuple(range(1, 12)), (0,)),
            "repair": host._repair_matrix(0, tuple(range(1, 12)))}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    times: dict[str, dict[str, list]] = {}
    ok = True
    for label, mat in mats.items():
        plan = gf_block_sparse.plan_for(mat)
        full = torch.randint(0, 256, (mat.shape[1], LANES[0]),
                             dtype=torch.uint8, device=dev, generator=gen)
        for n in LANES:
            x = full[:, :n].contiguous()
            want = gf_block_sparse_torch.matvec(plan, x)
            row = times[f"{label} N={n}"] = {}
            for src in sources + sources[::-1]:
                cuda_build._libs[gf_block_sparse_cuda._NAME] = \
                    builds[src]["lib"]
                same = torch.equal(gf_block_sparse_cuda.matvec(plan, x),
                                   want)
                ok &= same
                row.setdefault(str(src), []).append([
                    time_cuda(lambda: gf_block_sparse_cuda.matvec(plan, x),
                              20) * 1e3,
                    device_ms(lambda: gf_block_sparse_cuda.matvec(plan, x)),
                    same])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "card": smi, "columns": ["events_ms", "device_ms", "equal"],
        "builds": {str(s): {"ptxas": b["ptxas"], "sass": b["sass"]}
                   for s, b in builds.items()},
        "times": times, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
