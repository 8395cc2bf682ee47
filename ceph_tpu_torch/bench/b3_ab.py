"""A/B of kernel B3 builds on one card.

    python -m ceph_tpu_torch.bench.b3_ab [SOURCE.cu ...]

Builds each source (default: ``csrc/clay_encode.cu``; every source must
keep that file's C interface) with the port's nvcc flags, all at once,
and reports each build's ptxas registers and spills and its SASS
instruction mix per kernel (``b5_ab.build``). Then, at the Clay
k=8,m=4,d=11 encode and the lane counts B3 runs it at on the main path
(262,144 full size, the full form; 64 an ec_util per-stripe call, the
short form), it holds every build against the plain version byte for
byte and times it through the wrapper: CUDA events around back-to-back
calls (host launch included) and torch.profiler's device time of the
kernel alone. The builds are timed in turns, v1..vn then vn..v1, so that
they are compared within one run on one card. Prints one JSON line;
exits 1 if a build disagrees.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from ceph_tpu_torch.bench.b5_ab import build, device_ms
from ceph_tpu_torch.bench.ec_bench import time_cuda
from ceph_tpu_torch.models import clay_device, instance
from ceph_tpu_torch.ops import clay_cuda, cuda_build

LANES = (1 << 18, 64)


def main(argv: list[str]) -> int:
    sources = [Path(a) for a in argv] or [cuda_build.CSRC / "clay_encode.cu"]
    builds = build(sources)
    dev = torch.device("cuda", 0)
    codec = instance().factory("clay", {"k": "8", "m": "4", "d": "11"},
                               device=dev)
    enc = clay_device.build_encode_kernel(codec)
    kern = clay_cuda.EncodeKernel(clay_device.encode_kernel_arrays(
        enc.tables))
    gen = torch.Generator(device=dev).manual_seed(6)
    full = torch.randint(0, 256, (codec.k, codec.sub_chunk_no, LANES[0]),
                         dtype=torch.uint8, device=dev, generator=gen)
    times: dict[str, dict[str, list]] = {}
    ok = True
    for n in LANES:
        x = full[:, :, :n].contiguous()
        want = enc.plain(x)
        row = times[f"L={n}"] = {}
        for src in sources + sources[::-1]:
            cuda_build._libs["clay_encode"] = builds[src]["lib"]
            clay_cuda._encode = None
            same = torch.equal(kern(x), want)
            ok &= same
            row.setdefault(str(src), []).append([
                time_cuda(lambda: kern(x), 20) * 1e3,
                device_ms(lambda: kern(x), kernel="clay_encode_kernel"),
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
