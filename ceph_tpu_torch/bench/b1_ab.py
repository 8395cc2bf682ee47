"""A/B of kernel B1 builds on one card.

    python -m ceph_tpu_torch.bench.b1_ab [SOURCE.cu ...] [--nibble OLD.cu ...]

Builds each source (default: ``csrc/gf_matvec.cu``; every source must
keep that file's C interface) and each ``--nibble`` source (the C
interface of the split-nibble design B1 had before its bit-sliced form:
``gf_matvec_launch(tables, data, out, m, k, n, vec, stream)`` with
[m, k, 32] nibble tables on the device) with the port's nvcc flags, all
at once, and reports each build's ptxas registers and spills and its
SASS instruction mix per kernel (``b5_ab.build``), and per kernel its
registers, stack and local memory (``cuobjdump -res-usage``). Then, at
the three matrices ``chip_smoke.py`` phase 5 times (the ISA k=8, m=3
encode and the decode matrices of 1 and 2 lost data chunks) on a
resident [8, 16 Mi] batch (128 MiB), it holds every build against the
plain version byte for byte and times it: CUDA events around
back-to-back calls (host launch included) and torch.profiler's device
time of the kernel alone. The
builds are timed in turns, v1..vn then vn..v1, so that they are compared
within one run on one card. Prints one JSON line; exits 1 if a build
disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ceph_tpu_torch.bench.b5_ab import build, device_ms
from ceph_tpu_torch.bench.ec_bench import time_cuda
from ceph_tpu_torch.ops import cuda_build, gf256, gf_cuda, gf_torch

K, M = 8, 3
LANES = 1 << 24


def matrices() -> dict[str, np.ndarray]:
    """chip_smoke.py phase 5's matrices."""
    isa = gf256.rs_matrix_isa(K, M)
    gen = gf256.systematic_generator(isa)
    return {"encode": isa,
            "decode e=1": gf256.decode_matrix(gen, list(range(1, K + 1)),
                                              [0]),
            "decode e=2": gf256.decode_matrix(gen, list(range(2, K + 2)),
                                              [0, 1])}


def res_usage(so: Path) -> dict[str, str]:
    """Per kernel, its registers, stack and local memory from
    ``cuobjdump -res-usage`` (ptxas -v's numbers, by function name)."""
    cuobjdump = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-res-usage", str(so)],
                          capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function (\S+):", line)
        if head:
            fn = head.group(1)
        elif fn and "REG:" in line:
            form = re.search(r"kernelILi(\d+)ELb([01])E", fn)
            name = (f"rows={form.group(1)} "
                    f"{'16-byte' if form.group(2) == '1' else 'byte'} path"
                    if form else fn)
            out[name] = " ".join(line.split()[:4])
            fn = None
    return out


def _nibble_tables(mat: np.ndarray) -> np.ndarray:
    """[m, k, 32] uint8: mat[i,j]*x for x = 0..15, then mat[i,j]*(x << 4)."""
    nib = np.arange(16, dtype=np.uint8)
    lo = gf256.MUL_TABLE[mat[:, :, None], nib[None, None, :]]
    hi = gf256.MUL_TABLE[mat[:, :, None], (nib << 4)[None, None, :]]
    return np.ascontiguousarray(np.concatenate([lo, hi], axis=2))


def _nibble_runner(lib: ctypes.CDLL, mat: np.ndarray, dev):
    fn = lib.gf_matvec_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tables = torch.from_numpy(_nibble_tables(mat)).to(dev)
    m, k = mat.shape

    def run(x: torch.Tensor) -> torch.Tensor:
        out = torch.empty((m, x.shape[1]), dtype=torch.uint8, device=dev)
        err = fn(tables.data_ptr(), x.data_ptr(), out.data_ptr(), m, k,
                 x.shape[1], int(x.shape[1] % 16 == 0),
                 torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(lib, err, "gf_matvec (nibble) launch")
        return out
    return run


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m ceph_tpu_torch.bench.b1_ab")
    ap.add_argument("sources", nargs="*", type=Path)
    ap.add_argument("--nibble", action="append", default=[], type=Path)
    args = ap.parse_args(argv)
    sources = args.sources or ([] if args.nibble else
                               [cuda_build.CSRC / "gf_matvec.cu"])
    builds = build(sources + args.nibble)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randint(0, 256, (K, LANES), dtype=torch.uint8, device=dev,
                      generator=gen)
    order = sources + args.nibble
    times: dict[str, dict[str, list]] = {}
    ok = True
    # each bit-sliced build runs through the entry point, bound in turn;
    # the process's own B1 is put back afterwards
    saved = cuda_build._libs.get(gf_cuda._NAME), gf_cuda._launcher
    try:
        for label, mat in matrices().items():
            want = gf_torch.matvec(mat, x)
            row = times[label] = {}
            for src in order + order[::-1]:
                lib = builds[src]["lib"]
                if src in args.nibble:
                    run = _nibble_runner(lib, mat, dev)
                else:
                    cuda_build._libs[gf_cuda._NAME] = lib
                    gf_cuda._launcher = None

                    def run(x, mat=mat):
                        return gf_cuda.matvec_device(mat, x)
                same = torch.equal(run(x), want)
                ok &= same
                row.setdefault(str(src), []).append([
                    time_cuda(lambda: run(x), 20) * 1e3,
                    device_ms(lambda: run(x), kernel="gf_matvec"), same])
    finally:
        if saved[0] is None:
            cuda_build._libs.pop(gf_cuda._NAME, None)
        else:
            cuda_build._libs[gf_cuda._NAME] = saved[0]
        gf_cuda._launcher = saved[1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "card": smi, "lanes": LANES,
        "columns": ["events_ms", "device_ms", "equal"],
        "builds": {str(s): {"ptxas": b["ptxas"], "sass": b["sass"],
                            "resources": res_usage(Path(b["lib"]._name)),
                            "interface": "nibble" if s in args.nibble
                            else "bit-sliced"}
                   for s, b in builds.items()},
        "times": times, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
