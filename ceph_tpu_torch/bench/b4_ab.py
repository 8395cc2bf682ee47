"""A/B of kernel B4 builds and launch plans on one card.

    python -m ceph_tpu_torch.bench.b4_ab [SOURCE.cu[@NAME=VALUE,...] ...]
        [--plan G:THREADS ...] [--lanes N ...] [--bytewise OLD.cu ...]
        [--table-order]

Builds each source (default: ``csrc/clay_transform.cu``; every source must
keep that file's C interface; ``@NAME=VALUE`` builds a copy under
``build/ab/`` with those macros defined first, e.g.
``csrc/clay_transform.cu@B4_SKIP=2``, the kernel without its MDS phase,
for a time split) with the port's nvcc flags, all at once, and reports
each build's ptxas registers and spills, its SASS instruction mix
(``b5_ab.build``) and its registers, stack and local memory per kernel
(``b1_ab.res_usage``). ``--bytewise`` sources keep the C interface of
the byte-wise design B4 had before its bit-sliced form (every table on
the device, a lane tile of ``tw`` 4-byte words), e.g. ``git show
73e02c8:ceph_tpu_torch/csrc/clay_transform.cu > build/ab/bytewise.cu``;
each runs at its own tile. ``--table-order`` runs every build also with
the phase-1 and phase-2 items in the order of ``transform_kernel_arrays``'
lists (``transform_items(by_coef=False)``) under the committed plan.

Then, on the Clay k=8,m=4,d=11 signature B4 decodes on the main path
(chunks 0 and 1 lost, padded to the erased nodes [0, 1, 8, 9]) at each
lane count (default 262,144, the main path's), it runs every build under
every plan (the committed ``transform_plan`` and, default, G lane groups
a block by threads: 1 by 128 and 256, 2 by 256 and 512, 4 by 512; a G
that leaves SMs idle at that lane count is kept), holds each against the
plain version byte for byte and times it through the wrapper: CUDA
events around back-to-back calls (host launch included) and
torch.profiler's device time of the kernel alone. Each build's launcher
is called directly (nothing of the process's own B4 is swapped). The
variants are timed in turns, v1..vn then vn..v1, so that they are
compared within one run on one card. Prints one JSON line; exits 1 if a
variant disagrees.
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
from ceph_tpu_torch.bench.b5_ab import build, device_ms
from ceph_tpu_torch.bench.ec_bench import time_cuda
from ceph_tpu_torch.models import clay_device, instance
from ceph_tpu_torch.ops import clay_cuda, cuda_build

CLAY = {"k": "8", "m": "4", "d": "11"}
PLANS = ((1, 128), (1, 256), (2, 256), (2, 512), (4, 512))


def with_macros(spec: str) -> Path:
    """``SOURCE.cu[@NAME=VALUE,...]`` -> the source to build: the file
    itself, or a copy under build/ab/ with the macros defined first."""
    src, _, macros = spec.partition("@")
    if not macros:
        return Path(src)
    defs = dict(m.split("=", 1) for m in macros.split(","))
    out = cuda_build.BUILD_DIR.parent / "ab" / (
        Path(src).stem + "".join(f"_{k}{v}" for k, v in defs.items()) + ".cu")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(f"#define {k} {v}\n" for k, v in defs.items()) +
                   f'#line 1 "{Path(src).resolve()}"\n' +
                   Path(src).read_text())
    return out


def _bytewise_runner(lib: ctypes.CDLL, arrays: dict, dev):
    """The byte-wise design's launch: its 17 tables on the device and the
    widest lane tile (<= 32 words) whose C and U fit 100 KiB, as it
    chose them."""
    fn = lib.clay_transform_launch
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    names = ("a1", "a2", "pair", "b1", "b2", "b3", "p2", "u_off", "u_rows",
             "p_off", "planes", "c_off", "c_rows", "intact", "er", "dmat",
             "load")
    tabs = [torch.from_numpy(arrays[n].copy()).to(dev) for n in names]
    qt, ssc, e = arrays["qt"], arrays["ssc"], arrays["e"]
    tw = 32
    while tw > 1 and 2 * qt * ssc * tw * 4 > 100 * 1024:
        tw //= 2

    def run(x: torch.Tensor) -> torch.Tensor:
        L = x.shape[2]
        out = torch.empty((e, ssc, L), dtype=torch.uint8, device=dev)
        err = fn(*(t.data_ptr() for t in tabs), x.data_ptr(), out.data_ptr(),
                 qt, ssc, arrays["kk"], e, arrays["n_levels"], L,
                 int(L % 4 == 0), tw,
                 torch.cuda.current_stream(dev).cuda_stream)
        cuda_build.check(lib, err, "clay_transform (byte-wise) launch")
        return out
    return run


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m ceph_tpu_torch.bench.b4_ab")
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--plan", action="append", default=[],
                    help="G:THREADS, lane groups of 32 a block and block size")
    ap.add_argument("--lanes", action="append", type=int, default=[])
    ap.add_argument("--bytewise", action="append", default=[])
    ap.add_argument("--table-order", action="store_true")
    args = ap.parse_args(argv)
    specs = args.sources or [str(cuda_build.CSRC / "clay_transform.cu")]
    sources = {spec: with_macros(spec) for spec in specs}
    sources.update({spec: Path(spec) for spec in args.bytewise})
    builds = build(list(sources.values()))
    launchers = {spec: (builds[src]["lib"],
                        clay_cuda.transform_launcher(builds[src]["lib"]))
                 for spec, src in sources.items() if spec in specs}
    dev = torch.device("cuda", 0)
    codec = instance().factory("clay", dict(CLAY, decode_kernel="true"),
                               device=dev)
    erased = codec._pad_erased(codec._node_id(i) for i in (0, 1))
    er = sorted(erased)
    arrays = clay_device.transform_kernel_arrays(codec, erased)
    kern = clay_cuda.TransformKernel(arrays)
    # the same kernel with the items in table order: only its item tables
    # differ
    table = clay_cuda.TransformKernel(arrays)
    u_items, c_items = clay_cuda.transform_items(arrays, by_coef=False)
    table.tables = cuda_build.DeviceArrays(dict(
        table.tables.arrays, u_items=u_items, c_items=c_items))
    bytewise = {spec: _bytewise_runner(builds[sources[spec]]["lib"], arrays,
                                       dev) for spec in args.bytewise}
    plain = clay_device.build_transform(codec, erased)
    qt, ssc = kern.qt, kern.ssc
    sms = clay_cuda._sm_count(dev)
    pairs = [tuple(int(v) for v in p.split(":")) for p in args.plan] or \
        list(PLANS)
    gen = torch.Generator(device=dev).manual_seed(9)
    times: dict[str, dict[str, list]] = {}
    plans: dict[str, dict] = {}
    ok = True
    for L in args.lanes or [1 << 18]:
        x = torch.randint(0, 256, (qt, ssc, L), dtype=torch.uint8,
                          device=dev, generator=gen)
        x[er] = 0
        want = plain(x)[er]
        committed = clay_cuda.transform_plan(L, qt, ssc, sms)
        variants = {"committed": committed}
        for g, t in pairs:
            variants[f"G={g} threads={t}"] = clay_cuda.transform_plan(
                L, qt, ssc, 0, groups=g, threads=t)
        plans[f"L={L}"] = {k: v._asdict() for k, v in variants.items()}
        order = [(spec, label) for spec in specs for label in variants] + \
            [(spec, "table order") for spec in specs if args.table_order] + \
            [(spec, "own tile") for spec in args.bytewise]
        row = times[f"L={L}"] = {}
        for spec, label in order + order[::-1]:
            if spec in bytewise:
                def run(fn=bytewise[spec]):
                    return fn(x)
            elif label == "table order":
                def run(launcher=launchers[spec]):
                    return table(x, committed, launcher)
            else:
                def run(plan=variants[label], launcher=launchers[spec]):
                    return kern(x, plan, launcher)
            same = torch.equal(run(), want)
            ok &= same
            row.setdefault(f"{spec} {label}", []).append([
                time_cuda(run, 20) * 1e3,
                device_ms(run, kernel="clay_transform_kernel"), same])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "card": smi, "erased_nodes": er, "sms": sms,
        "columns": ["events_ms", "device_ms", "equal"],
        "builds": {spec: {"ptxas": builds[src]["ptxas"],
                          "sass": builds[src]["sass"],
                          "resources": res_usage(
                              Path(builds[src]["lib"]._name))}
                   for spec, src in sources.items()},
        "plans": plans, "times": times, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
