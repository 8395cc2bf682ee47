"""Erasure-code benchmark — CLI-compatible with ``ceph_erasure_code_benchmark``.

Port of ``ceph_tpu/bench/ec_bench.py``. Reference:
src/test/erasure-code/ceph_erasure_code_benchmark.cc. Same surface:
``--plugin/-p``, repeated ``--parameter/-P k=v``, ``--size/-S`` (bytes per
object), ``--iterations/-i``, ``--workload/-w encode|decode``,
``--erasures/-e`` or ``--erased``, ``--erasures-generation exhaustive``,
and the same output: one line ``elapsed_seconds <TAB> total_KiB``.

``--batch`` objects form one batch, and ``--device-resident`` keeps that
batch on the card as one [k, N] tensor and times kernel B1 on it with CUDA
events (warm-up, then the median of several timed runs), so the number
measures the kernel, not the host link; as in the reference it is for
matrix codecs only. ``--device`` picks the codec's device (``cuda`` by
default). Any plugin runs through its codec's ``encode``/``decode``,
Clay included (kernels B3-B5 on the card):

    python -m ceph_tpu_torch.bench.ec_bench -P k=8 -P m=3 -p isa \\
        --device-resident -S 1048576 --batch 128
    python -m ceph_tpu_torch.bench.ec_bench -p clay -P k=8 -P m=4 \\
        -P d=11 -w decode -e 2
"""

from __future__ import annotations

import argparse
import itertools
import random
import statistics
import sys
import time

import numpy as np
import torch

from ceph_tpu_torch.models import instance


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="ec_bench")
    ap.add_argument("--plugin", "-p", default="jerasure")
    ap.add_argument("--parameter", "-P", action="append", default=[],
                    help="profile k=v pairs")
    ap.add_argument("--size", "-S", type=int, default=1 << 20,
                    help="bytes per object per iteration")
    ap.add_argument("--iterations", "-i", type=int, default=10)
    ap.add_argument("--workload", "-w", default="encode",
                    choices=("encode", "decode"))
    ap.add_argument("--erasures", "-e", type=int, default=1)
    ap.add_argument("--erased", type=int, action="append", default=None,
                    help="fixed erased chunk ids")
    ap.add_argument("--erasures-generation", default="random",
                    choices=("random", "exhaustive"))
    ap.add_argument("--batch", type=int, default=1,
                    help="objects per batch")
    ap.add_argument("--device-resident", action="store_true",
                    help="keep the batch on the card and time kernel B1 "
                         "with CUDA events (CUDA only)")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=42)
    return ap.parse_args(argv)


def time_cuda(fn, iterations: int, repeats: int = 5) -> float:
    """Seconds per call of ``fn`` on the current CUDA stream: one warm-up
    call, then the median over ``repeats`` runs of ``iterations`` calls,
    each run timed between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iterations):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / 1e3 / iterations)
    return statistics.median(runs)


class ErasureCodeBench:
    """Mirrors ErasureCodeBench::{setup,run,encode,decode} (reference :40-328)."""

    def __init__(self, args) -> None:
        self.args = args
        profile = {}
        for kv in args.parameter:
            key, _, val = kv.partition("=")
            profile[key] = val
        profile.setdefault("backend", args.backend)
        self.profile = profile
        self.codec = instance().factory(args.plugin, profile,
                                        device=args.device)
        self.k = self.codec.get_data_chunk_count()
        self.n = self.codec.get_chunk_count()

    def run(self) -> tuple[float, int]:
        if self.args.device_resident:
            if self.args.workload != "encode":
                raise SystemExit("--device-resident supports encode only")
            return self.encode_device_resident()
        if self.args.workload == "encode":
            return self.encode()
        return self.decode()

    def _make_objects(self):
        rng = np.random.default_rng(self.args.seed)
        return [
            rng.integers(0, 256, size=self.args.size, dtype=np.uint8).tobytes()
            for _ in range(self.args.batch)
        ]

    def encode(self) -> tuple[float, int]:
        objs = self._make_objects()
        want = list(range(self.n))
        self.codec.encode(want, objs[0])        # warm-up (kernel build)
        begin = time.perf_counter()
        total = 0
        for _ in range(self.args.iterations):
            for data in objs:
                self.codec.encode(want, data)
                total += len(data)
        elapsed = time.perf_counter() - begin
        return elapsed, total // 1024

    def encode_device_resident(self) -> tuple[float, int]:
        """Kernel B1 on a device-resident [k, N] batch of ``--batch``
        objects, timed with CUDA events."""
        from ceph_tpu_torch.ops import gf_cuda
        if self.codec.device.type != "cuda":
            raise SystemExit("--device-resident needs --device cuda")
        mat = getattr(self.codec, "coding_matrix", None)
        if mat is None:
            raise SystemExit("--device-resident needs a matrix codec "
                             "(jerasure/isa/shec)")
        mat = np.asarray(mat, dtype=np.uint8)
        n_lanes = max(self.args.size * self.args.batch // self.k, 1)
        gen = torch.Generator(device=self.codec.device)
        gen.manual_seed(self.args.seed)
        data = torch.randint(0, 256, (self.k, n_lanes), dtype=torch.uint8,
                             device=self.codec.device, generator=gen)
        per_call = time_cuda(lambda: gf_cuda.matvec_device(mat, data),
                             iterations=10)
        elapsed = per_call * self.args.iterations
        total = n_lanes * self.k * self.args.iterations
        return elapsed, total // 1024

    def _erasure_patterns(self):
        if self.args.erased:
            return itertools.repeat(tuple(self.args.erased))
        if self.args.erasures_generation == "exhaustive":
            combos = list(itertools.combinations(range(self.n),
                                                 self.args.erasures))
            return itertools.cycle(combos)
        rnd = random.Random(self.args.seed)

        def gen():
            while True:
                yield tuple(rnd.sample(range(self.n), self.args.erasures))
        return gen()

    def decode(self) -> tuple[float, int]:
        data = self._make_objects()[0]
        encoded = self.codec.encode(list(range(self.n)), data)
        chunk_size = len(encoded[0])
        patterns = self._erasure_patterns()
        first = next(patterns)                  # warm-up
        avail = {i: encoded[i] for i in range(self.n) if i not in first}
        self.codec.decode(list(first), avail, chunk_size)
        begin = time.perf_counter()
        total = 0
        for _, lost in zip(range(self.args.iterations), patterns):
            avail = {i: encoded[i] for i in range(self.n) if i not in lost}
            out = self.codec.decode(list(lost), avail, chunk_size)
            if any(len(v) != chunk_size for v in out.values()):
                raise RuntimeError("decode returned a short chunk")
            total += len(data)
        elapsed = time.perf_counter() - begin
        return elapsed, total // 1024


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    bench = ErasureCodeBench(args)
    elapsed, kib = bench.run()
    # output contract of the reference benchmark (:188)
    print(f"{elapsed:f}\t{kib}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
