"""One exploratory run of the served engine path, outside the cells: 8
producer threads stage 1 MiB RS k=8,m=3 writes into one
``DeviceEncodeEngine`` at its default flush size and window, and the
continuations land each op's shards and crcs in host arrays, as an OSD's
op queue does. Prints one JSON line: GB/s of object data completed, ops a
flush, the share of each engine stage in the ops' stage clocks, and the
card's idle share over a traced stretch (the CUDA activity alone).

    python3 -m ecbench.explore.served_engine [--seconds 10] [--seed 1]

It answers whether a ``write_GBps`` cell on this path could hold a bound;
it is not a cell, and no check runs it.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time

import numpy as np
import torch

from ecbench import trace

K, M = 8, 3
OBJECT = 1 << 20
PRODUCERS = 8
OUTSTANDING = 32          # ops a producer keeps staged and unfinished


class KeyedExecutor:
    """Per-key FIFO workers, as an OSD's sharded op queue."""

    def __init__(self, workers: int) -> None:
        self._queues = [queue.SimpleQueue() for _ in range(workers)]
        self._threads = [threading.Thread(target=self._work, args=(q,),
                                          daemon=True) for q in self._queues]
        for th in self._threads:
            th.start()

    def dispatch(self, key, fn) -> None:
        self._queues[hash(key) % len(self._queues)].put(fn)

    @staticmethod
    def _work(q) -> None:
        while (fn := q.get()) is not None:
            fn()
            del fn

    def stop(self) -> None:
        for q in self._queues:
            q.put(None)
        for th in self._threads:
            th.join()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="served_engine")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--trace-seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="cpu rehearses the run with the plain versions")
    args = ap.parse_args(argv)

    from ceph_tpu_torch.models import instance
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.device_engine import DeviceEncodeEngine
    from ceph_tpu_torch.utils.stage_clock import StageClock

    dev = torch.device(args.device)
    codec = instance().factory("isa", {"k": str(K), "m": str(M)},
                               device=dev)
    sinfo = ec_util.StripeInfo(K * 4096, 4096)
    rng = np.random.default_rng(args.seed)
    objs = [rng.integers(0, 256, OBJECT, dtype=np.uint8)
            for _ in range(PRODUCERS * OUTSTANDING)]
    seg = OBJECT // K
    land = np.ones((PRODUCERS, OUTSTANDING, K + M, seg), np.uint8)
    crcs = np.zeros((PRODUCERS, OUTSTANDING, K + M), np.int64)
    executor = KeyedExecutor(PRODUCERS)
    eng = DeviceEncodeEngine(executor.dispatch)
    stop = threading.Event()
    lock = threading.Lock()
    done = {"ops": 0, "errors": 0}
    stages: dict[str, float] = {}

    def producer(t: int) -> None:
        room = threading.Semaphore(OUTSTANDING)
        i = 0
        while not stop.is_set():
            if not room.acquire(timeout=0.5):
                continue
            slot = i % OUTSTANDING
            clock = StageClock()

            def cont(shards, lin, err, slot=slot, clock=clock):
                if err is None:
                    for j in range(K + M):
                        land[t, slot, j] = shards[j]
                        crcs[t, slot, j] = lin[j] if lin else 0
                clock.mark("landed")
                with lock:
                    done["ops"] += 1
                    done["errors"] += err is not None
                    for name, s in clock.durations():
                        stages[name] = stages.get(name, 0.0) + s
                room.release()
            eng.stage_encode(t, codec, sinfo,
                             objs[t * OUTSTANDING + slot], cont, clock=clock)
            i += 1

    threads = [threading.Thread(target=producer, args=(t,), daemon=True)
               for t in range(PRODUCERS)]
    for th in threads:
        th.start()
    time.sleep(2.0)                    # warm: builds, allocator, streams
    with lock:
        ops0 = done["ops"]
        stages.clear()
    flushes0 = eng.stats["flushes"]
    t0 = time.perf_counter()
    time.sleep(args.seconds)
    with lock:
        ops1 = done["ops"]
        stage_s = dict(stages)
    wall = time.perf_counter() - t0
    flushes1, ops_f = eng.stats["flushes"], eng.stats["ops"]
    view = None
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(dev)
            time.sleep(args.trace_seconds)
            torch.cuda.synchronize(dev)
        view = trace.view_from_events(trace.export_events(prof), 1, {},
                                      None)
    stop.set()
    for th in threads:
        th.join()
    eng.stop()
    executor.stop()
    total = sum(stage_s.values()) or 1.0
    print(json.dumps({
        "write_GBps": (ops1 - ops0) * OBJECT / wall / 1e9,
        "ops": ops1 - ops0, "seconds": wall,
        "flushes": flushes1 - flushes0,
        "ops_per_flush": (ops1 - ops0) / max(flushes1 - flushes0, 1),
        "engine_ops_total": ops_f, "errors": done["errors"],
        "stage_share_pct": {k: 100.0 * v / total
                            for k, v in sorted(stage_s.items())},
        "device_idle_pct": None if view is None
        else 100.0 * (1 - view.busy_s() / view.window_s),
        "traced_window_s": None if view is None else view.window_s,
        "breakdown": None if view is None else view.breakdown(),
        "card": torch.cuda.get_device_name(dev) if view else "cpu",
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
