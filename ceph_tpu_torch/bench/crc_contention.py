"""Host crc32c under thread contention: the cost of giving up the GIL.

An OSD verifies every shard it serves with the host crc32c
(``utils/checksum.crc32c``) on an op thread, beside the messenger's event
loops and the other op threads. A numpy call may give up the GIL, and a
thread that gave it up waits for it again behind busy threads, so what
matters there is how many numpy calls a crc makes, not only its time
alone. This times, on a 128 KiB shard (one k=8 chunk stream of a 1 MiB
object):

- ``crc32c``: the native library's crc (one ctypes call, which gives up
  the GIL for its length);
- ``plain``: ``crc32c_plain``, the row-parallel numpy path (a handful of
  numpy calls), which the OSD ran before the native library was built;
- ``rows_per_position``: ``crc32c_rows`` on the same bytes as [256, 512],
  one numpy step a byte position (512 calls), the shape of a loop that
  walks positions;

each alone, beside one thread spinning in Python, and (``crc32c`` and
``plain``) from 8 threads at once. Host clock, median of the repeats;
prints one JSON line:

    python -m ceph_tpu_torch.bench.crc_contention [--repeats N]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import threading
import time

import numpy as np

from ceph_tpu_torch.utils import checksum

SHARD_BYTES = 128 << 10


def _median_ms(fn, repeats: int) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def _beside_spinner(fn, repeats: int) -> float:
    stop = threading.Event()

    def spin():
        x = 0
        while not stop.is_set():
            x += 1

    th = threading.Thread(target=spin, daemon=True)
    th.start()
    try:
        return _median_ms(fn, repeats)
    finally:
        stop.set()
        th.join()


def run(repeats: int = 5) -> dict:
    rng = np.random.default_rng(12)
    shard = rng.integers(0, 256, SHARD_BYTES, dtype=np.uint8)
    rows = shard.reshape(256, 512)
    want = checksum.crc32c_sw(shard[:4096])
    assert checksum.crc32c(shard[:4096]) == want
    assert checksum.crc32c(shard) == checksum.crc32c_plain(shard)

    def crc():
        checksum.crc32c(shard, 0xFFFFFFFF)

    def plain():
        checksum.crc32c_plain(shard, 0xFFFFFFFF)

    def per_position():
        checksum.crc32c_rows(rows)

    crc()
    plain()
    per_position()
    shards = [rng.integers(0, 256, SHARD_BYTES, dtype=np.uint8)
              for _ in range(8)]

    def eight_threads(fn):
        def run():
            ts = [threading.Thread(target=fn, args=(s,)) for s in shards]
            for th in ts:
                th.start()
            for th in ts:
                th.join()
        return run

    return {"bench": "crc_contention", "host_cpus": os.cpu_count(),
            "shard_bytes": SHARD_BYTES, "repeats": repeats,
            "crc32c_ms": _median_ms(crc, repeats),
            "crc32c_beside_spinner_ms": _beside_spinner(crc, repeats),
            "crc32c_8_threads_wall_ms": _median_ms(
                eight_threads(checksum.crc32c), repeats),
            "plain_ms": _median_ms(plain, repeats),
            "plain_beside_spinner_ms": _beside_spinner(plain, repeats),
            "plain_8_threads_wall_ms": _median_ms(
                eight_threads(checksum.crc32c_plain), repeats),
            "rows_per_position_ms": _median_ms(per_position, repeats),
            "rows_per_position_beside_spinner_ms":
                _beside_spinner(per_position, max(1, repeats // 2))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.repeats)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
