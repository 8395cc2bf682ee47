"""``rados`` CLI — object I/O + benchmark (src/tools/rados/rados.cc role).

Usage (python -m ceph_tpu_torch.tools.rados_cli):

    rados -m HOST:PORT -p POOL put OBJ FILE      (or - for stdin)
    rados -m HOST:PORT -p POOL get OBJ FILE      (or - for stdout)
    rados -m HOST:PORT -p POOL ls
    rados -m HOST:PORT -p POOL rm OBJ
    rados -m HOST:PORT -p POOL stat OBJ
    rados -m HOST:PORT -p POOL bench SECONDS write|seq
          [-b OBJ_SIZE] [-t CONCURRENCY]

``bench`` is the ObjBencher role (rados.cc:1030): timed write (then
read-back for ``seq``) with a thread pool, reporting aggregate
throughput/latency the way ``rados bench`` does.
"""

from __future__ import annotations

import concurrent.futures
import sys
import time


def _percentile_ms(lats: list[float], q: float) -> float:
    """Nearest-rank percentile over the timed ops, in ms (zero extra
    bench budget: same list avg/max already read). Six decimals: a
    sub-microsecond latency (in-process stub stores) must round to a
    nonzero value, not masquerade as an unmeasured op."""
    if not lats:
        return 0.0
    ordered = sorted(lats)
    idx = min(len(ordered) - 1, max(0, int(q * len(ordered)) - 1))
    return round(ordered[idx] * 1e3, 6)


def _bench(io, seconds: float, mode: str, obj_size: int,
           concurrency: int) -> dict:
    payload = bytes((i * 131) & 0xFF for i in range(obj_size))
    written: list[str] = []
    lats: list[float] = []
    t_end = time.monotonic() + seconds
    counter = [0]

    def one_write() -> str:
        i = counter[0]
        counter[0] += 1
        oid = f"bench_{i}"
        t0 = time.monotonic()
        io.write_full(oid, payload)
        lats.append(time.monotonic() - t0)
        return oid

    t_start = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
        futs = {pool.submit(one_write) for _ in range(concurrency)}
        while futs:
            done, futs = concurrent.futures.wait(
                futs, return_when=concurrent.futures.FIRST_COMPLETED)
            for f in done:
                written.append(f.result())
                if time.monotonic() < t_end:
                    futs.add(pool.submit(one_write))
    write_elapsed = time.monotonic() - t_start

    result = {
        "mode": "write", "objects": len(written),
        "object_size": obj_size, "seconds": round(write_elapsed, 3),
        "bandwidth_MBps": round(
            len(written) * obj_size / write_elapsed / 1e6, 2),
        "iops": round(len(written) / write_elapsed, 1),
        "avg_latency_s": round(sum(lats) / max(len(lats), 1), 5),
        "max_latency_s": round(max(lats, default=0.0), 5),
        # client-op latency tails from the SAME timed ops
        "p50_ms": _percentile_ms(lats, 0.50),
        "p99_ms": _percentile_ms(lats, 0.99),
    }
    if mode == "seq":
        rlats: list[float] = []

        def one_read(oid: str) -> None:
            t0 = time.monotonic()
            data = io.read(oid)
            rlats.append(time.monotonic() - t0)
            assert data == payload, f"bench read mismatch on {oid}"

        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(concurrency) as pool:
            list(pool.map(one_read, written))
        relapsed = time.monotonic() - t0
        result["read"] = {
            "objects": len(written), "seconds": round(relapsed, 3),
            "bandwidth_MBps": round(
                len(written) * obj_size / relapsed / 1e6, 2),
            "avg_latency_s": round(
                sum(rlats) / max(len(rlats), 1), 5),
        }
    # cleanup (rados bench write leaves objects unless --no-cleanup;
    # we clean up by default to keep the pool reusable)
    for oid in written:
        try:
            io.remove(oid)
        except Exception:
            pass
    return result


def main(argv: list[str] | None = None) -> int:
    import json

    from ceph_tpu_torch.client.rados import RadosClient, RadosError

    argv = list(sys.argv[1:] if argv is None else argv)
    mon_addr = pool = ""
    while argv and argv[0] in ("-m", "-p"):
        flag = argv.pop(0)
        val = argv.pop(0)
        if flag == "-m":
            mon_addr = val
        else:
            pool = val
    if not argv or not mon_addr:
        print(__doc__, file=sys.stderr)
        return 22
    cmd, *rest = argv

    client = RadosClient(mon_addr).connect()
    try:
        if cmd == "lspools":
            code, _, data = client.mon_command({"prefix": "osd pool ls"})
            print(json.dumps(json.loads(data or b"[]")))
            return -code if code else 0
        if not pool:
            print("need -p POOL", file=sys.stderr)
            return 22
        io = client.open_ioctx(pool)
        if cmd == "put":
            oid, path = rest[0], rest[1]
            data = (sys.stdin.buffer.read() if path == "-"
                    else open(path, "rb").read())
            io.write_full(oid, data)
        elif cmd == "get":
            oid, path = rest[0], rest[1]
            data = io.read(oid)
            if path == "-":
                sys.stdout.buffer.write(data)
            else:
                with open(path, "wb") as f:
                    f.write(data)
        elif cmd == "ls":
            for oid in io.list_objects():
                print(oid)
        elif cmd == "rm":
            io.remove(rest[0])
        elif cmd == "stat":
            print(json.dumps({"oid": rest[0], "size": io.stat(rest[0])}))
        elif cmd == "bench":
            seconds = float(rest[0])
            mode = rest[1] if len(rest) > 1 else "write"
            obj_size, conc = 4 << 20, 16
            i = 2
            while i < len(rest):
                if rest[i] == "-b":
                    obj_size = int(rest[i + 1]); i += 2
                elif rest[i] == "-t":
                    conc = int(rest[i + 1]); i += 2
                else:
                    i += 1
            print(json.dumps(_bench(io, seconds, mode, obj_size, conc),
                             indent=2))
        else:
            print(f"unknown command {cmd!r}", file=sys.stderr)
            return 22
        return 0
    except RadosError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return abs(exc.code) or 1
    finally:
        client.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
