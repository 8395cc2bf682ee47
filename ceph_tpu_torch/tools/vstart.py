"""vstart — boot a dev cluster in one process (src/vstart.sh role).

    python -m ceph_tpu_torch.tools.vstart [-n N_OSDS]
        [--store memstore|blockstore|kstore] [--data DIR] [--ec k,m]
        [--backend auto_device|cuda|torch|native|numpy] [--prometheus]
        [--mgr]

Boots one mon + N OSDs, creates a replicated pool ``rbd`` and (with
--ec) an EC pool ``ecpool``, prints the mon address + asok paths, and
runs until SIGINT or SIGTERM, then stops the cluster and exits 0. Drive
it with the ``ceph``/``rados`` CLIs:

    python -m ceph_tpu_torch.tools.ceph_cli -m <addr> status
    python -m ceph_tpu_torch.tools.rados_cli -m <addr> -p rbd bench 5 write

The EC pool runs on the card: ``--backend`` defaults to ``auto_device``,
which resolves to ``cuda`` and raises without a card. ``--backend
torch`` runs the kernels' plain versions on the CPU, and a host backend
(``native``, ``numpy``) the host codec. :func:`start` boots the same
cluster in the caller's process and returns it with a ``stop``.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="vstart")
    ap.add_argument("-n", "--n-osds", type=int, default=3)
    ap.add_argument("--store", default="memstore",
                    choices=("memstore", "blockstore", "kstore"))
    ap.add_argument("--data", default=None,
                    help="data dir (blockstore)")
    ap.add_argument("--ec", default=None, metavar="K,M",
                    help="also create EC pool 'ecpool' with k,m")
    ap.add_argument("--backend", default="auto_device",
                    help="the EC pool's codec backend (default "
                         "auto_device: the card, or an error without "
                         "one; torch runs the plain versions on the CPU)")
    ap.add_argument("--prometheus", action="store_true",
                    help="serve /metrics on an ephemeral port")
    ap.add_argument("--mgr", action="store_true",
                    help="also boot a mgr (balancer/progress/telemetry)")
    return ap


def start(argv: list[str] | None = None):
    """Boot the cluster ``argv`` describes in this process. Returns
    ``(cluster, info, stop)``: the ``MiniCluster``, the dict ``main``
    prints, and a callable that stops the metrics server and the
    cluster. An ``auto_device`` or ``cuda`` backend without a card
    raises before anything starts."""
    args = _parser().parse_args(argv)
    backend = args.backend
    if args.ec:
        k, m = (int(x) for x in args.ec.split(","))
        if backend == "auto_device":
            from ceph_tpu_torch.osd.ec_backend import resolve_auto_device
            backend = resolve_auto_device()

    from ceph_tpu_torch.qa.cluster import MiniCluster

    cluster = MiniCluster(n_osds=args.n_osds, store=args.store,
                          data_dir=args.data).start()
    servers = []

    def stop() -> None:
        for srv in servers:
            srv.stop()
        cluster.stop()

    try:
        cluster.create_pool("rbd", pg_num=8, size=min(3, args.n_osds))
        if args.ec:
            cluster.create_ec_pool("ecpool", k=k, m=m, backend=backend)
        info = {
            "mon_addr": cluster.mon_addr,
            "mon_asok": cluster.mon.asok.path,
            "osd_asoks": {i: o.asok.path for i, o in cluster.osds.items()},
            "pools": ["rbd"] + (["ecpool"] if args.ec else []),
        }
        if args.mgr:
            mgr = cluster.start_mgr()
            info["mgr_asok"] = mgr.asok.path
        if args.prometheus:
            from ceph_tpu_torch.utils.prometheus import MetricsServer
            ms = MetricsServer()
            servers.append(ms)
            info["metrics_url"] = f"http://127.0.0.1:{ms.start()}/metrics"
    except BaseException:
        stop()
        raise
    return cluster, info, stop


def main(argv: list[str] | None = None) -> int:
    stopping = []
    signal.signal(signal.SIGINT, lambda *a: stopping.append(1))
    signal.signal(signal.SIGTERM, lambda *a: stopping.append(1))
    _, info, stop = start(argv)
    print(json.dumps(info, indent=2), flush=True)
    print("cluster up — ctrl-c to stop", file=sys.stderr, flush=True)
    try:
        # a short sleep, not signal.pause(): a signal that lands between
        # the test and the wait cannot leave the loop blocked
        while not stopping:
            time.sleep(0.2)
    finally:
        stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
