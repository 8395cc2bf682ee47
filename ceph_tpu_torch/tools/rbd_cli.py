"""``rbd`` CLI — block-image management (src/tools/rbd role, reduced).

    rbd -m HOST:PORT -p POOL create NAME SIZE_BYTES
    rbd -m HOST:PORT -p POOL ls
    rbd -m HOST:PORT -p POOL info NAME
    rbd -m HOST:PORT -p POOL rm NAME
    rbd -m HOST:PORT -p POOL resize NAME NEW_SIZE
    rbd -m HOST:PORT -p POOL import NAME FILE   (or - for stdin)
    rbd -m HOST:PORT -p POOL export NAME FILE   (or - for stdout)
    rbd -m HOST:PORT -p POOL snap create|rollback|rm NAME SNAP
    rbd -m HOST:PORT -p POOL snap ls NAME
    rbd -m ADDR -p POOL mirror enable|disable|promote|demote|ls IMG
    rbd -m ADDR -p SRC mirror sync DSTPOOL
"""

from __future__ import annotations

import json
import sys


def main(argv: list[str] | None = None) -> int:
    from ceph_tpu_torch.client.rados import RadosClient
    from ceph_tpu_torch.services.rbd import RBD, RBDError

    argv = list(sys.argv[1:] if argv is None else argv)
    mon_addr = pool = ""
    while argv and argv[0] in ("-m", "-p"):
        flag = argv.pop(0)
        val = argv.pop(0)
        if flag == "-m":
            mon_addr = val
        else:
            pool = val
    if not argv or not mon_addr or not pool:
        print(__doc__, file=sys.stderr)
        return 22
    cmd, *rest = argv

    client = RadosClient(mon_addr).connect()
    try:
        rbd = RBD(client.open_ioctx(pool))
        if cmd == "create":
            journaling = "--journaling" in rest
            rest = [r for r in rest if r != "--journaling"]
            rbd.create(rest[0], int(rest[1]), journaling=journaling)
        elif cmd == "ls":
            for name in rbd.list():
                print(name)
        elif cmd == "info":
            # read-only open: must not replay (may race a live writer)
            print(json.dumps(
                rbd.open(rest[0], read_only=True).stat(), indent=2))
        elif cmd == "rm":
            rbd.remove(rest[0])
        elif cmd == "resize":
            rbd.open(rest[0]).resize(int(rest[1]))
        elif cmd == "import":
            data = (sys.stdin.buffer.read() if rest[1] == "-"
                    else open(rest[1], "rb").read())
            img = rbd.create(rest[0], len(data))
            img.write(0, data)
        elif cmd == "export":
            img = rbd.open(rest[0], read_only=True)
            data = img.read(0, img.size())
            if rest[1] == "-":
                sys.stdout.buffer.write(data)
            else:
                with open(rest[1], "wb") as f:
                    f.write(data)
        elif cmd == "snap":
            sub, name = rest[0], rest[1]
            img = rbd.open(name, read_only=(rest[0] == "ls"))
            if sub == "create":
                img.snap_create(rest[2])
            elif sub == "rollback":
                img.snap_rollback(rest[2])
            elif sub == "rm":
                img.snap_remove(rest[2])
            elif sub == "ls":
                for s in img.snap_list():
                    print(s)
            else:
                print(f"unknown snap command {sub!r}", file=sys.stderr)
                return 22
        elif cmd == "mirror":
            from ceph_tpu_torch.services import rbd_mirror as rm
            sub = rest[0]
            if sub == "enable":
                rm.mirror_image_enable(rbd.io, rest[1])
            elif sub == "disable":
                rm.mirror_image_disable(rbd.io, rest[1])
            elif sub == "promote":
                rm.promote(rbd.io, rest[1])
            elif sub == "demote":
                rm.demote(rbd.io, rest[1])
            elif sub == "ls":
                for name in rm.mirror_images(rbd.io):
                    print(name)
            elif sub == "sync":
                # one-shot pool replication: rbd ... mirror sync DSTPOOL
                dst = client.open_ioctx(rest[1])
                out = rm.MirrorDaemon(rbd.io, dst).sync_once()
                print(json.dumps(out, sort_keys=True))
            else:
                print(f"unknown mirror command {sub!r}",
                      file=sys.stderr)
                return 22
        else:
            print(f"unknown command {cmd!r}", file=sys.stderr)
            return 22
        return 0
    except RBDError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    finally:
        client.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
