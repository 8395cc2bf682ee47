"""objectstore_tool — offline object-store surgery.

Role of src/tools/ceph-objectstore-tool: operate on a (stopped) OSD's
object store directly — list PGs/objects, dump or rewrite object bytes,
attrs and omap, remove objects, and export/import whole collections as
portable dump files (the PG export/import used for disaster recovery).

    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR <op> ...

Ops:
    list [--cid CID]              collections, or objects of one
    info --cid CID --oid OID      size + attrs + omap keys (JSON)
    get-bytes / set-bytes         object data to/from stdout/stdin/file
    get-attrs / rm                attrs dump / remove object
    export --cid CID --file F     collection -> portable dump
    import --file F               dump -> collection (must not exist)
    fsck                          read every object, report EIO/crc

Port of ``ceph_tpu/tools/objectstore_tool.py``: the same ops, output and
export format, on the port's BlockStore (a directory either package
wrote).
"""

from __future__ import annotations

import argparse
import base64
import json
import sys

from ceph_tpu_torch.store.object_store import (
    StoreError,
    Transaction,
    create_store,
)
from ceph_tpu_torch.utils.encoding import Decoder, Encoder

EXPORT_MAGIC = b"ceph-tpu-export-1\n"


def _store(args):
    store = create_store("blockstore", args.data_path)
    store.mount()
    return store


def _apply(store, txn: Transaction) -> None:
    done = []
    store.queue_transaction(txn, on_commit=lambda: done.append(1))
    # stores apply synchronously or on a flush thread; poll briefly
    import time
    for _ in range(100):
        if done:
            return
        time.sleep(0.01)
    raise StoreError("transaction did not commit")


def op_list(store, args) -> int:
    if args.cid:
        print(json.dumps(sorted(store.list_objects(args.cid))))
    else:
        print(json.dumps(sorted(store.list_collections())))
    return 0


def op_info(store, args) -> int:
    info = {
        "cid": args.cid, "oid": args.oid,
        "size": store.stat(args.cid, args.oid),
        "attrs": {k: base64.b64encode(v).decode()
                  for k, v in store.getattrs(args.cid, args.oid).items()},
        "omap": {k: base64.b64encode(v).decode()
                 for k, v in store.omap_get(args.cid, args.oid).items()},
    }
    print(json.dumps(info, indent=2, sort_keys=True))
    return 0


def op_get_bytes(store, args) -> int:
    data = store.read(args.cid, args.oid)
    if args.file and args.file != "-":
        with open(args.file, "wb") as f:
            f.write(data)
    else:
        sys.stdout.buffer.write(data)
    return 0


def op_set_bytes(store, args) -> int:
    if args.file and args.file != "-":
        with open(args.file, "rb") as f:
            data = f.read()
    else:
        data = sys.stdin.buffer.read()
    txn = Transaction()
    txn.touch(args.cid, args.oid)
    txn.truncate(args.cid, args.oid, 0)
    txn.write(args.cid, args.oid, 0, data)
    _apply(store, txn)
    print(f"wrote {len(data)} bytes to {args.cid}/{args.oid}",
          file=sys.stderr)
    return 0


def op_rm(store, args) -> int:
    txn = Transaction()
    txn.remove(args.cid, args.oid)
    _apply(store, txn)
    return 0


def op_export(store, args) -> int:
    """Collection -> self-contained dump (PG export role). The dump is
    a versioned wire encoding, so it survives tool versions the same
    way on-disk state does."""
    body = Encoder()
    oids = sorted(store.list_objects(args.cid))
    body.str(args.cid)
    body.u32(len(oids))
    for oid in oids:
        body.str(oid)
        body.bytes(store.read(args.cid, oid))
        body.str_map({k: v.decode("latin1") for k, v in
                      store.getattrs(args.cid, oid).items()})
        body.str_map({k: v.decode("latin1") for k, v in
                      store.omap_get(args.cid, oid).items()})
    out = Encoder()
    out.section(1, body)
    with open(args.file, "wb") as f:
        f.write(EXPORT_MAGIC + out.getvalue())
    print(f"exported {len(oids)} objects from {args.cid}",
          file=sys.stderr)
    return 0


def op_import(store, args) -> int:
    with open(args.file, "rb") as f:
        raw = f.read()
    if not raw.startswith(EXPORT_MAGIC):
        print("not an export file", file=sys.stderr)
        return 22
    _, d = Decoder(raw[len(EXPORT_MAGIC):]).section(1)
    cid = d.str()
    if cid in store.list_collections():
        print(f"collection {cid} already exists (remove it first)",
              file=sys.stderr)
        return 17
    txn = Transaction()
    txn.create_collection(cid)
    n = d.u32()
    for _ in range(n):
        oid = d.str()
        data = d.bytes()
        attrs = d.str_map()
        omap = d.str_map()
        txn.touch(cid, oid)
        if data:
            txn.write(cid, oid, 0, data)
        for k, v in attrs.items():
            txn.setattr(cid, oid, k, v.encode("latin1"))
        if omap:
            txn.omap_set(cid, oid,
                         {k: v.encode("latin1") for k, v in omap.items()})
    _apply(store, txn)
    print(f"imported {n} objects into {cid}", file=sys.stderr)
    return 0


def op_fsck(store, args) -> int:
    """Read every byte of every object: blockstore verifies blob crcs
    on read, so this surfaces silent corruption (deep-scrub-offline)."""
    bad = []
    n = 0
    for cid in store.list_collections():
        for oid in store.list_objects(cid):
            n += 1
            try:
                store.read(cid, oid)
                store.getattrs(cid, oid)
            except StoreError as exc:
                bad.append({"cid": cid, "oid": oid, "error": str(exc)})
    print(json.dumps({"objects": n, "errors": bad}, indent=2))
    return 1 if bad else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="objectstore_tool")
    ap.add_argument("--data-path", required=True,
                    help="blockstore directory of a STOPPED osd")
    ap.add_argument("op", choices=("list", "info", "get-bytes",
                                   "set-bytes", "rm", "export",
                                   "import", "fsck"))
    ap.add_argument("--cid", default=None, help="collection (pg) id")
    ap.add_argument("--oid", default=None)
    ap.add_argument("--file", default=None)
    args = ap.parse_args(argv)

    need_cid = {"info", "get-bytes", "set-bytes", "rm", "export"}
    if args.op in need_cid and not args.cid:
        ap.error(f"{args.op} requires --cid")
    if args.op in {"info", "get-bytes", "set-bytes", "rm"} \
            and not args.oid:
        ap.error(f"{args.op} requires --oid")
    if args.op in {"export", "import"} and not args.file:
        ap.error(f"{args.op} requires --file")

    store = _store(args)
    try:
        return {
            "list": op_list, "info": op_info,
            "get-bytes": op_get_bytes, "set-bytes": op_set_bytes,
            "rm": op_rm, "export": op_export, "import": op_import,
            "fsck": op_fsck,
        }[args.op](store, args)
    except StoreError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    finally:
        store.umount()


if __name__ == "__main__":
    raise SystemExit(main())
