"""dencoder — encode/decode/dump wire types (ceph-dencoder role).

Reference: src/tools/ceph-dencoder (+ src/test/encoding/readable.sh):
lists every encodable type, round-trips instances through the versioned
wire encoding, and dumps them as JSON — the tool behind the
ceph-object-corpus cross-version compatibility gate.

    python -m ceph_tpu_torch.tools.dencoder list
    python -m ceph_tpu_torch.tools.dencoder type MOSDOp dump_json < payload.bin
    python -m ceph_tpu_torch.tools.dencoder type OSDMap encode > map.bin
    python -m ceph_tpu_torch.tools.dencoder test          # roundtrip all types

Message types use their declarative FIELDS schema; structural types
(OSDMap, Transaction, HashInfo) register explicit codecs.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys


def _message_types() -> dict[str, type]:
    from ceph_tpu_torch.parallel import messages as M
    return {name: cls for name, cls in vars(M).items()
            if isinstance(cls, type) and issubclass(cls, M.Message)
            and cls is not M.Message and cls.MSG_TYPE}


def _jsonable(v):
    if isinstance(v, bytes):
        return {"__b64__": base64.b64encode(v).decode()}
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


def _dump_message(msg) -> dict:
    return {"type": type(msg).__name__,
            "fields": {n: _jsonable(getattr(msg, n))
                       for n, _ in msg.FIELDS}}


# -- structural types --------------------------------------------------

def _osdmap_sample():
    from ceph_tpu_torch.parallel import crush
    from ceph_tpu_torch.parallel.osdmap import OSDMap
    m = OSDMap()
    m.epoch = 42
    m.crush.add_bucket("default", "root")
    m.crush.add_bucket("host0", "host", parent="default")
    m.crush.add_device(0, "host0")
    m.add_osd(0)
    m.mark_up(0, "127.0.0.1:6800")
    m.crush.add_rule(crush.Rule("data", "default", "osd", "firstn"))
    m.create_pool("p", 8, "data", size=1, min_size=1)
    m.pg_upmap_items[(1, 0)] = [(0, 0)]
    return m


def _txn_sample():
    from ceph_tpu_torch.store.object_store import Transaction
    t = Transaction()
    t.create_collection("c")
    t.touch("c", "o")
    t.write("c", "o", 0, b"data")
    t.setattr("c", "o", "v", b"\x01")
    t.omap_set("c", "o", {"k": b"v"})
    return t


def _hashinfo_sample():
    """A HashInfo folded with ``append``, which hashes the bytes on the
    host, as the reference's sample is. The OSD's write path folds the
    linear crc parts kernel B2 computed with ``append_linear``; both give
    the same hashes, so the same encoded bytes."""
    import numpy as np
    from ceph_tpu_torch.osd.ec_util import HashInfo
    h = HashInfo(3)
    h.append(0, {i: np.full(16, i, dtype=np.uint8) for i in range(3)})
    return h


def _osdmap_decode(raw: bytes):
    from ceph_tpu_torch.parallel.osdmap import OSDMap
    return OSDMap.decode(raw)


def _txn_decode(raw: bytes):
    from ceph_tpu_torch.store.object_store import Transaction
    return Transaction.decode(raw)


def _hashinfo_decode(raw: bytes):
    from ceph_tpu_torch.osd.ec_util import HashInfo
    return HashInfo.from_dict(json.loads(raw))


STRUCTS = {
    "OSDMap": {
        "sample": _osdmap_sample,
        "encode": lambda m: m.encode(),
        "decode": _osdmap_decode,
        "dump": lambda m: {"epoch": m.epoch,
                           "osds": sorted(m.osds),
                           "pools": sorted(m.pool_by_name),
                           "pg_upmap_items": {
                               f"{k[0]}.{k[1]}": v for k, v in
                               m.pg_upmap_items.items()}},
        "eq": lambda a, b: a.encode() == b.encode(),
    },
    "Transaction": {
        "sample": _txn_sample,
        "encode": lambda t: t.encode(),
        "decode": _txn_decode,
        "dump": lambda t: {"ops": [_jsonable(list(op)) for op in t.ops]},
        "eq": lambda a, b: a.encode() == b.encode(),
    },
    "HashInfo": {
        "sample": _hashinfo_sample,
        # the bytes the OSD stores as an EC object's ``hinfo`` attr
        "encode": lambda h: json.dumps(h.to_dict()).encode(),
        "decode": _hashinfo_decode,
        "dump": lambda h: h.to_dict(),
        "eq": lambda a, b: a.to_dict() == b.to_dict(),
    },
}


def op_list() -> int:
    names = sorted(_message_types()) + sorted(STRUCTS)
    print("\n".join(names))
    return 0


def op_type(name: str, action: str) -> int:
    msgs = _message_types()
    if name in msgs:
        cls = msgs[name]
        if action == "encode":
            sys.stdout.buffer.write(cls().encode_payload())
            return 0
        payload = sys.stdin.buffer.read()
        msg = cls.decode_payload(payload)
        if action == "decode":
            print("ok")
        else:
            print(json.dumps(_dump_message(msg), indent=2))
        return 0
    if name in STRUCTS:
        spec = STRUCTS[name]
        if action == "encode":
            sys.stdout.buffer.write(spec["encode"](spec["sample"]()))
            return 0
        obj = spec["decode"](sys.stdin.buffer.read())
        if action == "decode":
            print("ok")
        else:
            print(json.dumps(_jsonable(spec["dump"](obj)), indent=2))
        return 0
    print(f"unknown type {name!r} (see 'list')", file=sys.stderr)
    return 22


def op_test() -> int:
    """Roundtrip every type: encode(default) -> decode -> re-encode
    must be byte-identical (the readable.sh non-regression role)."""
    failures = []
    count = 0
    for name, cls in sorted(_message_types().items()):
        count += 1
        try:
            msg = cls()
            raw = msg.encode_payload()
            back = cls.decode_payload(raw)
            if back.encode_payload() != raw:
                failures.append(f"{name}: re-encode mismatch")
        except Exception as exc:
            failures.append(f"{name}: {exc!r}")
    for name, spec in sorted(STRUCTS.items()):
        count += 1
        try:
            obj = spec["sample"]()
            raw = spec["encode"](obj)
            back = spec["decode"](raw)
            if not spec["eq"](obj, back):
                failures.append(f"{name}: roundtrip mismatch")
            if spec["encode"](back) != raw:
                failures.append(f"{name}: re-encode mismatch")
        except Exception as exc:
            failures.append(f"{name}: {exc!r}")
    print(json.dumps({"types": count, "failures": failures}, indent=2))
    return 1 if failures else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="dencoder")
    sub = ap.add_subparsers(dest="op", required=True)
    sub.add_parser("list")
    tp = sub.add_parser("type")
    tp.add_argument("name")
    tp.add_argument("action",
                    choices=("encode", "decode", "dump_json"))
    sub.add_parser("test")
    args = ap.parse_args(argv)
    if args.op == "list":
        return op_list()
    if args.op == "test":
        return op_test()
    return op_type(args.name, args.action)


if __name__ == "__main__":
    import signal
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)   # behave under | head
    raise SystemExit(main())
