"""``ceph`` CLI — cluster admin commands over the mon (src/ceph.in role).

Usage (python -m ceph_tpu_torch.tools.ceph_cli):

    ceph -m HOST:PORT status
    ceph -m HOST:PORT health
    ceph -m HOST:PORT health detail      # structured named checks
    ceph -m HOST:PORT osd tree
    ceph -m HOST:PORT osd pool create NAME [pg_num] [size]
    ceph -m HOST:PORT osd pool ls
    ceph -m HOST:PORT osd erasure-code-profile set NAME k=K m=M [plugin=P ...]
    ceph -m HOST:PORT osd erasure-code-profile ls
    ceph -m HOST:PORT osd erasure-code-profile get NAME
    ceph -m HOST:PORT osd out ID | osd in ID
    ceph daemon /path/to/daemon.asok COMMAND [k=v ...]

The mon side is the command table of OSDMonitor::prepare_command; the
``daemon`` form is the reference's admin-socket passthrough.
"""

from __future__ import annotations

import json
import sys


def _parse_kv(args: list[str]) -> dict:
    out = {}
    for a in args:
        if "=" not in a:
            raise SystemExit(f"expected key=value, got {a!r}")
        k, v = a.split("=", 1)
        out[k] = v
    return out


def _daemon_command(argv: list[str]) -> int:
    from ceph_tpu_torch.utils.admin_socket import asok_command
    if len(argv) < 2:
        print("usage: ceph daemon <path.asok> <command> [k=v ...]",
              file=sys.stderr)
        return 22
    path, prefix = argv[0], argv[1]
    # multi-word asok commands ("perf dump", "config set"): greedily
    # join non-k=v words into the prefix
    rest = argv[2:]
    while rest and "=" not in rest[0]:
        prefix += " " + rest.pop(0)
    out = asok_command(path, prefix, **_parse_kv(rest))
    print(json.dumps(out, indent=2, sort_keys=True))
    return 0


def _mon_command(mon_addr: str, argv: list[str]) -> int:
    from ceph_tpu_torch.client.rados import RadosClient
    words = []
    kv: dict = {}
    for a in argv:
        if "=" in a:
            k, v = a.split("=", 1)
            kv[k] = v
        else:
            words.append(a)
    prefix = " ".join(words)
    cmd: dict = {"prefix": prefix}

    # positional sugar for the common commands
    if prefix.startswith("osd pool create"):
        rest = prefix.split()[3:]
        cmd["prefix"] = "osd pool create"
        if rest:
            cmd["pool"] = rest[0]
        if len(rest) > 1:
            cmd["pg_num"] = int(rest[1])
        if len(rest) > 2:
            cmd["size"] = int(rest[2])
    elif prefix.startswith("osd erasure-code-profile set"):
        rest = prefix.split()[3:]
        cmd["prefix"] = "osd erasure-code-profile set"
        if rest:
            cmd["name"] = rest[0]
        cmd["profile"] = json.dumps(kv)
        kv = {}
    elif prefix.startswith("osd erasure-code-profile get"):
        rest = prefix.split()[3:]
        cmd["prefix"] = "osd erasure-code-profile get"
        if rest:
            cmd["name"] = rest[0]
    elif prefix.startswith(("osd out", "osd in")):
        parts = prefix.split()
        cmd["prefix"] = " ".join(parts[:2])
        if len(parts) > 2:
            cmd["id"] = int(parts[2])
    for k, v in kv.items():
        cmd[k] = int(v) if v.isdigit() else v

    client = RadosClient(mon_addr).connect()
    try:
        code, outs, data = client.mon_command(cmd)
    finally:
        client.shutdown()
    if data:
        try:
            print(json.dumps(json.loads(data), indent=2, sort_keys=True))
        except ValueError:
            sys.stdout.write(data.decode(errors="replace"))
    if outs:
        print(outs, file=sys.stderr)
    return 0 if code == 0 else -code


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "daemon":
        return _daemon_command(argv[1:])
    mon_addr = ""
    if argv[:1] == ["-m"]:
        mon_addr = argv[1]
        argv = argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 22
    if not mon_addr:
        print("need -m HOST:PORT (mon address)", file=sys.stderr)
        return 22
    return _mon_command(mon_addr, argv)


if __name__ == "__main__":
    raise SystemExit(main())
