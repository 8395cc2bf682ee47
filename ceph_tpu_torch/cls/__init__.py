"""cls — in-OSD object classes (src/cls/ role, 17 modules there).

Reference: "stored procedures" loaded into the OSD (dlopen'd
``libcls_*``) and invoked via the CEPH_OSD_OP_CALL op: the method runs
SERVER-side against the object, atomically with respect to other ops
on its PG, and librados exposes it as ``ioctx.exec(oid, cls, method,
input)``.

Here a class method is a pure function over the object's current
bytes:

    method(input: bytes, obj: bytes | None) -> (code, out, new_obj)

``new_obj is None`` leaves the object untouched; otherwise the OSD
writes it back through the normal versioned replication path. The PG
executes ops serially, so read-modify-write methods are atomic exactly
like the reference's cls handlers.

Built-in families mirror 15 of the reference's 17 cls modules:
lock, log, version, refcount, numops, timeindex, statelog, hello,
rgw (bucket index + multipart), rbd (image directory), user (rgw
account stats), cas (dedup chunk refs), otp (in-OSD TOTP), fs
(the cephfs dirop/ino methods, src/cls/cephfs role), and journal
(client registry / commit positions / trim floor,
src/cls/journal/cls_journal.cc — the client-side Journaler drives
these, the reference's layering). Deliberate cuts: ``lua`` (no Lua
runtime in this image), ``sdk`` (a reference test scaffold).
"""

from __future__ import annotations

import json
import time
from typing import Callable

#: method(input, obj) -> (code, out, new_obj | None)
Method = Callable[[bytes, "bytes | None"],
                  "tuple[int, bytes, bytes | None]"]

_REGISTRY: dict[tuple[str, str], Method] = {}

#: sentinel a method returns as ``new_obj`` to REMOVE the object (the
#: reference's cls_cxx_remove — e.g. cls_refcount drops the object
#: when the last reference is put)
REMOVE = object()


class ClsError(Exception):
    def __init__(self, code: int, message: str = "") -> None:
        super().__init__(message or f"cls error {code}")
        self.code = code


def register(cls_name: str, method: str):
    def deco(fn: Method) -> Method:
        _REGISTRY[(cls_name, method)] = fn
        return fn
    return deco


def methods() -> list[str]:
    return sorted(f"{c}.{m}" for c, m in _REGISTRY)


def call(cls_name: str, method: str, inp: bytes,
         obj: bytes | None) -> tuple[int, bytes, bytes | None]:
    fn = _REGISTRY.get((cls_name, method))
    if fn is None:
        return -8, b"", None          # -ENOEXEC: no such class/method
    try:
        return fn(inp, obj)
    except ClsError as exc:
        return exc.code, b"", None
    except Exception:
        return -22, b"", None


# -- cls_lock (src/cls/lock role): advisory object locks --------------

def _lock_state(obj: bytes | None) -> dict:
    if not obj:
        return {"lockers": {}}
    try:
        return json.loads(obj)
    except ValueError:
        return {"lockers": {}}


@register("lock", "lock")
def _lock_lock(inp: bytes, obj: bytes | None):
    """input: {"name", "cookie", "type": "exclusive"|"shared",
    "duration": seconds (0 = forever), "owner": opt client instance
    id}. ``owner`` is what the reference records as the locker's
    entity_addr_t — a lock breaker reads it back from ``info`` to
    know which instance to blocklist before break_lock (the
    ManagedLock break/steal flow, src/librbd/ManagedLock.h:28)."""
    req = json.loads(inp)
    st = _lock_state(obj)
    now = time.time()
    lockers = {k: v for k, v in st["lockers"].items()
               if not v["expires"] or v["expires"] > now}
    key = f"{req['name']}/{req['cookie']}"
    # conflicts are judged against the OTHER lockers: a re-lock by the
    # same cookie renews (or up/downgrades) its own entry, but an
    # upgrade to exclusive must still fail while another holder exists
    # (granting it would hand two clients conflicting caps)
    others = {k: v for k, v in lockers.items() if k != key}
    excl = any(v["type"] == "exclusive" for v in others.values())
    if excl or (req["type"] == "exclusive" and others):
        return -16, b"", None         # -EBUSY
    lockers[key] = {
        "type": req["type"],
        "expires": (now + req["duration"]) if req.get("duration") else 0,
        "owner": req.get("owner", ""),
    }
    st["lockers"] = lockers
    return 0, b"", json.dumps(st).encode()


@register("lock", "unlock")
def _lock_unlock(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    st = _lock_state(obj)
    key = f"{req['name']}/{req['cookie']}"
    if key not in st["lockers"]:
        return -2, b"", None          # -ENOENT
    del st["lockers"][key]
    return 0, b"", json.dumps(st).encode()


@register("lock", "break_lock")
def _lock_break(inp: bytes, obj: bytes | None):
    """Forcibly remove ANOTHER holder's lock (src/cls/lock break_lock
    role — the admin/fencing path). input: {"name", "cookie"};
    cookie "*" breaks every holder of ``name``."""
    req = json.loads(inp)
    st = _lock_state(obj)
    prefix = f"{req['name']}/"
    if req.get("cookie", "*") == "*":
        victims = [k for k in st["lockers"] if k.startswith(prefix)]
    else:
        key = f"{req['name']}/{req['cookie']}"
        victims = [key] if key in st["lockers"] else []
    if not victims:
        return -2, b"", None          # -ENOENT
    for k in victims:
        del st["lockers"][k]
    return 0, b"", json.dumps(st).encode()


@register("lock", "info")
def _lock_info(inp: bytes, obj: bytes | None):
    st = _lock_state(obj)
    now = time.time()
    st["lockers"] = {k: v for k, v in st["lockers"].items()
                     if not v["expires"] or v["expires"] > now}
    return 0, json.dumps(st).encode(), None


# -- cls_log (src/cls/log role): append-only timestamped records ------

@register("log", "add")
def _log_add(inp: bytes, obj: bytes | None):
    entries = json.loads(obj) if obj else []
    entries.append({"stamp": time.time(),
                    "data": inp.decode(errors="replace")})
    return 0, b"", json.dumps(entries).encode()


@register("log", "list")
def _log_list(inp: bytes, obj: bytes | None):
    req = json.loads(inp) if inp else {}
    entries = json.loads(obj) if obj else []
    n = req.get("max_entries", len(entries))
    return 0, json.dumps(entries[-n:]).encode(), None


@register("log", "trim")
def _log_trim(inp: bytes, obj: bytes | None):
    req = json.loads(inp) if inp else {}
    entries = json.loads(obj) if obj else []
    keep = req.get("keep", 0)
    return 0, b"", json.dumps(entries[len(entries) - keep
                                      if keep else len(entries):]).encode()


# -- cls_rgw (src/cls/rgw role): atomic bucket-index ops ---------------
# The reference's rgw keeps every bucket's index in an omap maintained
# by cls_rgw methods, so concurrent gateways never race the index.

def _index(obj: bytes | None) -> dict:
    return json.loads(obj) if obj else {}


@register("rgw", "bucket_add")
def _rgw_bucket_add(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    idx = _index(obj)
    idx[req["key"]] = {"size": req["size"], "etag": req.get("etag", ""),
                       "mtime": time.time()}
    return 0, b"", json.dumps(idx).encode()


@register("rgw", "bucket_rm")
def _rgw_bucket_rm(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    idx = _index(obj)
    if req["key"] not in idx:
        return -2, b"", None
    del idx[req["key"]]
    return 0, b"", json.dumps(idx).encode()


@register("rgw", "mp_add_part")
def _rgw_mp_add_part(inp: bytes, obj: bytes | None):
    """Record one multipart part in the upload's meta object —
    ATOMICALLY under the PG lock, so concurrent part uploads (the
    normal S3 client pattern) cannot lose each other's entries the
    way a client-side read-modify-write would."""
    req = json.loads(inp)
    if not obj:
        return -2, b"", None          # NoSuchUpload
    meta = json.loads(obj)
    meta["parts"][str(req["part"])] = {"size": req["size"],
                                       "etag": req["etag"]}
    return 0, b"", json.dumps(meta).encode()


@register("rgw", "pair_advance")
def _rgw_pair_advance(inp: bytes, obj: bytes | None):
    """Multisite conflict pairs (rgw_data_sync resolution state):
    advance one key's (epoch, zone) pair ATOMICALLY under the PG
    lock. input {"key", "zone", "pair": optional}: no pair = local
    mutation, mint [cur_epoch+1, zone]; with pair = remote apply,
    install only if it beats the current pair lexicographically
    (-ECANCELED when it loses — the caller skips the mutation).
    Client-side read-modify-write here would let two concurrent local
    puts mint IDENTICAL pairs and permanently diverge the zones."""
    req = json.loads(inp)
    table = json.loads(obj) if obj else {}
    cur = table.get(req["key"], [0, ""])
    if req.get("pair") is None:
        new = [int(cur[0]) + 1, req["zone"]]
    else:
        new = [int(req["pair"][0]), str(req["pair"][1])]
        if (new[0], new[1]) <= (int(cur[0]), str(cur[1])):
            return -125, b"", None          # -ECANCELED: lost
    table[req["key"]] = new
    return 0, json.dumps({"pair": new}).encode(), \
        json.dumps(table).encode()


@register("rgw", "pair_get")
def _rgw_pair_get(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    table = json.loads(obj) if obj else {}
    return 0, json.dumps(
        {"pair": table.get(req["key"], [0, ""])}).encode(), None


@register("rgw", "bucket_list")
def _rgw_bucket_list(inp: bytes, obj: bytes | None):
    req = json.loads(inp) if inp else {}
    idx = _index(obj)
    prefix = req.get("prefix", "")
    marker = req.get("marker", "")
    keys = sorted(k for k in idx if k.startswith(prefix)
                  and (not marker or k > marker))
    n = req.get("max_keys", len(keys))
    out = {k: idx[k] for k in keys[:n]}
    return 0, json.dumps(out).encode(), None


# -- cls_fs (cephfs-lite metadata ops; the dirop atomicity the
# reference gets from the MDS journal, reduced to per-inode-object
# atomic methods) ------------------------------------------------------

@register("fs", "alloc_ino")
def _fs_alloc_ino(inp: bytes, obj: bytes | None):
    st = json.loads(obj) if obj else {"next_ino": 2}   # 1 = root
    ino = st["next_ino"]
    st["next_ino"] = ino + 1
    return 0, json.dumps({"ino": ino}).encode(), json.dumps(st).encode()


@register("fs", "dir_link")
def _fs_dir_link(inp: bytes, obj: bytes | None):
    """Add one entry to a directory inode; -EEXIST if taken."""
    req = json.loads(inp)
    inode = json.loads(obj) if obj else None
    if inode is None or inode.get("type") != "dir":
        return -20, b"", None         # -ENOTDIR
    if req["name"] in inode["entries"]:
        return -17, b"", None         # -EEXIST
    inode["entries"][req["name"]] = req["ino"]
    inode["mtime"] = time.time()
    return 0, b"", json.dumps(inode).encode()


@register("fs", "dir_unlink")
def _fs_dir_unlink(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    inode = json.loads(obj) if obj else None
    if inode is None or inode.get("type") != "dir":
        return -20, b"", None
    if req["name"] not in inode["entries"]:
        return -2, b"", None          # -ENOENT
    ino = inode["entries"].pop(req["name"])
    inode["mtime"] = time.time()
    return 0, json.dumps({"ino": ino}).encode(), \
        json.dumps(inode).encode()


# further reference modules (cls_version, cls_refcount, cls_numops,
# cls_timeindex, cls_statelog, cls_hello) live in classes.py — split
# so this framework file stays readable
from ceph_tpu_torch.cls import classes as _classes  # noqa: E402,F401


# -- cls_journal (src/cls/journal/cls_journal.cc role) -----------------
# The journal's CONTROL PLANE lives in-OSD: client registry, per-client
# commit positions, and the trim floor mutate atomically under the PG
# lock, exactly as the reference's Journaler drives cls_journal. Data
# chunks stay ordinary objects (services/journal.py).

def _journal_meta(obj: bytes | None) -> dict:
    if not obj:
        return {"clients": {}, "minimum": 0}
    return json.loads(obj)


@register("journal", "client_register")
def _journal_client_register(inp: bytes, obj: bytes | None):
    """input {"id"}: add a client at position 0. Registering an
    ACTIVE id again is idempotent-ok (a restarted consumer); a
    RETIRED id stays retired (-EEXIST) — resurrecting it would
    re-pin the trim floor the unregister released."""
    req = json.loads(inp)
    meta = _journal_meta(obj)
    ent = meta["clients"].get(req["id"])
    if ent is not None:
        if ent.get("retired"):
            return -17, b"", None          # -EEXIST
        return 0, b"", None                # already active: no-op
    meta["clients"][req["id"]] = {"pos": 0}
    return 0, b"", json.dumps(meta).encode()


@register("journal", "client_commit")
def _journal_client_commit(inp: bytes, obj: bytes | None):
    """input {"id", "pos"}: advance (monotonically) the client's
    commit position; -ENOENT for unknown/retired clients."""
    req = json.loads(inp)
    meta = _journal_meta(obj)
    ent = meta["clients"].get(req["id"])
    if ent is None or ent.get("retired"):
        return -2, b"", None
    pos = int(req["pos"])
    if pos <= ent["pos"]:
        return 0, b"", None                # stale: no regression
    ent["pos"] = pos
    return 0, b"", json.dumps(meta).encode()


@register("journal", "client_unregister")
def _journal_client_unregister(inp: bytes, obj: bytes | None):
    """input {"id"}: retire a client for good — its position stops
    pinning trim, and the id can never resurrect (tombstone)."""
    req = json.loads(inp)
    meta = _journal_meta(obj)
    ent = meta["clients"].get(req["id"])
    if ent is None:
        return -2, b"", None
    meta["clients"][req["id"]] = {"retired": True}
    return 0, b"", json.dumps(meta).encode()


@register("journal", "client_list")
def _journal_client_list(inp: bytes, obj: bytes | None):
    meta = _journal_meta(obj)
    return 0, json.dumps({
        "clients": {cid: ent["pos"]
                    for cid, ent in meta["clients"].items()
                    if not ent.get("retired")},
        "minimum": meta.get("minimum", 0)}).encode(), None


@register("journal", "set_minimum")
def _journal_set_minimum(inp: bytes, obj: bytes | None):
    """input {"pos"}: advance the trim floor (monotonic)."""
    req = json.loads(inp)
    meta = _journal_meta(obj)
    pos = int(req["pos"])
    if pos <= meta.get("minimum", 0):
        return 0, b"", None
    meta["minimum"] = pos
    return 0, b"", json.dumps(meta).encode()
