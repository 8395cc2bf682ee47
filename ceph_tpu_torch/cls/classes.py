"""More in-OSD object classes mirroring reference cls modules.

Reduction note shared by all of these: the reference keeps this state
in xattrs/omap alongside arbitrary object data (src/cls/*/cls_*.cc);
here the object's body IS the JSON state, matching the framework's
method contract (see ceph_tpu_torch/cls/__init__.py). Semantics — error
codes, conditional checks, removal-on-last-ref — follow the reference
files cited per class.
"""

from __future__ import annotations

import json
import time

from ceph_tpu_torch.cls import REMOVE, register


def _state(obj: bytes | None, default):
    if not obj:
        return default
    try:
        return json.loads(obj)
    except ValueError:
        return default


# -- cls_version (src/cls/version/cls_version.cc): object version
# tracking with conditional checks --------------------------------------

@register("version", "set")
def _version_set(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    st = _state(obj, {"ver": 0, "tag": ""})
    st["ver"] = int(req["ver"])
    st["tag"] = str(req.get("tag", st["tag"]))
    return 0, b"", json.dumps(st).encode()


@register("version", "inc")
def _version_inc(inp: bytes, obj: bytes | None):
    st = _state(obj, {"ver": 0, "tag": ""})
    st["ver"] += 1
    return 0, b"", json.dumps(st).encode()


@register("version", "read")
def _version_read(inp: bytes, obj: bytes | None):
    st = _state(obj, {"ver": 0, "tag": ""})
    return 0, json.dumps(st).encode(), None


@register("version", "check")
def _version_check(inp: bytes, obj: bytes | None):
    """input: {"ver": N, "op": "eq"|"gt"|"ge"} — -ECANCELED on
    mismatch (the reference's VER_COND checks)."""
    req = json.loads(inp)
    st = _state(obj, {"ver": 0, "tag": ""})
    have, want = st["ver"], int(req["ver"])
    ok = {"eq": have == want, "gt": have > want,
          "ge": have >= want}.get(req.get("op", "eq"), False)
    return (0 if ok else -125), b"", None     # -ECANCELED


# -- cls_refcount (src/cls/refcount/cls_refcount.cc): tagged
# references; the object disappears with its last ref ------------------

@register("refcount", "get")
def _refcount_get(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    st = _state(obj, {"refs": []})
    tag = str(req["tag"])
    if tag not in st["refs"]:
        st["refs"].append(tag)
    return 0, b"", json.dumps(st).encode()


@register("refcount", "put")
def _refcount_put(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    st = _state(obj, {"refs": []})
    tag = str(req["tag"])
    if tag in st["refs"]:
        st["refs"].remove(tag)
    elif st["refs"]:
        return -2, b"", None                  # unknown tag, refs live
    if not st["refs"]:
        # last reference dropped: the object goes away
        # (cls_rc_refcount_put -> cls_cxx_remove)
        return 0, b"", REMOVE
    return 0, b"", json.dumps(st).encode()


@register("refcount", "read")
def _refcount_read(inp: bytes, obj: bytes | None):
    st = _state(obj, {"refs": []})
    return 0, json.dumps(sorted(st["refs"])).encode(), None


@register("refcount", "set")
def _refcount_set(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    return 0, b"", json.dumps(
        {"refs": sorted(set(map(str, req["refs"])))}).encode()


# -- cls_numops (src/cls/numops/cls_numops.cc): server-side numeric
# read-modify-write ----------------------------------------------------

@register("numops", "add")
def _numops_add(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    st = _state(obj, {})
    key, diff = str(req["key"]), float(req["value"])
    cur = float(st.get(key, 0))
    st[key] = cur + diff
    return 0, json.dumps({key: st[key]}).encode(), \
        json.dumps(st).encode()


@register("numops", "max")
def _numops_max(inp: bytes, obj: bytes | None):
    """Raise the counter to at least ``value`` (Lamport receive rule:
    a replicated event's origin sequence must never be re-minted
    locally). Returns the resulting value."""
    req = json.loads(inp)
    st = _state(obj, {})
    key, floor = str(req["key"]), float(req["value"])
    cur = float(st.get(key, 0))
    if floor <= cur:
        return 0, json.dumps({key: cur}).encode(), None
    st[key] = floor
    return 0, json.dumps({key: floor}).encode(), \
        json.dumps(st).encode()


@register("numops", "mul")
def _numops_mul(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    st = _state(obj, {})
    key, f = str(req["key"]), float(req["value"])
    cur = float(st.get(key, 0))
    st[key] = cur * f
    return 0, json.dumps({key: st[key]}).encode(), \
        json.dumps(st).encode()


# -- cls_timeindex (src/cls/timeindex/cls_timeindex.cc): entries
# indexed by timestamp, range-listed and trimmed ------------------------

@register("timeindex", "add")
def _timeindex_add(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    entries = _state(obj, [])
    entries.append({"ts": float(req.get("ts", time.time())),
                    "key": str(req.get("key", "")),
                    "value": req.get("value", "")})
    entries.sort(key=lambda e: (e["ts"], e["key"]))
    return 0, b"", json.dumps(entries).encode()


@register("timeindex", "list")
def _timeindex_list(inp: bytes, obj: bytes | None):
    req = json.loads(inp) if inp else {}
    entries = _state(obj, [])
    lo = float(req.get("from", 0))
    hi = float(req.get("to", float("inf")))
    out = [e for e in entries if lo <= e["ts"] < hi]
    n = int(req.get("max_entries", len(out)))
    return 0, json.dumps(out[:n]).encode(), None


@register("timeindex", "trim")
def _timeindex_trim(inp: bytes, obj: bytes | None):
    req = json.loads(inp) if inp else {}
    entries = _state(obj, [])
    hi = float(req.get("to", 0))
    keep = [e for e in entries if e["ts"] >= hi]
    if len(keep) == len(entries):
        return -61, b"", None                 # -ENODATA: nothing cut
    return 0, b"", json.dumps(keep).encode()


# -- cls_statelog (src/cls/statelog/cls_statelog.cc): per-(client,
# op) state entries ----------------------------------------------------

@register("statelog", "add")
def _statelog_add(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    st = _state(obj, {})
    key = f"{req['client']}/{req['op_id']}"
    st[key] = {"object": req.get("object", ""),
               "state": req["state"], "ts": time.time()}
    return 0, b"", json.dumps(st).encode()


@register("statelog", "list")
def _statelog_list(inp: bytes, obj: bytes | None):
    req = json.loads(inp) if inp else {}
    st = _state(obj, {})
    client = req.get("client")
    out = {k: v for k, v in st.items()
           if client is None or k.startswith(f"{client}/")}
    return 0, json.dumps(out).encode(), None


@register("statelog", "remove")
def _statelog_remove(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    st = _state(obj, {})
    key = f"{req['client']}/{req['op_id']}"
    if key not in st:
        return -2, b"", None
    del st[key]
    return 0, b"", json.dumps(st).encode()


# -- cls_hello (src/cls/hello/cls_hello.cc): the reference's example
# class — kept because its tests exercise every framework seam ---------

@register("hello", "say_hello")
def _hello_say(inp: bytes, obj: bytes | None):
    who = inp.decode() or "world"
    return 0, f"Hello, {who}!".encode(), None


@register("hello", "record_hello")
def _hello_record(inp: bytes, obj: bytes | None):
    if obj is not None:
        return -17, b"", None                 # -EEXIST, as reference
    who = inp.decode() or "world"
    return 0, b"", f"Hello, {who}!".encode()


@register("hello", "replay")
def _hello_replay(inp: bytes, obj: bytes | None):
    if obj is None:
        return -2, b"", None
    return 0, bytes(obj), None


# -- cls_rbd (src/cls/rbd/cls_rbd.cc): image header + directory
# management. The directory methods are what make concurrent clients
# safe: image create/remove/rename mutate the shared rbd_directory
# ATOMICALLY in-OSD instead of a client-side read-modify-write --------

@register("rbd", "dir_add_image")
def _rbd_dir_add(inp: bytes, obj: bytes | None):
    """input: {"name", "meta"} -> -EEXIST when present."""
    req = json.loads(inp)
    d = _state(obj, {})
    if req["name"] in d:
        return -17, b"", None
    d[req["name"]] = req.get("meta", {})
    return 0, b"", json.dumps(d, sort_keys=True).encode()


@register("rbd", "dir_remove_image")
def _rbd_dir_remove(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    d = _state(obj, {})
    if req["name"] not in d:
        return -2, b"", None
    del d[req["name"]]
    return 0, b"", json.dumps(d, sort_keys=True).encode()


@register("rbd", "dir_rename_image")
def _rbd_dir_rename(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    d = _state(obj, {})
    if req["src"] not in d:
        return -2, b"", None
    if req["dst"] in d:
        return -17, b"", None
    d[req["dst"]] = d.pop(req["src"])
    return 0, b"", json.dumps(d, sort_keys=True).encode()


@register("rbd", "dir_update_image")
def _rbd_dir_update(inp: bytes, obj: bytes | None):
    """Merge metadata keys into an existing entry (size bumps)."""
    req = json.loads(inp)
    d = _state(obj, {})
    ent = d.get(req["name"])
    if ent is None:
        return -2, b"", None
    ent.update(req.get("meta", {}))
    return 0, b"", json.dumps(d, sort_keys=True).encode()


@register("rbd", "dir_list")
def _rbd_dir_list(inp: bytes, obj: bytes | None):
    return 0, json.dumps(_state(obj, {}), sort_keys=True).encode(), \
        None


# -- cls_user (src/cls/user/cls_user.cc): per-user bucket accounting
# for rgw (the user's bucket list + usage header) ----------------------

@register("user", "add_bucket")
def _user_add_bucket(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    st = _state(obj, {"buckets": {}, "stats": {"count": 0, "bytes": 0}})
    b = st["buckets"].setdefault(
        req["bucket"], {"count": 0, "bytes": 0})
    b["count"] += int(req.get("count", 0))
    b["bytes"] += int(req.get("bytes", 0))
    st["stats"]["count"] = sum(x["count"]
                               for x in st["buckets"].values())
    st["stats"]["bytes"] = sum(x["bytes"]
                               for x in st["buckets"].values())
    return 0, b"", json.dumps(st, sort_keys=True).encode()


@register("user", "remove_bucket")
def _user_remove_bucket(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    st = _state(obj, {"buckets": {}, "stats": {"count": 0, "bytes": 0}})
    if st["buckets"].pop(req["bucket"], None) is None:
        return -2, b"", None
    st["stats"]["count"] = sum(x["count"]
                               for x in st["buckets"].values())
    st["stats"]["bytes"] = sum(x["bytes"]
                               for x in st["buckets"].values())
    return 0, b"", json.dumps(st, sort_keys=True).encode()


@register("user", "get_header")
def _user_get_header(inp: bytes, obj: bytes | None):
    st = _state(obj, {"buckets": {}, "stats": {"count": 0, "bytes": 0}})
    return 0, json.dumps(
        {"stats": st["stats"],
         "buckets": sorted(st["buckets"])}).encode(), None


# -- cls_cas (src/cls/cas/cls_cas.cc): content-addressed chunk
# refcounting — a dedup chunk object lives while references exist ------

@register("cas", "chunk_create_or_get_ref")
def _cas_get_ref(inp: bytes, obj: bytes | None):
    """input: {"source"}: take a reference on this chunk (creating
    the ref set on first use)."""
    req = json.loads(inp)
    st = _state(obj, {"refs": []})
    if req["source"] not in st["refs"]:
        st["refs"].append(req["source"])
    return 0, b"", json.dumps(st, sort_keys=True).encode()


@register("cas", "chunk_put_ref")
def _cas_put_ref(inp: bytes, obj: bytes | None):
    """Drop a reference; the LAST one removes the chunk object."""
    req = json.loads(inp)
    st = _state(obj, {"refs": []})
    if req["source"] not in st["refs"]:
        return -2, b"", None
    st["refs"].remove(req["source"])
    if not st["refs"]:
        return 0, b"", REMOVE
    return 0, b"", json.dumps(st, sort_keys=True).encode()


@register("cas", "references")
def _cas_refs(inp: bytes, obj: bytes | None):
    return 0, json.dumps(_state(obj, {"refs": []})).encode(), None


# -- cls_otp (src/cls/otp/cls_otp.cc): server-side TOTP secrets; the
# check runs IN the OSD so the secret never leaves it -------------------

def _totp(secret_hex: str, t: int, step: int = 30,
          digits: int = 6) -> str:
    import hashlib
    import hmac as _hmac
    counter = int(t // step).to_bytes(8, "big")
    mac = _hmac.new(bytes.fromhex(secret_hex), counter,
                    hashlib.sha1).digest()
    off = mac[-1] & 0xF
    code = (int.from_bytes(mac[off:off + 4], "big") & 0x7FFFFFFF) \
        % (10 ** digits)
    return f"{code:0{digits}d}"


@register("otp", "create")
def _otp_create(inp: bytes, obj: bytes | None):
    """input: {"id", "secret" (hex), "step"?, "digits"?}."""
    req = json.loads(inp)
    st = _state(obj, {})
    if req["id"] in st:
        return -17, b"", None
    st[req["id"]] = {"secret": req["secret"],
                     "step": int(req.get("step", 30)),
                     "digits": int(req.get("digits", 6))}
    return 0, b"", json.dumps(st, sort_keys=True).encode()


@register("otp", "remove")
def _otp_remove(inp: bytes, obj: bytes | None):
    req = json.loads(inp)
    st = _state(obj, {})
    if st.pop(req["id"], None) is None:
        return -2, b"", None
    return 0, b"", json.dumps(st, sort_keys=True).encode()


@register("otp", "check")
def _otp_check(inp: bytes, obj: bytes | None):
    """input: {"id", "token", "t"}: verify with a ±1-step window (the
    reference tolerates clock skew the same way)."""
    req = json.loads(inp)
    st = _state(obj, {})
    ent = st.get(req["id"])
    if ent is None:
        return -2, b"", None
    t = float(req["t"])
    # tolerate integer tokens: '12345' must match code '012345'
    token = str(req["token"]).zfill(ent["digits"])
    ok = any(_totp(ent["secret"], t + d * ent["step"], ent["step"],
                   ent["digits"]) == token
             for d in (-1, 0, 1))
    return 0, json.dumps({"ok": ok}).encode(), None
