"""EC non-regression corpus — port of ``ceph_tpu/tools/ec_non_regression.py``.

Reference: src/test/erasure-code/ceph_erasure_code_non_regression.cc
(+ the ceph-erasure-code-corpus repo). Encoded chunks live on disk for
years: an encoder whose output drifts across versions or backends makes
every stored object unreadable. ``--create`` writes deterministic
content and its encoded chunks under ``DIR/<plugin>/<profile-slug>/``;
``--check`` re-encodes the stored content and requires byte-identical
chunks, then decodes every 1- and 2-erasure combination back to the
content. The corpus format (content, slugs, ``meta.json``) is the
reference's, so a corpus created by either package checks under the
other.

    python -m ceph_tpu_torch.tools.ec_non_regression --base DIR --create \
        [--plugin P --profile k=2,m=1,...] [--backend numpy] [--device cpu]
    python -m ceph_tpu_torch.tools.ec_non_regression --base DIR --check \
        [--backend cuda] [--device cuda]

``--backend`` forces the codecs' backend (``numpy``, ``torch``, ``cuda``
or ``auto``; ops/backend.py); ``--device`` is the torch device the codecs
run on (default ``cuda``).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

import numpy as np

from ceph_tpu_torch.models import registry as ec_registry

#: object size of the corpus vectors (reference uses option -s; fixed
#: here so corpora are comparable)
CONTENT_SIZE = 31116  # deliberately not chunk-aligned (exercises padding)

DEFAULT_PROFILES = [
    ("jerasure", {"k": "2", "m": "1"}),
    ("jerasure", {"k": "4", "m": "2"}),
    ("jerasure", {"k": "8", "m": "3"}),
    ("isa", {"k": "8", "m": "3"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("clay", {"k": "4", "m": "2"}),
]


def _slug(profile: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(profile.items())
                    if k != "backend")


def _content(size: int = CONTENT_SIZE) -> bytes:
    # deterministic, seed-free content (must never change)
    return bytes((i * 2654435761 >> 7) & 0xFF for i in range(size))


def _codec(plugin: str, profile: dict, backend: str | None, device):
    prof = dict(profile)
    if backend:
        prof["backend"] = backend
    return ec_registry.instance().factory(plugin, prof, device=device)


def create_one(base: str, plugin: str, profile: dict,
               backend: str | None = None, device="cuda") -> str:
    codec = _codec(plugin, profile, backend, device)
    n = codec.get_chunk_count()
    content = _content()
    encoded = codec.encode(list(range(n)), content)
    d = os.path.join(base, plugin, _slug(profile))
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "content"), "wb") as f:
        f.write(content)
    for i, chunk in encoded.items():
        with open(os.path.join(d, f"chunk.{i}"), "wb") as f:
            f.write(np.asarray(chunk, dtype=np.uint8).tobytes())
    mapping = codec.get_chunk_mapping()
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump({"plugin": plugin, "profile": profile,
                   "chunk_count": n,
                   "data_chunks": codec.get_data_chunk_count(),
                   "chunk_mapping": mapping}, f)
    return d


def check_one(base_dir: str, backend: str | None = None,
              max_erasures: int = 2, device="cuda") -> list[str]:
    """Returns a list of failure strings (empty = pass)."""
    with open(os.path.join(base_dir, "meta.json")) as f:
        meta = json.load(f)
    codec = _codec(meta["plugin"], meta["profile"], backend, device)
    n = meta["chunk_count"]
    k = meta["data_chunks"]
    with open(os.path.join(base_dir, "content"), "rb") as f:
        content = f.read()
    golden = {}
    for i in range(n):
        with open(os.path.join(base_dir, f"chunk.{i}"), "rb") as f:
            golden[i] = np.frombuffer(f.read(), dtype=np.uint8)
    failures: list[str] = []

    # 1. re-encode must be byte-identical
    encoded = codec.encode(list(range(n)), content)
    for i in range(n):
        if not np.array_equal(np.asarray(encoded[i], dtype=np.uint8),
                              golden[i]):
            failures.append(f"{base_dir}: chunk {i} re-encode differs")

    # 2. every recoverable erasure combination decodes back to the
    # content. Logical data chunk i lives at raw chunk mapping[i]
    # (LRC-style layered codes remap; ErasureCodeInterface
    # get_chunk_mapping), and erasures are capped at the code's
    # tolerance m.
    mapping = meta.get("chunk_mapping") or list(range(n))
    data_pos = [mapping[i] if mapping else i for i in range(k)]
    chunk_size = len(golden[0])
    max_r = min(max_erasures, n - k)
    for r in range(1, max_r + 1):
        for lost in itertools.combinations(range(n), r):
            avail = {i: golden[i] for i in range(n) if i not in lost}
            try:
                plan = codec.minimum_to_decode(data_pos, sorted(avail))
                use = {i: avail[i] for i in plan if i in avail}
                decoded = codec.decode(data_pos, use, chunk_size)
            except Exception as exc:
                failures.append(
                    f"{base_dir}: decode with lost={lost} raised {exc!r}")
                continue
            out = np.concatenate(
                [np.asarray(decoded[p], dtype=np.uint8)
                 for p in data_pos]).tobytes()[:len(content)]
            if out != content:
                failures.append(
                    f"{base_dir}: decode with lost={lost} wrong bytes")
    return failures


def _iter_corpus(base: str):
    for plugin in sorted(os.listdir(base)):
        pdir = os.path.join(base, plugin)
        if not os.path.isdir(pdir):
            continue
        for slug in sorted(os.listdir(pdir)):
            d = os.path.join(pdir, slug)
            if os.path.isfile(os.path.join(d, "meta.json")):
                yield d


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="ec_non_regression")
    ap.add_argument("--base", required=True)
    ap.add_argument("--create", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--plugin")
    ap.add_argument("--profile", help="k=2,m=1,...")
    ap.add_argument("--backend", default=None,
                    choices=("numpy", "torch", "cuda", "auto"),
                    help="force kernel backend")
    ap.add_argument("--device", default="cuda",
                    help="torch device the codecs run on (default cuda)")
    args = ap.parse_args(argv)

    if args.create:
        if args.plugin:
            profile = dict(kv.split("=", 1)
                           for kv in (args.profile or "").split(",") if kv)
            d = create_one(args.base, args.plugin, profile, args.backend,
                           args.device)
            print(f"created {d}")
        else:
            for plugin, profile in DEFAULT_PROFILES:
                try:
                    d = create_one(args.base, plugin, profile,
                                   args.backend, args.device)
                    print(f"created {d}")
                except Exception as exc:
                    print(f"SKIP {plugin}/{_slug(profile)}: {exc!r}",
                          file=sys.stderr)
    if args.check:
        all_failures: list[str] = []
        checked = 0
        for d in _iter_corpus(args.base):
            all_failures += check_one(d, args.backend, device=args.device)
            checked += 1
        if all_failures:
            print("\n".join(all_failures), file=sys.stderr)
            print(f"FAIL: {len(all_failures)} failures in "
                  f"{checked} corpora")
            return 1
        print(f"OK: {checked} corpora byte-identical and decodable")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
