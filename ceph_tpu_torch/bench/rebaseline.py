"""Device re-baseline session — port of ``ceph_tpu/bench/rebaseline.py``:
each ``BASELINE.md`` device row re-measured on the card with the plateau
method (``measure.stable_best_slope``).

Rows (the canonical configs of ``BASELINE.json``, the reference's
``ceph_erasure_code_benchmark`` runs, src/erasure-code/isa/README:36-45):

  rs_dec3     RS k=8,m=3 decode, 3 erasures            kernel B1, [3, 8]
  shec_enc    SHEC k=8,m=4,c=3 encode                  kernel B1, [4, 8]
  shec_rec    SHEC k=8,m=4,c=3 single-chunk recovery   kernel B1 on the
              (the local-layer solve)                  local inverse
  clay_rep    Clay k=8,m=4,d=11 single-node repair     kernel B1 tiled over
              (the linearized repair matrix, the       the [64, 176] matrix,
              sub-chunk helper reads)                  2 x 2 launches a step
  crc32c      crc32c over a 24 MiB resident batch      kernel B2 + stage 2

Byte accounting follows the reference benchmark's contract (elapsed
against KiB *of object data* processed, ceph_erasure_code_benchmark.cc:188,
326): encode and decode rows count k x n object bytes a step; the Clay
repair row counts the object bytes the repair serves (its helper reads move
only sub_chunk_no / q of that: the bandwidth the code saves); crc counts
hashed bytes.

A step is one product on the resident data, then row 0 of the output
copied into row 0 of the input, so every step depends on the last. Before
it is timed, each row passes the reference's host bit-exactness gate, and
its first step's output is held against the plain version (``gf_torch``,
``crc32c_torch``) on the same device. Each row dict carries the
reference's keys, and ``steps``: the steps the row ran, so launches a
step can be read off the kernels' counters.

    python -m ceph_tpu_torch.bench.rebaseline [row ...] [--device cuda|cpu]
        [--lanes N] [--budget S]

Prints one JSON line per row; a row that fails prints ``{"row": name,
"error": ...}`` and the session goes on (exit 0). ``--device cpu`` runs the
plain versions (use a small ``--lanes``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import NamedTuple

import numpy as np
import torch

from ceph_tpu_torch.bench.measure import stable_best_slope
from ceph_tpu_torch.models import instance
from ceph_tpu_torch.ops import crc32c_torch, gf256, gf_cuda, gf_torch

#: lanes per measured batch (the bytes of the batch; a matrix-input row
#: holds N_LANES // 8 of them)
N_LANES = 16 << 20
#: lanes of the first step's output held against the plain version
CHECK_LANES = 1 << 16


def _gate(ok: bool, what: str) -> None:
    """A bit-exactness gate: raise (under ``python -O`` too) if it fails."""
    if not ok:
        raise RuntimeError(f"bit-exactness gate failed: {what}")


class Case(NamedTuple):
    """One row's inputs: the matrix (None for crc32c), the host data, the
    bytes a step counts, and the row's extra (non-timing) fields."""
    tag: str
    mat: np.ndarray | None
    data: np.ndarray
    counted_bytes: int
    extra: dict


def _codec(plugin: str, profile: dict):
    return instance().factory(plugin, {"plugin": plugin, **profile,
                                       "backend": "numpy"}, device="cpu")


def _shec_codec():
    return _codec("shec", {"k": "8", "m": "4", "c": "3"})


def _clay_codec():
    return _codec("clay", {"k": "8", "m": "4", "d": "11"})


def rs_dec3_case(n_lanes: int = N_LANES) -> Case:
    k, m = 8, 3
    mat = gf256.rs_matrix_isa(k, m)
    gen = gf256.systematic_generator(mat)
    missing = [0, 1, 2]
    present = [i for i in range(k + m) if i not in missing][:k]
    dmat = gf256.decode_matrix(gen, present, missing)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(k, n_lanes // 8), dtype=np.uint8)
    small = rng.integers(0, 256, size=(k, 1 << 14), dtype=np.uint8)
    full = np.concatenate([small, gf256.gf_matvec_chunks(mat, small)])
    _gate(np.array_equal(gf256.gf_matvec_chunks(dmat, full[present]),
                         small[missing]), "rs_dec3: the decode matrix")
    full_b = np.concatenate([data, gf256.gf_matvec_chunks(mat, data)])
    return Case("rs_k8m3_decode_e3", dmat, full_b[present],
                k * data.shape[1], {})


def shec_enc_case(n_lanes: int = N_LANES) -> Case:
    mat = _shec_codec().coding_matrix                  # [4, 8]
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=(8, n_lanes // 8), dtype=np.uint8)
    return Case("shec_k8m4c3_encode", mat, data, data.nbytes, {})


def shec_rec_case(n_lanes: int = N_LANES) -> Case:
    """Single-chunk recovery: the local-layer solve (the repair set the
    plan search picks reads a c-sized neighbourhood, not k chunks)."""
    codec = _shec_codec()
    k = 8
    _dup, rows, cols, _psel, _minimum, _wd = codec._search_plan(
        frozenset({0}), frozenset(range(1, 12)))
    inv = gf256.invert_matrix(codec._submatrix(rows, cols))
    rng = np.random.default_rng(2)
    n = n_lanes // 8
    data = rng.integers(0, 256, size=(len(rows), n), dtype=np.uint8)
    # the solve == the host decode of chunk 0
    small_d = rng.integers(0, 256, size=(k, 1 << 14), dtype=np.uint8)
    enc = codec.encode_chunks(list(range(8, 12)),
                              {i: small_d[i] for i in range(k)})
    chunks = {i: small_d[i] for i in range(1, k)}
    chunks.update(enc)
    host = np.asarray(codec.decode_chunks([0], chunks)[0])
    b = np.stack([np.asarray(chunks[r], dtype=np.uint8) for r in rows])
    _gate(np.array_equal(gf256.gf_matvec_chunks(inv, b)[cols.index(0)],
                         host), "shec_rec: the local solve")
    return Case("shec_k8m4c3_recover1", inv, data, k * n,
                {"helpers": len(rows)})


def clay_rep_case(n_lanes: int = N_LANES) -> Case:
    codec = _clay_codec()
    ssc = codec.sub_chunk_no                        # q^t = 64
    rss = ssc // codec.q                            # helper rows = 16
    helpers = tuple(range(1, 12))                   # repair chunk 0, d=11
    mat = codec._repair_matrix(0, helpers)          # [64, 176]
    sc = (n_lanes // 8) // ssc
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=(len(helpers) * rss, sc),
                        dtype=np.uint8)
    # one object's repair serves k*ssc*sc logical bytes while reading
    # only len(helpers)*rss*sc helper bytes (the MSR bandwidth win)
    counted = 8 * ssc * sc
    return Case("clay_k8m4d11_repair", mat, data, counted,
                {"helper_bytes_per_object": len(helpers) * rss * sc,
                 "object_bytes": counted})


def crc32c_case(n_lanes: int = N_LANES) -> Case:
    from ceph_tpu_torch.utils import checksum

    rows, ln = 12, n_lanes // 8                     # 24 MiB at N_LANES
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, size=(rows, ln), dtype=np.uint8)
    # against the host oracle
    win = data[:2, : 1 << 16]
    lin = crc32c_torch.crc_linear_device(torch.from_numpy(win.copy()))
    got = [crc32c_torch.crc32c_from_linear(v, win.shape[1], 0)
           for v in lin.tolist()]
    _gate(got == [checksum.crc32c(bytes(r), 0) for r in win],
          "crc32c: the host crc32c")
    return Case("crc32c_device_24MiB", None, data, data.nbytes, {})


def matvec_step(mat: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """One chained step of a matrix row: B1 (tiled past its limit) on the
    resident data, then row 0 of the product into row 0 of ``x``."""
    out = gf_cuda.matvec_tiled(mat, x)
    x[0:1].copy_(out[0:1])
    return out


def crc_step(x: torch.Tensor) -> torch.Tensor:
    """One chained step of the crc32c row: the linear crc of each row (B2
    and the stage-2 combine), its low byte into ``x[0, 0]``."""
    lin = crc32c_torch.crc_linear_device(x)
    x[0, 0:1].copy_((lin[0:1] & 0xFF).to(torch.uint8))
    return lin


def plain_crc_linear(x: torch.Tensor) -> torch.Tensor:
    """``crc_linear_device``'s plain version (no B2) on ``x``'s device."""
    n, ln = x.shape
    pad = -ln % crc32c_torch.ROW_BYTES
    if pad:
        x = torch.nn.functional.pad(x, (pad, 0))
    rowc = crc32c_torch.crc_rows(x.contiguous().reshape(
        -1, crc32c_torch.ROW_BYTES))
    return crc32c_torch.combine_rows(rowc.reshape(n, -1))


def run_case(case: Case, device="cuda", budget: float = 150.0) -> dict:
    """Measure ``case`` on ``device``: the first step held against the
    plain version, then the chained slope; returns the row dict."""
    dd = torch.from_numpy(case.data).to(torch.device(device))
    if case.mat is None:
        one, window = crc_step, slice(None)
        want = plain_crc_linear(dd)
        traffic = case.data.nbytes
    else:
        mat = np.ascontiguousarray(case.mat, dtype=np.uint8)

        def one(x):
            return matvec_step(mat, x)

        window = slice(0, min(CHECK_LANES, dd.shape[1]))
        want = gf_torch.matvec(mat, dd[:, window].contiguous())
        traffic = case.data.nbytes + mat.shape[0] * case.data.shape[1]
    _gate(torch.equal(one(dd)[..., window], want),
          f"{case.tag}: the first step against the plain version")
    steps = 1                                   # the checked first step

    def step(x):
        nonlocal steps
        steps += 1
        one(x)
        return x

    slope, spread, samples, _contended = stable_best_slope(
        step, dd, min_traffic_bytes=traffic, time_budget=budget,
        stable_n=6)
    out = {"row": case.tag,
           "GBps": round(case.counted_bytes / slope / 1e9, 2),
           "spread_pct": spread, "samples": samples}
    if case.mat is not None:
        out["mat_shape"] = list(case.mat.shape)
    out.update(case.extra)
    out["steps"] = steps
    return out


CASES = {"rs_dec3": rs_dec3_case, "shec_enc": shec_enc_case,
         "shec_rec": shec_rec_case, "clay_rep": clay_rep_case,
         "crc32c": crc32c_case}


def run_row(name: str, device="cuda", n_lanes: int = N_LANES,
            budget: float = 150.0) -> dict:
    return run_case(CASES[name](n_lanes), device, budget)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rebaseline")
    ap.add_argument("rows", nargs="*",
                    help=f"rows to run (default all: {' '.join(CASES)})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--lanes", type=int, default=N_LANES,
                    help="bytes of a measured batch")
    ap.add_argument("--budget", type=float, default=150.0,
                    help="sampling seconds a row")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    for name in args.rows or list(CASES):
        try:
            print(json.dumps(run_row(name, args.device, args.lanes,
                                     args.budget)), flush=True)
        except Exception as exc:                 # keep the session going
            print(json.dumps({"row": name, "error": repr(exc)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
