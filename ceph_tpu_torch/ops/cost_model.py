"""Analytic cost + roofline estimates for the port's device programs.

Port of ``ceph_tpu/ops/cost_model.py``, with its names and keys:
:func:`peaks`, :func:`analyze`, :func:`roofline_gbps` and
:func:`bench_fields` (``cost_flops``, ``cost_bytes``, ``roofline_GBps``).
The bench gate reports MEASURED GB/s; this module adds the number to judge
it against. The reference asks XLA for its compiled program's cost; the
port has no compiled program to ask, so its costs are analytic, counted as
PERF.md section 2 counts a kernel's bound:

- bytes: each input read once and each output written once;
- operations: a GF(2^8) multiply as an 8x8 bit-matrix product of 128 int8
  tensor operations, a crc32c of a 512-byte row as a 4096 x 32 bit-matrix
  product (2 x 4096 x 32), an XOR as one int32 operation.

A device program states its cost as a ``cost`` attribute taking the
program's own arguments (``osd/ec_util.fused_step.cost``); :func:`analyze`
calls it. Under ``CEPH_TPU_COST_ANALYSIS`` the fused flush records the cost
of each new signature in the device telemetry (``costs_by_signature``).

Peaks: on the card, its memory rate from its memory clock and bus width
(the published H100 SXM rate when it reports neither) and the published
dense int8 tensor rate; on the CPU the reference's CPU peaks. Both are
overridable via ``CEPH_TPU_PEAK_HBM_GBPS`` / ``CEPH_TPU_PEAK_TFLOPS``.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

#: published peaks of one H100 SXM (NVIDIA data sheet): device memory,
#: used only if the card does not report its memory clock and bus, and
#: the dense int8 tensor rate that bounds the bit-matrix formulation
H100_HBM_BYTES_PER_S = 3.35e12
H100_INT8_OPS_PER_S = 1979e12
#: two-input int32 operations (XOR) per second: Hopper runs 64 int32
#: lanes per SM and clock, half its float32 lanes, so a quarter of the
#: published 67e12 float32 FMA flop rate (two flops per FMA)
H100_INT32_OPS_PER_S = 67e12 / 4

#: the reference's CPU entry: (memory GB/s, peak TFLOP/s), coarse
CPU_PEAKS = (25.0, 0.5)

#: int8 tensor operations of one GF(2^8) multiply (an 8x8 bit-matrix
#: product) and of one crc32c of a 512-byte row (a 4096 x 32 product)
GF_MUL_OPS = 2 * 8 * 8
CRC_ROW_BYTES = 512
CRC_ROW_OPS = 2 * 4096 * 32


@functools.lru_cache(maxsize=None)
def hbm_rate() -> tuple[float, str]:
    """Peak device-memory bytes/s of the current card from its memory
    clock and bus width (cuDeviceGetAttribute 36 and 37; double data
    rate), and where the number came from."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        dev, clk, bus = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = lib.cuDeviceGet(ctypes.byref(dev), torch.cuda.current_device())
        rc |= lib.cuDeviceGetAttribute(ctypes.byref(clk), 36, dev)
        rc |= lib.cuDeviceGetAttribute(ctypes.byref(bus), 37, dev)
        if rc == 0 and clk.value > 0 and bus.value > 0:
            return (2.0 * clk.value * 1e3 * bus.value / 8,
                    f"card: {clk.value} kHz x {bus.value} bit x 2")
    except OSError:
        pass
    return H100_HBM_BYTES_PER_S, "published H100 SXM peak"


def peaks(device=None) -> tuple[float, float]:
    """(peak_GBps, peak_TFLOPs) of ``device`` (default: the card when
    there is one, else the CPU), env-overridable."""
    if device is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    else:
        kind = torch.device(device).type
    if kind == "cuda":
        bw, tf = hbm_rate()[0] / 1e9, H100_INT8_OPS_PER_S / 1e12
    else:
        bw, tf = CPU_PEAKS
    bw = float(os.environ.get("CEPH_TPU_PEAK_HBM_GBPS", bw))
    tf = float(os.environ.get("CEPH_TPU_PEAK_TFLOPS", tf))
    return bw, tf


# -- analytic costs: {"flops", "bytes_accessed"} ------------------------

def gf_matvec(m: int, k: int, n: int) -> dict:
    """parity[m, n] = mat[m, k] (x) data[k, n] (kernel B1)."""
    return {"flops": float(GF_MUL_OPS * m * k * n),
            "bytes_accessed": float((k + m) * n)}


def crc_rows(rows: int) -> dict:
    """One linear crc32c (int64 out) of each 512-byte row (kernel B2)."""
    return {"flops": float(CRC_ROW_OPS * rows),
            "bytes_accessed": float(rows * (CRC_ROW_BYTES + 8))}


def fused_flush(m: int, k: int, n: int, nops: int, lmax: int) -> dict:
    """The fused flush's device step: B1's parity of [k, n] data, then
    B2's crc of every op's k + m segments, each padded to ``lmax`` bytes.
    Bytes: the data in, the parity and one int64 crc a segment out."""
    rows = nops * (k + m) * lmax // CRC_ROW_BYTES
    return {"flops": gf_matvec(m, k, n)["flops"] + crc_rows(rows)["flops"],
            "bytes_accessed": float(k * n + m * n + nops * (k + m) * 8)}


def scrub_verify(m: int, k: int, nobj: int, shard_bytes: int) -> dict:
    """Deep scrub's verify program of a batch of ``nobj`` objects of
    ``k + m`` shards: B1 re-encodes the parity and B2 hashes every shard.
    Bytes: the batch in, a mismatch flag a parity and an int64 crc a
    shard out."""
    n = k + m
    return {"flops": float(GF_MUL_OPS * m * k * nobj * shard_bytes
                           + CRC_ROW_OPS * nobj * n * shard_bytes
                           // CRC_ROW_BYTES),
            "bytes_accessed": float(nobj * n * shard_bytes + nobj * m
                                    + nobj * n * 8)}


def bound(nbytes: float, int8_ops: float = 0.0, int32_ops: float = 0.0,
          hbm: float | None = None) -> tuple[float, str]:
    """(least ms, what bounds it) of work that moves ``nbytes`` and runs
    ``int8_ops`` tensor operations and ``int32_ops`` XORs on the card:
    the bytes over its memory rate (``hbm`` bytes/s, default the card's)
    against the operations over their peaks."""
    t_bytes = nbytes / (hbm if hbm is not None else hbm_rate()[0])
    t_ops = int8_ops / H100_INT8_OPS_PER_S + \
        int32_ops / H100_INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


# -- the reference's surface --------------------------------------------

def analyze(fn, *args, signature: str | None = None) -> dict | None:
    """``{"flops", "bytes_accessed"}`` of one call of ``fn`` on ``args``,
    from its ``cost`` attribute, or None when it states none. With
    ``signature`` the outcome is recorded in the device-telemetry
    per-signature cost table (``device perf dump`` / dashboard)."""
    cost_fn = getattr(fn, "cost", None)
    if cost_fn is None:
        return None
    cost = cost_fn(*args)
    if cost and signature:
        from ceph_tpu_torch.utils.device_telemetry import telemetry
        telemetry().note_cost(signature, cost)
    return cost


def roofline_gbps(flops: float | None, bytes_accessed: float | None,
                  traffic_bytes: float) -> float | None:
    """Best-case GB/s for a program serving ``traffic_bytes`` of logical
    traffic per execution: execution time is bounded below by
    max(bytes/peak_bw, flops/peak_flops)."""
    bw_gbps, tflops = peaks()
    t = 0.0
    if bytes_accessed:
        t = max(t, bytes_accessed / (bw_gbps * 1e9))
    if flops:
        t = max(t, flops / (tflops * 1e12))
    if t <= 0:
        return None
    return traffic_bytes / t / 1e9


def bench_fields(fn, args, traffic_bytes: float,
                 signature: str | None = None) -> dict:
    """The bench-line payload: ``{"cost_flops", "cost_bytes",
    "roofline_GBps"}`` for ``fn`` on ``args``, or ``{}`` when it states
    no cost."""
    cost = analyze(fn, *args, signature=signature)
    if not cost:
        return {}
    out = {}
    if "flops" in cost:
        out["cost_flops"] = round(cost["flops"])
    if "bytes_accessed" in cost:
        out["cost_bytes"] = round(cost["bytes_accessed"])
    rl = roofline_gbps(cost.get("flops"), cost.get("bytes_accessed"),
                       traffic_bytes)
    if rl is not None:
        out["roofline_GBps"] = round(rl, 2)
    return out
