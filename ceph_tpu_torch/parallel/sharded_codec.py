"""Sharded EC compute: the multi-device encode/placement/read pipeline — port of ``ceph_tpu/parallel/sharded_codec.py``.

The reference distributes EC work as: the primary OSD encodes a stripe, fans
sub-writes out to k+m shard OSDs over the cluster messenger
(ECBackend.cc:1986-2048), and degraded reads gather k surviving shards and
decode (ECBackend.cc:2301). On a mesh (parallel/mesh.py) the same dataflow:

- encode is position-wise over chunk bytes, so the byte axis shards over
  ``shard`` and stripe batches over ``stripe`` — zero-communication compute;
- chunk *placement* to its home shard position is a ring step along
  ``shard`` (the stand-in for the messenger fan-out);
- degraded-read reconstruction decodes locally and gathers the rows along
  ``shard``;
- stripe-batch integrity stats (the hinfo crc role, ECUtil.h:101-162)
  reduce over the whole mesh.

Every step is built on the layout/compile seam (parallel/mesh_compile.py):
the specs live in its one ``SpecLayout`` table, and each step is a per-slot
body with explicit collectives. Each slot's local work runs the port's
kernels on that slot's stream: the GF product is kernel B1
(``ops/gf_cuda.matvec_device``, its plain version for a CPU slot), tiled
over row blocks of at most ``gf_cuda.MAX_M`` and column blocks of at most
``gf_cuda.MAX_K`` with the partial products XORed, so any flat matrix
runs (Clay's linearized repair matrix k=8,m=4,d=11 is 64 x 176); the verify
body is B1 + a torch compare + kernel B2 (``crc32c_torch.crc_linear_device``),
as the single-device ``scrub_engine.verify_fn``. The reference's local
product is a bit-sliced XLA ``dot_general`` (sharded_codec.py:72-104), not
a Pallas kernel; B1 computes the same bytes.

The integrity sum is the reference's ``uint32`` sum, which wraps mod 2^32:
here each slot sums in int64, the mesh sums those, and the total is reduced
mod 2^32 (an int64 tensor holding the uint32 value).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ceph_tpu_torch.ops import crc32c_torch, gf256, gf_cuda
from ceph_tpu_torch.parallel import mesh_compile
from ceph_tpu_torch.parallel.mesh import Mesh
from ceph_tpu_torch.parallel.mesh_compile import LAYOUT, Sharded
from ceph_tpu_torch.utils.device_telemetry import telemetry


def _instrumented(step, sig: str):
    """Wrap a mesh step with device telemetry: a per-call dispatch count
    plus first-call accounting keyed by ``sig``."""

    def run(*args):
        tel = telemetry()
        tel.note_mesh_dispatch()
        return tel.timed_call(sig, step, *args)

    run.__wrapped__ = step
    run.compile_path = getattr(step, "compile_path", "?")
    return run


def _mat_sig(kind: str, mesh: Mesh, mat: np.ndarray) -> str:
    shape = "x".join(str(s) for s in mat.shape)
    return (f"sharded_codec.{kind}[{shape}]"
            f"#{zlib.crc32(np.ascontiguousarray(mat).tobytes()):08x}"
            f"@mesh{dict(mesh.shape)}")


def matmul_local(mat: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """[w, p] (x) [p, N] -> [w, N] over GF(2^8) on ``x``'s device: kernel B1
    (on the current stream) for a CUDA tensor, tiled over row blocks of at
    most ``gf_cuda.MAX_M`` and column blocks of at most ``gf_cuda.MAX_K``,
    the column blocks' partial products XORed together."""
    w, p = mat.shape
    rows = []
    for r0 in range(0, w, gf_cuda.MAX_M):
        acc = None
        for c0 in range(0, p, gf_cuda.MAX_K):
            part = gf_cuda.matvec_device(
                np.ascontiguousarray(mat[r0:r0 + gf_cuda.MAX_M,
                                         c0:c0 + gf_cuda.MAX_K]),
                x[c0:c0 + gf_cuda.MAX_K])
            acc = part if acc is None else acc.bitwise_xor_(part)
        rows.append(acc)
    return rows[0] if len(rows) == 1 else torch.cat(rows)


def _stripes_product(mat: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """[S_l, p, C_l] block -> [S_l, w, C_l]: the stripes fold into the byte
    axis (position-wise math), one product, and unfold."""
    s_l, p, c_l = x.shape
    flat = x.transpose(0, 1).reshape(p, s_l * c_l).contiguous()
    out = matmul_local(mat, flat)
    return out.view(-1, s_l, c_l).transpose(0, 1).contiguous()


def _finish_step(compiled, path: str, mesh: Mesh, mat: np.ndarray,
                 sig: str):
    """Bind the replicated coding matrix (a host array: B1 takes it in its
    launch parameters) and wrap with telemetry."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)

    def step(data):
        return compiled(mat, data)

    step.compile_path = path
    return _instrumented(step, f"{sig}/{path}")


def make_encode_step(mesh: Mesh, coding_matrix: np.ndarray,
                     place: bool = True):
    """Build the distributed EC write step.

    Input  : data [S, k, C] uint8, laid out (stripe, -, shard)
             (:func:`shard_stripe_batch`).
    Output : chunks [S, k+m, C] uint8 and an integrity checksum per chunk
             position summed over the mesh (int64 holding the uint32
             value). With ``place`` (default), parity is shipped one
             shard-ring position away (the messenger fan-out analog), so
             the host-visible parity bytes are ring-rolled along C by
             slot blocks; ``place=False`` keeps parity home (the batcher
             flush path, where the messenger owns placement and the bytes
             must be exact)."""
    coding_matrix = np.ascontiguousarray(coding_matrix, dtype=np.uint8)

    def encode_shard(mesh, mat, data):   # grids of [S_l, k, C_l] blocks
        parity = mesh_compile.map_slots(
            mesh, lambda _slot, m_, d: _stripes_product(m_, d), mat, data)
        if place:
            parity = mesh_compile.ppermute(mesh, parity, 1)
        chunks = mesh_compile.map_slots(
            mesh, lambda _slot, d, p: torch.cat([d, p], dim=1), data, parity)
        csum = mesh_compile.map_slots(
            mesh, lambda _slot, c: c.sum(dim=(0, 2)), chunks)
        csum = mesh_compile.map_slots(
            mesh, lambda _slot, c: c & 0xFFFFFFFF,
            mesh_compile.psum(mesh, csum))
        return chunks, csum

    compiled, path = mesh_compile.compile_step(
        mesh, shard_fn=encode_shard,
        in_specs=(LAYOUT.coding_matrix(), LAYOUT.stage_batch()),
        out_specs=(LAYOUT.chunks_out(), LAYOUT.csum_out()))
    return _finish_step(compiled, path, mesh, coding_matrix,
                        _mat_sig("encode", mesh, coding_matrix))


def make_matrix_step(mesh: Mesh, flat_matrix: np.ndarray,
                     kind: str = "matrix", gather: bool = True):
    """Generic distributed GF matrix step: [S, rows_in, C] laid out
    (stripe, -, shard) -> (local [S, rows_out, C], gathered full rows).
    The collective shape shared by degraded reads AND the Clay linearized
    repair (models/clay.py ``_repair_matrix``). ``kind`` keys the
    telemetry signature.

    ``gather=False`` drops the second (all-gathered) output: the engine's
    ``flush_decode_mesh`` reassembles on the host from the sharded rows."""
    flat_matrix = np.ascontiguousarray(flat_matrix, dtype=np.uint8)

    def matrix_shard(mesh, mat, x):      # grids of [S_l, rows_in, C_l]
        rec = mesh_compile.map_slots(
            mesh, lambda _slot, m_, xb: _stripes_product(m_, xb), mat, x)
        if not gather:
            return rec
        return rec, mesh_compile.all_gather(mesh, rec, dim=2)

    out_specs = (LAYOUT.chunks_out(), LAYOUT.gathered_out()) \
        if gather else LAYOUT.chunks_out()
    compiled, path = mesh_compile.compile_step(
        mesh, shard_fn=matrix_shard,
        in_specs=(LAYOUT.coding_matrix(), LAYOUT.stage_batch()),
        out_specs=out_specs)
    return _finish_step(compiled, path, mesh, flat_matrix,
                        _mat_sig(kind, mesh, flat_matrix))


def make_degraded_read_step(mesh: Mesh, generator: np.ndarray,
                            present_rows: list[int],
                            want_rows: list[int],
                            gather: bool = True):
    """Build the distributed reconstruct step (degraded read).

    Surviving chunk bytes [S, p, C] laid out (stripe, -, shard) are decoded
    into the wanted chunks. The decode matrix is built on the host from the
    erasure signature exactly as the reference inverts the k x k submatrix
    (ErasureCodeIsa.cc:150-310). The second output reassembles full chunk
    bytes at every shard position (the read-reply gather of
    ECBackend.cc:1123)."""
    dmat = gf256.decode_matrix(generator, present_rows, want_rows)
    return make_matrix_step(mesh, dmat, kind="degraded_read",
                            gather=gather)


def make_verify_step(mesh: Mesh, mat: np.ndarray, k: int):
    """Mesh twin of the deep-scrub verify program
    (osd/scrub_engine.verify_fn): a [N, k+m, L] object batch spreads over
    EVERY slot (both mesh axes flattened — each slot re-encodes and crcs its
    objects locally, zero communication), and only the [N, m] mismatch
    bitmap + [N, k+m] crc linear parts (int64) come home. N must divide by
    the mesh's slot count (callers pad)."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    m = mat.shape[0]

    def verify_local(_slot, mat, batch):  # [N_l, n, L] on the slot
        nobj, n, length = batch.shape
        data = batch[:, :k, :].transpose(0, 1).reshape(
            k, nobj * length).contiguous()
        par = matmul_local(mat, data).view(m, nobj, length).transpose(0, 1)
        mism = (par != batch[:, k:, :]).any(dim=2)           # [N_l, m]
        lin = crc32c_torch.crc_linear_device(
            batch.reshape(nobj * n, length))
        return mism, lin.reshape(nobj, n)

    def verify_shard(mesh, mat_grid, batch):
        return mesh_compile.map_slots(mesh, verify_local, mat_grid, batch)

    compiled, path = mesh_compile.compile_step(
        mesh, shard_fn=verify_shard,
        in_specs=(LAYOUT.coding_matrix(), LAYOUT.object_batch()),
        out_specs=(LAYOUT.verdict_out(), LAYOUT.verdict_out()))
    return _finish_step(compiled, path, mesh, mat,
                        _mat_sig(f"scrub_verify_k{k}", mesh, mat))


def shard_stripe_batch(mesh: Mesh, data) -> Sharded:
    """Place a host [S, k, C] batch onto the mesh with the layout table's
    stage-batch spec (S must divide by the stripe axis, C by the shard
    axis)."""
    return mesh_compile.put(mesh, data, LAYOUT.stage_batch())


def shard_object_batch(mesh: Mesh, batch) -> Sharded:
    """Place a host [N, n, L] per-object shard batch onto the mesh with
    the layout table's object-batch spec (deep-scrub verify)."""
    return mesh_compile.put(mesh, batch, LAYOUT.object_batch())
