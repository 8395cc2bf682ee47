"""Stripe math + batched encode/decode — port of ``ceph_tpu/osd/ec_util.py``.

Reference: src/osd/ECUtil.{h,cc}. ``stripe_info_t`` (ECUtil.h:27-80) maps
logical object offsets to stripes and chunk offsets; ``ECUtil::encode``
loops ``ec_impl->encode`` once per stripe_width window (ECUtil.cc:120-159).
For matrix codecs the position-wise math lets S stripes fold into one
[k, S*chunk_size] matvec, so a whole append batch is one kernel launch.

``HashInfo`` is the cumulative per-shard crc xattr (ECUtil.h:101-162).

The fused flush (:func:`_flush_device_fused_async`) is the write path's
device program: upload the batch once, run kernel B1 for parity, cut every
op's per-shard segment from the same device tensors, run kernel B2 on the
segments, and download parity plus 4 bytes of crc per shard. It runs on
its own CUDA stream; ``finalize()`` waits on an event. The multi-device
mesh flush is not part of this module yet: a mesh raises.
"""

from __future__ import annotations

import os
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.models.matrix_codec import MatrixErasureCode
from ceph_tpu_torch.ops import backend as backend_mod
from ceph_tpu_torch.ops import crc32c_torch, gf256
from ceph_tpu_torch.utils import checksum

#: initial per-shard crc seed (the reference seeds with -1, ECUtil.h:117)
HINFO_SEED = 0xFFFFFFFF


@dataclass(frozen=True)
class StripeInfo:
    """stripe_width/chunk offset algebra (stripe_info_t, ECUtil.h:27-80)."""

    stripe_width: int   # k * chunk_size bytes of logical data per stripe
    chunk_size: int     # bytes per chunk per stripe

    def __post_init__(self):
        if self.stripe_width % self.chunk_size:
            raise ValueError(
                f"stripe_width {self.stripe_width} not a multiple of "
                f"chunk_size {self.chunk_size}")

    @property
    def k(self) -> int:
        return self.stripe_width // self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.stripe_width

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.chunk_size

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        if offset % self.stripe_width:
            raise ValueError(f"offset {offset} not stripe-aligned")
        return (offset // self.stripe_width) * self.chunk_size

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        if offset % self.chunk_size:
            raise ValueError(f"offset {offset} not chunk-aligned")
        return (offset // self.chunk_size) * self.stripe_width

    def offset_len_to_stripe_bounds(self, offset: int,
                                    length: int) -> tuple[int, int]:
        """Expand [offset, offset+length) to stripe-aligned bounds
        (ECUtil.h:72-79)."""
        start = self.logical_to_prev_stripe_offset(offset)
        end = self.logical_to_next_stripe_offset(offset + length)
        return start, end - start


def _is_plain_matrix(codec) -> bool:
    return isinstance(codec, MatrixErasureCode) and not codec.chunk_mapping


def _data_shards(batch: np.ndarray, sinfo: StripeInfo, k: int) -> np.ndarray:
    """[S*k*cs] logical bytes -> per-shard contiguous [k, S*cs]."""
    cs = sinfo.chunk_size
    s = len(batch) // sinfo.stripe_width
    return np.ascontiguousarray(
        batch.reshape(s, k, cs).transpose(1, 0, 2).reshape(k, s * cs))


def encode(sinfo: StripeInfo, codec, data: bytes | np.ndarray,
           want: list[int] | None = None) -> dict[int, np.ndarray]:
    """Encode a stripe-aligned logical extent into per-shard buffers
    (shard id -> concatenated chunk bytes across all S stripes). Matrix
    codecs encode all S stripes in ONE matvec; others loop per stripe
    (ECUtil.cc:136-148 semantics)."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8) \
        if not isinstance(data, np.ndarray) \
        else data.astype(np.uint8, copy=False).ravel()
    sw, cs = sinfo.stripe_width, sinfo.chunk_size
    if len(buf) % sw:
        raise ErasureCodeError(
            f"encode: length {len(buf)} not a multiple of stripe_width {sw}")
    s = len(buf) // sw
    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    if sw != k * cs:
        raise ErasureCodeError(f"stripe_width {sw} != k={k} * chunk {cs}")
    want = list(range(n)) if want is None else list(want)
    data_shards = _data_shards(buf, sinfo, k)
    out: dict[int, np.ndarray] = {}
    if _is_plain_matrix(codec):
        parity = codec._matvec(codec.coding_matrix, data_shards)
        for i in want:
            out[i] = data_shards[i] if i < k else parity[i - k]
        return out
    stripes = buf.reshape(s, k, cs)
    per_stripe = [codec.encode_chunks(
        want, {j: stripes[si, j] for j in range(k)}) for si in range(s)]
    for i in want:
        out[i] = data_shards[i] if i < k else \
            np.concatenate([per_stripe[si][i] for si in range(s)])
    return out


def decode(sinfo: StripeInfo, codec, shards: dict[int, np.ndarray],
           want: list[int]) -> dict[int, np.ndarray]:
    """Reconstruct wanted shards from surviving per-shard buffers
    (ECUtil.cc:47-118). Shard buffers hold S concatenated chunks."""
    some = next(iter(shards.values()))
    cs = sinfo.chunk_size
    if len(some) % cs:
        raise ErasureCodeError(
            f"decode: shard length {len(some)} not a multiple of {cs}")
    s = len(some) // cs
    missing = [i for i in want if i not in shards]
    if not missing:
        return {i: np.asarray(shards[i], dtype=np.uint8) for i in want}
    if _is_plain_matrix(codec):
        # one matvec across all stripes
        return codec.decode_chunks(
            want, {i: np.asarray(v, dtype=np.uint8)
                   for i, v in shards.items()})
    out = {i: np.zeros(s * cs, dtype=np.uint8) for i in want}
    for si in range(s):
        got = codec.decode_chunks(
            want, {i: np.asarray(v[si * cs:(si + 1) * cs], dtype=np.uint8)
                   for i, v in shards.items()})
        for i in want:
            out[i][si * cs:(si + 1) * cs] = got[i]
    return out


class HashInfo:
    """Cumulative per-shard crc32c (ECUtil.h:101-162)."""

    def __init__(self, num_chunks: int) -> None:
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [HINFO_SEED] * num_chunks

    def _check_contiguous(self, old_size: int) -> None:
        if old_size != self.total_chunk_size:
            raise ValueError(
                f"hinfo append at {old_size} != current size "
                f"{self.total_chunk_size} (appends must be contiguous)")

    def append(self, old_size: int, shard_chunks: dict[int, np.ndarray]):
        """Fold an append at chunk-offset ``old_size`` into the crcs by
        hashing the bytes on the host (ECUtil.cc:161-177)."""
        self._check_contiguous(old_size)
        sizes = {len(v) for v in shard_chunks.values()}
        if len(sizes) != 1:
            raise ValueError("hinfo append: unequal shard chunk sizes")
        for shard, data in shard_chunks.items():
            self.cumulative_shard_hashes[shard] = checksum.crc32c(
                data, self.cumulative_shard_hashes[shard])
        self.total_chunk_size += sizes.pop()

    def append_linear(self, old_size: int, linear: dict[int, int],
                      chunk_len: int) -> None:
        """Fold an append whose per-shard LINEAR crc parts were computed
        on the device: the running crc is L(chunk) ^ crc32c(0^len, prev),
        the affine identity, with no byte re-hash."""
        self._check_contiguous(old_size)
        for shard, lv in linear.items():
            self.cumulative_shard_hashes[shard] = \
                crc32c_torch.crc32c_from_linear(
                    lv, chunk_len, self.cumulative_shard_hashes[shard])
        self.total_chunk_size += chunk_len

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]

    def to_dict(self) -> dict:
        return {"total_chunk_size": self.total_chunk_size,
                "hashes": list(self.cumulative_shard_hashes)}

    @classmethod
    def from_dict(cls, d: dict) -> "HashInfo":
        hi = cls(len(d["hashes"]))
        hi.total_chunk_size = d["total_chunk_size"]
        hi.cumulative_shard_hashes = list(d["hashes"])
        return hi


class StripeBatcher:
    """Stripe batch accumulator: coalesce many sub-writes into one
    kernel launch. ``flush()`` encodes everything queued in a single
    batched call and returns per-op shard buffers in submission order."""

    def __init__(self, sinfo: StripeInfo, codec,
                 flush_bytes: int = 8 << 20, mesh=None) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "the multi-device mesh flush is not ported yet")
        self.sinfo = sinfo
        self.codec = codec
        self.flush_bytes = flush_bytes
        self._pending: list[tuple[object, np.ndarray]] = []
        self._pending_bytes = 0

    def append(self, op_id, data: bytes | np.ndarray) -> None:
        buf = np.frombuffer(bytes(data), dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        if len(buf) % self.sinfo.stripe_width:
            raise ErasureCodeError(
                f"append: {len(buf)} bytes not stripe-aligned")
        self._pending.append((op_id, buf))
        self._pending_bytes += len(buf)

    def should_flush(self) -> bool:
        return self._pending_bytes >= self.flush_bytes

    def flush(self, with_crcs: bool = False
              ) -> list[tuple[object, dict[int, np.ndarray],
                              dict[int, int] | None]]:
        """Encode all queued ops in one batch; returns
        [(op_id, shards, crcs-or-None)] in submission order. ``with_crcs``
        takes each op's per-shard LINEAR crc parts from the same device
        buffers as the encode (fused path only; None otherwise)."""
        return self.flush_async(with_crcs)()

    def flush_async(self, with_crcs: bool = False):
        """Launch the batch and return ``finalize() -> results``. On the
        fused path the launch is asynchronous on a CUDA stream and
        finalize waits for it; the plain path finalizes trivially."""
        if not self._pending:
            return lambda: []
        ops, bufs = zip(*self._pending)
        self._pending, self._pending_bytes = [], 0
        if with_crcs and _device_fusable(self.codec) and \
                _fused_fits(self.sinfo, self.codec, bufs):
            return _flush_device_fused_async(self.sinfo, self.codec,
                                             ops, bufs)
        shards = encode(self.sinfo, self.codec, np.concatenate(bufs))
        results = []
        cs, sw = self.sinfo.chunk_size, self.sinfo.stripe_width
        off = 0  # in chunk units per shard
        for op_id, buf in zip(ops, bufs):
            nchunk = len(buf) // sw * cs
            results.append((op_id, {
                i: v[off:off + nchunk] for i, v in shards.items()}, None))
            off += nchunk
        return lambda: results


#: upper bound on the fused path's crc segment working set, computed
#: from the same pow2 buckets as the reference so the same op mixes fuse
_FUSE_CRC_MAX_SEG_BYTES = 256 << 20


def _pow2_bucket(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def _fused_fits(sinfo: StripeInfo, codec, bufs) -> bool:
    cs, sw = sinfo.chunk_size, sinfo.stripe_width
    lmax = max(len(b) // sw * cs for b in bufs)
    lmax_b = _pow2_bucket(lmax, max(crc32c_torch.ROW_BYTES, 1 << 12))
    nops_b = _pow2_bucket(len(bufs), 1)
    return nops_b * codec.get_chunk_count() * lmax_b \
        <= _FUSE_CRC_MAX_SEG_BYTES


def _device_fusable(codec) -> bool:
    return _is_plain_matrix(codec) and \
        codec.resolved_backend in backend_mod.DEVICE_BACKENDS


def host_flushable(codec) -> bool:
    """Whether a small flush can take the host route: plain matrix
    codecs encode with one host matvec over the coding matrix."""
    return _is_plain_matrix(codec) and codec.coding_matrix is not None


def device_decodable(codec) -> bool:
    """Whether the batched decode can run on the device: plain matrix
    codecs reconstruct with one signature-keyed matvec."""
    return _device_fusable(codec)


def fuse_crc_policy(codec) -> bool:
    """Whether to ask for device-fused crcs: yes on a CUDA device; on
    the CPU (plain torch versions) only when forced with
    CEPH_TPU_FUSE_CRC=1, as the reference does for its plain-XLA path."""
    if not _device_fusable(codec):
        return False
    return codec.device.type == "cuda" or \
        bool(os.environ.get("CEPH_TPU_FUSE_CRC"))


def _split_results(ops, lens, k, data_shards, parity, lin):
    results = []
    off = 0
    for idx, (op_id, ln) in enumerate(zip(ops, lens)):
        shards = {i: data_shards[i, off:off + ln] for i in range(k)}
        for j in range(parity.shape[0]):
            shards[k + j] = parity[j, off:off + ln]
        crcs = None if lin is None else \
            {i: int(lin[idx, i]) for i in range(lin.shape[1])}
        results.append((op_id, shards, crcs))
        off += ln
    return results


def flush_host_async(sinfo: StripeInfo, codec, ops, bufs, batch=None):
    """Small-flush HOST route: the same ``finalize() -> [(op_id, shards,
    None)]`` contract as the fused flush, but the encode is one host
    matvec (the gf256 oracle) run at finalize time."""
    cs, sw = sinfo.chunk_size, sinfo.stripe_width
    k = codec.get_data_chunk_count()
    lens = [len(b) // sw * cs for b in bufs]
    if batch is None:
        batch = np.concatenate(bufs)

    def finalize():
        data_shards = _data_shards(batch, sinfo, k)
        parity = gf256.gf_matvec_chunks(codec.coding_matrix, data_shards)
        return _split_results(ops, lens, k, data_shards, parity, None)

    return finalize


def _segments(data_dev: torch.Tensor, parity: torch.Tensor, lens,
              lmax: int) -> torch.Tensor:
    """[nops * n_chunks, lmax] uint8: row (op, shard) holds that op's
    segment of the shard at its END, front-zero-padded — free under crc
    linearity, so every row's linear crc is its segment's."""
    k, m = data_dev.shape[0], parity.shape[0]
    segs = torch.zeros((len(lens), k + m, lmax), dtype=torch.uint8,
                       device=data_dev.device)
    off = 0
    for i, ln in enumerate(lens):
        segs[i, :k, lmax - ln:] = data_dev[:, off:off + ln]
        segs[i, k:, lmax - ln:] = parity[:, off:off + ln]
        off += ln
    return segs.reshape(len(lens) * (k + m), lmax)


def _flush_device_fused_async(sinfo: StripeInfo, codec, ops, bufs,
                              batch=None):
    """Upload the stripe batch once, encode parity (kernel B1), and take
    every op's per-shard crc linear part (kernel B2 + the stage-2
    combine) from the SAME device tensors; download parity plus 4 bytes
    per shard of crcs. Returns ``finalize() -> [(op_id, shards, crcs)]``
    with ``crcs`` the linear parts (combine with ``HashInfo.append_linear``
    or ``crc32c_from_linear``)."""
    cs, sw = sinfo.chunk_size, sinfo.stripe_width
    k = codec.get_data_chunk_count()
    n_chunks = codec.get_chunk_count()
    lens = [len(b) // sw * cs for b in bufs]
    if not _fused_fits(sinfo, codec, bufs):
        raise ValueError("fused crc working set too large; plain flush")
    if batch is None:
        batch = np.concatenate(bufs)
    data_shards = _data_shards(batch, sinfo, k)
    lmax = -(-max(lens) // crc32c_torch.ROW_BYTES) * crc32c_torch.ROW_BYTES
    device = codec.device
    on_cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if on_cuda else None
    with torch.cuda.stream(stream) if on_cuda else nullcontext():
        data_dev = torch.from_numpy(data_shards).to(device)
        parity = backend_mod.matvec(codec.coding_matrix, data_dev,
                                    codec.resolved_backend)
        lin = crc32c_torch.crc_linear_device(
            _segments(data_dev, parity, lens, lmax)).reshape(
                len(lens), n_chunks)
        if on_cuda:
            parity_h = torch.empty(parity.shape, dtype=torch.uint8,
                                   pin_memory=True)
            lin_h = torch.empty(lin.shape, dtype=torch.int64,
                                pin_memory=True)
            parity_h.copy_(parity, non_blocking=True)
            lin_h.copy_(lin, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        else:
            parity_h, lin_h, done = parity, lin, None

    def finalize():
        if done is not None:
            done.synchronize()
        return _split_results(ops, lens, k, data_shards,
                              parity_h.numpy(), lin_h.numpy())

    return finalize
