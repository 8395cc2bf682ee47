"""Stripe math + batched encode/decode — port of ``ceph_tpu/osd/ec_util.py``.

Reference: src/osd/ECUtil.{h,cc}. ``stripe_info_t`` (ECUtil.h:27-80) maps
logical object offsets to stripes and chunk offsets; ``ECUtil::encode``
loops ``ec_impl->encode`` once per stripe_width window (ECUtil.cc:120-159).
For matrix codecs the position-wise math lets S stripes fold into one
[k, S*chunk_size] matvec, so a whole append batch is one kernel launch.

``HashInfo`` is the cumulative per-shard crc xattr (ECUtil.h:101-162).

The fused flush (:func:`_flush_device_fused_async`) is the write path's
device program: upload the batch once, transpose it to shard-major on the
device, and run the device step (:func:`fused_step`): kernel B1 for
parity, every op's per-shard segment cut from the same device tensors,
kernel B2 on the segments; ``finalize()`` then downloads the data shards,
parity and 8 bytes of crc per shard into pinned memory. It runs on the
caller's current stream (the device engine launches each flush inside
its window slot's side stream). The multi-device mesh flush is not part
of this module yet: a mesh raises.
"""

from __future__ import annotations

import os
import time
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from ceph_tpu_torch.models.interface import ErasureCodeError
from ceph_tpu_torch.models.matrix_codec import MatrixErasureCode
from ceph_tpu_torch.ops import backend as backend_mod
from ceph_tpu_torch.ops import crc32c_torch, gf256
from ceph_tpu_torch.utils import checksum
from ceph_tpu_torch.utils.device_telemetry import telemetry

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


def xor_decodable(codec, shards: dict[int, np.ndarray],
                  missing: list[int]) -> bool:
    """True when reconstructing ``missing`` from ``shards`` reduces to
    bitwise XOR: the decode matrix of this erasure signature has only 0/1
    coefficients, so ``decode_chunks`` takes its host XOR path and no
    device launch. Mirrors decode_chunks' survivor selection (sorted,
    first k). Port of the reference's ``xor_decodable``."""
    if not missing or not isinstance(codec, MatrixErasureCode):
        return False
    have = sorted(shards)
    k = codec.get_data_chunk_count()
    if len(have) < k:
        return False
    try:
        dmat = codec._decode_matrix(tuple(have[:k]), tuple(missing))
    except Exception:          # a singular signature: not XOR-decodable
        return False
    return bool(((dmat == 0) | (dmat == 1)).all())


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
                 flush_bytes: int = 8 << 20, mesh=None,
                 on_fallback=None) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "the multi-device mesh flush is not ported yet")
        self.sinfo = sinfo
        self.codec = codec
        self.flush_bytes = flush_bytes
        #: on_fallback(path, exc): the reference calls it when a fused
        #: flush failed and the batch re-ran on the plain path (the
        #: engine counts it). The port has no such fallback — a failed
        #: fused flush raises — so it is stored and never called.
        self.on_fallback = on_fallback
        self._pending: list[tuple[object, np.ndarray]] = []
        self._pending_bytes = 0
        #: zero-copy staging: when every appended buffer is an adjacent
        #: view into ONE contiguous array (the engine's concat buffer),
        #: the caller hands that array here and flush skips its own
        #: np.concatenate
        self._preconcat: np.ndarray | None = None

    def append(self, op_id, data: bytes | np.ndarray) -> None:
        buf = np.frombuffer(bytes(data), dtype=np.uint8) \
            if not isinstance(data, np.ndarray) else data
        if len(buf) % self.sinfo.stripe_width:
            raise ErasureCodeError(
                f"append: {len(buf)} bytes not stripe-aligned")
        self._pending.append((op_id, buf))
        self._pending_bytes += len(buf)

    def set_preconcat(self, batch: np.ndarray | torch.Tensor) -> None:
        """Declare that every appended buffer is a view into ``batch``
        in append order (total length must match); flush then uses
        ``batch`` directly instead of concatenating. ``batch`` is a 1-D
        uint8 numpy array, or a pinned 1-D uint8 tensor (the engine's
        stager buffers), which the fused flush uploads asynchronously."""
        self._preconcat = batch

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
        batch = self._preconcat
        if batch is not None and len(batch) != sum(len(b) for b in bufs):
            batch = None           # caller's contract broken: re-copy
        self._pending, self._pending_bytes = [], 0
        self._preconcat = None
        if with_crcs and _device_fusable(self.codec) and \
                _fused_fits(self.sinfo, self.codec, bufs):
            return _flush_device_fused_async(self.sinfo, self.codec,
                                             ops, bufs, batch=batch)
        if batch is None:
            batch = np.concatenate(bufs)
        shards = encode(self.sinfo, self.codec, _host_batch(batch))
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


def _host_batch(batch) -> np.ndarray:
    """A staged batch as host numpy (a pinned tensor's own view)."""
    return batch.numpy() if isinstance(batch, torch.Tensor) else batch


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
    batch = _host_batch(batch)

    def finalize():
        data_shards = _data_shards(batch, sinfo, k)
        parity = gf256.gf_matvec_chunks(codec.coding_matrix, data_shards)
        return _split_results(ops, lens, k, data_shards, parity, None)

    return finalize


def _segments(data_dev: torch.Tensor, parity: torch.Tensor, lens,
              lmax: int) -> torch.Tensor:
    """[nops * n_chunks, lmax] uint8: row (op, shard) holds that op's
    segment of the shard at its END, front-zero-padded — free under crc
    linearity, so every row's linear crc is its segment's. Each run of
    consecutive ops of one length is cut with one copy a tensor (two for
    a batch of equal ops, instead of two an op)."""
    k, m = data_dev.shape[0], parity.shape[0]
    nops = len(lens)
    alloc = torch.empty if all(ln == lmax for ln in lens) else torch.zeros
    segs = alloc((nops, k + m, lmax), dtype=torch.uint8,
                 device=data_dev.device)
    i = off = 0
    while i < nops:
        ln, j = lens[i], i
        while j < nops and lens[j] == ln:
            j += 1
        width = (j - i) * ln
        segs[i:j, :k, lmax - ln:] = data_dev[:, off:off + width] \
            .view(k, j - i, ln).transpose(0, 1)
        segs[i:j, k:, lmax - ln:] = parity[:, off:off + width] \
            .view(m, j - i, ln).transpose(0, 1)
        off += width
        i = j
    return segs.reshape(nops * (k + m), lmax)


def fused_step(mat: np.ndarray, data_dev: torch.Tensor, lens, lmax: int,
               backend: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused flush's device step, queued on the current stream:
    parity[m, N] = mat (x) data_dev (kernel B1 for the ``cuda`` backend)
    and [nops, k + m] int64 linear crc parts of every op's per-shard
    segment (``lens``, padded to ``lmax``) from the same device tensors
    (kernel B2 + the stage-2 combine)."""
    parity = backend_mod.matvec(mat, data_dev, backend)
    lin = crc32c_torch.crc_linear_device(
        _segments(data_dev, parity, lens, lmax))
    n_chunks = data_dev.shape[0] + parity.shape[0]
    return parity, lin.reshape(len(lens), n_chunks)


def _flush_device_fused_async(sinfo: StripeInfo, codec, ops, bufs,
                              batch=None):
    """Upload the stripe batch once on the current stream of the codec's
    device (the engine makes it a window slot's side stream), transpose it to shard-major [k, N] on the device, run
    :func:`fused_step` (parity by kernel B1, every op's per-shard crc
    linear part by kernel B2 + the stage-2 combine, from the SAME device
    tensors), and return ``finalize() -> [(op_id, shards, crcs)]`` with
    ``crcs`` the linear parts (combine with ``HashInfo.append_linear`` or
    ``crc32c_from_linear``).

    A pinned tensor ``batch`` (the engine's stager hands it so) uploads
    asynchronously, and the copy records its event on the block in
    PyTorch's caching host allocator, which so holds the block until the
    upload has read it; a numpy batch is copied before this returns.
    ``finalize`` allocates the pinned outputs (data shards,
    parity, 8 bytes a shard of crcs) on PyTorch's caching host allocator,
    queues their download behind the step and waits for it, so the
    launching thread never allocates them. ``finalize`` also carries
    ``fused_fn`` and ``staged`` (``fused_fn(*staged)`` is exactly this
    launch's device step) and ``host_split``, the seconds of each host
    part."""
    t0 = time.perf_counter()
    cs, sw = sinfo.chunk_size, sinfo.stripe_width
    k = codec.get_data_chunk_count()
    lens = [len(b) // sw * cs for b in bufs]
    if not _fused_fits(sinfo, codec, bufs):
        raise ValueError("fused crc working set too large; plain flush")
    if batch is None:
        batch = np.concatenate(bufs)
    s = len(batch) // sw
    device = codec.device
    on_cuda = device.type == "cuda"
    lmax = -(-max(lens) // crc32c_torch.ROW_BYTES) * crc32c_torch.ROW_BYTES
    mat = codec.coding_matrix
    backend = codec.resolved_backend
    # the reference's pow2-bucketed signature form (no jit behind it)
    lmax_b = _pow2_bucket(max(lens), max(crc32c_torch.ROW_BYTES, 1 << 12))
    signature = (f"fused_crc[{backend}{list(mat.shape)}]"
                 f"N{_pow2_bucket(s * cs, 1 << 14)}"
                 f"L{lmax_b}ops{_pow2_bucket(len(lens), 1)}")
    pinned = isinstance(batch, torch.Tensor)
    src = batch if pinned else torch.from_numpy(batch)
    stream = torch.cuda.current_stream(device) if on_cuda else None
    with torch.cuda.stream(stream) if on_cuda else nullcontext():
        flat = src.to(device, non_blocking=pinned)
        t1 = time.perf_counter()
        data_dev = flat.view(s, k, cs).permute(1, 0, 2).contiguous() \
            .view(k, s * cs)
        t2 = time.perf_counter()
        parity, lin = telemetry().timed_call(
            signature, fused_step, mat, data_dev, lens, lmax, backend)
    split = {"upload_s": t1 - t0, "transpose_s": t2 - t1,
             "launch_s": time.perf_counter() - t2}

    def finalize():
        t3 = time.perf_counter()
        if on_cuda:
            outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in (data_dev, parity, lin)]
            t4 = time.perf_counter()
            with torch.cuda.stream(stream):
                for host, dev_t in zip(outs, (data_dev, parity, lin)):
                    host.copy_(dev_t, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            done.synchronize()
        else:
            outs, t4 = (data_dev, parity, lin), t3
        t5 = time.perf_counter()
        results = _split_results(ops, lens, k,
                                 *(t.numpy() for t in outs))
        split.update(alloc_s=t4 - t3, wait_s=t5 - t4,
                     split_s=time.perf_counter() - t5)
        return results

    finalize.fused_fn = fused_step
    finalize.staged = (mat, data_dev, lens, lmax, backend)
    finalize.host_split = split
    return finalize
