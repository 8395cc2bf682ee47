"""XOR-strip codec — port of ``ceph_tpu/ops/gf_xor_pallas.py``'s host side.

jerasure's bit-matrix techniques never multiply bytes over GF(2^8): they
expand the coding matrix to GF(2) (ops/bitmatrix.py), slice each chunk
into w=8 *strips*, and make every parity strip the XOR of the data strips
its bit-matrix row selects (reference: jerasure's bitmatrix/schedule
technique, src/erasure-code/jerasure/ErasureCodeJerasure.h:156-190).
Encode and decode are the same transform with different matrices (decode
expands the inverted matrix).

Layout: a chunk of C bytes is 8 contiguous strips of C/8 bytes, held as
``[8k, C/4096, 128]`` int32 words. C must be a multiple of 4096. For a
torch tensor the conversion is a ``view`` of the same memory (no copy), so
device-resident callers convert for free and keep data in strip layout.

The transform itself is kernel B6 on CUDA (ops/gf_xor_cuda.py) and its
plain version on the CPU (ops/gf_xor_torch.py). The reference's
``sub_block`` argument, ``DEFAULT_SUBBLOCK``, ``_sub_block`` and
``_VMEM_BUDGET`` size the TPU's VMEM grid blocks and have no counterpart:
the CUDA kernel picks its own shared-memory tile.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ceph_tpu_torch.ops import bitmatrix, cuda_build, gf_xor_cuda


def _schedule_from_bitmatrix(bmat: np.ndarray) -> tuple[tuple[int, ...], ...]:
    """Row r -> tuple of contributing strip rows. All-zero rows are invalid
    (a zero parity strip would mean a degenerate matrix row)."""
    sched = []
    for r in range(bmat.shape[0]):
        terms = tuple(int(j) for j in np.flatnonzero(bmat[r]))
        if not terms:
            raise ValueError(f"bit-matrix row {r} is all-zero")
        sched.append(terms)
    return tuple(sched)


def to_strips(data):
    """[k, C] uint8 -> [8k, C/(8*512), 128] int32 strip layout, a pure
    reinterpretation of the same bytes. numpy in, numpy out; a contiguous
    torch tensor in, a view of its memory out (no copy)."""
    k, c = data.shape
    assert c % 4096 == 0, f"chunk size {c} must be a multiple of 4096"
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.uint8 or not data.is_contiguous():
            raise ValueError("data must be a contiguous uint8 tensor")
        return data.view(torch.int32).view(8 * k, c // 4096, 128)
    w = c // 8 // 4
    return np.ascontiguousarray(data).view("<u4").astype(
        np.uint32, copy=False).reshape(8 * k, w // 128, 128).view(np.int32)


def from_strips(strips):
    """[8r, B, 128] int32 -> [r, C] uint8 (inverse of to_strips; a view of
    a contiguous torch tensor)."""
    r8 = strips.shape[0]
    if isinstance(strips, torch.Tensor):
        if not strips.is_contiguous():
            raise ValueError("strips must be contiguous")
        return strips.view(torch.uint8).view(r8 // 8, -1)
    return np.ascontiguousarray(strips).view(np.uint8).reshape(r8 // 8, -1)


class StripCodecKernel:
    """The XOR-strip transform for one GF matrix, on ``device``.

    Operates on the strip layout: input [k, C] uint8 chunks reshape to
    [8k, C/8] strips; C must be a multiple of 8*128*4 = 4096 bytes.
    """

    def __init__(self, mat: np.ndarray, device="cuda"):
        mat = np.asarray(mat, dtype=np.uint8)
        self.m_out, self.k_in = mat.shape
        self.device = torch.device(device)
        self.bmat = bitmatrix.expand_bitmatrix(mat)
        self.schedule = _schedule_from_bitmatrix(self.bmat)
        self._arrays = cuda_build.DeviceArrays(
            gf_xor_cuda.schedule_arrays(self.schedule))

    def encode_strips(self, strips: torch.Tensor) -> torch.Tensor:
        """Device hot path: strips [8k, B, 128] int32 -> [8m, B, 128] int32
        on strips' device (kernel B6 on CUDA, the plain version on CPU).
        No layout conversion happens here: callers keep data in strip
        layout, which ``to_strips`` / ``from_strips`` give as free views."""
        k8 = strips.shape[0]
        assert k8 == 8 * self.k_in, (k8, self.k_in)
        return gf_xor_cuda.xor_strips(self.schedule, self._arrays,
                                      self.k_in, strips)

    def __call__(self, data) -> np.ndarray:
        """Host-boundary path: [k, C] uint8 -> [m, C] uint8 numpy in strip
        layout (chunk c = its 8 strips concatenated): upload to the
        kernel's device, transform, download."""
        if isinstance(data, torch.Tensor):
            data = data.cpu().numpy()
        strips = torch.from_numpy(to_strips(np.asarray(data, np.uint8)))
        out = self.encode_strips(strips.to(self.device))
        return from_strips(out.cpu().numpy())


@functools.lru_cache(maxsize=512)
def _kernel_cache_key(shape_rows: int, mat_bytes: bytes,
                      device: str) -> StripCodecKernel:
    mat = np.frombuffer(mat_bytes, dtype=np.uint8).reshape(shape_rows, -1)
    return StripCodecKernel(mat, device)


def get_kernel(mat: np.ndarray, device="cuda") -> StripCodecKernel:
    mat = np.asarray(mat, dtype=np.uint8)
    return _kernel_cache_key(mat.shape[0], mat.tobytes(),
                             str(torch.device(device)))


def strip_matvec(mat: np.ndarray, data: np.ndarray,
                 device="cuda") -> np.ndarray:
    """Host-in/host-out strip-layout transform on ``device`` (the numpy
    oracle is strip_matvec_reference)."""
    return get_kernel(mat, device)(data)


def strip_matvec_reference(mat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Numpy oracle for the strip layout: same math, host-side."""
    mat = np.asarray(mat, dtype=np.uint8)
    data = np.asarray(data, dtype=np.uint8)
    m, k = mat.shape
    _, c = data.shape
    w = c // 8
    bmat = bitmatrix.expand_bitmatrix(mat)
    strips = data.reshape(8 * k, w)
    out = np.zeros((8 * m, w), dtype=np.uint8)
    for r in range(8 * m):
        for j in np.flatnonzero(bmat[r]):
            out[r] ^= strips[j]
    return out.reshape(m, c)
