"""Plain torch version of kernel B1 — the bit-sliced GF(2^8) matvec.

Twin of ``ceph_tpu/ops/gf_jax.py::_bitsliced_matvec_device``: unpack the
[k, N] bytes to 8k bit planes, multiply by the [8m, 8k] bit matrix
(ops/bitmatrix.py), take ``& 1``, and pack back to [m, N] bytes.

The product runs in float32: CUDA has no integer ``torch.matmul`` and the
CPU's is slow. It stays exact because every entry is 0 or 1 and each sum
is at most 8k <= 2048 < 2^24 (float32 holds every integer below 2^24;
TF32, were it enabled, also keeps 0/1 inputs exact and accumulates in
float32).

This is the reference the CUDA kernel (ops/gf_cuda.py) is held to, and
what the kernel's wrapper runs for a tensor on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ops import bitmatrix

#: float32 bit-plane elements per matmul step (512 MiB): bounds the 32x
#: expansion of the input
_STEP_ELEMS = 1 << 27


def bit_matrix(mat: np.ndarray, device) -> torch.Tensor:
    """[m, k] GF(2^8) matrix -> [8m, 8k] float32 0/1 tensor on ``device``."""
    bmat = bitmatrix.expand_bitmatrix(np.asarray(mat, dtype=np.uint8))
    return torch.from_numpy(bmat.astype(np.float32)).to(device)


def matvec(mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """parity[m, N] = mat[m, k] (x) data[k, N] over GF(2^8), on data's device."""
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be [k, N] uint8, got "
                         f"{tuple(data.shape)} {data.dtype}")
    mat = np.asarray(mat, dtype=np.uint8)
    m, k = mat.shape
    if data.shape[0] != k:
        raise ValueError(f"matrix {mat.shape} vs data {tuple(data.shape)}")
    n = data.shape[1]
    bmat = bit_matrix(mat, data.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    weights = (1 << torch.arange(8, device=data.device)).to(torch.float32)
    out = torch.empty((m, n), dtype=torch.uint8, device=data.device)
    step = max(1, _STEP_ELEMS // (8 * k))
    for c0 in range(0, n, step):
        d = data[:, c0:c0 + step]
        # plane 8j+c = bit c of chunk j
        bits = ((d[:, None, :] >> shifts[None, :, None]) & 1)
        bits = bits.reshape(8 * k, -1).to(torch.float32)
        acc = bmat @ bits                                   # [8m, cols]
        pbits = torch.remainder(acc, 2).reshape(m, 8, -1)
        out[:, c0:c0 + step] = \
            (pbits * weights[None, :, None]).sum(dim=1).to(torch.uint8)
    return out
