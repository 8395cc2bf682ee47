"""Kernel backend dispatch for the port's matrix codecs.

Same contract as ``ceph_tpu/ops/backend.py``:

    encode:  parity[m, N] = mat[m, k] (x) data[k, N]   over GF(2^8)
    decode:  wanted[w, N] = dmat[w, p] (x) present[p, N]

with ``data`` a uint8 torch tensor and the result on its device. Backends:

- ``cuda``:  kernel B1 (ops/gf_cuda.py) — on a CUDA tensor it launches the
  kernel or raises; a failed build or launch is never retried elsewhere;
- ``torch``: the plain bit-sliced version (ops/gf_torch.py);
- ``numpy``: the gf256 host oracle.

``auto`` is ``cuda`` when the codec's device is CUDA, else ``torch``.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ops import gf256, gf_cuda, gf_torch


def _numpy(mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    out = gf256.gf_matvec_chunks(mat, data.cpu().numpy())
    return torch.from_numpy(out).to(data.device)


BACKENDS = {
    "cuda": gf_cuda.matvec_device,
    "torch": gf_torch.matvec,
    "numpy": _numpy,
}

#: backends whose matvec runs on the codec's device
DEVICE_BACKENDS = frozenset({"cuda", "torch"})


def resolve_name(name: str, device) -> str:
    """The concrete backend ``name`` stands for on ``device``."""
    if name == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if name not in BACKENDS:
        raise KeyError(f"backend {name!r} not available "
                       f"(have {sorted(BACKENDS)} and 'auto')")
    return name


def matvec(mat: np.ndarray, data: torch.Tensor,
           backend: str = "auto") -> torch.Tensor:
    return BACKENDS[resolve_name(backend, data.device)](mat, data)
