"""Kernel backend dispatch for the port's matrix codecs.

Same contract as ``ceph_tpu/ops/backend.py``:

    encode:  parity[m, N] = mat[m, k] (x) data[k, N]   over GF(2^8)
    decode:  wanted[w, N] = dmat[w, p] (x) present[p, N]

with ``data`` a uint8 torch tensor and the result on its device. Backends:

- ``cuda``:  kernel B1 (ops/gf_cuda.py) — on a CUDA tensor it launches the
  kernel or raises; a failed build or launch is never retried elsewhere.
  A matrix larger than ``gf_cuda.MAX_M x MAX_K`` (Clay's linearized
  transforms) is routed BY SHAPE, before any launch, to the plain
  bit-sliced product ``gf_torch.matvec`` on the same device, counted in
  ``gf_torch.dense_calls`` — the reference's pallas backend routes such
  matrices to its plain XLA product the same way (gf_pallas.py:237-243);
- ``torch``: the plain bit-sliced version (ops/gf_torch.py);
- ``native``: the host C++ library (ops/native.py, registered on import of
  this module), the host twin's backend;
- ``numpy``: the gf256 host oracle.

``auto`` is the backend the ``erasure_code_backend`` option names, as in
the reference; when that option is ``auto`` too, ``cuda`` for a codec on
a CUDA device, else ``torch``.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ops import gf256, gf_cuda, gf_torch
from ceph_tpu_torch.utils.config import g_conf


def device_get(t: torch.Tensor) -> np.ndarray:
    """Copy ``t`` to host numpy, waiting for the work that makes it: the
    port's counterpart of ``jax.device_get``, and the one seam of a copy
    from the card to the host on the daemon paths (the lock witness
    wraps it as a ``device_barrier``)."""
    return t.cpu().numpy()


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as host numpy: a CPU tensor's own memory, a card tensor
    through :func:`device_get`."""
    return t.numpy() if t.device.type == "cpu" else device_get(t)


def _numpy(mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    out = gf256.gf_matvec_chunks(mat, to_host(data))
    return torch.from_numpy(out).to(data.device)


def _cuda(mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    m, k = np.shape(mat)
    if m > gf_cuda.MAX_M or k > gf_cuda.MAX_K:
        gf_torch.dense_calls += 1
        return gf_torch.matvec(mat, data)
    return gf_cuda.matvec_device(mat, data)


BACKENDS = {
    "cuda": _cuda,
    "torch": gf_torch.matvec,
    "numpy": _numpy,
}

#: backends whose matvec runs on the codec's device
DEVICE_BACKENDS = frozenset({"cuda", "torch"})


def resolve_name(name: str, device) -> str:
    """The concrete backend ``name`` stands for on ``device``."""
    if name == "auto":
        name = g_conf()["erasure_code_backend"]
    if name == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if name not in BACKENDS:
        raise KeyError(f"backend {name!r} not available "
                       f"(have {sorted(BACKENDS)} and 'auto')")
    return name


def matvec(mat: np.ndarray, data: torch.Tensor,
           backend: str = "auto") -> torch.Tensor:
    return BACKENDS[resolve_name(backend, data.device)](mat, data)


# registers "native" (it imports this module back: BACKENDS exists by now)
from ceph_tpu_torch.ops import native as _native  # noqa: E402,F401
