"""The ``native`` backend: the host GF(2^8) matvec of the port's native
library (``native/gf256.cc`` through ``ops/native_loader.py``).

Port of ``ceph_tpu/ops/native.py``. It registers ``native`` in
``ops/backend.BACKENDS`` with the backend contract (a uint8 torch tensor in,
the result on its device); the host paths that hold numpy call
``native_loader.matvec``. The library is built on first use, and a failed
build raises (``native_loader.NativeBuildError``): there is no numpy
fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.ops import backend as backend_mod
from ceph_tpu_torch.ops import native_loader


def matvec(mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    out = native_loader.matvec(mat, backend_mod.to_host(data))
    return torch.from_numpy(out).to(data.device)


backend_mod.BACKENDS["native"] = matvec
