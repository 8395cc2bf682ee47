"""ceph_tpu_torch — the PyTorch + CUDA port of ``ceph_tpu``.

The same erasure-coded storage framework with its device layer in PyTorch
and its hot kernels written by hand in CUDA C++ for Hopper (``sm_90a``).
``ceph_tpu`` (JAX) stays beside it as the reference; this package imports
none of it and keeps its own copies of the host modules it needs.

Layers, mirroring the reference layout:
  - ``ceph_tpu_torch.utils``    — host crc32c, config, logging, telemetry
  - ``ceph_tpu_torch.ops``      — GF(2^8) math, plain torch kernels, CUDA kernels
  - ``ceph_tpu_torch.models``   — erasure-code plugins
  - ``ceph_tpu_torch.osd``      — stripe math, the fused flush, the device
    engine, ECBackend, the PG layer and the OSD
  - ``ceph_tpu_torch.parallel`` — messenger, mon, OSD map, CRUSH
  - ``ceph_tpu_torch.store``    — memstore
  - ``ceph_tpu_torch.client``   — librados-style client and Objecter
  - ``ceph_tpu_torch.qa``       — ``MiniCluster``
  - ``ceph_tpu_torch.bench``    — ``ceph_erasure_code_benchmark``-compatible CLI

Entry points take an explicit ``device=`` and run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
