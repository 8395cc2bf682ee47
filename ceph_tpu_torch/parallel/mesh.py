"""Device-mesh helpers for the sharded EC pipeline — port of ``ceph_tpu/parallel/mesh.py``.

Mesh axes (the storage analog of DP/TP/SP):

- ``stripe``: data-parallel over stripe batches (the reference's per-stripe
  loop, ECUtil.cc:136-148, becomes this leading dimension);
- ``shard``: parallel over the chunk byte dimension *and* the home axis for
  chunk placement collectives (one EC shard per OSD,
  doc/dev/osd_internals/erasure_coding/ecbackend.rst).

The reference's ``jax.sharding.Mesh`` is single-controller: one process, the
OSD's, drives every device of it. The port keeps that shape. A mesh is a 2-D
grid of :class:`Slot`\\ s in one process; a slot is a ``torch.device`` plus,
on CUDA, a stream of its own, made on first use. Several slots may share one
device (the reference's tier-1 mesh is 8 forced host devices on one CPU; on
one card, 8 slots on ``cuda:0`` each launch on their own stream). The
collectives between slots are explicit tensor moves
(``parallel/mesh_compile.py``), not a ``torch.distributed`` process group.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ceph_tpu_torch.analysis.lock_witness import make_lock

AXIS_NAMES = ("stripe", "shard")

_stream_lock = make_lock("mesh.stream")


class Slot:
    """One position of a mesh: the device its blocks live on and, for a
    CUDA device, the stream its work is queued on (made on first use and
    kept for the slot's life)."""

    __slots__ = ("device", "index", "_stream")

    def __init__(self, device, index: int) -> None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.index = index
        self._stream = None

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"

    def stream(self):
        """The slot's CUDA stream (None for a CPU slot)."""
        if not self.is_cuda:
            return None
        if self._stream is None:
            with _stream_lock:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def context(self):
        """Where the slot's work is queued: inside its stream on CUDA (the
        kernels' wrappers launch on the current stream), in place on the
        CPU."""
        if not self.is_cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream())

    def record(self):
        """An event at the tail of the slot's stream (None on the CPU,
        where every operation has finished when it returns)."""
        if not self.is_cuda:
            return None
        event = torch.cuda.Event()
        event.record(self.stream())
        return event

    def wait(self, event) -> None:
        """Queue a wait for ``event`` on the slot's stream."""
        if event is not None and self.is_cuda:
            self.stream().wait_event(event)

    def __repr__(self) -> str:
        return f"Slot({self.index}, {self.device})"


class Mesh:
    """A 2-D ('stripe', 'shard') grid of slots. ``devices`` is the grid as
    a numpy object array (the reference's ``Mesh.devices``), ``shape``
    maps each axis name to its size."""

    def __init__(self, devices: np.ndarray,
                 axis_names: tuple[str, str] = AXIS_NAMES) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D slot grid for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self):
        """Every (stripe, shard) coordinate with its slot, row-major."""
        for coord in np.ndindex(*self.devices.shape):
            yield coord, self.devices[coord]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.ravel())})"


def make_mesh(n_devices: int | None = None, stripe: int | None = None,
              shard: int | None = None, devices=None,
              chunk_count: int | None = None) -> Mesh:
    """Build a 2D ('stripe', 'shard') mesh over the first n devices.

    ``devices`` lists one device (or ``Slot``) a slot; a device may repeat
    (several slots on one device). Without it the mesh takes every CUDA
    device and raises when there is no card.

    Default factorization, as the reference's: the shard axis as large as
    possible up to the codec profile's chunk count when one is known
    (``chunk_count`` = k+m), else up to 4, the remainder to stripe."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass devices= "
                               "to build a mesh of CPU slots)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    if not 0 < n_devices <= len(devices):
        raise ValueError(f"make_mesh: {n_devices} slots of "
                         f"{len(devices)} devices")
    devices = devices[:n_devices]
    if stripe is None or shard is None:
        cap = chunk_count if chunk_count else 4
        shard = shard or _largest_factor_leq(n_devices, cap)
        stripe = stripe or n_devices // shard
    if stripe * shard != n_devices:
        raise ValueError(f"make_mesh: stripe {stripe} x shard {shard} != "
                         f"{n_devices} slots")
    slots = [d if isinstance(d, Slot) else Slot(d, i)
             for i, d in enumerate(devices)]
    grid = np.empty(len(slots), dtype=object)
    grid[:] = slots
    return Mesh(grid.reshape(stripe, shard))


def _largest_factor_leq(n: int, cap: int) -> int:
    for f in range(min(cap, n), 0, -1):
        if n % f == 0:
            return f
    return 1


#: process-wide default mesh: when set, the OSD's device engine routes
#: stripe-batch flushes through the sharded steps
#: (parallel/sharded_codec.py) instead of the single-device route, and
#: the deep scrub its verify batches (the multi-device deployment switch;
#: tests and the chip smoke set it)
_default_mesh: Mesh | None = None


def set_default_mesh(mesh: Mesh | None) -> None:
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh() -> Mesh | None:
    return _default_mesh
