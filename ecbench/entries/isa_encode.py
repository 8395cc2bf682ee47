"""Encode through the OSD's fused flush: ``osd/ec_util.fused_step``, the
device step that ``_flush_device_fused_async`` launches for a batch of
whole-object writes (parity by kernel B1, every op's per-shard crc by
kernel B2 and the stage-2 combine).

Set-up runs one real flush of ring slot 0's objects through
``_flush_device_fused_async`` (from a pinned host batch, as the engine's
stager hands it) and takes the device step and its staged arguments from
the seam the flush exposes (``fused_fn``, ``staged``). Every ring slot is
a staged shard-major batch [k, nops * object_bytes / k] made on the card
from the seed; a timed call is ``fused_fn`` on one slot.
"""

from __future__ import annotations

import torch

from ecbench import yardstick
from ecbench.reference import gf256, rs


class Work:
    #: the end-to-end metric: object bytes a call over the window
    rate_metric = "flush_GBps"

    def __init__(self, cfg: dict, traffic: dict, device: torch.device,
                 seed: int) -> None:
        from ceph_tpu_torch.models import instance
        from ceph_tpu_torch.osd import ec_util

        k, m = int(cfg["k"]), int(cfg["m"])
        cs, obj = int(cfg["stripe_unit"]), int(cfg["object_bytes"])
        nops = int(cfg["flush_objects"])
        if obj % (k * cs):
            raise ValueError("object_bytes is not a whole number of stripes")
        self.k, self.m, self.nops = k, m, nops
        self.op_shard_bytes = obj // k
        n = nops * self.op_shard_bytes
        self.objects_per_call = nops
        self.bytes_per_call = nops * obj
        self.n_slots = max(1, int(traffic["ring_bytes"]) // self.bytes_per_call)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self.ring = [torch.empty((k, n), dtype=torch.uint8, device=device)
                     .random_(0, 256, generator=gen)
                     for _ in range(self.n_slots)]

        codec = instance().factory(cfg["plugin"], cfg["profile"],
                                   device=device)
        sinfo = ec_util.StripeInfo(k * cs, cs)
        objects = self.ring[0].view(k, n // cs, cs).permute(1, 0, 2) \
            .contiguous().view(-1)
        pinned = torch.empty(objects.shape, dtype=torch.uint8,
                             pin_memory=device.type == "cuda")
        pinned.copy_(objects)
        host = pinned.numpy()
        bufs = [host[i * obj:(i + 1) * obj] for i in range(nops)]
        fin = ec_util._flush_device_fused_async(
            sinfo, codec, list(range(nops)), bufs, batch=pinned)
        fin()
        self.fused_fn = fin.fused_fn
        mat, staged_data, self.lens, self.lmax, self.backend = fin.staged
        self.mat = mat
        if not torch.equal(staged_data, self.ring[0]):
            raise RuntimeError("the flush staged slot 0 in another layout")
        self.describe_lines = [
            f"entry osd/ec_util.fused_step through _flush_device_fused_async"
            f" (backend {self.backend}, {len(self.lens)} ops of "
            f"{self.lens[0]} B a shard, lmax {self.lmax})",
            f"ring {self.n_slots} slots of {self.bytes_per_call} B",
        ]
        self.yard = {
            "step": yardstick.fused_step(k, m, n, nops),
            "b1": yardstick.gf_matvec(k, m, n),
            "b2": yardstick.crc_rows(nops * (k + m) * self.lmax),
        }

    def describe(self) -> list[str]:
        return self.describe_lines

    def call(self, slot: int):
        return self.fused_fn(self.mat, self.ring[slot], self.lens, self.lmax,
                             self.backend)

    def release(self, keep: list[int]) -> None:
        self.ring = [t if i in keep else None
                     for i, t in enumerate(self.ring)]

    def check(self, kept: list) -> dict:
        """Parity and every op's per-shard crc of each sampled call against
        the reference's, worked out from the slot's data."""
        field = gf256.Field(self.ring[kept[0][0]].device) if kept else None
        bytes_wrong = crcs_wrong = failed = 0
        for slot, (parity, lin) in kept:
            data = self.ring[slot]
            ref_par = rs.parity(field, self.k, self.m, data)
            ref_lin = rs.segment_crcs(data, ref_par, self.op_shard_bytes)
            diff = parity != ref_par
            bytes_wrong += int(diff.sum())
            crc_diff = lin.reshape(ref_lin.shape) != ref_lin
            crcs_wrong += int(crc_diff.sum())
            per_op = diff.view(self.m, self.nops, -1).any(dim=2).any(dim=0) \
                | crc_diff.any(dim=1)
            failed += int(per_op.sum())
        return {"checks": {"parity_bytes_wrong": (bytes_wrong, 0),
                           "crcs_wrong": (crcs_wrong, 0)},
                "failed": failed}


def setup(cfg: dict, traffic: dict, device: torch.device, seed: int) -> Work:
    return Work(cfg, traffic, device, seed)
