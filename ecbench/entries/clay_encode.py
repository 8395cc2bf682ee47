"""Encode through the Clay codec's encoder: what
``ErasureCodeClay._encode_fn`` returns (``clay_device.build_encode_kernel``,
kernel B3 on the card), on [k, ssc, L] batches of whole objects."""

from __future__ import annotations

import torch

from ecbench import yardstick
from ecbench.entries import clay_common
from ecbench.reference.clay import ClayCode


class Work:
    #: the end-to-end metric: object bytes a call over the window
    rate_metric = "encode_GBps"

    def __init__(self, cfg: dict, traffic: dict, device: torch.device,
                 seed: int) -> None:
        codec = clay_common.codec_for(cfg, device)
        self.geo = geo = clay_common.geometry(cfg, codec)
        slots = max(1, int(traffic["ring_bytes"]) // geo["bytes_per_call"])
        self.ring = clay_common.data_ring(geo, slots, device, seed)
        self.n_slots = len(self.ring)
        self.objects_per_call = geo["objects"]
        self.bytes_per_call = geo["bytes_per_call"]
        self.encode = codec._encode_fn()
        self.yard = {"b3": yardstick.clay_encode(geo["k"], geo["m"],
                                                 geo["ssc"], geo["lanes"])}

    def describe(self) -> list[str]:
        g = self.geo
        return [f"entry ErasureCodeClay._encode_fn on [{g['k']}, {g['ssc']}, "
                f"{g['lanes']}] ({g['objects']} objects of "
                f"{g['bytes_per_call'] // g['objects']} B)",
                f"ring {self.n_slots} slots of {self.bytes_per_call} B"]

    def call(self, slot: int):
        return self.encode(self.ring[slot])

    def release(self, keep: list[int]) -> None:
        self.ring = [t if i in keep else None
                     for i, t in enumerate(self.ring)]

    def check(self, kept: list) -> dict:
        """The parity chunks of each sampled call against the reference
        Clay encoder's, from the slot's data."""
        g = self.geo
        ref_code = ClayCode(g["k"], g["m"], g["d"],
                            self.ring[kept[0][0]].device) if kept else None
        wrong = failed = 0
        for slot, parity in kept:
            diff = parity != ref_code.encode(self.ring[slot])
            wrong += int(diff.sum())
            failed += clay_common.objects_failed(diff, g)
        return {"checks": {"parity_bytes_wrong": (wrong, 0)},
                "failed": failed}


def setup(cfg: dict, traffic: dict, device: torch.device, seed: int) -> Work:
    return Work(cfg, traffic, device, seed)
