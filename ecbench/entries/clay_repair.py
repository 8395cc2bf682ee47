"""Single-chunk repair through the product the Clay codec runs on the
card for a repair signature: ``ErasureCodeClay._lin_matvec``'s
``clay_device.build_decode_matvec(codec, codec._repair_matrix(lost,
helpers), label="repair")``, calibrated between kernel B5 and the dense
product, called on the device batch of the helpers' sub-chunks.

Every chunk of the code is the lost one in turn, in an order drawn from
the seed: each seed runs the same set of repair signatures, whose matrices
(and so whose speeds) differ. Ring slot i holds its own objects and
repairs chunk ``order[i % (k + m)]``. Set-up writes each slot's objects
with the codec's encoder (as an OSD stored them), then lays out what the
helpers send: each helper's repair-plane sub-chunks, as the codec's
``minimum_to_decode`` names them, stacked helper by helper."""

from __future__ import annotations

import random

import torch

from ecbench import yardstick
from ecbench.entries import clay_common
from ecbench.reference.clay import ClayCode


class Work:
    #: the end-to-end metric: object bytes a call over the window
    rate_metric = "decode_GBps"

    def __init__(self, cfg: dict, traffic: dict, device: torch.device,
                 seed: int) -> None:
        from ceph_tpu_torch.models.clay_device import build_decode_matvec

        codec = clay_common.codec_for(cfg, device)
        self.geo = geo = clay_common.geometry(cfg, codec)
        n = geo["k"] + geo["m"]
        order = list(range(n))
        random.Random(seed).shuffle(order)
        slots = -(-int(traffic["ring_bytes"]) // geo["bytes_per_call"])
        slots = -(-slots // n) * n
        self.lost = [order[i % n] for i in range(slots)]
        self.products, plan = {}, {}
        for lost in order:
            minimum = codec.minimum_to_decode(
                [lost], [c for c in range(n) if c != lost])
            helpers = tuple(sorted(minimum))
            planes = [z for off, cnt in minimum[helpers[0]]
                      for z in range(off, off + cnt)]
            if any(minimum[h] != minimum[helpers[0]] for h in helpers):
                raise RuntimeError("helpers read different sub-chunks")
            plan[lost] = (helpers, planes)
            self.products[lost] = build_decode_matvec(
                codec, codec._repair_matrix(lost, helpers), label="repair")

        encode = codec._encode_fn()
        self.data = clay_common.data_ring(geo, slots, device, seed)
        self.inputs = []
        for lost, data in zip(self.lost, self.data):
            helpers, planes = plan[lost]
            chunks = torch.cat([data, encode(data)])
            self.inputs.append(
                chunks.index_select(0, torch.tensor(helpers, device=device))
                .index_select(1, torch.tensor(planes, device=device))
                .reshape(len(helpers) * len(planes), geo["lanes"]))
            del chunks
        d, rss = len(plan[order[0]][0]), len(plan[order[0]][1])
        self.shape = (d * rss, geo["lanes"])
        self.n_slots = slots
        self.objects_per_call = geo["objects"]
        self.bytes_per_call = geo["bytes_per_call"]
        self.yard = {"repair": yardstick.clay_repair(d, rss, geo["ssc"],
                                                     geo["lanes"])}

    def describe(self) -> list[str]:
        routes = {}
        for lost, p in sorted(self.products.items()):
            routes.setdefault(p.path, []).append(lost)
        lines = [f"entry build_decode_matvec(label=repair) on "
                 f"{list(self.shape)}, every chunk lost in turn, order "
                 f"{self.lost[:len(self.products)]}",
                 f"repair routes {routes}"]
        lines += [f"repair chunk {lost}: {p.path} {p.measured}"
                  for lost, p in sorted(self.products.items())]
        lines.append(f"ring {self.n_slots} slots of {self.bytes_per_call} B")
        return lines

    def call(self, slot: int):
        return self.products[self.lost[slot]](self.inputs[slot])

    def stratum(self, slot: int) -> int:
        """Calls are sampled for the check by their lost chunk, so that
        the product of every repair signature is judged."""
        return self.lost[slot]

    def release(self, keep: list[int]) -> None:
        self.inputs = None
        self.data = [t if i in keep else None
                     for i, t in enumerate(self.data)]

    def check(self, kept: list) -> dict:
        """The rebuilt chunk of each sampled call against the chunk the
        reference Clay encoder gives for the slot's data."""
        g = self.geo
        ref_code = ClayCode(g["k"], g["m"], g["d"],
                            self.data[kept[0][0]].device) if kept else None
        wrong = failed = 0
        parity = {}
        for slot, rebuilt in kept:
            data, lost = self.data[slot], self.lost[slot]
            if lost < g["k"]:
                want = data[lost]
            else:
                if slot not in parity:
                    parity[slot] = ref_code.encode(data)
                want = parity[slot][lost - g["k"]]
            diff = rebuilt.view(1, g["ssc"], g["lanes"]) != want
            wrong += int(diff.sum())
            failed += clay_common.objects_failed(diff, g)
        unchecked = len(set(self.lost) - {self.lost[s] for s, _ in kept})
        return {"checks": {"chunk_bytes_wrong": (wrong, 0),
                           "signatures_unchecked": (unchecked, 0)},
                "failed": failed}


def setup(cfg: dict, traffic: dict, device: torch.device, seed: int) -> Work:
    return Work(cfg, traffic, device, seed)
