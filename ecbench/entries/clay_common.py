"""What the Clay entries share: the codec from the configuration's
profile, and a ring of data batches made on the card from the seed.

One object of ``object_bytes`` is one codec call's worth (k chunks of
ssc sub-chunks); ``objects_per_call`` objects lie side by side along the
lanes, so a batch is [k, ssc, objects_per_call * sub_chunk_bytes] and
object o's sub-chunk z of chunk i is lanes [o * sc, (o + 1) * sc)."""

from __future__ import annotations

import torch


def codec_for(cfg: dict, device: torch.device):
    from ceph_tpu_torch.models import instance

    return instance().factory(cfg["plugin"], cfg["profile"], device=device)


def geometry(cfg: dict, codec) -> dict:
    k, m = int(cfg["k"]), int(cfg["m"])
    ssc = codec.get_sub_chunk_count()
    obj = int(cfg["object_bytes"])
    if obj % (k * ssc):
        raise ValueError("object_bytes is not k whole chunks of sub-chunks")
    sc = obj // (k * ssc)
    per_call = int(cfg["objects_per_call"])
    return {"k": k, "m": m, "d": int(cfg["d"]), "ssc": ssc, "sc": sc,
            "objects": per_call, "lanes": per_call * sc,
            "bytes_per_call": per_call * obj}


def data_ring(geo: dict, slots: int, device: torch.device,
              seed: int) -> list[torch.Tensor]:
    """``slots`` batches of random objects, from one generator seeded
    with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [torch.empty((geo["k"], geo["ssc"], geo["lanes"]),
                        dtype=torch.uint8, device=device)
            .random_(0, 256, generator=gen) for _ in range(slots)]


def objects_failed(diff: torch.Tensor, geo: dict) -> int:
    """Objects with a wrong byte, from a [rows, ssc, lanes] mismatch."""
    return int(diff.view(diff.shape[0], geo["ssc"], geo["objects"],
                         geo["sc"]).any(dim=3).any(dim=1).any(dim=0).sum())
