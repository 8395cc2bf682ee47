"""Coroutine-native EC reads for the crimson data path.

The threaded ``ECBackend._read_shards`` parks an op worker in
``SubOpWait.wait`` (a condition variable) while MECSubRead replies
trickle in — fine when workers are threads, fatal when the "worker"
is the PG's owning reactor: blocking it stalls every PG on the shard.
This module is the same read protocol — minimum_to_decode planning
over the up set, retry ladder with jittered backoff around
unreachable/EIO shards, version-agreement before combining chunks
(mixing a mid-commit shard into a decode is silent garbage), ENOENT
only when EVERY shard says so — rebuilt on awaitable futures the
messenger resolves via the owning reactor, so a degraded read costs
the reactor nothing but the suspended coroutine frame.

Degraded decode runs the HOST codec twin (``ec_util.decode``)
deliberately: ``decode_sync`` blocks its caller on an engine
continuation, and on a reactor that continuation would be queued
behind the very frame that is blocking — a self-deadlock. The host
twin is exact (the device path is an optimization, not a semantic),
and crimson's read fan-out concurrency comes from the event loop
instead of the engine's signature batching.
"""

from __future__ import annotations

import asyncio
import random

import numpy as np

from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.ec_backend import ECReadError
from ceph_tpu_torch.osd.pg import pg_cid
from ceph_tpu_torch.osd.pg_backend import SUBOP_TIMEOUT, user_xattrs
from ceph_tpu_torch.parallel import messages as M
from ceph_tpu_torch.store.object_store import (
    NoSuchCollection,
    NoSuchObject,
    StoreError,
)
from ceph_tpu_torch.utils.config import g_conf
from ceph_tpu_torch.utils.dout import Dout

log = Dout("crimson")

__all__ = ["read_shards", "read_object", "object_attrs"]


async def _backoff(attempt: int) -> None:
    conf = g_conf()
    base = conf["osd_ec_read_backoff_base"]
    cap = conf["osd_ec_read_backoff_max"]
    await asyncio.sleep(min(cap, base * (1 << attempt))
                        * (0.5 + random.random() * 0.5))


async def _fan_out_round(svc, be, pg, oid: str, need: list[int]):
    """One fan-out attempt over the planned positions: local shard
    read inline, remote shards as MECSubRead with one awaited future
    per (tid, shard) that the messenger resolves THROUGH the owning
    reactor. Returns (results, vers, attrs, failed, saw_data)."""
    reactor = svc.reactor
    mypos = be.my_position(pg)
    results: dict[int, np.ndarray] = {}
    vers: dict[int, int] = {}
    attrs: dict[str, bytes] = {}
    failed: set[int] = set()
    saw_data = False
    remote = [p for p in need if p != mypos]
    tid = svc.new_tid()
    futs: dict[int, asyncio.Future] = {}
    for pos in remote:
        futs[pos] = reactor.loop.create_future()
        reactor.read_waits[(tid, pos)] = futs[pos]
    try:
        for pos in remote:
            svc.send_osd(pg.acting[pos], M.MECSubRead(
                tid=tid, pool=pg.pool, ps=pg.ps, shard=pos,
                oid=oid, want_attrs=True))
        if mypos in need:
            cid = pg_cid(pg.pool, pg.ps, mypos)
            try:
                results[mypos] = np.frombuffer(
                    svc.store.read(cid, oid), dtype=np.uint8)
                local_attrs = svc.store.getattrs(cid, oid)
                vers[mypos] = int.from_bytes(
                    local_attrs.get("v", b""), "little")
                attrs = attrs or local_attrs
                saw_data = True
            except (NoSuchObject, NoSuchCollection):
                failed.add(mypos)
            except StoreError:
                failed.add(mypos)
                saw_data = True
        for pos in remote:
            try:
                rep = await asyncio.wait_for(futs[pos], SUBOP_TIMEOUT)
            except asyncio.TimeoutError:
                failed.add(pos)
                continue
            if rep.code != 0:
                failed.add(pos)
                if rep.code != -2:        # anything but ENOENT
                    saw_data = True
                continue
            saw_data = True
            results[pos] = np.frombuffer(rep.data, dtype=np.uint8)
            vers[pos] = rep.version
            if rep.attrs:
                attrs = dict(rep.attrs)
    finally:
        for pos in remote:
            reactor.read_waits.pop((tid, pos), None)
    return results, vers, attrs, failed, saw_data


async def read_shards(svc, be, pg, oid: str, want_chunks: list[int]
                      ) -> tuple[dict[int, np.ndarray],
                                 dict[str, bytes]]:
    """Awaitable ``_read_shards``: same ladder, same version
    discipline, no blocked thread. ``svc`` is the owning reactor's
    :class:`~ceph_tpu_torch.crimson.reactor.ReactorServices`, ``be`` its
    mainline :class:`ECBackend`."""
    base_avoid: set[int] = set()
    ver_avoid: set[int] = set()
    known_vers: dict[int, int] = {}
    enoent_everywhere = True
    disagreements = 0
    for attempt in range(be.MAX_READ_ATTEMPTS):
        avoid = set(base_avoid) | ver_avoid
        available = [p for p in be.up_positions(pg) if p not in avoid]
        try:
            plan = be.codec.minimum_to_decode(want_chunks, available)
        except Exception:
            if enoent_everywhere and attempt > 0:
                raise NoSuchObject(oid)
            if attempt < be.MAX_READ_ATTEMPTS - 1:
                await _backoff(attempt)
                continue
            raise ECReadError(
                f"{oid}: cannot reconstruct chunks {want_chunks} "
                f"from positions {available} after {attempt + 1} "
                f"attempts (unreachable shards->osds "
                f"{be._shard_osd_map(pg, avoid)})")
        need = sorted(plan)
        results, vers, attrs, failed, saw = await _fan_out_round(
            svc, be, pg, oid, need)
        if saw:
            enoent_everywhere = False
        missing_reads = set(need) - set(results)
        if missing_reads:
            base_avoid |= failed | missing_reads
            if attempt < be.MAX_READ_ATTEMPTS - 1:
                await _backoff(attempt)
            continue
        known_vers.update(vers)
        if len(set(vers.values())) > 1:
            if attempt >= be.MAX_READ_ATTEMPTS - 1:
                break
            disagreements += 1
            if disagreements <= 2:
                log(10, f"{oid}: shard versions disagree {vers}, "
                    f"retrying")
            else:
                ver_avoid = be._version_split_avoid(
                    pg, want_chunks, base_avoid, known_vers)
                log(1, f"{oid}: persistent shard version split "
                    f"{known_vers}; re-reading around positions "
                    f"{sorted(ver_avoid)}")
            await _backoff(attempt)
            continue
        return results, attrs
    if enoent_everywhere:
        raise NoSuchObject(oid)
    raise ECReadError(
        f"{oid}: no consistent readable shard set after "
        f"{be.MAX_READ_ATTEMPTS} attempts (want {want_chunks}; "
        f"unreachable shards->osds "
        f"{be._shard_osd_map(pg, base_avoid)}; "
        f"observed shard versions {known_vers})")


async def read_object(svc, be, pg, oid: str) -> tuple[bytes, int]:
    """Full-object EC read -> (logical bytes, version). Fast path
    concatenates the k data chunks; degraded reconstructs on the host
    codec (see module docstring for why never ``decode_sync``)."""
    want = list(range(be.k))
    chunks, attrs = await read_shards(svc, be, pg, oid, want)
    size = be._attr_size(attrs)
    version = int.from_bytes(attrs.get("v", b""), "little")
    if not all(i in chunks for i in want):
        chunks = dict(chunks)
        chunks.update(ec_util.decode(
            be.sinfo, be.codec, chunks,
            [i for i in want if i not in chunks]))
    return be._chunks_to_logical(
        {i: chunks[i] for i in want}, size), version


async def object_attrs(svc, be, pg, oid: str) -> dict[str, bytes]:
    """Attrs (size/version/user xattrs travel on every shard): local
    shard fast path, else one remote sub-read round."""
    mypos = be.my_position(pg)
    if mypos >= 0:
        try:
            return svc.store.getattrs(
                pg_cid(pg.pool, pg.ps, mypos), oid)
        except StoreError:
            pass
    _, attrs = await read_shards(svc, be, pg, oid, [0])
    if not attrs:
        raise NoSuchObject(oid)
    return attrs


def user_visible_xattrs(attrs: dict[str, bytes]) -> dict[str, bytes]:
    return user_xattrs(attrs)
