"""Device-resident deep scrub — fused crc + parity-re-encode verify.

Port of ``ceph_tpu/osd/scrub_engine.py`` on PyTorch and the port's CUDA
kernels. The host shallow scrub (``osd.py _do_scrub``) is an
object-at-a-time crc32c comparison against hinfo: one csum fan-out per
object, hashes computed on the serving OSD's CPU, and no parity
consistency check at all (a shard whose hinfo rotted alongside its data
passes). This module is the deep mode: a PG's objects stream through the
SAME device kernels the write path already owns —

1. **Gather**: every up shard of every object is read RAW (the
   hinfo crc gate on the serving OSD is bypassed — deep scrub wants
   the observation, and moves the hashing to the device), grouped by
   shape into pow2-bucketed batches (the shape-bounding discipline of
   ``ec_util._flush_device_fused_async``).
2. **Verify**: one device pass per batch on the pool's device — re-encode
   the data shards with the GF matvec (kernel B1, ``ops/gf_cuda.py``),
   XOR-compare against the stored parity, and take every shard's crc32c
   linear part from the same device-resident buffers (kernel B2 and the
   stage-2 combine, ``ops/crc32c_torch.crc_linear_device``). Only a
   [objects, m] mismatch bitmap and a [objects, shards] crc vector
   return to host: a clean batch costs ZERO per-object host verdict
   work (the shallow path's per-object csum fan-out + retry ladder).
3. **Repair**: convicted shards are reconstructed from the good
   shards ALREADY IN MEMORY through ``ECBackend._decode`` (the device
   engine's signature-batched ``decode_sync`` and B1 when the pool runs a
   device backend) and pushed through the normal recovery write path
   (``MPGPush`` — the push guard still applies), rate-limited in
   bounded rounds. Shards that cannot be rebuilt from memory fall
   back to ``peer_missing`` + a QOS_SCRUB recovery kick.

Conviction logic (mirrors the shallow scrub's self-consistency rule):
a shard whose device-computed crc mismatches its OWN stored hinfo is
corrupt. A parity mismatch with no crc culprit (hinfo dropped by an
RMW, or the hinfo itself rotted) runs the EXCLUSION test: the one
position whose removal makes the remaining system self-consistent is
the rotten one — real bitrot *detection*, not just crc bookkeeping.
Anything still ambiguous goes to the host shallow oracle
(``_scrub_object``), which stays the cross-check for the device path.

Where the reference judges a whole batch on the host after a failed
device verify, the port does not: it counts ``device_errors``, judges
none of the batch's objects clean (they are listed as ``unverified``)
and returns the PG's result with an ``error`` that names the fault.
Replicated pools and layered or mapped codecs still take the host
shallow scrub (``deep_scrub_pg`` returns None), as in the reference.
With a default mesh (parallel/mesh.py) a batch that reaches the
dense->mesh crossover verifies through the sharded verify step on the
PG's placement-slot submesh, or the whole mesh; a fault there judges the
batch's objects as any device fault does (the reference's fallback to
the single-device program is not ported).

Batches are bounded (``max_batch_objects``/``max_batch_bytes``) so
the device working set is capped per round; verify launches run on the
device engine's thread (``run_sync``) so scrub never contends with a
client encode flush mid-download.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ceph_tpu_torch.ops import backend as backend_mod
from ceph_tpu_torch.ops import crc32c_torch, gf_cuda
from ceph_tpu_torch.osd import ec_util
from ceph_tpu_torch.osd.device_engine import mesh_flush_threshold
from ceph_tpu_torch.osd.pg_backend import SUBOP_TIMEOUT, SubOpWait
from ceph_tpu_torch.parallel import messages as M
from ceph_tpu_torch.parallel import mesh as mesh_mod
from ceph_tpu_torch.parallel import placement as _placement
from ceph_tpu_torch.parallel import sharded_codec
from ceph_tpu_torch.utils.device_telemetry import telemetry as _telemetry
from ceph_tpu_torch.utils.dout import Dout
from ceph_tpu_torch.analysis.lock_witness import make_lock

log = Dout("osd")

#: smallest shard-length bucket (pow2; a multiple of the crc kernel's
#: ROW_BYTES by construction — every pow2 >= 512 is)
_MIN_LEN_BUCKET = 1 << 12


def _pow2(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


#: (matrix bytes, k, l_b, nobj_b) -> verify program; pow2-bucketed dims
#: keep this bounded no matter the object mix
_verify_cache: dict = {}
_VERIFY_CACHE_MAX = 64


class DeviceVerifyError(RuntimeError):
    """A deep-scrub verify batch failed on the device; its objects stay
    unjudged (no host twin runs in its place)."""


def verify_fn(mat: np.ndarray, k: int, l_b: int, nobj_b: int):
    """The deep-scrub verify program for a [nobj_b, k+m, l_b] uint8 shard
    batch tensor: re-encode the data shards through the GF matvec (B1 on
    a CUDA tensor, its plain version on a CPU one), XOR-compare against
    the stored parity (reduced to a [nobj_b, m] any-mismatch bitmap), and
    compute every shard's crc32c LINEAR part from the same device-resident
    buffers (B2 + the stage-2 combine). Returns ``fn(batch) -> (mismatch
    [nobj_b, m] bool, crc_lin [nobj_b, k+m] int64)``, both on the batch's
    device. Cached per (matrix, k, l_b, nobj_b), as the reference caches
    its jitted program."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    m = mat.shape[0]
    n = k + m
    key = (mat.tobytes(), k, l_b, nobj_b)
    fn = _verify_cache.get(key)
    if fn is not None:
        return fn
    if len(_verify_cache) >= _VERIFY_CACHE_MAX:
        _verify_cache.clear()

    def verify(batch: torch.Tensor):
        # fold objects into the byte axis: GF matvec is position-wise
        data = batch[:, :k, :].transpose(0, 1).reshape(k, nobj_b * l_b)
        par = gf_cuda.matvec_device(mat, data.contiguous())  # [m, nobj*l]
        par = par.reshape(m, nobj_b, l_b).transpose(0, 1)
        mism = (par != batch[:, k:, :]).any(dim=2)           # [nobj, m]
        lin = crc32c_torch.crc_linear_device(
            batch.reshape(nobj_b * n, l_b))
        return mism, lin.reshape(nobj_b, n)

    fn = _verify_cache[key] = verify
    return fn


#: id(mesh) -> {(matrix bytes, k): verify step} — mesh twins of the
#: verify program (bounded like ec_util's step cache)
_mesh_verify_cache: dict = {}


def _mesh_verify_step(mesh, mat: np.ndarray, k: int):
    if id(mesh) not in _mesh_verify_cache and \
            len(_mesh_verify_cache) >= _VERIFY_CACHE_MAX:
        _mesh_verify_cache.clear()
    per_mesh = _mesh_verify_cache.setdefault(id(mesh), {})
    key = (mat.tobytes(), k)
    step = per_mesh.get(key)
    if step is None:
        step = per_mesh[key] = sharded_codec.make_verify_step(mesh, mat, k)
    return step


def verify_batch(mat: np.ndarray, k: int, batch: np.ndarray, mesh=None,
                 device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Host entry: verify a [nobj, k+m, L] uint8 batch (L already a
    pow2 bucket, shards FRONT-padded — free under both GF and crc
    linearity) on ``device`` (the card unless the caller passes the
    CPU). Pads the object axis to its pow2 bucket with zero objects,
    uploads the batch, runs the verify program through the telemetry
    compile accountant (the first call of a signature counts as its
    compile), and returns (mismatch [nobj, m] bool, crc_lin [nobj, k+m]
    uint32) as numpy.

    With ``mesh`` the batch spreads over every slot of the mesh through
    the sharded verify step (``parallel/sharded_codec.make_verify_step``)
    instead, the object axis padded to a multiple of the slot count; the
    verdicts are bit for bit the single-device program's (zero-padded
    objects verify clean on both). A fault raises."""
    mat = np.asarray(mat, dtype=np.uint8)
    nobj, n, l_b = batch.shape
    m = mat.shape[0]
    assert n == k + m, (n, k, m)
    nobj_b = _pow2(max(nobj, 1), 1)
    if mesh is not None and nobj_b % mesh.size:
        # the object axis splits over EVERY slot: round the pow2 bucket
        # up to a slot-count multiple
        nobj_b = -(-nobj_b // mesh.size) * mesh.size
    if nobj_b != nobj:
        # zero objects: zero parity re-encodes to zero (no mismatch)
        padded = np.zeros((nobj_b, n, l_b), dtype=np.uint8)
        padded[:nobj] = batch
        batch = padded
    if mesh is not None:
        step = _mesh_verify_step(mesh, mat, k)
        mism, lin = step(sharded_codec.shard_object_batch(mesh, batch))
        _telemetry().note_mesh_scrub_batch()
        return (mism.numpy()[:nobj],
                lin.numpy().astype(np.uint32)[:nobj])
    fn = verify_fn(mat, k, l_b, nobj_b)
    sig = f"scrub_verify[{m}x{k}]L{l_b}n{nobj_b}"
    dev_batch = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
    mism, lin = _telemetry().timed_call(sig, fn, dev_batch)
    return (backend_mod.to_host(mism)[:nobj],
            backend_mod.to_host(lin).astype(np.uint32)[:nobj])


class DeepScrubEngine:
    """Per-OSD deep-scrub orchestrator (one instance, lazily built by
    ``OSD.scrub_engine()``); stateless across PGs except counters."""

    #: batch caps: objects per device launch and bytes per launch (the
    #: batch, its re-encoded parity and the data transpose stay well
    #: under the card's memory)
    max_batch_objects = 128
    max_batch_bytes = 32 << 20
    #: repair rate limiter: at most this many reconstructed bytes per
    #: round, then a breather — background repair must not crowd the
    #: client op path off the device or the wire
    repair_bytes_per_round = 16 << 20
    repair_round_delay = 0.05
    #: gather fan-out attempts before an object is skipped as
    #: unsettled (online scrub races in-flight writes, exactly like
    #: the shallow path's retry ladder)
    GATHER_ATTEMPTS = 3

    def __init__(self, osd) -> None:
        self.osd = osd
        self._lock = make_lock("scrub.state")
        self.stats = {
            "pgs": 0, "objects": 0, "batches": 0,
            "bytes_verified": 0, "mismatch_stripes": 0,
            "crc_convictions": 0, "exclusion_convictions": 0,
            "host_fallback_objects": 0, "skipped_unsettled": 0,
            "repaired_shards": 0, "repair_rounds": 0,
            "repair_bytes": 0, "device_errors": 0,
        }

    # -- public entry --------------------------------------------------
    def deep_scrub_pg(self, pg, repair: bool = True) -> dict | None:
        """Deep-scrub one ACTIVE primary PG. Returns the scrub result
        dict, or None when this pool cannot take the device path
        (replicated, or a layered/mapped codec) — the caller falls
        back to the host shallow scrub."""
        from ceph_tpu_torch.osd.ec_backend import ECBackend
        be = pg.backend
        if not isinstance(be, ECBackend):
            return None
        from ceph_tpu_torch.models.matrix_codec import MatrixErasureCode
        codec = be.codec
        if not isinstance(codec, MatrixErasureCode) or \
                codec.chunk_mapping:
            return None                 # layered codec: host scrub
        osd = self.osd
        with pg.lock:
            if pg.state != pg.ACTIVE:
                return {"error": "pg not active here"}
            if len(be.up_positions(pg)) < be.n:
                # a down shard can neither be verified nor repaired
                # into; judge it when the set is whole (recovery owns
                # the degraded case)
                return {"error": "acting set not whole", "deep": True}
            latest: dict[str, int] = {}
            for v in sorted(pg.log.entries):
                latest[pg.log.entries[v].oid] = pg.log.entries[v].op
        from ceph_tpu_torch.osd.pg import LOG_REMOVE
        listing = [oid for oid in osd._scrub_listing(pg)
                   if latest.get(oid) != LOG_REMOVE]
        out = {"objects": len(listing), "inconsistent": {},
               "repaired": [], "deep": True, "batches": 0,
               "bytes_verified": 0}
        self.stats["pgs"] += 1

        gathered = self._gather(pg, listing)
        victims: dict[str, dict] = {}
        # bucket by shard-length bucket, chunk by the batch caps
        buckets: dict[int, list] = {}
        for oid, obs in gathered.items():
            if obs is None:
                self.stats["skipped_unsettled"] += 1
                continue
            if not obs["shards"] and not obs["bad"]:
                continue               # concurrently removed: clean
            if obs["bad"]:
                # read-layer conviction (EIO / ENOENT while peers
                # hold it): straight to repair, no device pass needed
                victims[oid] = obs
                continue
            l_b = _pow2(max(obs["shard_len"], 1), _MIN_LEN_BUCKET)
            buckets.setdefault(l_b, []).append((oid, obs))
        errors: list[str] = []
        unverified: list[str] = []
        for l_b, items in sorted(buckets.items()):
            per_batch = max(1, min(self.max_batch_objects,
                                   self.max_batch_bytes //
                                   (be.n * l_b) or 1))
            for i in range(0, len(items), per_batch):
                chunk = items[i:i + per_batch]
                try:
                    nb = self._verify_chunk(pg, be, l_b, chunk, victims)
                except DeviceVerifyError as exc:
                    # nothing of this batch is judged, clean or not
                    errors.append(str(exc))
                    unverified += [oid for oid, _obs in chunk]
                    continue
                out["batches"] += 1
                out["bytes_verified"] += nb
        for oid, obs in victims.items():
            out["inconsistent"][oid] = sorted(obs["bad"])
        if errors:
            out["error"] = "; ".join(errors)
            out["unverified"] = sorted(unverified)
        self.stats["objects"] += len(listing)
        if repair and victims:
            out["repaired"] = self._repair(pg, victims)
        return out

    # -- gather --------------------------------------------------------
    def _gather(self, pg, listing: list[str]) -> dict:
        """Raw full-shard reads of every object over every up
        position; per object returns {"shards": {pos: np}, "attrs":
        {pos: dict}, "versions", "shard_len", "bad": set()} or None
        when the observation never settled (in-flight write)."""
        from concurrent.futures import ThreadPoolExecutor
        if not listing:
            return {}
        with ThreadPoolExecutor(
                max_workers=min(8, len(listing)),
                thread_name_prefix="deep-scrub-gather") as pool:
            return dict(zip(listing,
                            pool.map(lambda o: self._gather_one(pg, o),
                                     listing)))

    def _gather_one(self, pg, oid: str) -> dict | None:
        osd = self.osd
        be = pg.backend
        for attempt in range(self.GATHER_ATTEMPTS):
            positions = be.up_positions(pg)
            tid = osd.new_tid()
            wait = SubOpWait(set(positions))
            osd.register_wait(tid, wait)
            for pos in positions:
                osd.send_osd(pg.acting[pos], M.MECSubRead(
                    tid=tid, pool=pg.pool, ps=pg.ps, shard=pos,
                    oid=oid, offset=0, length=0, want_attrs=True,
                    raw=True))
            replies = wait.wait(SUBOP_TIMEOUT)
            osd.unregister_wait(tid)
            shards: dict[int, np.ndarray] = {}
            attrs: dict[int, dict] = {}
            vers: dict[int, int] = {}
            bad: set[int] = set()
            enoent: set[int] = set()
            silent = False
            for pos in positions:
                rep = replies.get(pos)
                if rep is None:
                    silent = True
                    continue
                if rep.code == -2:
                    enoent.add(pos)
                    continue
                if rep.code != 0:
                    bad.add(pos)         # EIO: read-layer conviction
                    continue
                shards[pos] = np.frombuffer(rep.data, dtype=np.uint8)
                attrs[pos] = dict(rep.attrs)
                vers[pos] = rep.version
            lens = {len(v) for v in shards.values()}
            settled = (not silent and len(set(vers.values())) <= 1
                       and len(lens) <= 1
                       and not (shards and enoent))
            if settled:
                if not shards and not bad:
                    return {"shards": {}, "attrs": {}, "versions": {},
                            "shard_len": 0, "bad": set()}  # all-ENOENT
                bad |= enoent
                return {"shards": shards, "attrs": attrs,
                        "versions": vers,
                        "shard_len": lens.pop() if lens else 0,
                        "bad": bad}
            time.sleep(0.05 * (attempt + 1))
        return None

    # -- verify --------------------------------------------------------
    def _verify_chunk(self, pg, be, l_b: int, chunk: list,
                      victims: dict) -> int:
        """One device launch over ``chunk`` = [(oid, obs)] whose
        shards all bucket to ``l_b``. Convicts via the crc-vs-hinfo
        self-check, the exclusion test, or the host oracle; populates
        ``victims``. Returns bytes verified; raises DeviceVerifyError
        (counted in ``device_errors``) when the verify fails."""
        k, n = be.k, be.n
        mat = np.asarray(be.codec.coding_matrix, dtype=np.uint8)
        batch = np.zeros((len(chunk), n, l_b), dtype=np.uint8)
        for i, (_oid, obs) in enumerate(chunk):
            for pos, arr in obs["shards"].items():
                batch[i, pos, l_b - len(arr):] = arr  # FRONT pad
        nbytes = sum(len(a) for _o, obs in chunk
                     for a in obs["shards"].values())
        t0 = time.perf_counter()
        engine = self.osd.device_engine()
        mesh = self._pick_mesh(pg, batch.nbytes)
        # the pool's device: its device codec's (the card for ``cuda``,
        # the CPU for ``torch``), the CPU for a host pool
        device = be.device_codec.device if be.device_codec is not None \
            else "cpu"
        try:
            mism, lin = engine.run_sync(
                lambda: verify_batch(mat, k, batch, mesh=mesh,
                                     device=device))
        except Exception as exc:
            # no host oracle judges the batch in the device's place:
            # the fault is counted and named, the objects stay unjudged
            log(0, f"{pg}: deep-scrub device verify failed ({exc!r})")
            self.stats["device_errors"] += 1
            raise DeviceVerifyError(
                f"{pg}: deep-scrub device verify failed: {exc!r}") from exc
        tel = _telemetry()
        self.stats["batches"] += 1
        self.stats["bytes_verified"] += nbytes
        tel.note_scrub_flush(len(chunk), nbytes,
                             time.perf_counter() - t0)
        for i, (oid, obs) in enumerate(chunk):
            parity_bad = bool(mism[i].any())
            crc_bad: set[int] = set()
            for pos in obs["shards"]:
                hraw = obs["attrs"].get(pos, {}).get("hinfo")
                if not hraw:
                    continue       # RMW dropped it: no self-check
                try:
                    hinfo = ec_util.HashInfo.from_dict(
                        json.loads(hraw))
                    want = hinfo.get_chunk_hash(pos)
                except (ValueError, KeyError, TypeError, IndexError):
                    crc_bad.add(pos)   # unparseable hinfo: corrupt
                    continue
                # full crc from the device linear part + the seed
                # correction for THIS object's true shard length (the
                # linear part is invariant under the bucket front pad)
                if crc32c_torch.crc32c_from_linear(
                        int(lin[i, pos]), obs["shard_len"],
                        ec_util.HINFO_SEED) != want:
                    crc_bad.add(pos)
            if not parity_bad and not crc_bad:
                continue               # clean: bitmap row only
            self.stats["mismatch_stripes"] += 1
            tel.note_scrub_mismatch()
            if crc_bad:
                self.stats["crc_convictions"] += len(crc_bad)
                victims[oid] = {**obs, "bad": set(crc_bad)}
                continue
            excl = self._exclusion_test(be, obs)
            if excl is not None:
                self.stats["exclusion_convictions"] += 1
                victims[oid] = {**obs, "bad": {excl}}
                continue
            self._host_verdict(pg, oid, obs, victims)
        return nbytes

    @staticmethod
    def _pick_mesh(pg, nbytes: int):
        """The mesh this PG's verify batch should ride: None below the
        dense->mesh crossover or with no default mesh; the PG's
        placement-slot submesh when a multi-slot map is active (scrub lands
        on the slots that own the PG's encode/decode work); else the whole
        default mesh."""
        mesh = mesh_mod.get_default_mesh()
        if mesh is None or nbytes < mesh_flush_threshold():
            return None
        pmap = _placement.active_map()
        if pmap is not None and pmap.n_slots > 1:
            return pmap.submesh(pmap.slot(pg.pgid))
        return mesh

    def _exclusion_test(self, be, obs: dict) -> int | None:
        """Single-corruption localization with no crc evidence: the
        one position whose exclusion leaves a self-consistent system
        (decode it from any k of the others, re-encode, and every
        OTHER stored shard matches) is the rotten shard. Host-side
        numpy on one object's shards — runs only for the rare
        parity-mismatch-without-crc-culprit case."""
        k = be.k
        m = be.n - k
        codec = be.codec
        shards = obs["shards"]
        if len(shards) < k + 1:
            return None                # cannot cross-check
        consistent = []
        for p in sorted(shards):
            others = {c: v for c, v in shards.items() if c != p}
            try:
                dec = ec_util.decode(be.sinfo, codec, others,
                                     list(range(k)))
                data = np.stack([np.asarray(dec[c], dtype=np.uint8)
                                 for c in range(k)])
                parity = codec._matvec(codec.coding_matrix, data)
            except Exception:
                continue
            full = {c: data[c] for c in range(k)}
            full.update({k + j: parity[j] for j in range(m)})
            # decode returns present chunks verbatim, so re-derive the
            # WHOLE system from the decoded data and compare every
            # remaining stored shard against it
            if all(np.array_equal(full[c], np.asarray(shards[c]))
                   for c in others):
                consistent.append(p)
        return consistent[0] if len(consistent) == 1 else None

    def _host_verdict(self, pg, oid: str, obs: dict,
                      victims: dict) -> None:
        """Cross-check oracle: the shallow per-object judge."""
        self.stats["host_fallback_objects"] += 1
        _telemetry().note_scrub_host_fallback()
        bad, _auth = self.osd._scrub_object(pg, oid)
        if bad:
            victims[oid] = {**obs, "bad": set(bad)}

    # -- repair --------------------------------------------------------
    def _repair(self, pg, victims: dict) -> list[str]:
        """Reconstruct convicted shards from the gathered good shards
        (sparse-aware decode, signature-batched on the device path)
        and push them through the normal recovery write path, rate-
        limited per round. Unrebuildable objects fall back to
        peer_missing + a QOS_SCRUB recovery kick."""
        from ceph_tpu_torch.osd.osd import QOS_SCRUB, _SelfConn
        osd = self.osd
        be = pg.backend
        repaired: list[str] = []
        fallback: dict[str, set] = {}
        round_bytes = 0
        self.stats["repair_rounds"] += 1
        for oid, obs in sorted(victims.items()):
            bad = sorted(obs["bad"])
            good = {pos: arr for pos, arr in obs["shards"].items()
                    if pos not in obs["bad"]}
            if len(good) < be.k or not obs.get("attrs"):
                fallback[oid] = set(bad)
                continue
            try:
                decoded = be._decode(pg, good, bad)
            except Exception as exc:
                log(1, f"{pg}: deep-scrub repair decode {oid} "
                    f"failed: {exc!r}")
                fallback[oid] = set(bad)
                continue
            ref_attrs = next(iter(
                obs["attrs"][p] for p in sorted(obs["attrs"])
                if p not in obs["bad"]), None)
            if ref_attrs is None:
                fallback[oid] = set(bad)
                continue
            ok = True
            for pos in bad:
                chunk = np.asarray(decoded[pos], dtype=np.uint8)
                tid = osd.new_tid()
                push = be._push_from_chunk(pg, oid, pos,
                                           obs["versions"].get(pos, 0)
                                           or int.from_bytes(
                                               ref_attrs.get("v", b""),
                                               "little"),
                                           chunk, ref_attrs, tid)
                if push is None:
                    ok = False
                    continue
                wait = SubOpWait({oid})
                osd.register_wait(tid, wait)
                target = pg.acting[pos]
                if target == osd.whoami:
                    osd._handle_pg_push(push, _SelfConn(osd))
                else:
                    osd.send_osd(target, push)
                replies = wait.wait(SUBOP_TIMEOUT)
                osd.unregister_wait(tid)
                rep = replies.get(oid)
                if rep is None or not getattr(rep, "committed",
                                              False):
                    ok = False
                    continue
                self.stats["repaired_shards"] += 1
                self.stats["repair_bytes"] += len(chunk)
                _telemetry().note_scrub_repair()
                round_bytes += len(chunk)
                if round_bytes >= self.repair_bytes_per_round:
                    # breather: background repair yields the device
                    # and the wire back to client traffic
                    self.stats["repair_rounds"] += 1
                    round_bytes = 0
                    time.sleep(self.repair_round_delay)
            if ok:
                repaired.append(oid)
                with pg.lock:
                    for pos in bad:
                        missing = pg.peer_missing.get(pos)
                        if missing:
                            missing.pop(oid, None)
            else:
                fallback[oid] = set(bad)
        if fallback:
            with pg.lock:
                for oid, bad in fallback.items():
                    ver = max(victims[oid]["versions"].values(),
                              default=0)
                    if ver <= 0:
                        continue       # nothing judgeable to push
                    for pos in bad:
                        pg.peer_missing.setdefault(pos, {})[oid] = ver
            osd.op_wq.enqueue(pg.pgid, lambda p=pg: osd._recover(p),
                              qos=QOS_SCRUB)
        return repaired
