#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``ceph_tpu_torch``) on one GPU.

Run from the repository root, with one NVIDIA H100 visible:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name, ``nvidia-smi`` name and power limit, and the
   device-memory rate read from the card;
2. build: kernels B1 (csrc/gf_matvec.cu), B2 (csrc/crc32c_rows.cu), B3
   (csrc/clay_encode.cu), B4 (csrc/clay_transform.cu), B5
   (csrc/gf_block_sparse.cu) and B6 (csrc/gf_xor.cu), one ``nvcc`` each,
   all started together, into ``build/torch_ext/``;
3. kernels: each kernel against its plain torch version on the card,
   byte-exact, over ragged shapes, decode matrices and a 32x128 matrix;
   B1 also over random k=8 matrices of 4, 5, 16, 17 and 32 rows (with
   the RS matrices, its 2-, 4- and 16-row templates, one and two passes)
   and from a pointer one byte off alignment (its byte path); B2 also at
   its tile's edges (rows a warp reduces together, +- 1), one grid-stride
   round of its grid and past it, and from a pointer one byte off
   alignment, which must raise;
4. main path, at the north-star benchmark's size (bench.py:47-49): the
   ISA ``reed_sol_van`` k=8, m=3 codec, 128 objects of 1 MiB (128 MiB per
   flush), stripe unit 4096 B. ``StripeBatcher.flush(with_crcs=True)`` on
   CUDA, then a degraded read erasing 1 and then 2 data shards through
   ``ec_util.decode``. Parity is checked byte-exact against the host GF
   oracle, every op's per-shard crc against the host crc32c (all 1408
   segments), and the reads against the data. Kernel launch counts are
   zeroed before and read after this phase;
5. times on the card (CUDA events; warm-up, then the median of several
   runs): B1 encode and e=1/e=2 decode on a resident [8, 16 Mi] batch,
   each held against its plain version and timed through the entry point
   (``ms``, beside the split-nibble design's ``prev_ms``) and as the
   profiler's device time of the kernel (``device_ms``); B2 on the main
   path's rows, held against its plain version there and timed through
   the entry point (``b2_ms``, beside the thread-per-row design's
   ``b2_prev_ms``), through its C launcher (``b2_wrapper_ms``) and as the
   profiler's device time (``b2_device_ms``); each beside its plain
   version and its bound; the stage-2 combine of the flush's 1408 x 256
   row crcs (``stage2_combine``: events and device time, held against the
   CPU); and the fused flush's wall time, with a torch.profiler breakdown
   of one flush (device busy share, top device and host entries);
5b. engine: the write path through ``DeviceEncodeEngine`` (window 3,
   flushes of 128 MiB) on the same profile: 8 x 128 objects of 1 MiB
   (1 GiB, from the seed) staged from 4 producer threads, after a held
   warm-up burst of the same objects into a store of its own, which warms
   the slot streams' allocators and the pinned host blocks the drain
   holds at once. Continuations run on a per-key executor (2 workers, as
   an OSD's sharded op queue), copy their shards into a host store and
   keep their crcs. Two bursts: "drain",
   staged while the engine is held in a ``run_sync`` and timed from the
   release (the engine's rate on a full queue), and "live", staged into
   the running engine and timed from the first ``stage_encode`` (the
   write rate with the producers' staging copy in it). Checked: every
   op's data shards and parity against the host GF oracle, every crc of
   the drain's first and last flush against the host crc32c, the live
   burst's shards and crcs equal to the drain's, degraded reads of 1 and
   2 lost data shards of the first flush through ``decode_sync``, and
   each key's continuation order; asserted after the ``engine`` line:
   8 drain flushes, window depth >= 2 in the drain, no errors, fused
   fallbacks or host flushes, B1 launches = 8 + the reads that are not
   XOR-decodable and B2 launches = 8 in the drain, both = the flush
   count in the live burst (counts zeroed just before each burst). The
   line prints both walls and GB/s beside phase 5's single flush, each
   drain flush's host split (upload enqueue, device transpose enqueue,
   launch, pinned output allocation, ``finalize`` wait,
   ``_split_results``; the producers' stager copy and the
   continuations' store copy) and the data shards' way back (download
   against a host transpose). Then ``bench/engine_loop``'s line;
5c. cluster: the OSD chain end to end on the same profile as a pool
   users run: a ``MiniCluster`` of 12 OSDs (threaded, memstore; k+m = 11
   positions and one spare), an EC pool ``plugin=isa``
   ``technique=reed_sol_van`` k=8, m=3, ``pg_num=32``, stripe unit 4096,
   ``backend=cuda``, bulk ingest on (the OSDs share one engine). 512
   objects of 1 MiB (from the seed) written with ``write_full`` from 8
   client threads, then a ``write_full`` + ``append`` and a write +
   ``remove`` on one object each (the engine's barrier ordering). Checked:
   every object reads back byte-exact; the engine's ops >= 512,
   ``max_batch_ops`` > 1, no errors; B1 and B2 launched, B2 once a fused
   flush; for 16 objects in different PGs every shard read straight from
   its OSD's store, parity against the host GF oracle and each ``hinfo``
   crc against the host crc32c. The cluster runs with Ceph's default
   heartbeat grace (20 s) but while two OSDs are killed (the knobs
   tightened as the reference's ``fast_death`` fixtures do, until both
   are marked down): all 512 objects read back degraded, the engine
   decoded (``decode_ops`` > 0, no ``decode_errors``) with B1 launches,
   and 32 more objects are written and read back; then both OSDs revive,
   ``wait_for_clean``, and everything reads back again. The ``cluster``
   line prints the walls and GB/s of the writes, the clean, degraded and
   final reads and the recovery (the surviving shard bytes it decoded
   from through the engine, over its wall), flushes and ops a flush, the
   window
   depth, each kernel's launches by step, and the card's name and power
   limit. Kernel launch counts are zeroed before and read after each
   step. The phase runs in a child process on the same card (this script
   with ``--cluster-phase``), so the cluster's threads stay out of this
   process's profiler sessions, after phase 13 with 5e, 5f, 5g, 5h and 5d;
5d. scrub: deep scrub on the card over the durable store, 5c's
   deployment on BlockStore (the BlueStore role; its data files in a
   temporary directory under ``build/scrub/``): 12 OSDs, the ISA k=8,m=3
   ``backend=cuda`` pool with ``pg_num=32``, 512 objects of 1 MiB (from the
   seed) written from 8 client threads; then a silent bit flip
   (``BlockStore.inject_bit_flip``: the blob is rewritten under a matching
   csum, so reads return the rot with no EIO) of 4 bytes in each of 11
   objects of different PGs, object i at shard position i (8 data, 3
   parity), and a deep scrub of the pool: per PG the shards are gathered
   raw, verified in batches (``scrub_engine.verify_batch``: B1 re-encodes
   the data shards, a compare gives the mismatch bitmap, B2 + stage 2 the
   linear crcs, about 22 MiB of shards a batch) and the convicted shards
   are rebuilt through ``ECBackend._decode`` and pushed. Checked: exactly
   the flipped (object, position) pairs are convicted and every one is
   repaired, a second deep scrub and a shallow scrub are clean, every
   object reads back equal to its payload, the engines' ``device_errors``
   are 0, B1 and B2 launched at least once a verify batch in each deep
   scrub, and one gathered batch (the first with a mismatch) verifies on
   the card to the plain version's bitmap and crcs on the CPU, byte for
   byte. The ``scrub`` line prints the write wall, the deep scrub's wall
   split into gather, verify and repair, the host ms of each verify batch
   (upload, program, download), the verify program's events ms on the
   gathered batch, resident, beside its bound, shard GB verified a
   second, batches and objects a batch, and B1 and B2 launches by step
   (counts zeroed before and read after each step). It runs in a child
   process like 5c (``--scrub-phase``), which takes no profiler session,
   and it runs last. The cluster children (5c, 5e, 5f, 5g, 5h, 5d) run after
   phase 13: profiler sessions in this process after a cluster child
   have come back empty (phase 8). The ``scrub_times`` line, in
   phase 5, gives the verify program's events and profiler device ms at
   5d's batch shape (16 objects of 11 shards of 128 KiB: seeded bytes,
   their parity and one flip) beside its bound;
5e. crimson: 5c's deployment on crimson OSDs (``osd_flavor="crimson"``,
   3 reactors an OSD, each with its own memstore; the mainline
   ``ECBackend`` and the shared engine on every reactor): 512 objects of
   1 MiB (from the seed) written from 8 client threads and read back; 16
   objects' shards read from the reactor stores against the host oracles;
   OSD 3 killed (the heartbeat knobs tightened until it is marked down),
   the 512 read back degraded, OSD 3 revived with its shard stores
   (crimson has no recovery) and the 512 read again. Checked: every read
   equals its payload, B1 and B2 launched on the writes (B2 once a fused
   flush), the degraded reads reconstructed on the host twin
   (``ec_util.decode``, the reference's route for a reactor: no engine
   decode, no B1 launch), no engine errors. The ``crimson`` line prints
   the walls and GB/s, flushes and ops a flush, window depth, launches
   and dispatch telemetry (hops a client op by seam, wakeups a reply
   frame) by step and the writes' host split; the ``crimson_vs_threaded``
   line puts them beside 5c's. Runs in a child process
   (``--crimson-phase``);
5f. serving: a threaded 12-OSD ``MiniCluster`` under cephx (``auth=True``:
   tickets from the mon, every frame signed) with 5c's pool, driven by the
   degraded-serving load generator (``bench/load_gen.py``): 512 keys of
   1 MiB preloaded, then a zipfian (theta 0.99) half-read load from 8
   closed-loop clients through the ladder healthy -> kill OSD 11 ->
   degraded -> revive -> recovering -> ``wait_for_clean`` -> recovered,
   8 s a phase, every read verified against its self-describing payload,
   and a final durability sweep. Checked: the four phases each served
   ops, no acked write lost, no wrong byte, no corruption, the clean wait
   returned, B1 and B2 launched in the healthy phase. The ``serving`` line
   prints each phase's ops, MB/s, p50 and p99, error census, health brief
   and launches, the QoS verdict beside its bar (printed, not gated), and
   cephx's share of the host's busy samples. Runs in a child process
   (``--serving-phase``);
5g. mgr: first, as the child's first profiler session, an 8-flush engine
   burst (16 objects of 1 MiB a flush, window 3) under
   ``utils/tracepoints.device_trace`` (torch.profiler with CUDA activity,
   a Chrome trace under ``build/mgr_trace/``), which must list B1's and
   B2's kernels. Then 5c's pool (12 threaded OSDs on memstore, ISA k=8,
   m=3, ``backend=cuda``, ``pg_num 32``, the shared engine with its
   defaults) with ``start_mgr()`` booting the default module set
   (balancer, progress, telemetry, dashboard, health, trace, tuner) under
   ``CEPH_TPU_TUNER=1``: the tuner ticks from the mgr's loop (0.5 s,
   cool-down 3 s, hysteresis 2) on the live sensors and steps knobs
   through the ``mon`` config layer, which the engine follows through its
   observers. 512 keys of 1 MiB written from 8 client threads, then 4
   intervals of 5 s of the load generator's healthy phase (zipfian theta
   0.99, half reads, 8 closed-loop clients), the dashboard's
   ``api/health``, ``api/tuner`` and ``api/osds`` fetched over HTTP during
   the second, and every key read back and checked. Checked: no wrong or
   lost byte; every tuner knob inside its bounds at every 0.1 s sample;
   every step or revert of an engine knob landed on the engine (its
   attribute equal to the pushed value), and at least one step did; after
   ``mgr.stop()`` and clearing the ``mon`` layer the engine's four knobs
   are back to their defaults; an archived trace holds a
   ``kernel_dispatch`` span. The ``mgr`` line prints every decision (time,
   rule, knob, from, to, landed), the engine's window and flush threshold
   at each change, the deepest window depth and the flushes a slot for
   each window value, each interval's ops/s and p99, the launches by
   step, the API answers, the kept trace tree, the prometheus text's
   ``tuner_*`` and ``autopsy_*`` samples and the build ledger's hits and
   misses (the main process requires no miss: phase 2 built every
   library). Runs in a child process (``--mgr-phase``);
5h. witness: the port's lock witness and lock timing
   (``ceph_tpu_torch/analysis/lock_witness``) armed in a child process
   (``--witness-phase``) before the port's modules are imported, so every
   lock they and the deployment build (module-level ones too) is named,
   tracked and timed; then 5c's
   deployment (12 threaded OSDs on memstore, the ISA k=8,m=3
   ``backend=cuda`` pool, ``pg_num=32``, one shared engine, a 20 s grace):
   128 objects of 1 MiB written from 8 client threads through B1 + B2; a
   planted probe, ``torch.cuda.synchronize()`` under
   ``make_lock("smoke.probe")``; the highest OSD killed (the ``fast_death``
   knobs until the mon marks it down), 32 objects read degraded, the OSD
   revived and ``wait_for_clean``; every object read back and 16 objects'
   shards checked against the host oracles. Checked: the probe shows up as
   a ``device_barrier`` finding on its lock (the hook fires on real CUDA;
   the witness sees explicit waits on the card, not a copy to the host);
   no other finding outside the ``witness`` section of
   ``analysis/baseline.json``; a lock-order graph with at least one edge;
   B2 launches equal the write's fused flushes. The ``witness`` line
   prints edges, cycles, findings by kind and lock, the top 5 locks by
   total wait, by total hold and by longest wait, the top condvar
   wakeups (``dispatch`` telemetry), the walls and the launches by step;
   ``witness_vs_cluster`` prints its walls beside 5c's (5h's run with the
   wrappers on, 5c's without);
6. Clay kernels against their plain versions on the card, byte-exact: B3
   and B4 over k=8,m=4,d=11, k=4,m=2 and k=4,m=3,d=6 (virtual nodes) at
   ragged L (B3 also at 64 and 32 Ki lanes, its short form; B3 and B4 from
   a pointer one byte off alignment, their byte paths), B4 over 1- to
   4-erasure signatures, B5 over the k=8,m=4,d=11 decode-1, decode-2
   and repair matrices and a random 5% matrix at
   ragged N and at every lane count of phases 7-8 (64, 32 Ki, 256 Ki);
7. Clay main path, the repo's Clay deployment k=8, m=4, d=11 on CUDA, one
   128 MiB object (8 data chunks of 16 MiB, L = 256 KiB per sub-chunk):
   ``codec.encode`` (B3); degraded reads e=1 and e=2 through
   ``codec.decode`` (calibrated B5 vs dense), through a codec with
   ``decode_kernel=true`` (B4) and with ``CEPH_TPU_CLAY_SPARSE=always``
   (B5); a single-node repair from d=11 helpers reading 16 of 64
   sub-chunks each; ``ec_util.encode``/``decode`` on 8 objects of 1 MiB
   at stripe unit 4096. Every read must equal the data, the parity must
   equal the host layered oracle on a lane window, and kernel outputs
   must equal the plain versions at full size. Launch counts are zeroed
   before and read after this phase, B3's and B5's also by lane count
   (full size, the 32 Ki-lane calibration sample, the 64-lane ec_util
   per-stripe calls);
8. Clay times on the card (CUDA events; warm-up, then the median): B3,
   B4 and B5 at the main path's shapes (B3 also at the 64-lane
   per-stripe shape; B5 also at the decode-2 matrix's 32 Ki-lane
   calibration sample and 64-lane per-stripe shapes), each beside its
   plain version, its bound and the dense bit-sliced product on the same
   linearized matrix (the product the calibration compares against); B3
   and B5 held against their plain versions at each of those shapes, and
   B4 at full size, and timed through the entry point (``ms``, the span of
   the old designs' ``prev_ms``: B3's and B4's byte-wise, B5's
   split-nibble), through the wrapper (``wrapper_ms``) and as the
   profiler's device time of the kernel (``device_ms``), beside the
   XOR-count floor (B4's also beside its set coefficient bits); with the
   calibration's picks and timings, and a torch.profiler breakdown of one
   128 MiB ``codec.encode``;
9. B6 against its plain version on the card, byte-exact: ISA encode
   m=1..3, jerasure ``reed_sol_van`` and ``cauchy_good`` at k=8, m=3,
   decode e=1..3, at B = 1, 3, 64 and 4097 blocks of 128 words per strip,
   and the largest matrix it takes (32x128); once against the host oracle;
10. the XOR-strip main path at ISA ``reed_sol_van`` k=8, m=3 on the RS
   flush's 128 MiB batch (8 chunks of 16 MiB, strips [64, 4096, 128]
   int32): ``get_kernel(isa)(data)`` checked against the host oracle,
   degraded reads of all 56 erasure patterns of 1 to 3 chunks that lose
   data chunk 0 on survivors in strip layout, and ``encode_strips`` on the
   resident strips. B6's launch count is zeroed before and read after;
   then a torch.profiler breakdown of one host-boundary encode;
11. B6 times (CUDA events; warm-up, then the median): encode and decode
   e=1/2/3 on the resident strips, each beside its bytes bound, its
   XOR-count bound and its plain version, with B1's encode time at the
   same bytes from phase 5;
12. the plugin layer on the card: the non-regression corpus of every
   ``DEFAULT_PROFILES`` entry plus ``example`` k=8,m=1, created on the host
   with the numpy backend and checked with ``cuda`` (0 failures); LRC
   k=4,m=2,l=3 on a 64 MiB object: encode, the local repair of every
   single chunk from 3 reads, and a 2-erasure read through the global
   layer, each equal to a numpy-backend codec, with B1's launches, and a
   torch.profiler breakdown of one LRC encode.

13. a 3-flush engine burst (crcs kept, shards dropped, continuations on
   the per-key executor) under torch.profiler: device busy share, top
   device and host entries, host split, and the device time in which two
   slot streams ran at once; asserted: window depth >= 2 and that time
   > 0 (last, since a session spanning the engine's threads has been
   followed by empty sessions).

Then the ``kernels`` summary line (every number in it measured in this
run, but ``bound_ms``, which it computes from this run's inputs; the old
designs' pinned ``prev_ms`` print only in the phase lines above), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``. Any mismatch, missing GPU, failed build
or failed launch raises and exits non-zero before the last line.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import linecache
import os
import queue
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

#: published peaks of one H100 SXM (NVIDIA data sheet): device memory,
#: used only if the card does not report its memory clock and bus, and
#: the dense int8 tensor rate that bounds the bit-matrix formulation
H100_HBM_BYTES_PER_S = 3.35e12
H100_INT8_OPS_PER_S = 1979e12
#: two-input int32 operations (XOR) per second: Hopper runs 64 int32
#: lanes per SM and clock, half its float32 lanes, so a quarter of the
#: published 67e12 float32 FMA flop rate (two flops per FMA)
H100_INT32_OPS_PER_S = 67e12 / 4

K, M = 8, 3
OBJECT_BYTES = 1 << 20
OBJECTS = 128
CHUNK = 4096                       # osd_pool_erasure_code_stripe_unit default
RESIDENT_LANES = OBJECTS * OBJECT_BYTES // K     # 16 Mi bytes per shard
SEED = 20261016
#: phase 5b: the engine burst, 8 flushes of OBJECTS objects staged from 4
#: threads into an engine whose launch window holds 3 flushes
ENGINE_FLUSHES = 8
ENGINE_PRODUCERS = 4
ENGINE_WINDOW = 3
#: workers of the per-key executor that runs the continuations: their
#: store copies are bound by the host's memory rate, so on an H100 host
#: (8 cores) two land the shards as fast as four, while four slowed the
#: engine thread's launch of a flush from ~3 ms to 11-27 ms, longer than
#: a flush's device round (``python -m ceph_tpu_torch.bench.engine_callers``)
ENGINE_CALLERS = 2

#: phase 5c: the cluster, the north-star profile as an EC pool of a
#: 12-OSD MiniCluster (k+m = 11 positions and one spare), written by 8
#: client threads; two OSDs are killed for the degraded reads
CLUSTER_OSDS = 12
CLUSTER_PG_NUM = 32
CLUSTER_OBJECTS = 512
CLUSTER_CLIENTS = 8
CLUSTER_DEGRADED_WRITES = 32
CLUSTER_CHECKED = 16
CLUSTER_KILLED = (3, 7)
#: the heartbeat knobs while the two OSDs are killed: the reference's
#: ``fast_death`` fixtures (kill -> down in ~2 s)
FAST_DEATH = {"osd_heartbeat_interval": 0.25, "osd_heartbeat_grace": 1.0}
#: the grace the rest of phase 5c runs with: Ceph's default
#: ``osd_heartbeat_grace`` (the mon's beacon backstop is twice it). The
#: repo's 4 s default is scaled for small test clusters; with 12 OSDs and
#: the mon in one process, recovery traffic on an H100 host delayed live
#: OSDs' beacons past its 8 s backstop, and the mon marked 9 of them down
CLUSTER_GRACE = {"osd_heartbeat_grace": 20.0}

#: phase 5d: deep scrub, 5c's deployment on BlockStore (the durable store
#: of the BlueStore role): 512 objects of 1 MiB, then one silent bit flip
#: in each of 11 objects, object i at shard position i (8 data, 3 parity)
SCRUB_OBJECTS = 512
SCRUB_FLIP_BYTES = 4
#: objects a PG, and so a verify batch, in phase 5d (512 over 32 PGs)
SCRUB_BATCH_OBJECTS = SCRUB_OBJECTS // CLUSTER_PG_NUM

#: the repo's Clay deployment (BASELINE.json configs[3], bench.py:546):
#: q=4, t=3, nu=0, 64 sub-chunks per chunk
CLAY = {"k": "8", "m": "4", "d": "11"}
CLAY_PROFILES = [CLAY, {"k": "4", "m": "2"}, {"k": "4", "m": "3", "d": "6"}]
CLAY_L = (1, 63, 4097, 1 << 18)
#: B3 is checked also at 64 lanes (an ec_util per-stripe call) and 32 Ki,
#: both in its short form on an H100, and at full size in its full form;
#: one more case per profile reads from a pointer one byte off alignment
B3_L = (1, 63, 64, 4097, 1 << 15, 1 << 18)
#: B5 is checked also at the lane counts it runs at on the main path
#: besides full size: 64 (an ec_util per-stripe call) and 32 Ki (the
#: calibration sample), whole 16-byte words, which its column-slice form
#: takes on its 16-byte path
B5_L = (1, 63, 64, 4097, 1 << 15, 1 << 18)
CLAY_SUB = 1 << 18                 # L: bytes per sub-chunk on the main path
CLAY_OBJECT = 8 * 64 * CLAY_SUB    # one 128 MiB object, 16 MiB per chunk
CLAY_EC_OBJECTS = 8                # ec_util leg: 8 objects of 1 MiB
CLAY_WINDOW = 64                   # lanes checked against the host oracle
STRIP_CHECK_B = (1, 3, 64, 4097)   # B6 checks: blocks of 128 words a strip
LRC_OBJECT = 64 << 20              # LRC k=4,m=2,l=3: 4 chunks of 16 MiB

#: B1 is checked over these N (ragged, the 16-byte and the byte path) and
#: from a pointer one byte off alignment, with random k=8 matrices of
#: these row counts besides the RS ones (1-3 rows): together they cross
#: the 2-, 4- and 16-row templates and the two-pass case
B1_N = (1, 15, 16, 4097, 65536 + 7, 1 << 20)
B1_ROWS = (4, 5, 16, 17, 32)
#: B1 times of the split-nibble design the bit-sliced kernel replaced, ms,
#: from this script's phase 5 (NVIDIA H100 80GB HBM3, 700.00 W; through
#: the entry point), printed beside the new times as ``prev_ms``
PREV_B1_MS = {"encode": 0.1763, "decode e=1": 0.0740, "decode e=2": 0.1230}
#: B5 times of the split-nibble design the bit-sliced kernel replaced, ms,
#: from this script's phase 8 on the tree before the redesign (NVIDIA H100
#: 80GB HBM3, 700.00 W; through the entry point), printed beside the new
#: times as ``prev_ms``; the 32 Ki-lane sample shape was not timed then
PREV_B5_MS = {"decode-2": 1.1044447898864747, "decode-1": 0.5856832027435303,
              "repair": 0.21266560554504396,
              "decode-2 per-stripe": 0.5138144016265869}
#: B3 times of the byte-wise design the bit-sliced kernel replaced, ms,
#: from this script's phase 8 (NVIDIA H100 80GB HBM3, 700.00 W; through
#: the entry point), printed beside the new times as ``prev_ms``
PREV_B3_MS = {"full": 0.7168, "64 lanes": 0.1174}
#: B4 time of the byte-wise design the bit-sliced kernel replaced, ms, from
#: this script's phase 8 (NVIDIA H100 80GB HBM3, 700.00 W; through the
#: entry point), printed beside the new time as ``prev_ms``
PREV_B4_MS = 1.4534
#: B2 time of the thread-per-row design the warp-per-row kernel replaced,
#: ms, from this script's phase 5 (NVIDIA H100 80GB HBM3, 700.00 W; through
#: the entry point), printed beside the new time as ``b2_prev_ms``
PREV_B2_MS = 0.1953


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.strip().splitlines()[0]


def hbm_rate() -> tuple[float, str]:
    """Peak device-memory bytes/s from the card's memory clock and bus
    width (cuDeviceGetAttribute 36 and 37; double data rate)."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
        dev, clk, bus = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = lib.cuDeviceGet(ctypes.byref(dev), torch.cuda.current_device())
        rc |= lib.cuDeviceGetAttribute(ctypes.byref(clk), 36, dev)
        rc |= lib.cuDeviceGetAttribute(ctypes.byref(bus), 37, dev)
        if rc == 0 and clk.value > 0 and bus.value > 0:
            return (2.0 * clk.value * 1e3 * bus.value / 8,
                    f"card: {clk.value} kHz x {bus.value} bit x 2")
    except OSError:
        pass
    return H100_HBM_BYTES_PER_S, "published H100 SXM peak"


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    check(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def flush_profile(flush, phase: str = "flush_profile") -> dict:
    """Where one call's wall time goes: torch.profiler over one call of
    ``flush``; device busy = the sum of device-side activity (kernels and
    copies, one stream, so no overlap), host = top CPU ops by self time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        flush()
        wall = time.perf_counter() - t0
    return profile_report(prof, wall, phase)


def profile_report(prof, wall: float, phase: str) -> dict:
    """Device busy time and share of ``wall`` and the top device and host
    entries of a finished torch.profiler session."""
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    dev = [e for e in avgs if e.device_type == DeviceType.CUDA]
    host = [e for e in avgs if e.device_type == DeviceType.CPU]
    busy_us = sum(e.self_device_time_total for e in dev)

    def top(events, attr):
        events = sorted(events, key=lambda e: -getattr(e, attr))[:8]
        return [[e.key[:70], getattr(e, attr) / 1e3, e.count]
                for e in events]

    return {"phase": phase, "wall_ms": wall * 1e3,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "top_device_ms": top(dev, "self_device_time_total"),
            "top_host_self_ms": top(host, "self_cpu_time_total")}


# -- the device engine (kernels B1, B2 through DeviceEncodeEngine) --------

class KeyedExecutor:
    """Per-key FIFO executor, as an OSD's sharded op queue: the
    continuations of key ``k`` run in order on worker ``hash(k) %
    workers``, off the engine's retire thread."""

    def __init__(self, workers: int) -> None:
        self._queues = [queue.SimpleQueue() for _ in range(workers)]
        self._threads = [threading.Thread(target=self._work, args=(q,),
                                          daemon=True)
                         for q in self._queues]
        for th in self._threads:
            th.start()

    def dispatch(self, key, fn) -> None:
        self._queues[hash(key) % len(self._queues)].put(fn)

    @staticmethod
    def _work(q) -> None:
        while (fn := q.get()) is not None:
            fn()
            # drop the continuation before waiting: it holds its op's
            # shards, views of a flush's pinned outputs, which would stay
            # out of PyTorch's host allocator until the next op came
            del fn

    def stop(self) -> None:
        for q in self._queues:
            q.put(None)
        for th in self._threads:
            th.join()


def _engine_burst(eng, codec, sinfo, objs, producers: int, prof=None,
                  store=None, hold: bool = True):
    """Stage ``objs`` from ``producers`` threads (thread t stages objects
    t, t + producers, ... under key t). With ``hold``, the engine is held
    in a ``run_sync`` until all are staged and then released: the wall
    runs from the release to the last continuation, the engine's drain
    rate of a full queue. Without, the producers stage into the running
    engine and the wall runs from the first ``stage_encode`` to the last
    continuation. ``prof``, a torch.profiler session, records over the
    wall. Each op's continuation keeps its crcs and, given ``store``
    ([n, K, seg] and [n, M, seg] host arrays), copies its data and
    parity shards into it, as a caller that lands the shards and drops
    the engine's buffers would; the results' pinned memory then goes back
    to PyTorch's host allocator. Returns (wall s, {op: (crcs, err)},
    {key: continuation order}, [op by completion], seconds each producer
    spent in stage_encode, seconds each key's continuations spent
    copying into ``store``)."""
    gate, held = threading.Event(), threading.Event()
    if hold:
        holder = threading.Thread(
            target=eng.run_sync,
            args=(lambda: (held.set(), gate.wait(600)), 900))
        holder.start()
        check(held.wait(60), "engine never picked up the hold")
    out, order, completed = {}, {t: [] for t in range(producers)}, []
    lock, done = threading.Lock(), threading.Event()
    stage_s, store_s = [0.0] * producers, [0.0] * producers

    def producer(t):
        for i in range(t, len(objs), producers):
            def cont(shards, crcs, err, i=i):
                if store is not None and err is None:
                    t0 = time.perf_counter()
                    for j, dst in enumerate(store[0][i]):
                        dst[:] = shards[j]
                    for j, dst in enumerate(store[1][i]):
                        dst[:] = shards[K + j]
                    store_s[t] += time.perf_counter() - t0
                with lock:
                    out[i] = (crcs, err)
                    order[t].append(i)
                    completed.append(i)
                    if len(out) == len(objs):
                        done.set()
            t0 = time.perf_counter()
            eng.stage_encode(t, codec, sinfo, objs[i], cont)
            stage_s[t] += time.perf_counter() - t0

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(producers)]

    def stage_all():
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    if hold:
        stage_all()
    with prof if prof is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        if hold:
            gate.set()
        else:
            stage_all()
        check(done.wait(600), "engine burst never completed")
        wall = time.perf_counter() - t0
    if hold:
        holder.join()
    return wall, out, order, completed, stage_s, store_s


def _check_engine_store(codec, data, store, out, completed, n_obj) -> int:
    """Every op's data shards and parity in ``store`` against the host GF
    oracle, and every crc of the first and the last flush against the
    host crc32c; returns the number of crcs checked."""
    from ceph_tpu_torch.ops import gf256
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.utils import checksum
    seg = OBJECT_BYTES // K
    for o in range(n_obj):
        crcs, err = out[o]
        check(err is None and crcs is not None, f"op {o}: err {err!r}")
    for lo in range(0, n_obj, OBJECTS):
        # objects lo .. lo+127 in shard layout: op o's shard i is its
        # column slice; each op is checked against its own bytes
        dsh = np.ascontiguousarray(
            data[lo * OBJECT_BYTES:(lo + OBJECTS) * OBJECT_BYTES]
            .reshape(OBJECTS, -1, K, CHUNK).transpose(0, 2, 1, 3)
            .reshape(OBJECTS, K, seg))
        check(np.array_equal(store[0][lo:lo + OBJECTS], dsh),
              f"engine data shards of objects {lo}..")
        par = gf256.gf_matvec_chunks(
            codec.coding_matrix, np.ascontiguousarray(
                dsh.transpose(1, 0, 2)).reshape(K, -1)) \
            .reshape(M, OBJECTS, seg).transpose(1, 0, 2)
        check(np.array_equal(store[1][lo:lo + OBJECTS], par),
              f"engine parity of objects {lo}.. vs host oracle")
    crc_checked = 0
    for ops in (completed[:OBJECTS], completed[-OBJECTS:]):
        segs = np.concatenate([np.concatenate([store[0][o], store[1][o]])
                               for o in ops])
        host = checksum.crc32c_rows(segs, ec_util.HINFO_SEED)
        got = []
        for o in ops:
            hi = ec_util.HashInfo(K + M)
            hi.append_linear(0, out[o][0], seg)
            got += [hi.get_chunk_hash(i) for i in range(K + M)]
        check(got == host.tolist(), "engine shard crcs vs host crc32c")
        crc_checked += len(got)
    return crc_checked


def _data_return_probe(dev, data) -> dict:
    """How a flush's data shards come back to the host: ``finalize``
    downloads the device's shard-major copy (128 MiB more over PCIe a
    flush, timed with CUDA events), against a host transpose of the
    pinned staged batch (host clock), which moves no bytes over PCIe.
    Median of 3 each; both results must be equal."""
    nb = OBJECTS * OBJECT_BYTES
    s = nb // (K * CHUNK)
    staged = torch.empty(nb, dtype=torch.uint8, pin_memory=True)
    staged.numpy()[:] = data[:nb]
    on_dev = staged.to(dev).view(s, K, CHUNK).permute(1, 0, 2).contiguous()
    d2h = torch.empty((K, s, CHUNK), dtype=torch.uint8, pin_memory=True)
    host_t = torch.empty((K, s, CHUNK), dtype=torch.uint8, pin_memory=True)
    d2h_ms, host_ms = [], []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        d2h.copy_(on_dev, non_blocking=True)
        e1.record()
        e1.synchronize()
        d2h_ms.append(e0.elapsed_time(e1))
        t0 = time.perf_counter()
        host_t.copy_(staged.view(s, K, CHUNK).permute(1, 0, 2))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    check(torch.equal(d2h, host_t), "data shards: download vs host transpose")
    return {"bytes": nb, "download_events_ms": statistics.median(d2h_ms),
            "host_transpose_ms": statistics.median(host_ms),
            "download_runs_ms": d2h_ms, "host_transpose_runs_ms": host_ms}


def engine_phase(dev, codec, sinfo, smi, single_flush_s) -> dict:
    """Phase 5b: the write path through ``DeviceEncodeEngine`` on the card
    (see the module docstring). Returns the B1/B2 launch counts."""
    from ceph_tpu_torch.bench import engine_loop
    from ceph_tpu_torch.ops import crc32c_cuda, gf_cuda
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.device_engine import DeviceEncodeEngine
    from ceph_tpu_torch.utils.device_telemetry import telemetry

    rng = np.random.default_rng(SEED + 11)
    n_obj = ENGINE_FLUSHES * OBJECTS
    data = rng.integers(0, 256, n_obj * OBJECT_BYTES, dtype=np.uint8)
    objs = [data[i * OBJECT_BYTES:(i + 1) * OBJECT_BYTES]
            for i in range(n_obj)]
    # whether pinned stager buffers would pay: one 128 MiB buffer, made
    # and filled as the stager would, host numpy against pinned
    t0 = time.perf_counter()
    buf = np.empty(OBJECTS * OBJECT_BYTES, np.uint8)
    buf[:] = data[:len(buf)]
    numpy_fill = time.perf_counter() - t0
    t0 = time.perf_counter()
    pinned = torch.empty(OBJECTS * OBJECT_BYTES, dtype=torch.uint8,
                         pin_memory=dev.type == "cuda")
    pinned_alloc = time.perf_counter() - t0
    t0 = time.perf_counter()
    pinned.numpy()[:] = data[:len(buf)]
    pinned_fill = time.perf_counter() - t0
    del buf, pinned
    data_return = _data_return_probe(dev, data)

    def landing():
        """The shards' landing place, touched before the burst."""
        seg = OBJECT_BYTES // K
        return (np.ones((n_obj, K, seg), np.uint8),
                np.ones((n_obj, M, seg), np.uint8))

    def launches_now():
        return {"gf_matvec": gf_cuda.launches,
                "crc32c_rows": crc32c_cuda.launches}

    store = landing()
    executor = KeyedExecutor(ENGINE_CALLERS)

    def engine():
        return DeviceEncodeEngine(executor.dispatch,
                                  flush_bytes=OBJECTS * OBJECT_BYTES,
                                  window=ENGINE_WINDOW)
    try:
        # a first burst, held and landed as the drain will be, warms the
        # device allocator of the three slot streams and the pinned host
        # blocks the drain holds at once, as a running engine has them: a
        # pinned block made during the drain holds PyTorch's host
        # allocator, and the next flush's upload waits behind it
        warm = engine()
        try:
            warm_wall = _engine_burst(warm, codec, sinfo, objs,
                                      ENGINE_PRODUCERS, store=landing())[0]
        finally:
            warm.stop()
        telemetry().reset()
        with _captured_splits() as splits:
            eng = engine()
            try:
                gf_cuda.reset_launches()
                crc32c_cuda.reset_launches()
                (wall, out, order, completed, stage_s,
                 store_s) = _engine_burst(eng, codec, sinfo, objs,
                                          ENGINE_PRODUCERS, store=store)
                # degraded reads of the first flush's objects
                first = completed[:OBJECTS]
                streams = {i: np.concatenate(
                    [store[0][o, i] for o in first]) for i in range(K)}
                streams.update({K + j: np.concatenate(
                    [store[1][o, j] for o in first]) for j in range(M)})
                reads, b1_decodes = {}, 0
                for lost in ([0], [0, 1]):
                    avail = {i: streams[i] for i in range(K + M)
                             if i not in lost}
                    b1_decodes += not ec_util.xor_decodable(codec, avail,
                                                            lost)
                    t0 = time.perf_counter()
                    got = eng.decode_sync("read", codec, sinfo, avail,
                                          lost, timeout=300)
                    reads[f"e={len(lost)}"] = time.perf_counter() - t0
                    check(got is not None,
                          f"decode_sync with {lost} lost failed")
                    for i in lost:
                        check(np.array_equal(got[i], streams[i]),
                              f"engine degraded read of shard {i}, "
                              f"{lost} lost")
                launches = launches_now()
                stats = dict(eng.stats)
                stager = dict(eng._stager.stats)
            finally:
                eng.stop()
        counters = telemetry().snapshot()["counters"]
        hbm_after = telemetry().hbm_live_bytes()
        del streams
        crc_checked = _check_engine_store(codec, data, store, out,
                                          completed, n_obj)
        # the same objects staged by live producers into a running engine
        live_store = landing()
        live = engine()
        try:
            gf_cuda.reset_launches()
            crc32c_cuda.reset_launches()
            (live_wall, live_out, live_order, _done, live_stage_s,
             live_store_s) = _engine_burst(live, codec, sinfo, objs,
                                           ENGINE_PRODUCERS,
                                           store=live_store, hold=False)
            live_launches = launches_now()
            live_stats = dict(live.stats)
        finally:
            live.stop()
    finally:
        executor.stop()
    check(all(live_out[o] == out[o] for o in range(n_obj)),
          "live burst crcs or errors differ from the held burst's")
    check(np.array_equal(live_store[0], store[0]) and
          np.array_equal(live_store[1], store[1]),
          "live burst shards differ from the held burst's")
    del out, live_out, store, live_store

    split = _split_ms(splits[:ENGINE_FLUSHES])
    split["stager_copy_s"] = {
        "per_flush_mean": sum(stage_s) / ENGINE_FLUSHES * 1e3,
        "per_producer": [x * 1e3 for x in stage_s]}
    split["store_copy_s"] = {
        "per_flush_mean": sum(store_s) / ENGINE_FLUSHES * 1e3,
        "per_key": [x * 1e3 for x in store_s]}
    gbytes = n_obj * OBJECT_BYTES / 1e9
    emit({"phase": "engine", "card": smi,
          "profile": "isa reed_sol_van k=8 m=3",
          "objects": n_obj, "object_bytes": OBJECT_BYTES,
          "flush_bytes": OBJECTS * OBJECT_BYTES, "window": ENGINE_WINDOW,
          "producers": ENGINE_PRODUCERS,
          "continuations": f"per-key executor, {ENGINE_CALLERS} workers",
          "drain_wall_s": wall, "drain_GBps": gbytes / wall,
          "live_wall_s": live_wall, "live_GBps": gbytes / live_wall,
          "warm_burst_s": warm_wall,
          "phase5_single_flush_s": single_flush_s,
          "host_split_ms": split, "stats": stats, "stager": stager,
          "inflight_depth_hist": counters["engine_inflight_depth"],
          "overlap_pct_hist": counters["engine_overlap_pct"],
          "hbm_live_bytes_after": hbm_after,
          "launches": launches, "b1_decode_launches": b1_decodes,
          "parity_ops_checked": n_obj, "crc_segments_checked": crc_checked,
          "degraded_read_s": reads,
          "live": {"stats": live_stats, "launches": live_launches,
                   "stager_copy_ms_per_producer":
                       [x * 1e3 for x in live_stage_s],
                   "store_copy_ms_per_key":
                       [x * 1e3 for x in live_store_s]},
          "data_return": data_return,
          "stager_probe_ms": {"numpy_alloc_fill": numpy_fill * 1e3,
                              "pinned_alloc": pinned_alloc * 1e3,
                              "pinned_fill": pinned_fill * 1e3}})
    check(stats["flushes"] == ENGINE_FLUSHES and
          stats["ops"] == n_obj, f"engine flushes: {stats}")
    check(stats["max_inflight_depth"] >= 2,
          f"the window never held two flushes: {stats}")
    for st in (stats, live_stats):
        for key in ("errors", "device_fused_fallbacks", "host_flushes",
                    "decode_errors"):
            check(st[key] == 0, f"engine {key}: {st}")
    check(launches == {"gf_matvec": ENGINE_FLUSHES + b1_decodes,
                       "crc32c_rows": ENGINE_FLUSHES},
          f"engine kernel launches {launches}, expected B1 "
          f"{ENGINE_FLUSHES} + {b1_decodes} decodes, B2 {ENGINE_FLUSHES}")
    check(live_stats["ops"] == n_obj and
          live_launches == {"gf_matvec": live_stats["flushes"],
                            "crc32c_rows": live_stats["flushes"]},
          f"live burst launches {live_launches}: {live_stats}")
    for seqs in (order, live_order):
        for t, seq in seqs.items():
            check(seq == list(range(t, n_obj, ENGINE_PRODUCERS)),
                  f"continuation order of key {t}")

    del objs, data
    loop = engine_loop.run(device=dev, time_budget=30.0)
    emit({"phase": "engine_loop", **loop})
    return launches


# -- the OSD chain (kernels B1, B2 through ECBackend and the engine) ------

#: leaf functions of a thread that waits (lock, queue, socket, event loop
#: poll): its samples count as idle
_IDLE_LEAVES = frozenset(("wait", "acquire", "get", "select", "poll",
                          "_wait_for_tstate_lock", "sleep", "epoll",
                          "_read_from_self", "accept", "readexactly"))


#: the inclusive counts name the port's own functions only
_PORT_DIR = "/ceph_tpu_torch/"

#: text of a leaf frame's current line that blocks inside a C call, which
#: leaves no Python frame of its own (a renewal loop's ``time.sleep``, an
#: executor worker's queue wait): its samples count as idle
_IDLE_CALLS = ("time.sleep(", "work_queue.get(")


def _blocked_in_c(frame) -> bool:
    line = linecache.getline(frame.f_code.co_filename, frame.f_lineno)
    return any(call in line for call in _IDLE_CALLS)


class StackSampler:
    """The host split of a step: a thread that reads every other
    thread's Python stack every ``interval`` s (``sys._current_frames``)
    and counts, over the samples of busy threads, the thread group (the
    name without its index), the leaf function and each function on the
    stack. Shares are of busy samples; a busy sample is a thread that was
    running Python or inside a call that had not returned (a numpy or
    torch kernel, a copy, or a wait for the GIL), but not a thread whose
    line blocks in a C call (``_IDLE_CALLS``). Inclusive counts name
    the port's functions only; the per-file counts count a sample once
    for each port file on its stack."""

    def __init__(self, interval: float = 0.005) -> None:
        self.interval = interval
        self.ticks = 0
        self.busy = 0
        self.idle = 0
        self.groups: dict = {}
        self.leaves: dict = {}
        self.inclusive: dict = {}
        self.files: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stack-sampler")

    def __enter__(self) -> "StackSampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join()

    def _run(self) -> None:
        me = threading.get_ident()
        names = {}
        while not self._stop.wait(self.interval):
            self.ticks += 1
            if len(names) != threading.active_count():
                names = {t.ident: t.name for t in threading.enumerate()}
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                if frame.f_code.co_name in _IDLE_LEAVES or \
                        _blocked_in_c(frame):
                    self.idle += 1
                    continue
                self.busy += 1
                group = "".join(ch for ch in names.get(tid, "?")
                                if not ch.isdigit()).rstrip("-.")
                self.groups[group] = self.groups.get(group, 0) + 1
                leaf = _frame_name(frame)
                self.leaves[leaf] = self.leaves.get(leaf, 0) + 1
                seen, files = set(), set()
                while frame is not None:
                    name = _frame_name(frame)
                    if name not in seen and \
                            _PORT_DIR in frame.f_code.co_filename:
                        seen.add(name)
                        self.inclusive[name] = \
                            self.inclusive.get(name, 0) + 1
                        files.add(name.rsplit(":", 1)[0])
                    frame = frame.f_back
                for f in files:
                    self.files[f] = self.files.get(f, 0) + 1

    def report(self, top: int = 12) -> dict:
        def shares(counts):
            best = sorted(counts.items(), key=lambda kv: -kv[1])[:top]
            return [[name, round(n / max(self.busy, 1), 4)]
                    for name, n in best]
        return {"interval_s": self.interval, "ticks": self.ticks,
                "busy_samples": self.busy, "idle_samples": self.idle,
                "busy_threads_mean": self.busy / max(self.ticks, 1),
                "thread_groups": shares(self.groups),
                "leaf": shares(self.leaves),
                "inclusive": shares(self.inclusive),
                "files": shares(self.files)}

    def file_share(self, path: str) -> float:
        """Share of busy samples with a function of the port file
        ``path`` (``dir/name.py``) on the stack."""
        return self.files.get(path, 0) / max(self.busy, 1)


def _frame_name(frame) -> str:
    path = frame.f_code.co_filename
    mod = path.rsplit("/", 2)
    return f"{'/'.join(mod[-2:])}:{frame.f_code.co_name}"


def _threaded(fn, n_items: int, threads: int) -> float:
    """Run ``fn(i)`` for every item, item i on thread i mod ``threads``;
    returns the wall time, re-raising the first failure."""
    errs: list = []

    def run(t):
        try:
            for i in range(t, n_items, threads):
                fn(i)
        except BaseException as exc:       # re-raised below
            errs.append(exc)

    ts = [threading.Thread(target=run, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for th in ts:
        th.start()
    for th in ts:
        th.join()
    wall = time.perf_counter() - t0
    if errs:
        raise errs[0]
    return wall


@contextlib.contextmanager
def _heartbeat_knobs(conf, knobs: dict):
    """Set the heartbeat ``knobs`` for the block, then restore them. The
    mon reads them at each tick and failure report; an OSD keeps the
    interval and grace it started with."""
    old = {k: conf[k] for k in knobs}
    for key, val in knobs.items():
        conf.set(key, val)
    try:
        yield
    finally:
        for key, val in old.items():
            conf.set(key, val)


def _store_with(stores, cid: str):
    """The store holding collection ``cid``: an OSD's store, or the one
    of a crimson OSD's per-reactor stores that owns the PG."""
    if not isinstance(stores, list):
        return stores
    return next(st for st in stores if cid in st.list_collections())


def _dispatch_brief() -> dict:
    """Cross-thread hops a completed client op crossed (mean, and each
    seam's count) and client threads woken a reply frame, from the port's
    dispatch telemetry since its last reset."""
    from ceph_tpu_torch.utils.dispatch_telemetry import SEAMS, telemetry
    tel = telemetry()
    c = tel.perf.dump()
    chains = c["op_chains"]
    return {"op_chains": chains,
            "dispatch_hops_per_op": sum(c[f"ophop_{s}"] for s in SEAMS)
            / chains if chains else None,
            "hops_by_seam": {s: c[f"ophop_{s}"] for s in SEAMS
                             if c[f"ophop_{s}"]},
            "wakeups_per_frame": tel.wakeup_table()["wakeups_per_frame"]}


def _check_cluster_shards(cluster, pool_id: int, oids, pays, codec) -> int:
    """Every shard of ``oids`` read straight from its OSD's store: the data
    shards against the object's bytes, the parity against the host GF
    oracle, each ``hinfo`` crc against the host crc32c. Returns the number
    of shards checked."""
    from ceph_tpu_torch.ops import gf256
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.osd.pg import pg_cid
    from ceph_tpu_torch.utils import checksum
    osdmap = cluster.mon.osdmap
    checked = 0
    for oid in oids:
        ps = osdmap.object_to_pg(pool_id, oid)
        _, acting, _ = osdmap.pg_to_up_acting(pool_id, ps)
        shards, hinfo = {}, None
        for pos, osd in enumerate(acting):
            cid = pg_cid(pool_id, ps, pos)
            store = _store_with(cluster._stores[osd], cid)
            shards[pos] = np.frombuffer(store.read(cid, oid), np.uint8)
            attrs = store.getattrs(cid, oid)
            h = json.loads(attrs["hinfo"])
            check(hinfo is None or h == hinfo, f"{oid}: hinfo differs "
                  f"between shards")
            hinfo = h
        data = np.frombuffer(pays[oid], np.uint8)
        pad = -len(data) % (K * CHUNK)
        data = np.concatenate([data, np.zeros(pad, np.uint8)])
        want = data.reshape(-1, K, CHUNK).transpose(1, 0, 2).reshape(K, -1)
        for i in range(K):
            check(np.array_equal(shards[i], want[i]),
                  f"{oid}: data shard {i} differs from the object")
        parity = gf256.gf_matvec_chunks(codec.coding_matrix, want)
        for j in range(M):
            check(np.array_equal(shards[K + j], parity[j]),
                  f"{oid}: parity {j} differs from the host GF oracle")
        for pos, shard in shards.items():
            check(hinfo["hashes"][pos] ==
                  checksum.crc32c(shard, ec_util.HINFO_SEED),
                  f"{oid}: hinfo crc of shard {pos}")
        checked += len(shards)
    return checked


def cluster_phase(smi: str, backend: str = "cuda",
                  n_obj: int = CLUSTER_OBJECTS) -> dict:
    """Phase 5c: client writes and degraded reads of an RS k=8,m=3 pool
    through the port's OSD chain (see the module docstring). Returns the
    B1/B2 launch counts of each step; ``backend="torch"`` runs the plain
    versions (a rehearsal on the CPU, where no launch is counted)."""
    from ceph_tpu_torch.client.rados import RadosError
    from ceph_tpu_torch.models import instance
    from ceph_tpu_torch.ops import crc32c_cuda, gf_cuda
    from ceph_tpu_torch.osd.osd import ENOENT
    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.utils.config import g_conf
    from ceph_tpu_torch.utils.dispatch_telemetry import \
        telemetry as dispatch_telemetry

    on_card = backend == "cuda"
    rng = np.random.default_rng(SEED + 13)
    extra = CLUSTER_DEGRADED_WRITES
    data = rng.integers(0, 256, (n_obj + extra) * OBJECT_BYTES,
                        dtype=np.uint8)
    pays = {f"obj{i}": data[i * OBJECT_BYTES:(i + 1) * OBJECT_BYTES]
            .tobytes() for i in range(n_obj + extra)}
    del data
    oids = [f"obj{i}" for i in range(n_obj)]
    late = [f"obj{i}" for i in range(n_obj, n_obj + extra)]
    host_codec = instance().factory(
        "isa", {"k": str(K), "m": str(M), "technique": "reed_sol_van",
                "backend": "numpy"}, device="cpu")
    launches: dict = {}
    walls: dict = {}

    def reset():
        gf_cuda.reset_launches()
        crc32c_cuda.reset_launches()

    def read_back(names, io, label):
        def one(i):
            check(io.read(names[i]) == pays[names[i]],
                  f"{label} read of {names[i]}")
        return _threaded(one, len(names), CLUSTER_CLIENTS)

    host_split: dict = {}
    dispatch: dict = {}

    def step(label, fn, sampled: bool = False):
        reset()
        dispatch_telemetry().reset()
        with StackSampler() if sampled else contextlib.nullcontext() \
                as sampler:
            walls[label] = fn()
        launches[label] = {"gf_matvec": gf_cuda.launches,
                           "crc32c_rows": crc32c_cuda.launches}
        dispatch[label] = _dispatch_brief()
        if sampled:
            host_split[label] = sampler.report()

    t_boot = time.perf_counter()
    with _heartbeat_knobs(g_conf(), CLUSTER_GRACE), \
            MiniCluster(n_osds=CLUSTER_OSDS) as cluster:
        boot_s = time.perf_counter() - t_boot
        cluster.create_ec_pool("rbd_ec", k=K, m=M, plugin="isa",
                               technique="reed_sol_van",
                               pg_num=CLUSTER_PG_NUM, backend=backend)
        pool_id = cluster.mon.osdmap.pool_by_name["rbd_ec"]
        check(cluster.mon.osdmap.pools[pool_id].stripe_unit == CHUNK,
              "pool stripe unit")
        rados = cluster.client()
        io = rados.open_ioctx("rbd_ec")
        io.op_timeout = 600.0

        def write_all():
            return _threaded(lambda i: io.write_full(oids[i], pays[oids[i]]),
                             n_obj, CLUSTER_CLIENTS)

        step("write", write_all, sampled=True)
        handle = next(o._device_engine for o in cluster.osds.values()
                      if o._device_engine is not None)
        write_stats = dict(handle.stats)

        def barriers():
            t0 = time.perf_counter()
            io.write_full("ord", b"A" * 8192)
            io.append("ord", b"B" * 100)
            check(io.read("ord") == b"A" * 8192 + b"B" * 100,
                  "write_full then append through the engine barrier")
            io.write_full("gone", b"X" * 4096)
            io.remove("gone")
            try:
                io.read("gone")
                code = 0
            except RadosError as exc:
                code = exc.code
            check(code == ENOENT, f"write then remove: read gave {code}")
            return time.perf_counter() - t0

        step("barriers", barriers)
        step("read", lambda: read_back(oids, io, "clean"), sampled=True)
        stats = dict(handle.stats)
        check(stats["ops"] >= n_obj, f"engine ops {stats['ops']} < {n_obj}")
        check(stats["max_batch_ops"] > 1, f"no batching: {stats}")
        check(stats["errors"] == 0, f"engine errors: {stats}")
        fused = write_stats["flushes"] - write_stats["host_flushes"]
        if on_card:
            w = launches["write"]
            check(w["gf_matvec"] > 0 and w["crc32c_rows"] > 0,
                  f"write launches {w}")
            check(w["crc32c_rows"] == fused,
                  f"B2 launches {w['crc32c_rows']} != fused flushes {fused}")
        # 16 objects in 16 different PGs, every shard from its store
        osdmap = cluster.mon.osdmap
        picked, seen = [], set()
        for oid in oids:
            ps = osdmap.object_to_pg(pool_id, oid)
            if ps not in seen:
                seen.add(ps)
                picked.append(oid)
            if len(picked) == CLUSTER_CHECKED:
                break
        shards_checked = _check_cluster_shards(cluster, pool_id, picked,
                                               pays, host_codec)

        # -- degraded: two OSDs killed --------------------------------
        # PGs whose data positions lose two shards: not XOR-decodable,
        # so their reads decode through B1 (the acting sets the shards
        # were written to, before the kill)
        lost_two_data = 0
        for ps in range(CLUSTER_PG_NUM):
            _, acting, _ = osdmap.pg_to_up_acting(pool_id, ps)
            lost_two_data += sum(1 for osd in acting[:K]
                                 if osd in CLUSTER_KILLED) >= 2
        epoch = cluster.epoch()
        t0 = time.perf_counter()
        with _heartbeat_knobs(g_conf(), FAST_DEATH):
            for osd in CLUSTER_KILLED:
                cluster.kill_osd(osd)
            for osd in CLUSTER_KILLED:
                cluster.wait_for_osd_down(osd, timeout=60)
        down_s = time.perf_counter() - t0
        rados.wait_for_epoch(epoch + 1, timeout=30)
        before = dict(handle.stats)
        step("degraded_read", lambda: read_back(oids, io, "degraded"),
             sampled=True)
        after = dict(handle.stats)
        decode_ops = after["decode_ops"] - before["decode_ops"]
        check(decode_ops > 0, f"no decode through the engine: {after}")
        check(after["decode_errors"] == 0, f"decode errors: {after}")
        if on_card:
            check(launches["degraded_read"]["gf_matvec"] > 0,
                  f"no B1 decode launch: {launches['degraded_read']}")

        def degraded_writes():
            t0 = time.perf_counter()
            _threaded(lambda i: io.write_full(late[i], pays[late[i]]),
                      extra, CLUSTER_CLIENTS)
            read_back(late, io, "degraded-written")
            return time.perf_counter() - t0

        step("degraded_write", degraded_writes, sampled=True)

        # -- recovery ----------------------------------------------------
        def recover():
            t0 = time.perf_counter()
            for osd in CLUSTER_KILLED:
                cluster.revive_osd(osd)
            cluster.wait_for_osds_up(timeout=60)
            cluster.wait_for_clean(timeout=600)
            return time.perf_counter() - t0

        before_rec = dict(handle.stats)
        step("recovery", recover, sampled=True)
        rec_stats = dict(handle.stats)
        rec_bytes = rec_stats["decode_bytes"] - before_rec["decode_bytes"]
        step("final_read", lambda: read_back(oids + late, io, "final"))
        final = dict(handle.stats)
        check(final["errors"] == 0 and final["decode_errors"] == 0,
              f"engine errors after recovery: {final}")

    gb = n_obj * OBJECT_BYTES / 1e9
    flushes = final["flushes"]
    out = {"phase": "cluster", "card": smi, "backend": backend,
           "profile": "isa reed_sol_van k=8 m=3, stripe unit 4096",
           "osds": CLUSTER_OSDS, "pg_num": CLUSTER_PG_NUM,
           "objects": n_obj, "object_bytes": OBJECT_BYTES,
           "clients": CLUSTER_CLIENTS, "killed": list(CLUSTER_KILLED),
           "heartbeat": {**CLUSTER_GRACE, "while_killing": FAST_DEATH},
           "boot_s": boot_s,
           "write_s": walls["write"], "write_GBps": gb / walls["write"],
           "barriers_s": walls["barriers"],
           "read_s": walls["read"], "read_GBps": gb / walls["read"],
           "down_s": down_s, "pgs_lost_two_data": lost_two_data,
           "degraded_read_s": walls["degraded_read"],
           "degraded_read_GBps": gb / walls["degraded_read"],
           "degraded_writes": extra,
           "degraded_write_read_s": walls["degraded_write"],
           "recovery_s": walls["recovery"],
           "recovery_decode_ops": rec_stats["decode_ops"]
           - before_rec["decode_ops"],
           # the surviving shard bytes the recovery decoded from, through
           # the engine (its decode_bytes)
           "recovery_decode_bytes": rec_bytes,
           "recovery_GBps": rec_bytes / 1e9 / walls["recovery"],
           "final_read_s": walls["final_read"],
           "final_read_GBps": (n_obj + extra) * OBJECT_BYTES / 1e9
           / walls["final_read"],
           "flushes": flushes, "host_flushes": final["host_flushes"],
           "ops_per_flush": final["ops"] / max(flushes, 1),
           "write_flushes": write_stats["flushes"],
           "write_ops_per_flush": write_stats["ops"]
           / max(write_stats["flushes"], 1),
           "max_batch_ops": final["max_batch_ops"],
           "window_depth_max": final["max_inflight_depth"],
           "degraded_decode_ops": decode_ops,
           "decode_flushes": final["decode_flushes"],
           "decode_ops": final["decode_ops"],
           "shards_checked": shards_checked, "launches": launches,
           "dispatch": dispatch, "stats": final, "host_split": host_split}
    emit(out)
    return launches


def _engine_handle(cluster):
    """The shared engine's handle of any OSD attached to it (a threaded
    OSD's, or a crimson reactor's)."""
    for osd in cluster.osds.values():
        handle = getattr(osd, "_device_engine", None)
        if handle is not None:
            return handle
        for reactor in getattr(osd, "reactors", ()):
            if reactor.services._engine is not None:
                return reactor.services._engine
    raise AssertionError("no OSD attached to the device engine")


@contextlib.contextmanager
def _fast_death_kill(cluster, conf):
    """Tighten the heartbeat knobs (``FAST_DEATH``) from an OSD's kill
    until the mon marks it down, as phase 5c does around its kill, for a
    load that kills inside its own run (the load generator): the
    cluster's ``kill_osd`` sets them and ``wait_for_osd_down`` restores
    them."""
    kill, wait_down = cluster.kill_osd, cluster.wait_for_osd_down
    old = {k: conf[k] for k in FAST_DEATH}

    def restore():
        for key, val in old.items():
            conf.set(key, val)

    def kill_fast(osd_id):
        for key, val in FAST_DEATH.items():
            conf.set(key, val)
        kill(osd_id)

    def wait_down_then_restore(osd_id, timeout=30.0):
        try:
            wait_down(osd_id, timeout=max(timeout, 60))
        finally:
            restore()

    cluster.kill_osd = kill_fast
    cluster.wait_for_osd_down = wait_down_then_restore
    try:
        yield
    finally:
        cluster.kill_osd, cluster.wait_for_osd_down = kill, wait_down
        restore()


#: the OSD phase 5e kills (crimson has no recovery: it is revived and
#: read again)
CRIMSON_KILLED = CLUSTER_KILLED[0]


def crimson_vs_threaded(crimson: dict, threaded: dict, smi: str) -> dict:
    """Phase 5e's steps beside phase 5c's (the same 12-OSD pool, 512 x 1
    MiB from 8 clients; 5c kills two OSDs, 5e one): walls and GB/s,
    flushes and ops a flush, window depth, and the dispatch telemetry's
    hops a client op and wakeups a reply frame."""
    def side(line):
        return {
            "osd_flavor": line.get("osd_flavor", "threaded"),
            **{key: line[key] for key in
               ("write_s", "write_GBps", "read_s", "read_GBps",
                "degraded_read_s", "degraded_read_GBps", "write_flushes",
                "write_ops_per_flush", "window_depth_max")},
            "killed": line["killed"],
            "dispatch": {step: {key: d[key] for key in
                                ("dispatch_hops_per_op", "hops_by_seam",
                                 "wakeups_per_frame")}
                         for step, d in line["dispatch"].items()
                         if step in ("write", "read", "degraded_read")},
            "write_thread_groups":
                line["host_split"]["write"]["thread_groups"][:6]}
    return {"phase": "crimson_vs_threaded", "card": smi,
            "crimson": side(crimson), "threaded": side(threaded)}


def crimson_phase(smi: str, backend: str = "cuda",
                  n_obj: int = CLUSTER_OBJECTS) -> dict:
    """Phase 5e: phase 5c's deployment on crimson OSDs (see the module
    docstring). Returns the B1/B2 launch counts of each step;
    ``backend="torch"`` runs the plain versions (a rehearsal on the CPU,
    where no launch is counted)."""
    from ceph_tpu_torch.models import instance
    from ceph_tpu_torch.ops import crc32c_cuda, gf_cuda
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.utils.config import g_conf
    from ceph_tpu_torch.utils.dispatch_telemetry import \
        telemetry as dispatch_telemetry

    on_card = backend == "cuda"
    rng = np.random.default_rng(SEED + 14)
    data = rng.integers(0, 256, n_obj * OBJECT_BYTES, dtype=np.uint8)
    pays = {f"obj{i}": data[i * OBJECT_BYTES:(i + 1) * OBJECT_BYTES]
            .tobytes() for i in range(n_obj)}
    del data
    oids = list(pays)
    host_codec = instance().factory(
        "isa", {"k": str(K), "m": str(M), "technique": "reed_sol_van",
                "backend": "numpy"}, device="cpu")
    launches: dict = {}
    walls: dict = {}
    dispatch: dict = {}
    host_split: dict = {}
    decodes: list = []
    real_decode = ec_util.decode

    def counted_decode(*args, **kwargs):
        decodes.append(1)
        return real_decode(*args, **kwargs)

    def step(label, fn, sampled: bool = False):
        gf_cuda.reset_launches()
        crc32c_cuda.reset_launches()
        dispatch_telemetry().reset()
        with StackSampler() if sampled else contextlib.nullcontext() \
                as sampler:
            walls[label] = fn()
        launches[label] = {"gf_matvec": gf_cuda.launches,
                           "crc32c_rows": crc32c_cuda.launches}
        dispatch[label] = _dispatch_brief()
        if sampled:
            host_split[label] = sampler.report()

    def read_back(label):
        def one(i):
            check(io.read(oids[i]) == pays[oids[i]],
                  f"crimson {label} read of {oids[i]}")
        return _threaded(one, n_obj, CLUSTER_CLIENTS)

    t_boot = time.perf_counter()
    with _heartbeat_knobs(g_conf(), CLUSTER_GRACE), \
            MiniCluster(n_osds=CLUSTER_OSDS, osd_flavor="crimson") as cluster:
        boot_s = time.perf_counter() - t_boot
        smp = cluster.osds[0].smp
        cluster.create_ec_pool("rbd_ec", k=K, m=M, plugin="isa",
                               technique="reed_sol_van",
                               pg_num=CLUSTER_PG_NUM, backend=backend)
        pool_id = cluster.mon.osdmap.pool_by_name["rbd_ec"]
        rados = cluster.client()
        io = rados.open_ioctx("rbd_ec")
        io.op_timeout = 600.0

        def write_all():
            return _threaded(lambda i: io.write_full(oids[i], pays[oids[i]]),
                             n_obj, CLUSTER_CLIENTS)

        step("write", write_all, sampled=True)
        handle = _engine_handle(cluster)
        write_stats = dict(handle.stats)
        check(write_stats["ops"] >= n_obj,
              f"engine ops {write_stats['ops']} < {n_obj}")
        check(write_stats["errors"] == 0, f"engine errors: {write_stats}")
        fused = write_stats["flushes"] - write_stats["host_flushes"]
        if on_card:
            w = launches["write"]
            check(w["gf_matvec"] > 0 and w["crc32c_rows"] > 0,
                  f"crimson write launches {w}")
            check(w["crc32c_rows"] == fused,
                  f"B2 launches {w['crc32c_rows']} != fused flushes {fused}")
        step("read", lambda: read_back("clean"), sampled=True)
        osdmap = cluster.mon.osdmap
        picked, seen = [], set()
        for oid in oids:
            ps = osdmap.object_to_pg(pool_id, oid)
            if ps not in seen:
                seen.add(ps)
                picked.append(oid)
            if len(picked) == CLUSTER_CHECKED:
                break
        shards_checked = _check_cluster_shards(cluster, pool_id, picked,
                                               pays, host_codec)
        lost_data = sum(
            1 for ps in range(CLUSTER_PG_NUM)
            if CRIMSON_KILLED in osdmap.pg_to_up_acting(pool_id, ps)[1][:K])

        # -- one OSD killed: degraded reads on the host twin ------------
        epoch = cluster.epoch()
        t0 = time.perf_counter()
        with _heartbeat_knobs(g_conf(), FAST_DEATH):
            cluster.kill_osd(CRIMSON_KILLED)
            cluster.wait_for_osd_down(CRIMSON_KILLED, timeout=60)
        down_s = time.perf_counter() - t0
        rados.wait_for_epoch(epoch + 1, timeout=30)
        before = dict(handle.stats)
        ec_util.decode = counted_decode
        try:
            step("degraded_read", lambda: read_back("degraded"),
                 sampled=True)
        finally:
            ec_util.decode = real_decode
        after = dict(handle.stats)
        host_decodes = len(decodes)
        check(host_decodes > 0, "no degraded read reconstructed")
        check(after["decode_ops"] == before["decode_ops"],
              f"crimson decoded through the engine: {after}")
        if on_card:
            check(launches["degraded_read"]["gf_matvec"] == 0,
                  f"B1 launched on crimson's degraded reads (the host "
                  f"twin's route): {launches['degraded_read']}")

        # -- revived: the killed OSD's shard stores come back -------------
        def revive():
            t0 = time.perf_counter()
            cluster.revive_osd(CRIMSON_KILLED)
            cluster.wait_for_osds_up(timeout=60)
            return time.perf_counter() - t0

        step("revive", revive)
        step("revived_read", lambda: read_back("revived"))
        final = dict(handle.stats)
        check(final["errors"] == 0 and final["decode_errors"] == 0,
              f"engine errors: {final}")

    gb = n_obj * OBJECT_BYTES / 1e9
    flushes = write_stats["flushes"]
    out = {"phase": "crimson", "card": smi, "backend": backend,
           "profile": "isa reed_sol_van k=8 m=3, stripe unit 4096",
           "osds": CLUSTER_OSDS, "osd_flavor": "crimson", "smp": smp,
           "pg_num": CLUSTER_PG_NUM, "objects": n_obj,
           "object_bytes": OBJECT_BYTES, "clients": CLUSTER_CLIENTS,
           "killed": CRIMSON_KILLED,
           "heartbeat": {**CLUSTER_GRACE, "while_killing": FAST_DEATH},
           "boot_s": boot_s,
           "write_s": walls["write"], "write_GBps": gb / walls["write"],
           "read_s": walls["read"], "read_GBps": gb / walls["read"],
           "down_s": down_s, "pgs_lost_a_data_shard": lost_data,
           "degraded_read_s": walls["degraded_read"],
           "degraded_read_GBps": gb / walls["degraded_read"],
           "degraded_read_route": "host twin (ec_util.decode on the "
           "host codec, the reference's route: no B1)",
           "degraded_host_decodes": host_decodes,
           "revive_s": walls["revive"],
           "revived_read_s": walls["revived_read"],
           "revived_read_GBps": gb / walls["revived_read"],
           "write_flushes": flushes,
           "write_host_flushes": write_stats["host_flushes"],
           "write_ops_per_flush": write_stats["ops"] / max(flushes, 1),
           "max_batch_ops": write_stats["max_batch_ops"],
           "window_depth_max": final["max_inflight_depth"],
           "shards_checked": shards_checked, "launches": launches,
           "dispatch": dispatch, "stats": final, "host_split": host_split}
    emit(out)
    return out


#: phase 5f's load: the reference load generator's degraded-serving
#: ladder at 5c's object size and client count
SERVING_KEYS = 512
SERVING_PHASE_S = 8.0
SERVING_READ_FRAC = 0.5
SERVING_THETA = 0.99


def serving_phase(smi: str, backend: str = "cuda",
                  n_keys: int = SERVING_KEYS,
                  phase_s: float = SERVING_PHASE_S) -> dict:
    """Phase 5f: degraded serving under cephx (see the module docstring).
    Returns the load generator's report with the B1/B2 launches of each
    ladder phase; ``backend="torch"`` runs the plain versions (a
    rehearsal on the CPU, where no launch is counted)."""
    from ceph_tpu_torch.bench.load_gen import LoadGen, LoadSpec
    from ceph_tpu_torch.ops import crc32c_cuda, gf_cuda
    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.utils.config import g_conf

    on_card = backend == "cuda"
    launches: dict = {}
    t_boot = time.perf_counter()
    with _heartbeat_knobs(g_conf(), CLUSTER_GRACE), \
            MiniCluster(n_osds=CLUSTER_OSDS, auth=True) as cluster:
        boot_s = time.perf_counter() - t_boot
        check(cluster.keyring is not None, "cluster booted without cephx")
        cluster.faults.reseed(SEED)
        cluster.create_ec_pool("rbd_ec", k=K, m=M, plugin="isa",
                               technique="reed_sol_van",
                               pg_num=CLUSTER_PG_NUM, backend=backend)
        spec = LoadSpec(n_keys=n_keys, obj_size=OBJECT_BYTES,
                        read_frac=SERVING_READ_FRAC,
                        concurrency=CLUSTER_CLIENTS, phase_seconds=phase_s,
                        seed=SEED, zipf_theta=SERVING_THETA,
                        op_timeout=600.0)
        gen = LoadGen(cluster, "rbd_ec", spec)
        real_preload, real_phase = gen.preload, gen._run_phase

        def counted(label, fn, *args, **kwargs):
            gf_cuda.reset_launches()
            crc32c_cuda.reset_launches()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                launches[label] = {"gf_matvec": gf_cuda.launches,
                                   "crc32c_rows": crc32c_cuda.launches,
                                   "wall_s": time.perf_counter() - t0}

        gen.preload = lambda: counted("preload", real_preload)
        gen._run_phase = lambda name, *a, **kw: counted(
            name, real_phase, name, *a, **kw)
        t0 = time.perf_counter()
        with _fast_death_kill(cluster, g_conf()), StackSampler() as sampler:
            report = gen.run(clean_timeout=600.0)
        run_s = time.perf_counter() - t0
        stats = dict(_engine_handle(cluster).stats)

    phases = report["phases"]
    names = [p["phase"] for p in phases]
    check(names == ["healthy", "degraded", "recovering", "recovered"],
          f"ladder phases {names}")
    for p in phases:
        check(p["ops"] > 0, f"phase {p['phase']} served no op")
    verify = report["verify"]
    for key in ("lost_acked", "wrong_bytes", "corruptions"):
        check(verify[key] == [], f"durability sweep: {key} {verify[key][:3]}")
    check(stats["errors"] == 0 and stats["decode_errors"] == 0,
          f"engine errors: {stats}")
    if on_card:
        h = launches["healthy"]
        check(h["gf_matvec"] > 0 and h["crc32c_rows"] > 0,
              f"healthy-phase launches {h}")
    victim = CLUSTER_OSDS - 1
    out = {"phase": "serving", "card": smi, "backend": backend,
           "profile": "isa reed_sol_van k=8 m=3, stripe unit 4096",
           "osds": CLUSTER_OSDS, "auth": "cephx", "pg_num": CLUSTER_PG_NUM,
           "spec": report["spec"], "victim": victim,
           "heartbeat": {**CLUSTER_GRACE, "while_killing": FAST_DEATH},
           "boot_s": boot_s, "run_s": run_s,
           "preload": launches["preload"],
           "phases": [{key: p[key] for key in
                       ("phase", "seconds", "ops", "ops_per_s", "MBps",
                        "p50_ms", "p99_ms", "errors", "error_kinds",
                        "mode", "health")}
                      | {"launches": launches[p["phase"]]}
                      for p in phases],
           "qos": report["qos"],
           "verify": {"acked_keys": verify["acked_keys"],
                      **{key: verify[key] for key in
                         ("lost_acked", "wrong_bytes", "corruptions")}},
           "fault_log": report["fault_log"],
           "engine": {key: stats[key] for key in
                      ("flushes", "host_flushes", "ops", "decode_flushes",
                       "decode_ops", "max_inflight_depth")},
           "cephx_share_of_busy_samples":
               sampler.file_share("parallel/auth.py"),
           "host_split": sampler.report()}
    emit(out)
    return out


#: phase 5g: the mgr's default module set with the closed-loop tuner live
#: over 5c's pool: 512 keys of 1 MiB written from 8 client threads, then
#: the load generator's healthy phase (zipfian theta 0.99, half reads, 8
#: closed-loop clients) for MGR_INTERVALS intervals of MGR_INTERVAL_S
MGR_INTERVALS = 4
MGR_INTERVAL_S = 5.0
#: the device_trace burst: 8 flushes of 16 objects of 1 MiB
MGR_TRACE_FLUSHES = 8
MGR_TRACE_OBJECTS = 16
#: where device_trace writes its Chrome trace (gitignored)
MGR_TRACE_DIR = Path(__file__).resolve().parent / "build" / "mgr_trace"
#: the engine knobs the tuner steps and the engine attribute of each
ENGINE_KNOBS = {"engine_window": "_window",
                "engine_flush_bytes": "_flush_bytes",
                "mesh_flush_bytes": "_mesh_flush_bytes",
                "host_flush_bytes": "_host_flush_bytes"}


def _traced_burst(dev, codec, sinfo) -> dict:
    """An 8-flush engine burst (held, then released) under
    ``utils/tracepoints.device_trace``, the first profiler session of
    the process. Returns the device kernels it lists and the launches."""
    from ceph_tpu_torch.ops import crc32c_cuda, gf_cuda
    from ceph_tpu_torch.osd.device_engine import DeviceEncodeEngine
    from ceph_tpu_torch.utils.tracepoints import device_trace
    rng = np.random.default_rng(SEED + 15)
    n = MGR_TRACE_FLUSHES * MGR_TRACE_OBJECTS
    batch = rng.integers(0, 256, n * OBJECT_BYTES, dtype=np.uint8)
    objs = [batch[i * OBJECT_BYTES:(i + 1) * OBJECT_BYTES]
            for i in range(n)]
    executor = KeyedExecutor(ENGINE_CALLERS)
    eng = DeviceEncodeEngine(executor.dispatch, window=ENGINE_WINDOW,
                             flush_bytes=MGR_TRACE_OBJECTS * OBJECT_BYTES)
    trace = device_trace(str(MGR_TRACE_DIR), device=dev.type)
    gf_cuda.reset_launches()
    crc32c_cuda.reset_launches()
    try:
        wall, out, _o, _c, _s, _st = _engine_burst(
            eng, codec, sinfo, objs, 1, prof=trace)
    finally:
        eng.stop()
        executor.stop()
    check(all(err is None for _crcs, err in out.values()),
          "traced burst: an op failed")
    check(eng.stats["flushes"] == MGR_TRACE_FLUSHES,
          f"traced burst flushes {eng.stats['flushes']}")
    names = trace.kernel_names()
    ours = {n: c for n, c in names.items()
            if "gf_matvec_kernel" in n or "crc32c_rows_kernel" in n}
    return {"wall_s": wall, "flushes": eng.stats["flushes"],
            "trace": trace.path,
            "trace_bytes": os.path.getsize(trace.path),
            "kernels": ours, "other_kernels": len(names) - len(ours),
            "launches": {"gf_matvec": gf_cuda.launches,
                         "crc32c_rows": crc32c_cuda.launches}}


class _RecordedSensors:
    """The tuner's live sensors, each snapshot kept for the phase line."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.snaps: list = []

    def sample(self) -> dict:
        snap = self.inner.sample()
        self.snaps.append(snap)
        return snap

    def brief(self) -> dict:
        """Why ``window_grow`` (inflight >= window) and ``flush_shrink``
        (occupancy <= 2 and a mean flush under a quarter of the cap) did
        or did not fire: how many ticks met each condition, the longest
        run of such ticks, and the sensors' spread."""
        def runs(flags):
            best = cur = 0
            for f in flags:
                cur = cur + 1 if f else 0
                best = max(best, cur)
            return {"ticks": sum(flags), "longest_run": best}
        snaps = self.snaps
        inflight = [int(s.get("inflight", 0)) for s in snaps]
        occ = [s.get("occupancy", 0) for s in snaps]
        fbm = [s.get("flush_bytes_mean", 0) for s in snaps]
        return {"ticks": len(snaps),
                "inflight_at_tick": {str(v): inflight.count(v)
                                     for v in sorted(set(inflight))},
                "window_full": runs([s.get("window", 0) > 0 and
                                     s.get("inflight", 0) >= s["window"]
                                     for s in snaps]),
                "occupancy_max": max(occ, default=0),
                "occupancy_median": statistics.median(occ) if occ else 0,
                "flush_bytes_mean_median":
                    statistics.median(fbm) if fbm else 0}


def _http_json(url: str) -> dict:
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def _api_brief(url: str) -> dict:
    """What the dashboard's ``api/health``, ``api/tuner`` and
    ``api/osds`` answer over HTTP, cut to their gist."""
    health = _http_json(url + "api/health")
    tuner = _http_json(url + "api/tuner")
    osds = _http_json(url + "api/osds")
    return {"health": {"status": health["status"],
                       "checks": sorted(health["checks"])},
            "tuner": {"enabled": tuner["enabled"],
                      "pending": tuner.get("pending"),
                      "counters": tuner.get("counters"),
                      "knobs": {k: v["value"]
                                for k, v in tuner["knobs"].items()},
                      "history": [
                          (d["kind"], d.get("rule"), d.get("knob"),
                           d.get("from"), d.get("to"))
                          for d in tuner.get("history", [])][-8:]},
            "osds": {"count": len(osds),
                     "up": sum(v["up"] for v in osds.values()),
                     "in": sum(v["in"] for v in osds.values())}}


def _span_brief(node: dict) -> dict:
    return {"name": node["name"], "service": node["service"],
            "ms": round(node["duration"] * 1e3, 3),
            "children": [_span_brief(c) for c in node["children"]]}


def _kept_tree_with(trace_mod, span_name: str) -> dict | None:
    """One archived trace tree of the mgr trace module that holds a span
    named ``span_name``, compacted to names, services and ms."""
    from ceph_tpu_torch.mgr.trace import assemble
    trace_mod.pull_now()
    for row in trace_mod.archive.rows():
        rec = trace_mod.archive.get(row["trace_id"])
        if any(sp["name"] == span_name for sp in rec["spans"]):
            tree = assemble(rec)
            return {k: tree[k] for k in ("trace_id", "reason", "root",
                                         "duration_ms", "num_spans")} | \
                {"tree": [_span_brief(n) for n in tree["tree"]]}
    return None


def _preload_threaded(gen, threads: int) -> float:
    """``LoadGen.preload`` from ``threads`` client threads: token-0 writes
    of every key, recorded as issued and acked for the durability sweep."""
    from ceph_tpu_torch.bench.load_gen import payload_for

    def one(r):
        key = f"lg_{r:05d}"
        tok = gen._take_token()
        with gen.state.lock:
            gen.state.issued.setdefault(key, []).append(tok)
        gen.io.write_full(key, payload_for(key, tok, gen.spec.obj_size))
        with gen.state.lock:
            gen.state.acked.setdefault(key, []).append(tok)
    return _threaded(one, gen.spec.n_keys, threads)


def _verify_threaded(gen, threads: int) -> dict:
    """``LoadGen.final_verify`` from ``threads`` client threads: every key
    with an acked write reads back bit-exact with an issued token."""
    from ceph_tpu_torch.bench.load_gen import verify_payload
    with gen.state.lock:
        acked = sorted(k for k, v in gen.state.acked.items() if v)
        issued = {k: set(v) for k, v in gen.state.issued.items()}
        corruptions = list(gen.state.corruptions)
    lost, wrong = [], []

    def one(i):
        key = acked[i]
        try:
            k, tok = verify_payload(gen.io.read(key))
            if k != key or tok not in issued.get(key, ()):
                wrong.append(f"{key}: read back ({k}, {tok})")
        except Exception as exc:
            lost.append(f"{key}: {type(exc).__name__}: {exc}")
    wall = _threaded(one, len(acked), threads)
    return {"acked_keys": len(acked), "lost_acked": lost,
            "wrong_bytes": wrong, "corruptions": corruptions,
            "wall_s": wall}


def mgr_phase(smi: str, backend: str = "cuda",
              n_keys: int = CLUSTER_OBJECTS,
              intervals: int = MGR_INTERVALS,
              interval_s: float = MGR_INTERVAL_S) -> dict:
    """Phase 5g: the mgr's default module set with the closed-loop tuner
    live over 5c's pool (see the module docstring). Returns the phase
    line; ``backend="torch"`` runs the plain versions on the CPU (a
    rehearsal: no trace burst, no launch counted)."""
    from ceph_tpu_torch.bench.load_gen import LoadGen, LoadSpec
    from ceph_tpu_torch.mgr.mgr import DEFAULT_MODULES
    from ceph_tpu_torch.models import instance
    from ceph_tpu_torch.ops import crc32c_cuda, gf_cuda
    from ceph_tpu_torch.osd import device_engine as de
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.utils import autopsy, compile_cache, prometheus
    from ceph_tpu_torch.utils.config import g_conf
    from ceph_tpu_torch.utils.device_telemetry import telemetry
    from ceph_tpu_torch.utils.knobs import TUNER_KNOBS

    on_card = backend == "cuda"
    t_phase = time.perf_counter()
    traced = None
    if on_card:
        dev = torch.device("cuda", 0)
        codec = instance().factory(
            "isa", {"k": str(K), "m": str(M), "technique": "reed_sol_van"},
            device=dev)
        sinfo = ec_util.StripeInfo(stripe_width=K * CHUNK, chunk_size=CHUNK)
        traced = _traced_burst(dev, codec, sinfo)
        kernels = traced["kernels"]
        check(any("gf_matvec_kernel" in k for k in kernels),
              f"device_trace lists no B1 kernel: {sorted(kernels)}")
        check(any("crc32c_rows_kernel" in k for k in kernels),
              f"device_trace lists no B2 kernel: {sorted(kernels)}")
    ledger = {key: telemetry().perf.dump()[key]
              for key in ("compile_cache_hits", "compile_cache_misses")}
    autopsy.store()               # its counters ride the prometheus text

    launches: dict = {}
    walls: dict = {}
    samples: list = []            # (t, window, flush_bytes)
    decisions: list = []
    stop = threading.Event()
    t0 = time.perf_counter()

    def engine():
        return de._shared_engine

    sampler_errs: list = []

    def sampler():
        try:
            while not stop.wait(0.1):
                eng = engine()
                conf = g_conf()
                for knob in TUNER_KNOBS:
                    val = conf[knob.name]
                    check(knob.lo <= val <= knob.hi,
                          f"knob {knob.name} = {val} out of bounds")
                if eng is not None:
                    point = (round(time.perf_counter() - t0, 2),
                             eng._window, eng._flush_bytes)
                    if not samples or samples[-1][1:] != point[1:]:
                        samples.append(point)
        except BaseException as exc:       # re-raised after the join
            sampler_errs.append(exc)

    def counted(label, fn):
        gf_cuda.reset_launches()
        crc32c_cuda.reset_launches()
        try:
            walls[label] = fn()
        finally:
            launches[label] = {"gf_matvec": gf_cuda.launches,
                               "crc32c_rows": crc32c_cuda.launches}

    old_env = os.environ.get("CEPH_TPU_TUNER")
    os.environ["CEPH_TPU_TUNER"] = "1"
    watcher = threading.Thread(target=sampler, daemon=True)
    try:
        t_boot = time.perf_counter()
        with _heartbeat_knobs(g_conf(), CLUSTER_GRACE), \
                MiniCluster(n_osds=CLUSTER_OSDS) as cluster:
            cluster.create_ec_pool("rbd_ec", k=K, m=M, plugin="isa",
                                   technique="reed_sol_van",
                                   pg_num=CLUSTER_PG_NUM, backend=backend)
            mgr = cluster.start_mgr()
            boot_s = time.perf_counter() - t_boot
            check(tuple(mgr.modules) == DEFAULT_MODULES,
                  f"mgr modules {list(mgr.modules)}")
            tuner = mgr.modules["tuner"].engine
            check(tuner is not None, "tuner off with CEPH_TPU_TUNER=1")
            sensors = tuner._sensors = _RecordedSensors(tuner._sensors)
            real_decide = tuner._decide

            def decide(kind, **fields):
                # did a push of an engine knob land on the engine?
                rec = real_decide(kind, **fields)
                attr = ENGINE_KNOBS.get(rec.get("knob"))
                eng = engine()
                landed = None
                if attr is not None and kind in ("step", "revert") \
                        and eng is not None:
                    landed = getattr(eng, attr) == rec["to"]
                decisions.append({
                    "t": round(time.perf_counter() - t0, 2),
                    "kind": kind, "rule": rec.get("rule"),
                    "knob": rec.get("knob"), "from": rec.get("from"),
                    "to": rec.get("to"), "landed": landed})
                return rec
            tuner._decide = decide
            code, msg, _ = mgr.modules["dashboard"].handle_command(
                {"prefix": "on"})
            check(code == 0, f"dashboard on: {msg}")
            url = f"http://127.0.0.1:{mgr.modules['dashboard'].port}/"
            watcher.start()
            spec = LoadSpec(n_keys=n_keys, obj_size=OBJECT_BYTES,
                            read_frac=SERVING_READ_FRAC,
                            concurrency=CLUSTER_CLIENTS,
                            phase_seconds=interval_s, seed=SEED,
                            zipf_theta=SERVING_THETA, op_timeout=600.0)
            gen = LoadGen(cluster, "rbd_ec", spec)
            gen.health.evaluate(gen._status(), cluster.mon.osdmap)
            counted("write", lambda: _preload_threaded(gen, CLUSTER_CLIENTS))
            api: dict = {}

            def fetch_api():
                time.sleep(interval_s / 2)
                try:
                    api.update(_api_brief(url))
                except Exception as exc:     # reported by the check below
                    api["error"] = repr(exc)
            loads = []
            for i in range(intervals):
                fetcher = threading.Thread(target=fetch_api) \
                    if i == min(1, intervals - 1) else None
                if fetcher is not None:
                    fetcher.start()
                counted(f"load {i}", lambda i=i: loads.append(
                    gen._run_phase(f"healthy {i}", interval_s)))
                if fetcher is not None:
                    fetcher.join()
            check("error" not in api and api, f"dashboard API: {api}")
            verify = _verify_threaded(gen, CLUSTER_CLIENTS)
            for key in ("lost_acked", "wrong_bytes", "corruptions"):
                check(verify[key] == [],
                      f"mgr phase reads: {key} {verify[key][:3]}")
            kept = _kept_tree_with(mgr.modules["trace"], "kernel_dispatch")
            check(kept is not None, "no archived trace with a "
                  "kernel_dispatch span")
            prom = [line for line in prometheus.render_text().splitlines()
                    if not line.startswith("#")
                    and ("tuner_" in line or "autopsy_" in line)]
            history = tuner.history_dump()
            eng = engine()
            stats = dict(eng.stats)
            knobs_live = {k: getattr(eng, a) for k, a in ENGINE_KNOBS.items()}
            mgr.stop()
            cluster.mgr = None
            g_conf().set_mon_layer({})
            restored = {k: getattr(eng, a) for k, a in ENGINE_KNOBS.items()}
            defaults = {k: g_conf().schema.get(k).default
                        for k in ENGINE_KNOBS}
            check(restored == defaults,
                  f"engine knobs not restored: {restored} != {defaults}")
            stop.set()
            watcher.join()
            if sampler_errs:
                raise sampler_errs[0]
    finally:
        stop.set()
        if watcher.is_alive():
            watcher.join()
        g_conf().set_mon_layer({})
        if old_env is None:
            os.environ.pop("CEPH_TPU_TUNER", None)
        else:
            os.environ["CEPH_TPU_TUNER"] = old_env

    # each step's fate: the judgment that followed it on its knob
    for i, d in enumerate(decisions):
        if d["kind"] == "step":
            judged = next((j["kind"] for j in decisions[i + 1:]
                           if j["knob"] == d["knob"]
                           and j["kind"] in ("confirm", "revert")), None)
            d["outcome"] = {"confirm": "kept", "revert": "reverted"}.get(
                judged, "pending")
    engine_steps = [d for d in decisions if d["landed"] is not None]
    check(all(d["landed"] for d in engine_steps),
          f"an engine-knob push did not land: {engine_steps}")
    check(any(d["kind"] == "step" for d in engine_steps),
          f"no engine-knob step landed: {decisions}")
    check(stats["errors"] == 0 and stats["decode_errors"] == 0,
          f"engine errors: {stats}")
    if on_card:
        w = launches["write"]
        check(w["gf_matvec"] > 0 and w["crc32c_rows"] > 0,
              f"write launches {w}")
    out = {"phase": "mgr", "card": smi, "backend": backend,
           "profile": "isa reed_sol_van k=8 m=3, stripe unit 4096",
           "osds": CLUSTER_OSDS, "pg_num": CLUSTER_PG_NUM,
           "keys": n_keys, "object_bytes": OBJECT_BYTES,
           "clients": CLUSTER_CLIENTS, "modules": list(DEFAULT_MODULES),
           "tuner": {k: g_conf()[k] for k in
                     ("tuner_tick_period", "tuner_cooldown_s",
                      "tuner_hysteresis_ticks")},
           "boot_s": boot_s, "write_s": walls["write"],
           "write_GBps": n_keys * OBJECT_BYTES / 1e9 / walls["write"],
           "intervals": [{key: r[key] for key in
                          ("phase", "seconds", "ops", "ops_per_s", "MBps",
                           "p50_ms", "p99_ms", "errors")}
                         for r in loads],
           "verify": {k: verify[k] if not isinstance(verify[k], list)
                      else len(verify[k]) for k in verify},
           "decisions": decisions,
           "tuner_history_kinds": [d["kind"] for d in history],
           "sensors": sensors.brief(),
           "engine_knobs_over_time": samples,
           "engine_knobs_live": knobs_live, "engine_knobs_restored": restored,
           "window_max_depth": stats["window_max_depth"],
           "window_slot_flushes": stats["window_slot_flushes"],
           "max_inflight_depth": stats["max_inflight_depth"],
           "flushes": stats["flushes"], "ops": stats["ops"],
           "ops_per_flush": stats["ops"] / max(stats["flushes"], 1),
           "launches": launches, "traced_burst": traced,
           "api": api, "kept_trace": kept, "prometheus": prom,
           "build_ledger": ledger, "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


#: phase 5h: phase 5c's deployment under the lock witness and lock timing:
#: 128 objects of 1 MiB from 8 client threads, the highest OSD killed, 32
#: of them read degraded, the OSD revived, every write read back
WITNESS_OBJECTS = 128
WITNESS_DEGRADED_READS = 32
WITNESS_KILLED = CLUSTER_OSDS - 1
#: the lock the planted probe holds while it waits on the card: its
#: ``device_barrier`` finding proves the hook fires on real CUDA
WITNESS_PROBE_LOCK = "smoke.probe"


def _top_locks(table: dict, key: str, n: int = 5) -> list:
    """The ``n`` named locks with the largest ``key`` in a dispatch
    telemetry lock table, as [name, value, acquisitions] (every
    outermost acquire reports a wait, blocked or not)."""
    rows = sorted(table.items(), key=lambda kv: -kv[1][key])[:n]
    return [[name, row[key], row["waits"]] for name, row in rows
            if row[key]]


def witness_phase(smi: str, backend: str = "cuda",
                  n_obj: int = WITNESS_OBJECTS, armed: bool = True) -> dict:
    """Phase 5h: phase 5c's deployment with the port's lock witness and
    lock timing armed before anything of the port is built (see the
    module docstring). Fails on an unacknowledged finding, an empty lock
    graph, a wrong byte, or a planted device barrier the witness did not
    see. The witness sees explicit waits on the card only
    (``torch.cuda.synchronize`` and the event and stream waits); a copy
    from the card to the host (``.cpu()``) waits too, unwitnessed.
    ``backend="torch"`` runs the plain versions (a rehearsal on the CPU,
    where no launch is counted and the probe's barrier raises after the
    hook saw it). ``armed=False`` runs the same steps and checks of the
    bytes with neither mode on and no probe, the twin that measures what
    the wrappers cost (``--witness-phase --unarmed``)."""
    from ceph_tpu_torch.analysis import lock_witness as lw
    if armed:
        lw.enable()
        lw.enable_timing()
    from ceph_tpu_torch.models import instance
    from ceph_tpu_torch.ops import crc32c_cuda, gf_cuda
    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.utils.config import g_conf
    from ceph_tpu_torch.utils.dispatch_telemetry import \
        telemetry as dispatch_telemetry

    t_phase = time.perf_counter()
    on_card = backend == "cuda"
    rng = np.random.default_rng(SEED + 21)
    data = rng.integers(0, 256, n_obj * OBJECT_BYTES, dtype=np.uint8)
    pays = {f"obj{i}": data[i * OBJECT_BYTES:(i + 1) * OBJECT_BYTES]
            .tobytes() for i in range(n_obj)}
    del data
    oids = list(pays)
    degraded = oids[:min(WITNESS_DEGRADED_READS, n_obj)]
    host_codec = instance().factory(
        "isa", {"k": str(K), "m": str(M), "technique": "reed_sol_van",
                "backend": "numpy"}, device="cpu")
    launches: dict = {}
    walls: dict = {}

    def step(label, fn):
        gf_cuda.reset_launches()
        crc32c_cuda.reset_launches()
        walls[label] = fn()
        launches[label] = {"gf_matvec": gf_cuda.launches,
                           "crc32c_rows": crc32c_cuda.launches}

    def read_back(names, label):
        def one(i):
            check(io.read(names[i]) == pays[names[i]],
                  f"5h {label} read of {names[i]}")
        return _threaded(one, len(names), CLUSTER_CLIENTS)

    t_boot = time.perf_counter()
    with _heartbeat_knobs(g_conf(), CLUSTER_GRACE), \
            MiniCluster(n_osds=CLUSTER_OSDS) as cluster:
        boot_s = time.perf_counter() - t_boot
        cluster.create_ec_pool("rbd_ec", k=K, m=M, plugin="isa",
                               technique="reed_sol_van",
                               pg_num=CLUSTER_PG_NUM, backend=backend)
        pool_id = cluster.mon.osdmap.pool_by_name["rbd_ec"]
        rados = cluster.client()
        io = rados.open_ioctx("rbd_ec")
        io.op_timeout = 600.0
        # lock waits and holds from the first client write on
        dispatch_telemetry().reset()
        step("write", lambda: _threaded(
            lambda i: io.write_full(oids[i], pays[oids[i]]), n_obj,
            CLUSTER_CLIENTS))
        handle = _engine_handle(cluster)
        write_stats = dict(handle.stats)
        fused = write_stats["flushes"] - write_stats["host_flushes"]
        if on_card:
            w = launches["write"]
            check(w["gf_matvec"] > 0 and w["crc32c_rows"] > 0,
                  f"5h write launches {w}")
            check(w["crc32c_rows"] == fused,
                  f"5h B2 launches {w['crc32c_rows']} != fused flushes "
                  f"{fused}")

        # the planted probe: a device barrier under a witnessed lock
        if armed:
            with lw.make_lock(WITNESS_PROBE_LOCK):
                if on_card:
                    torch.cuda.synchronize()
                else:
                    with contextlib.suppress(AssertionError, RuntimeError):
                        torch.cuda.synchronize()

        epoch = cluster.epoch()
        t0 = time.perf_counter()
        with _fast_death_kill(cluster, g_conf()):
            cluster.kill_osd(WITNESS_KILLED)
            cluster.wait_for_osd_down(WITNESS_KILLED, timeout=60)
        down_s = time.perf_counter() - t0
        rados.wait_for_epoch(epoch + 1, timeout=30)
        before = dict(handle.stats)
        step("degraded_read", lambda: read_back(degraded, "degraded"))
        decode_ops = handle.stats["decode_ops"] - before["decode_ops"]

        def recover():
            t0 = time.perf_counter()
            cluster.revive_osd(WITNESS_KILLED)
            cluster.wait_for_osds_up(timeout=60)
            cluster.wait_for_clean(timeout=600)
            return time.perf_counter() - t0

        step("recovery", recover)
        step("final_read", lambda: read_back(oids, "final"))
        final = dict(handle.stats)
        check(final["errors"] == 0 and final["decode_errors"] == 0,
              f"5h engine errors: {final}")
        osdmap = cluster.mon.osdmap
        picked, seen = [], set()
        for oid in oids:
            ps = osdmap.object_to_pg(pool_id, oid)
            if ps not in seen:
                seen.add(ps)
                picked.append(oid)
            if len(picked) == CLUSTER_CHECKED:
                break
        shards_checked = _check_cluster_shards(cluster, pool_id, picked,
                                               pays, host_codec)
        locks = dispatch_telemetry().lock_table(top=1 << 16)["locks"]

    gb = n_obj * OBJECT_BYTES / 1e9
    out = {"phase": "witness", "card": smi, "backend": backend,
           "profile": "isa reed_sol_van k=8 m=3, stripe unit 4096",
           "osds": CLUSTER_OSDS, "pg_num": CLUSTER_PG_NUM,
           "objects": n_obj, "object_bytes": OBJECT_BYTES,
           "clients": CLUSTER_CLIENTS, "killed": WITNESS_KILLED,
           "witness": armed, "timing": armed, "boot_s": boot_s,
           "write_s": walls["write"], "write_GBps": gb / walls["write"],
           "down_s": down_s, "degraded_reads": len(degraded),
           "degraded_read_s": walls["degraded_read"],
           "degraded_read_GBps": len(degraded) * OBJECT_BYTES / 1e9
           / walls["degraded_read"],
           "degraded_decode_ops": decode_ops,
           "recovery_s": walls["recovery"],
           "final_read_s": walls["final_read"],
           "flushes": final["flushes"], "write_flushes":
           write_stats["flushes"], "write_fused_flushes": fused,
           "window_depth_max": final["max_inflight_depth"],
           "launches": launches, "shards_checked": shards_checked}
    if armed:
        out.update(_witness_findings(lw, locks))
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    return out


def _witness_findings(lw, locks: dict) -> dict:
    """Phase 5h's report of the armed witness and timing (disarmed
    here): the lock graph, the findings by kind and lock and the top
    locks, after the checks on the probe, the graph and the baseline."""
    rep = lw.report()
    lw.disable()
    lw.disable_timing()
    by_kind: dict = {}
    for v in rep["blocking"]:
        kind = by_kind.setdefault(v["kind"], {})
        kind[v["lock"]] = kind.get(v["lock"], 0) + v["count"]
    probe = [v for v in rep["blocking"] if v["lock"] == WITNESS_PROBE_LOCK]
    check(any(v["kind"] == "device_barrier" for v in probe),
          f"the planted device barrier under {WITNESS_PROBE_LOCK} was not "
          f"seen: {rep['blocking']}")
    unack = [u for u in lw.unacknowledged(rep)
             if u.get("lock") != WITNESS_PROBE_LOCK]
    check(rep["edges"] > 0, "5h: the lock witness saw no nested lock")
    check(not unack, "5h unacknowledged witness findings: "
          + json.dumps(unack)[:3000])
    return {"edges": rep["edges"], "edges_dropped": rep["edges_dropped"],
            "cycles": [c["key"] for c in rep["cycles"]],
            "blocking_by_kind": by_kind,
            "blocking": [{k: v[k] for k in ("key", "count", "site")}
                         for v in rep["blocking"]],
            "probe": [v["key"] for v in probe],
            "unacknowledged": len(unack),
            "locks_timed": len(locks),
            "top_wait_ms": _top_locks(locks, "wait_ms"),
            "top_hold_ms": _top_locks(locks, "hold_ms"),
            "top_max_wait_us": _top_locks(locks, "max_wait_us"),
            "top_condvar_wakeups": [
                [name, wakeups, locks[name]["cv_mean_latency_us"]]
                for name, wakeups, _ in _top_locks(locks, "cv_wakeups")]}


def witness_vs_cluster(witness: dict, cluster: dict, smi: str) -> dict:
    """Phase 5h's walls beside phase 5c's: the same deployment, 5h with
    the witness and lock timing on (128 objects, one OSD killed), 5c with
    both off (512 objects, two killed); rates, since the sizes differ."""
    def side(line, killed):
        return {"objects": line["objects"], "killed": killed,
                "write_s": line["write_s"],
                "write_GBps": line["write_GBps"],
                "degraded_read_s": line["degraded_read_s"],
                "degraded_read_GBps": line["degraded_read_GBps"],
                "recovery_s": line["recovery_s"]}
    return {"phase": "witness_vs_cluster", "card": smi,
            "witness_on": side(witness, [witness["killed"]]),
            "witness_off": side(cluster, cluster["killed"])}


#: the arguments that run phases 5c-5h alone (each the child process of
#: :func:`phase_in_child`)
CLUSTER_CHILD_ARG = "--cluster-phase"
SCRUB_CHILD_ARG = "--scrub-phase"
CRIMSON_CHILD_ARG = "--crimson-phase"
SERVING_CHILD_ARG = "--serving-phase"
MGR_CHILD_ARG = "--mgr-phase"
WITNESS_CHILD_ARG = "--witness-phase"
#: with ``--witness-phase``: 5h's steps with neither the witness nor
#: lock timing armed (what the wrappers cost, beside an armed run)
WITNESS_UNARMED_ARG = "--unarmed"


def phase_in_child(arg: str, phase: str, timeout: float = 900) -> dict:
    """Run a cluster phase in a child process on the same card (this
    script with ``arg``), so the cluster's ~150 threads and whatever they
    leave behind stay out of the later phases' profiler sessions
    (torch.profiler has returned empty sessions after them). The child
    prints its ``phase`` line, echoed here, and exits non-zero on any
    failed check. Returns that line."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), arg],
        capture_output=True, text=True, timeout=timeout)
    sys.stderr.write(proc.stderr)
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith(f'{{"phase": "{phase}"')]
    check(proc.returncode == 0 and len(lines) == 1,
          f"{arg} child exited {proc.returncode}: {proc.stdout[-2000:]}")
    print(lines[0], flush=True)
    return json.loads(lines[0])


def child_main(phase) -> int:
    """One cluster phase alone, on the card (the child of
    :func:`phase_in_child`)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    torch.cuda.set_device(0)
    phase(nvidia_smi_line())
    return 0


@contextlib.contextmanager
def _scrub_split():
    """Time the deep scrub's gather, verify and repair (each
    ``DeepScrubEngine`` step, summed over the PGs, which the pool scrub
    visits one after the other) and every ``verify_batch`` call (upload,
    program, download), and keep one verified batch, the first with a
    mismatch, for the check against the plain version."""
    from ceph_tpu_torch.osd import scrub_engine as se
    split = {"gather_s": 0.0, "verify_s": 0.0, "repair_s": 0.0,
             "verify_calls_s": [], "batch": None}
    lock = threading.Lock()
    saved = [(se.DeepScrubEngine, name, getattr(se.DeepScrubEngine, name))
             for name in ("_gather", "_verify_chunk", "_repair")]
    saved.append((se, "verify_batch", se.verify_batch))

    def timed(real, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                with lock:
                    split[key] += time.perf_counter() - t0
        return wrapper

    def verify_batch(mat, k, batch, mesh=None, device="cuda"):
        t0 = time.perf_counter()
        mism, lin = saved[-1][2](mat, k, batch, mesh=mesh, device=device)
        with lock:
            split["verify_calls_s"].append(time.perf_counter() - t0)
            if split["batch"] is None or (mism.any() and
                                          not split["batch"][3]):
                split["batch"] = (mat, k, batch, bool(mism.any()))
        return mism, lin

    for (owner, name, real), key in zip(saved[:3], ("gather_s", "verify_s",
                                                    "repair_s")):
        setattr(owner, name, timed(real, key))
    se.verify_batch = verify_batch
    try:
        yield split
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)


def verify_times(dev, mat, batch, hbm, profiled: bool) -> dict:
    """The deep-scrub verify program of one batch, resident on the card:
    events ms a batch and, with ``profiled``, the profiler's device ms,
    beside its bound (each input byte read once and each output written
    once over the memory rate, against B1's GF products and B2's row
    products at the int8 tensor peak, as PERF.md section 2 counts them).
    The phase 5d child takes no profiler session (the main process takes
    the device time at its batch shape, in phase 5)."""
    from ceph_tpu_torch.bench.b5_ab import device_ms
    from ceph_tpu_torch.bench.ec_bench import time_cuda
    from ceph_tpu_torch.osd import scrub_engine as se
    nobj, n, l_b = batch.shape
    m = n - K
    nobj_b = se._pow2(nobj, 1)
    padded = np.zeros((nobj_b, n, l_b), np.uint8)
    padded[:nobj] = batch
    dev_batch = torch.from_numpy(padded).to(dev)
    fn = se.verify_fn(mat, K, l_b, nobj_b)
    t_bytes = (nobj_b * n * l_b + nobj_b * m + nobj_b * n * 8) / hbm
    t_ops = (2 * 64 * m * K * nobj_b * l_b
             + 2 * 4096 * 32 * nobj_b * n * l_b // 512) / H100_INT8_OPS_PER_S
    out = {"objects": nobj, "objects_padded": nobj_b, "shard_bytes": l_b,
           "batch_bytes": nobj_b * n * l_b,
           "ms": time_cuda(lambda: fn(dev_batch), 20) * 1e3,
           "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if profiled:
        out["device_ms"] = device_ms(lambda: fn(dev_batch), kernel="")
    return out


def scrub_phase(smi: str, backend: str = "cuda",
                n_obj: int = SCRUB_OBJECTS) -> dict:
    """Phase 5d: deep scrub on the card over BlockStore (see the module
    docstring). Returns the B1/B2 launch counts of each step;
    ``backend="torch"`` runs the plain versions (a rehearsal on the CPU,
    where no launch is counted and no device time is taken)."""
    import tempfile
    from ceph_tpu_torch.ops import crc32c_cuda, gf_cuda
    from ceph_tpu_torch.osd import scrub_engine as se
    from ceph_tpu_torch.osd.pg import pg_cid
    from ceph_tpu_torch.qa.cluster import MiniCluster
    from ceph_tpu_torch.utils.config import g_conf

    on_card = backend == "cuda"
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    rng = np.random.default_rng(SEED + 17)
    data = rng.integers(0, 256, n_obj * OBJECT_BYTES, dtype=np.uint8)
    pays = {f"obj{i}": data[i * OBJECT_BYTES:(i + 1) * OBJECT_BYTES]
            .tobytes() for i in range(n_obj)}
    del data
    oids = sorted(pays, key=lambda o: int(o[3:]))
    launches: dict = {}
    walls: dict = {}

    def step(label, fn):
        gf_cuda.reset_launches()
        crc32c_cuda.reset_launches()
        walls[label] = fn()
        launches[label] = {"gf_matvec": gf_cuda.launches,
                           "crc32c_rows": crc32c_cuda.launches}

    def timed(fn):
        def run():
            t0 = time.perf_counter()
            out[fn.__name__] = fn()
            return time.perf_counter() - t0
        return run

    out: dict = {}
    work = Path(__file__).resolve().parent / "build" / "scrub"
    work.mkdir(parents=True, exist_ok=True)
    t_boot = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=work) as data_dir, \
            _heartbeat_knobs(g_conf(), CLUSTER_GRACE), \
            MiniCluster(n_osds=CLUSTER_OSDS, store="blockstore",
                        data_dir=data_dir) as cluster:
        boot_s = time.perf_counter() - t_boot
        cluster.create_ec_pool("scrub_ec", k=K, m=M, plugin="isa",
                               technique="reed_sol_van",
                               pg_num=CLUSTER_PG_NUM, backend=backend)
        osdmap = cluster.mon.osdmap
        pool_id = osdmap.pool_by_name["scrub_ec"]
        check(osdmap.pools[pool_id].stripe_unit == CHUNK, "pool stripe unit")
        io = cluster.client().open_ioctx("scrub_ec")
        io.op_timeout = 600.0
        step("write", lambda: _threaded(
            lambda i: io.write_full(oids[i], pays[oids[i]]), n_obj,
            CLUSTER_CLIENTS))

        # one silent flip in each of K + M objects of different PGs,
        # object i at shard position i
        flips, seen = {}, set()
        for oid in oids:
            ps = osdmap.object_to_pg(pool_id, oid)
            if ps in seen:
                continue
            seen.add(ps)
            pos = len(flips)
            _, acting, _ = osdmap.pg_to_up_acting(pool_id, ps)
            off = int(rng.integers(0, OBJECT_BYTES // K - SCRUB_FLIP_BYTES))
            cluster._stores[acting[pos]].inject_bit_flip(
                pg_cid(pool_id, ps, pos), oid, offset=off,
                length=SCRUB_FLIP_BYTES)
            flips[oid] = pos
            if len(flips) == K + M:
                break

        def deep_scrub():
            return cluster.scrub_pool("scrub_ec", deep=True)

        def deep_scrub_again():
            return cluster.scrub_pool("scrub_ec", deep=True)

        def shallow_scrub():
            return cluster.scrub_pool("scrub_ec")

        with _scrub_split() as split:
            step("deep_scrub", timed(deep_scrub))
        res = out["deep_scrub"]
        check(res.get("deep") and "skipped" not in res,
              f"deep scrub skipped PGs: {res.get('skipped')}")
        check(res["inconsistent"] == {o: [p] for o, p in flips.items()},
              f"convicted {res['inconsistent']}, flipped {flips}")
        check(sorted(res["repaired"]) == sorted(flips),
              f"repaired {res['repaired']}, flipped {sorted(flips)}")
        step("deep_scrub_again", timed(deep_scrub_again))
        check(out["deep_scrub_again"]["inconsistent"] == {} and
              "skipped" not in out["deep_scrub_again"],
              f"second deep scrub: {out['deep_scrub_again']}")
        step("shallow_scrub", timed(shallow_scrub))
        check(out["shallow_scrub"]["inconsistent"] == {} and
              "skipped" not in out["shallow_scrub"],
              f"shallow scrub after repair: {out['shallow_scrub']}")

        def read_back():
            def one(i):
                check(io.read(oids[i]) == pays[oids[i]],
                      f"read of {oids[i]} after repair")
            return _threaded(one, n_obj, CLUSTER_CLIENTS)

        step("read", read_back)
        stats = [o.scrub_engine().stats for o in cluster.osds.values()]
        engine_stats = {key: sum(st[key] for st in stats)
                        for key in stats[0]}
        check(engine_stats["device_errors"] == 0,
              f"deep-scrub device errors: {engine_stats}")
        batches = res["batches"]
        if on_card:
            for step_name in ("deep_scrub", "deep_scrub_again"):
                got = launches[step_name]
                check(got["gf_matvec"] >= batches and
                      got["crc32c_rows"] >= batches,
                      f"{step_name} launches {got} < {batches} batches")

    # one gathered batch on the card against the plain version on the CPU
    mat, k, batch, had_mismatch = split["batch"]
    cpu_mism, cpu_lin = se.verify_batch(mat, k, batch, device="cpu")
    card = {"objects": batch.shape[0], "had_mismatch": had_mismatch}
    if on_card:
        mism, lin = se.verify_batch(mat, k, batch, device=dev)
        check(np.array_equal(mism, cpu_mism) and np.array_equal(lin, cpu_lin),
              "verify of a gathered batch on the card differs from the CPU")
        card["equal_to_plain"] = True
        verify_device = verify_times(dev, mat, batch, hbm_rate()[0],
                                     profiled=False)
    else:
        verify_device = "not measured (no card)"
    calls = split["verify_calls_s"]
    scrub_s = walls["deep_scrub"]
    out_line = {
        "phase": "scrub", "card": smi, "backend": backend,
        "store": "blockstore",
        "profile": "isa reed_sol_van k=8 m=3, stripe unit 4096",
        "osds": CLUSTER_OSDS, "pg_num": CLUSTER_PG_NUM, "objects": n_obj,
        "object_bytes": OBJECT_BYTES, "clients": CLUSTER_CLIENTS,
        "boot_s": boot_s, "write_s": walls["write"],
        "write_GBps": n_obj * OBJECT_BYTES / 1e9 / walls["write"],
        "flips": flips, "convicted": res["inconsistent"],
        "repaired": sorted(res["repaired"]),
        "deep_scrub_s": scrub_s,
        "deep_scrub_split_s": {key: split[key] for key in
                               ("gather_s", "verify_s", "repair_s")},
        "verify_batch_host_ms": {
            "mean": 1e3 * sum(calls) / max(len(calls), 1),
            "max": 1e3 * max(calls, default=0.0), "calls": len(calls)},
        "verify_device": verify_device,
        "bytes_verified": res["bytes_verified"],
        "shard_GBps": res["bytes_verified"] / 1e9 / scrub_s,
        "batches": batches, "objects_per_batch": res["objects"]
        / max(batches, 1),
        "deep_scrub_again_s": walls["deep_scrub_again"],
        "shallow_scrub_s": walls["shallow_scrub"], "read_s": walls["read"],
        "gathered_batch_check": card, "engine_stats": engine_stats,
        "launches": launches}
    emit(out_line)
    return launches


@contextlib.contextmanager
def _captured_splits():
    """Collect every fused flush's host split inside the block (the dict
    its finalize completes; holding the finalize itself would pin its
    device inputs)."""
    from ceph_tpu_torch.osd import ec_util
    splits, real = [], ec_util._flush_device_fused_async

    def capture(*args, **kwargs):
        fin = real(*args, **kwargs)
        splits.append(fin.host_split)
        return fin

    ec_util._flush_device_fused_async = capture
    try:
        yield splits
    finally:
        ec_util._flush_device_fused_async = real


def _split_ms(splits) -> dict:
    """Mean, max and each flush's ms of every part of the host split."""
    out = {}
    for key in ("upload_s", "transpose_s", "launch_s", "alloc_s",
                "wait_s", "split_s"):
        vals = [sp[key] * 1e3 for sp in splits]
        out[key] = {"mean": statistics.mean(vals), "max": max(vals),
                    "each": vals}
    return out


def _device_union_ms(prof) -> tuple[float, float]:
    """(sum, union) in ms of the device activity intervals of a finished
    torch.profiler session: the sum exceeds the union by the time that
    work on different streams ran at once."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    total = sum(end - start for start, end in spans)
    union, cur_s, cur_e = 0.0, None, None
    for start, end in spans:
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                union += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        union += cur_e - cur_s
    return total / 1e3, union / 1e3


def engine_profile_phase(dev, codec, sinfo) -> None:
    """Phase 13: a 3-flush engine burst (the objects of phase 5b's first
    three flushes) under torch.profiler, from the release to the last
    continuation, keeping only the crcs; continuations on the per-key
    executor. Prints the window's depth and how long work on different
    slot streams ran at once on the device. Run last: a profiling
    session that spans the engine's threads has been followed by
    sessions that record nothing in the same process."""
    from ceph_tpu_torch.osd.device_engine import DeviceEncodeEngine
    rng = np.random.default_rng(SEED + 11)
    data = rng.integers(0, 256, 3 * OBJECTS * OBJECT_BYTES, dtype=np.uint8)
    objs = [data[i * OBJECT_BYTES:(i + 1) * OBJECT_BYTES]
            for i in range(3 * OBJECTS)]
    from torch.profiler import ProfilerActivity, profile
    session = profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
    executor = KeyedExecutor(ENGINE_CALLERS)
    eng = DeviceEncodeEngine(executor.dispatch,
                             flush_bytes=OBJECTS * OBJECT_BYTES,
                             window=ENGINE_WINDOW)
    try:
        with _captured_splits() as splits:
            prof_wall = _engine_burst(eng, codec, sinfo, objs,
                                      ENGINE_PRODUCERS, prof=session)[0]
        prof_stats = dict(eng.stats)
    finally:
        eng.stop()
        executor.stop()
    report = profile_report(session, prof_wall, "engine_profile")
    dev_sum, dev_union = _device_union_ms(session)
    report.update(flushes=3, per_flush_wall_ms=report["wall_ms"] / 3,
                  per_flush_device_busy_ms=report["device_busy_ms"] / 3,
                  device_interval_sum_ms=dev_sum,
                  device_interval_union_ms=dev_union,
                  device_concurrent_ms=dev_sum - dev_union,
                  max_inflight_depth=prof_stats["max_inflight_depth"],
                  errors=prof_stats["errors"],
                  host_split_ms=_split_ms(splits),
                  note="device busy sums the kernels and copies of all "
                       "side streams; the interval sum exceeds their "
                       "union by the time streams ran at once")
    emit(report)
    check(prof_stats["flushes"] == 3 and prof_stats["errors"] == 0,
          f"engine profile burst: {prof_stats}")
    check(prof_stats["max_inflight_depth"] >= 2,
          f"with cheap continuations the window never held two flushes: "
          f"{prof_stats}")
    check(dev_sum - dev_union > 0,
          "no device work of two slot streams ran at once")


# -- Clay (kernels B3, B4, B5) ---------------------------------------------

def _bound(nbytes: float, ops: float, hbm: float) -> tuple[float, str]:
    """(least ms, what bounds it): bytes over the card's memory rate vs
    GF multiplies as 8x8 bit-matrix products (128 ops each) at the
    dense int8 tensor peak."""
    t_bytes, t_ops = nbytes / hbm, ops / H100_INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def block_sparse_work(plan) -> tuple[int, int]:
    """(live (group, column) pairs, set coefficient bits) of a B5 plan,
    read from the arrays the kernel reads: it transposes and runs a
    multiply-by-x chain once per live pair and XORs 8 bit-plane words per
    set bit."""
    from ceph_tpu_torch.ops import gf_block_sparse_cuda
    arr = gf_block_sparse_cuda.plan_arrays(plan)
    return len(arr["col_row"]), int(np.unpackbits(arr["col_coef"]).sum())


def clay_kernel_checks(dev, gen) -> dict:
    """Phase 6: B3, B4 and B5 against their plain versions on the card."""
    from ceph_tpu_torch.models import clay_device, instance
    from ceph_tpu_torch.ops import gf_block_sparse, gf_block_sparse_torch

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    errs = {"b3": 0, "b4": 0, "b5": 0}
    cases = {"b3": 0, "b4": 0, "b5": 0}
    for prof in CLAY_PROFILES:
        codec = instance().factory("clay", prof, device=dev)
        ssc, qt = codec.sub_chunk_no, codec.q * codec.t
        n = codec.k + codec.m
        enc = clay_device.build_encode_kernel(codec)
        unaligned = rand(codec.k * ssc * 4096 + 1)[1:].view(codec.k, ssc,
                                                            4096)
        for L in B3_L + ("unaligned",):
            x = unaligned if L == "unaligned" else rand(codec.k, ssc, L)
            got = enc(x)
            torch.cuda.synchronize()
            err = max_err(got, enc.plain(x))
            check(err == 0, f"B3 {prof} L={L} differs from plain")
            errs["b3"], cases["b3"] = max(errs["b3"], err), cases["b3"] + 1
        for e in range(1, codec.m + 1):
            lost = list(range(0, n, max(1, n // e)))[:e]
            erased = codec._pad_erased(codec._node_id(i) for i in lost)
            er = sorted(erased)
            fn = clay_device.build_transform_kernel(codec, erased)
            for L in CLAY_L + ("unaligned",):
                # one byte off alignment: B4's byte path
                c = rand(qt * ssc * 4096 + 1)[1:].view(qt, ssc, 4096) \
                    if L == "unaligned" else rand(qt, ssc, L)
                c[er] = 0
                c[codec.k:codec.k + codec.nu] = 0
                got = fn(c)
                torch.cuda.synchronize()
                err = max_err(got, fn.plain(c)[er])
                check(err == 0, f"B4 {prof} lost={lost} L={L} differs")
                errs["b4"] = max(errs["b4"], err)
                cases["b4"] += 1
    host = instance().factory("clay", dict(CLAY, backend="numpy"),
                              device="cpu")
    rng = np.random.default_rng(SEED)
    mats = {"decode-1": host._decode_matrix(tuple(range(1, 12)), (0,)),
            "decode-2": host._decode_matrix(tuple(range(2, 12)), (0, 1)),
            "repair": host._repair_matrix(0, tuple(range(1, 12))),
            "random 5%": (rng.integers(0, 256, (128, 640)) *
                          (rng.random((128, 640)) < 0.05)).astype(np.uint8)}
    for label, mat in mats.items():
        plan = gf_block_sparse.plan_for(mat)
        for L in B5_L:
            x = rand(mat.shape[1], L)
            got = gf_block_sparse.matvec_device(mat, x)
            torch.cuda.synchronize()
            err = max_err(got, gf_block_sparse_torch.matvec(plan, x))
            check(err == 0, f"B5 {label} N={L} differs from plain")
            errs["b5"], cases["b5"] = max(errs["b5"], err), cases["b5"] + 1
    emit({"phase": "clay_kernels", "profiles": CLAY_PROFILES,
          "lanes": CLAY_L + ("unaligned 4096",),
          "b3_lanes": B3_L + ("unaligned 4096",),
          "b5_lanes": B5_L, "cases": cases,
          "max_abs_err": errs,
          "block_sparse_stats": {label: gf_block_sparse.occupancy_stats(mat)
                                 for label, mat in mats.items()},
          "tolerance": 0})
    return errs


def tally_lanes(owner, attr: str, read_count, lanes_of):
    """Wrap ``owner.attr`` so that every call is tallied by its lane count
    with the rise of the kernel's own launch counter (``read_count()``)
    over that call. Returns (tally, undo)."""
    orig = getattr(owner, attr)
    tally: dict[int, int] = {}

    def wrapped(*args):
        before = read_count()
        out = orig(*args)
        lanes = lanes_of(*args)
        tally[lanes] = tally.get(lanes, 0) + read_count() - before
        return out

    setattr(owner, attr, wrapped)
    return tally, lambda: setattr(owner, attr, orig)


def clay_main_path(dev, rng) -> dict:
    """Phase 7: the Clay k=8, m=4, d=11 codec on CUDA through its entry
    points, on one 128 MiB object, with launch counts (also by lane
    count: full size, calibration sample, ec_util per-stripe call)."""
    from ceph_tpu_torch.models import instance
    from ceph_tpu_torch.ops import (clay_cuda, gf_block_sparse,
                                    gf_block_sparse_cuda,
                                    gf_block_sparse_torch, gf_cuda, gf_torch)
    from ceph_tpu_torch.osd import ec_util

    codec = instance().factory("clay", CLAY, device=dev)
    kcodec = instance().factory("clay", dict(CLAY, decode_kernel="true"),
                                device=dev)
    check(codec.resolved_backend == "cuda", "clay codec is not on cuda")
    n, ssc = codec.get_chunk_count(), codec.sub_chunk_no
    data = rng.integers(0, 256, CLAY_OBJECT, dtype=np.uint8)
    cs = codec.get_chunk_size(CLAY_OBJECT)
    check(cs == ssc * CLAY_SUB, f"chunk size {cs}")
    sinfo = ec_util.StripeInfo(stripe_width=8 * CHUNK, chunk_size=CHUNK)
    objs = [rng.integers(0, 256, OBJECT_BYTES, dtype=np.uint8)
            for _ in range(CLAY_EC_OBJECTS)]
    walls = {}

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        walls[label] = time.perf_counter() - t0
        return out

    def read(label, c, lost):
        avail = {i: enc[i] for i in range(n) if i not in lost}
        out = timed(label, lambda: c.decode(list(lost), avail, cs))
        for i in lost:
            check(np.array_equal(out[i], enc[i]), f"{label}: chunk {i}")

    b3_lanes, undo_b3 = tally_lanes(
        clay_cuda.EncodeKernel, "__call__",
        lambda: clay_cuda.encode_launches, lambda _self, x: x.shape[2])
    b5_lanes, undo_b5 = tally_lanes(
        gf_block_sparse_cuda, "matvec", lambda: gf_block_sparse_cuda.launches,
        lambda _plan, x: x.shape[1])
    clay_cuda.reset_launches()
    gf_block_sparse_cuda.reset_launches()
    gf_cuda.reset_launches()
    gf_torch.reset_dense_calls()
    enc = timed("encode", lambda: codec.encode(list(range(n)), data))
    for lost in ([0], [0, 1]):
        read(f"decode e={len(lost)}", codec, lost)
        read(f"decode_kernel e={len(lost)}", kcodec, lost)
    saved = os.environ.get("CEPH_TPU_CLAY_SPARSE")
    os.environ["CEPH_TPU_CLAY_SPARSE"] = "always"
    try:
        scodec = instance().factory("clay", CLAY, device=dev)
        read("sparse=always e=2", scodec, [0, 1])
    finally:
        if saved is None:
            os.environ.pop("CEPH_TPU_CLAY_SPARSE", None)
        else:
            os.environ["CEPH_TPU_CLAY_SPARSE"] = saved
    plan = codec.minimum_to_decode([0], list(range(1, n)))
    check(len(plan) == 11 and all(sum(c for _, c in r) == ssc // 4
                                  for r in plan.values()),
          f"repair plan {plan}")
    helpers = {c: np.concatenate([enc[c][o * CLAY_SUB:(o + k) * CLAY_SUB]
                                  for o, k in r]) for c, r in plan.items()}
    rep = timed("repair", lambda: codec.decode([0], helpers, cs))
    check(np.array_equal(rep[0], enc[0]), "repair of chunk 0")
    ec_bytes = 0
    for obj in objs:
        shards = ec_util.encode(sinfo, codec, obj)
        stripes = obj.reshape(-1, 8, CHUNK)
        for i in range(8):
            check(np.array_equal(shards[i], stripes[:, i].ravel()),
                  f"ec_util data shard {i}")
        avail = {i: shards[i] for i in range(n) if i not in (0, 9)}
        out = ec_util.decode(sinfo, codec, avail, [0, 9])
        check(np.array_equal(out[0], shards[0]) and
              np.array_equal(out[9], shards[9]), "ec_util degraded read")
        ec_bytes += len(obj)
    launches = {"clay_encode": clay_cuda.encode_launches,
                "clay_transform": clay_cuda.transform_launches,
                "gf_block_sparse": gf_block_sparse_cuda.launches,
                "gf_matvec": gf_cuda.launches,
                "dense_route": gf_torch.dense_calls}
    undo_b3()
    undo_b5()
    check(all(launches[k] > 0 for k in
              ("clay_encode", "clay_transform", "gf_block_sparse")),
          f"a Clay kernel never launched on the main path: {launches}")
    by_lanes = {"clay_encode": b3_lanes, "gf_block_sparse": b5_lanes}
    for key, tally in by_lanes.items():
        check(sum(tally.values()) == launches[key],
              f"{key} launches by lanes {tally} vs {launches[key]}")

    # checks after the counts were read: data chunks, host oracle on a
    # lane window, kernels vs plain versions at full size
    for i in range(8):
        check(np.array_equal(enc[i], data[i * cs:(i + 1) * cs]),
              f"data chunk {i}")
    host = instance().factory(
        "clay", dict(CLAY, backend="numpy", linearize="false"), device="cpu")
    win = {i: enc[i].reshape(ssc, CLAY_SUB)[:, :CLAY_WINDOW].reshape(-1)
           for i in range(8)}
    oracle = host.encode_chunks(list(range(8, n)), win)
    for i in range(8, n):
        check(np.array_equal(
            oracle[i], enc[i].reshape(ssc, CLAY_SUB)[:, :CLAY_WINDOW]
            .reshape(-1)), f"parity {i} vs host layered oracle")
    x = torch.from_numpy(codec._stack(enc, range(8), ssc, CLAY_SUB)).to(dev)
    x = x.reshape(8, ssc, CLAY_SUB)
    enc_fn = codec._enc_fn
    par = enc_fn(x)
    check(torch.equal(par, enc_fn.plain(x)), "B3 vs plain at full size")
    check(np.array_equal(par.cpu().numpy().reshape(4, -1),
                         np.stack([enc[i] for i in range(8, n)])),
          "B3 vs codec parity")
    key = kcodec._pad_erased([0, 1])
    tfn = kcodec._lin_cache[("ker", key)]
    c_full = torch.zeros((12, ssc, CLAY_SUB), dtype=torch.uint8, device=dev)
    for i in range(n):
        if i not in key:
            c_full[i] = torch.from_numpy(enc[i].reshape(ssc, CLAY_SUB)).to(dev)
    check(torch.equal(tfn(c_full), tfn.plain(c_full)[sorted(key)]),
          "B4 vs plain at full size")
    avail2 = tuple(range(2, n))
    mat2 = codec._lin_cache[("dec", avail2, (0, 1))]
    x2 = torch.from_numpy(codec._stack(enc, avail2, ssc, CLAY_SUB)).to(dev)
    check(torch.equal(gf_block_sparse.matvec_device(mat2, x2),
                      gf_block_sparse_torch.matvec(
                          gf_block_sparse.plan_for(mat2), x2)),
          "B5 vs plain at full size")
    calib = {f"{key[1]} {key[3]}" if key[1] == "dec" else key[1]:
             {"path": fn.path, **fn.measured}
             for key, fn in codec._lin_cache.items() if key[0] == "sparse"}
    emit({"phase": "clay_main_path", "profile": "clay k=8 m=4 d=11",
          "object_bytes": CLAY_OBJECT, "chunk_size": cs,
          "sub_chunk_bytes": CLAY_SUB,
          "repair_read_bytes": sum(len(v) for v in helpers.values()),
          "ec_util_objects": CLAY_EC_OBJECTS, "ec_util_bytes": ec_bytes,
          "stripe_unit": CHUNK, "launches": launches,
          "launches_by_lanes": by_lanes, "wall_s": walls,
          "calibration": calib, "ok": True})
    return {"codec": codec, "kcodec": kcodec, "x": x, "c_full": c_full,
            "key": key, "x2": x2, "mat2": mat2, "enc": enc, "data": data,
            "launches": launches, "launches_by_lanes": by_lanes}


def clay_times(dev, hbm, smi, st) -> dict:
    """Phase 8: B3, B4 and B5 at the main path's shapes: kernel, plain
    version, bound and the dense bit-sliced product (library)."""
    from ceph_tpu_torch.bench.b5_ab import device_ms
    from ceph_tpu_torch.bench.ec_bench import time_cuda
    from ceph_tpu_torch.models import clay_device
    from ceph_tpu_torch.ops import (clay_cuda, gf_block_sparse,
                                    gf_block_sparse_cuda,
                                    gf_block_sparse_torch, gf_torch)

    codec, kcodec, ssc, L = st["codec"], st["kcodec"], 64, CLAY_SUB
    out = {}
    # B3: encode [8*64, L] -> [4*64, L], at full size and at the ec_util
    # leg's shape (one stripe of 4096 B per chunk, 64 lanes)
    x, enc_fn = st["x"], codec._enc_fn
    arr = clay_device.encode_kernel_arrays(enc_fn.tables)
    kern = clay_cuda.EncodeKernel(arr)
    live = {"a1": arr["ps_row"] >= 0, "a2": arr["pa_row"] >= 0,
            "b1": arr["pc_row"] >= 0, "b2": True, "b3": True}
    muls = ssc * int((arr["dmat"] != 0).sum()) + sum(
        int(((arr[t] != 0) & ok).sum()) for t, ok in live.items())
    # set coefficient bits: the bit-sliced kernel XORs 8 plane words each
    bits = ssc * int(np.unpackbits(arr["dmat"]).sum()) + sum(
        int(np.unpackbits(np.where(ok, arr[t], 0).astype(np.uint8)).sum())
        for t, ok in live.items())
    enc_mat = codec._encode_matrix()
    check(torch.equal(gf_torch.matvec(enc_mat, x.reshape(8 * ssc, L)),
                      enc_fn(x).reshape(4 * ssc, L)), "B3 vs dense product")
    b3 = {}
    for label, xs in (("full", x), ("64 lanes",
                                    x[:, :, :CHUNK // ssc].contiguous())):
        lanes = xs.shape[2]
        want = enc_fn.plain(xs)
        check(torch.equal(enc_fn(xs), want) and torch.equal(kern(xs), want),
              f"B3 {label} differs from plain")
        bound, by = _bound(12 * ssc * lanes, 128 * muls * lanes, hbm)
        flat = xs.reshape(8 * ssc, lanes)
        # through the entry point (the span PREV_B3_MS was taken on), the
        # wrapper alone, and the profiler's device time of the kernel
        ms = time_cuda(lambda: enc_fn(xs), 10) * 1e3
        b3[label] = {
            "ms": ms, "prev_ms": PREV_B3_MS[label],
            "wrapper_ms": time_cuda(lambda: kern(xs), 10) * 1e3,
            "device_ms": device_ms(lambda: kern(xs),
                                   kernel="clay_encode_kernel"),
            "GBps": 8 * ssc * lanes / ms / 1e6,
            "plain_ms": time_cuda(lambda: enc_fn.plain(xs), 1, 3) * 1e3,
            "library_ms": time_cuda(
                lambda: gf_torch.matvec(enc_mat, flat), 1, 3) * 1e3,
            "bound_ms": bound, "bound_by": by,
            "xor_floor_ms": 8 * bits * lanes / 32 / H100_INT32_OPS_PER_S
            * 1e3,
            "lanes": lanes, "launch_plan": clay_cuda.launch_plan(
                lanes, 4, ssc, 8, clay_cuda._sm_count(dev))._asdict()}
    out["b3"] = dict(b3["full"], gf_muls_per_lane=muls, coef_bits=bits,
                     shape=[8 * ssc, L], per_stripe=b3["64 lanes"])
    # B4: the e=2 signature, padded to 4 erased nodes
    key, c_full = st["key"], st["c_full"]
    tfn = kcodec._lin_cache[("ker", key)]
    tarr = clay_device.transform_kernel_arrays(kcodec, key)
    tkern = clay_cuda.TransformKernel(tarr)
    muls = bits = 0
    for li in range(tarr["n_levels"]):
        u = tarr["u_rows"][tarr["u_off"][li]:tarr["u_off"][li + 1]]
        c = tarr["c_rows"][tarr["c_off"][li]:tarr["c_off"][li + 1]]
        np_ = tarr["p_off"][li + 1] - tarr["p_off"][li]
        terms = [tarr["a1"][u], tarr["a2"][u], tarr["b1"][c], tarr["b2"][c],
                 tarr["b3"][c]]
        muls += int(np_ * (tarr["dmat"] != 0).sum() +
                    sum((t != 0).sum() for t in terms))
        # set coefficient bits: the bit-sliced kernel XORs 8 plane words each
        bits += int(np_ * np.unpackbits(tarr["dmat"]).sum() +
                    sum(np.unpackbits(t).sum() for t in terms))
    nbytes = (int(tarr["load"].sum()) + tarr["e"]) * ssc * L
    bound, by = _bound(nbytes, 128 * muls * L, hbm)
    x2, mat2 = st["x2"], st["mat2"]
    check(torch.equal(tkern(c_full), tfn.plain(c_full)[sorted(key)]),
          "B4 wrapper differs from plain")
    # through the entry point (the span PREV_B4_MS was taken on), the
    # wrapper alone, and the profiler's device time of the kernel
    ms = time_cuda(lambda: tfn(c_full), 10) * 1e3
    out["b4"] = {"ms": ms, "prev_ms": PREV_B4_MS,
                 "wrapper_ms": time_cuda(lambda: tkern(c_full), 10) * 1e3,
                 "device_ms": device_ms(lambda: tkern(c_full),
                                        kernel="clay_transform_kernel"),
                 "GBps": 10 * ssc * L / ms / 1e6,
                 "plain_ms": time_cuda(lambda: tfn.plain(c_full), 1, 3) * 1e3,
                 "library_ms": time_cuda(
                     lambda: gf_torch.matvec(mat2, x2), 1, 3) * 1e3,
                 "bound_ms": bound, "bound_by": by,
                 "xor_floor_ms": 8 * bits * L / 32 / H100_INT32_OPS_PER_S
                 * 1e3,
                 "gf_muls_per_lane": muls, "coef_bits": bits,
                 "levels": tarr["n_levels"], "erased_nodes": sorted(key),
                 "launch_plan": clay_cuda.transform_plan(
                     L, tkern.qt, tkern.ssc,
                     clay_cuda._sm_count(dev))._asdict()}
    # B5: decode-2, decode-1 and repair matrices of the main path
    mats = {"decode-2": (mat2, x2)}
    avail1 = tuple(range(1, 12))
    mat1 = codec._lin_cache[("dec", avail1, (0,))]
    mats["decode-1"] = (mat1, torch.from_numpy(codec._stack(
        st["enc"], avail1, ssc, L)).to(dev))
    helpers = tuple(range(1, 12))
    matr = codec._lin_cache[("rep", 0, helpers)]
    mats["repair"] = (matr, torch.randint(
        0, 256, (matr.shape[1], L), dtype=torch.uint8, device=dev))
    # the calibration sample's lane count (clay_device.build_decode_matvec)
    # and the ec_util leg's: one stripe of 4096 B per chunk, 64 lanes
    mats["decode-2 sample"] = (mat2, x2[:, :1 << 15].contiguous())
    mats["decode-2 per-stripe"] = (mat2, x2[:, :CHUNK // ssc].contiguous())
    out["b5"] = {}
    for label, (mat, xm) in mats.items():
        plan = gf_block_sparse.plan_for(mat)
        lanes = xm.shape[1]
        nnz = int((mat != 0).sum())
        rows_in = int((mat != 0).any(axis=0).sum())
        bound, by = _bound((rows_in + mat.shape[0]) * lanes,
                           128 * nnz * lanes, hbm)
        live, bits = block_sparse_work(plan)
        check(torch.equal(gf_block_sparse_cuda.matvec(plan, xm),
                          gf_block_sparse_torch.matvec(plan, xm)),
              f"B5 {label} differs from plain")
        # through the entry point (the span PREV_B5_MS was taken on: the
        # plan-cache lookup on the matrix bytes, then the wrapper), the
        # wrapper alone, and the profiler's device time of the kernel
        ms = time_cuda(lambda: gf_block_sparse.matvec_device(mat, xm),
                       10) * 1e3
        out["b5"][label] = {
            "ms": ms, "prev_ms": PREV_B5_MS.get(label),
            "wrapper_ms": time_cuda(
                lambda: gf_block_sparse_cuda.matvec(plan, xm), 10) * 1e3,
            "device_ms": device_ms(
                lambda: gf_block_sparse_cuda.matvec(plan, xm)),
            "GBps": mat.shape[1] * lanes / ms / 1e6,
            "plain_ms": time_cuda(
                lambda: gf_block_sparse_torch.matvec(plan, xm), 1, 3) * 1e3,
            "library_ms": time_cuda(
                lambda: gf_torch.matvec(mat, xm), 1, 3) * 1e3,
            "bound_ms": bound, "bound_by": by,
            "xor_bound_ms": (8 * bits + 21 * live) * lanes / 32
            / H100_INT32_OPS_PER_S * 1e3,
            "shape": list(mat.shape), "lanes": lanes, "nonzeros": nnz,
            "live_pairs": live, "coef_bits": bits,
            "cost_frac": plan.cost_frac}
    data = st["data"]
    emit(flush_profile(lambda: codec.encode(list(range(12)), data),
                       "clay_encode_profile"))
    emit({"phase": "clay_times", "card": smi, "lanes": L, **out})
    return out


def clay_phases(dev, hbm, smi) -> list:
    """Phases 6-8; returns the B3, B4 and B5 entries of the kernels line."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    errs = clay_kernel_checks(dev, gen)
    st = clay_main_path(dev, np.random.default_rng(SEED + 2))
    t = clay_times(dev, hbm, smi, st)
    launches, by_lanes = st["launches"], st["launches_by_lanes"]
    b5 = t["b5"]["decode-2"]
    rows = [("clay_encode (B3)", "clay_encode", "clay_encode.cu",
             "ceph_tpu/models/clay_device.py:724", errs["b3"], t["b3"]),
            ("clay_transform (B4)", "clay_transform", "clay_transform.cu",
             "ceph_tpu/models/clay_device.py:1051", errs["b4"], t["b4"]),
            ("gf_block_sparse (B5)", "gf_block_sparse", "gf_block_sparse.cu",
             "ceph_tpu/ops/gf_block_sparse.py:193", errs["b5"], b5)]
    return [{"name": name, "route": "cuda",
             "source": f"ceph_tpu_torch/csrc/{src}", "replaces": ref,
             "launches": launches[key], "max_abs_err": err, "ms": m["ms"],
             "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
             "bound_by": m["bound_by"], "library_ms": m["library_ms"],
             "pass": True,
             **({"launches_by_lanes": by_lanes[key]} if key in by_lanes
                else {}),
             **({"wrapper_ms": m["wrapper_ms"], "device_ms": m["device_ms"]}
                if key in ("clay_encode", "clay_transform") else {}),
             **({"per_stripe": {k: v for k, v in m["per_stripe"].items()
                                if k != "prev_ms"}}
                if key == "clay_encode" else {})}
            for name, key, src, ref, err, m in rows]


# -- the XOR-strip codec (kernel B6) ----------------------------------------

def _strip_matrices(rng) -> dict:
    """B6's check matrices: ISA encode m=1..3, jerasure reed_sol_van and
    cauchy_good at k=8, m=3, decode e=1..3, and the largest it takes."""
    from ceph_tpu_torch.models import jerasure
    from ceph_tpu_torch.ops import gf256, gf_xor_cuda
    gen = gf256.systematic_generator(gf256.rs_matrix_isa(K, M))
    mats = {f"isa m={mm}": gf256.rs_matrix_isa(K, mm) for mm in (1, 2, 3)}
    mats["reed_sol_van"] = gf256.rs_vandermonde_matrix(K, M)
    mats["cauchy_good"] = jerasure.improve_cauchy_matrix(
        gf256.cauchy_original_matrix(K, M))
    for e in (1, 2, 3):
        mats[f"decode e={e}"] = gf256.decode_matrix(
            gen, list(range(e, e + K)), list(range(e)))
    mats["random 32x128"] = rng.integers(
        0, 256, (gf_xor_cuda.MAX_M_OUT, gf_xor_cuda.MAX_K_IN), dtype=np.uint8)
    return mats


def strip_kernel_checks(dev, gen, rng) -> int:
    """Phase 9: B6 against its plain version on the card, byte-exact, and
    once against the host oracle."""
    from ceph_tpu_torch.ops import gf256, gf_xor, gf_xor_torch
    err_max, cases = 0, 0
    for label, mat in _strip_matrices(rng).items():
        kern = gf_xor.get_kernel(mat, dev)
        for b in STRIP_CHECK_B if mat.shape[1] == K else (1, 3):
            x = torch.randint(0, 256, (8 * kern.k_in, b * 512),
                              dtype=torch.uint8, device=dev, generator=gen)
            x = x.view(torch.int32).view(8 * kern.k_in, b, 128)
            got = kern.encode_strips(x)
            torch.cuda.synchronize()
            err = max_err(got, gf_xor_torch.xor_strips(kern.schedule, x))
            check(err == 0, f"B6 {label} B={b} differs from plain")
            err_max, cases = max(err_max, err), cases + 1
    isa = gf256.rs_matrix_isa(K, M)
    small = rng.integers(0, 256, (K, 3 * 4096), dtype=np.uint8)
    check(np.array_equal(gf_xor.get_kernel(isa, dev)(small),
                         gf_xor.strip_matvec_reference(isa, small)),
          "B6 vs host oracle")
    emit({"phase": "strip_kernels", "cases": cases, "blocks": STRIP_CHECK_B,
          "max_abs_err": err_max, "tolerance": 0})
    return err_max


def strip_main_path(dev, data_shards: np.ndarray) -> dict:
    """Phase 10: the XOR-strip codec at ISA reed_sol_van k=8, m=3 on the
    128 MiB batch of the RS flush (8 chunks of 16 MiB): the host-boundary
    encode, degraded reads of every erasure pattern of 1 to 3 chunks that
    loses data chunk 0, and the resident encode, with launch counts."""
    import itertools

    from ceph_tpu_torch.ops import gf256, gf_xor, gf_xor_cuda
    isa = gf256.rs_matrix_isa(K, M)
    gen = gf256.systematic_generator(isa)
    kern = gf_xor.get_kernel(isa, dev)
    walls = {}
    gf_xor_cuda.reset_launches()
    t0 = time.perf_counter()
    parity = kern(data_shards)
    walls["encode_host_boundary_s"] = time.perf_counter() - t0
    data = gf_xor.to_strips(torch.from_numpy(data_shards).to(dev))
    whole = torch.cat([data, gf_xor.to_strips(
        torch.from_numpy(parity).to(dev))]).view(K + M, 8, *data.shape[1:])
    patterns = [lost for e in (1, 2, 3)
                for lost in itertools.combinations(range(K + M), e)
                if 0 in lost]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lost in patterns:
        present = [i for i in range(K + M) if i not in lost][:K]
        dmat = gf256.decode_matrix(gen, present, list(lost))
        surv = whole[present].reshape(8 * K, *data.shape[1:])
        rec = gf_xor.get_kernel(dmat, dev).encode_strips(surv)
        check(torch.equal(rec, whole[list(lost)].reshape(rec.shape)),
              f"strip degraded read with {lost} lost")
    walls["degraded_reads_s"] = time.perf_counter() - t0
    resident = kern.encode_strips(data)
    torch.cuda.synchronize()
    launches = gf_xor_cuda.launches
    check(launches > 0, "B6 never launched on the strip path")

    # checks after the counts were read
    check(data.shape == (8 * K, RESIDENT_LANES // 4096, 128),
          f"strip shape {tuple(data.shape)}")
    check(np.array_equal(parity, gf_xor.strip_matvec_reference(
        isa, data_shards)), "strip parity vs host oracle")
    check(torch.equal(gf_xor.from_strips(resident).cpu(),
                      torch.from_numpy(parity)), "resident vs host boundary")
    emit(flush_profile(lambda: kern(data_shards), "strip_encode_profile"))
    emit({"phase": "strip_main_path", "profile": "isa reed_sol_van k=8 m=3",
          "batch_bytes": int(data_shards.size), "strips_in": list(data.shape),
          "strips_out": list(resident.shape), "patterns": len(patterns),
          "launches": {"gf_xor": launches}, "wall_s": walls, "ok": True})
    return {"data": data, "whole": whole, "gen": gen, "launches": launches}


def strip_times(dev, hbm, smi, st, b1_encode_ms: float) -> dict:
    """Phase 11: B6 encode and decode e=1..3 on the resident strips, each
    beside its bytes bound, its XOR-count bound and its plain version,
    with B1's encode time at the same bytes (phase 5)."""
    from ceph_tpu_torch.bench.ec_bench import time_cuda
    from ceph_tpu_torch.ops import gf256, gf_xor, gf_xor_torch
    data, whole, gen = st["data"], st["whole"], st["gen"]
    words = data.shape[1] * 128
    cases = {"encode": (gf256.rs_matrix_isa(K, M), data)}
    for e in (1, 2, 3):
        present = list(range(e, e + K))
        cases[f"decode e={e}"] = (
            gf256.decode_matrix(gen, present, list(range(e))),
            whole[present].reshape(8 * K, *data.shape[1:]))
    out = {}
    for label, (mat, x) in cases.items():
        kern = gf_xor.get_kernel(mat, dev)
        rows = len(kern.schedule)
        xors = sum(len(t) for t in kern.schedule) - rows
        t_bytes = (8 * K + rows) * words * 4 / hbm
        t_ops = xors * words / H100_INT32_OPS_PER_S
        ms = time_cuda(lambda: kern.encode_strips(x), 20) * 1e3
        out[label] = {
            "ms": ms, "GBps_in": 8 * K * words * 4 / ms / 1e6,
            "plain_ms": time_cuda(
                lambda: gf_xor_torch.xor_strips(kern.schedule, x), 1,
                3) * 1e3,
            "bytes_bound_ms": t_bytes * 1e3, "xor_bound_ms": t_ops * 1e3,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "xors_per_word": xors, "rows_out": rows}
    emit({"phase": "strip_times", "card": smi, "strips_in": list(data.shape),
          "b6": out, "b1_encode_ms_same_bytes": b1_encode_ms,
          "int32_ops_per_s": H100_INT32_OPS_PER_S})
    return out


def plugin_phases(dev) -> dict:
    """Phase 12: the codec layer on the card. The non-regression corpus
    for every DEFAULT_PROFILES entry plus example k=8,m=1, created on the
    host with the numpy backend and checked with the cuda backend; LRC
    k=4, m=2, l=3 on a 64 MiB object: encode, every single-chunk local
    repair and one 2-erasure read through the global layer, each equal
    to a numpy-backend codec's bytes."""
    import tempfile

    from ceph_tpu_torch.models import instance
    from ceph_tpu_torch.ops import clay_cuda, gf_block_sparse_cuda, gf_cuda
    from ceph_tpu_torch.tools import ec_non_regression as nr

    profiles = nr.DEFAULT_PROFILES + [("example", {"k": "8", "m": "1"})]
    failures, walls = [], {}
    scratch = Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as base:
        dirs = [nr.create_one(base, plugin, prof, "numpy", device="cpu")
                for plugin, prof in profiles]
        gf_cuda.reset_launches()
        clay_cuda.reset_launches()
        gf_block_sparse_cuda.reset_launches()
        t0 = time.perf_counter()
        for d in dirs:
            failures += nr.check_one(d, "cuda", device=dev)
        walls["corpus_check_s"] = time.perf_counter() - t0
    corpus_launches = {"gf_matvec": gf_cuda.launches,
                       "clay_encode": clay_cuda.encode_launches,
                       "gf_block_sparse": gf_block_sparse_cuda.launches}
    check(not failures, f"corpus check on cuda: {failures[:5]}")
    check(corpus_launches["gf_matvec"] > 0, "corpus check never ran B1")

    kml = {"k": "4", "m": "2", "l": "3"}
    rng = np.random.default_rng(SEED + 3)
    obj = rng.integers(0, 256, LRC_OBJECT, dtype=np.uint8)
    host = instance().factory("lrc", dict(kml, backend="numpy"),
                              device="cpu")
    want = host.encode(list(range(8)), obj)
    codec = instance().factory("lrc", kml, device=dev)
    cs = codec.get_chunk_size(LRC_OBJECT)
    gf_cuda.reset_launches()
    t0 = time.perf_counter()
    got = codec.encode(list(range(8)), obj)
    walls["lrc_encode_s"] = time.perf_counter() - t0
    reads = {}
    t0 = time.perf_counter()
    for lost in range(8):
        plan = codec.minimum_to_decode([lost], [i for i in range(8)
                                                if i != lost])
        reads[lost] = sorted(plan)
        out = codec.decode([lost], {i: got[i] for i in plan}, cs)
        check(len(plan) == 3 and np.array_equal(out[lost], want[lost]),
              f"lrc local repair of chunk {lost} (plan {sorted(plan)})")
    walls["lrc_local_repairs_s"] = time.perf_counter() - t0
    lost2 = [0, 1]
    avail = [i for i in range(8) if i not in lost2]
    plan2 = codec.minimum_to_decode(lost2, avail)
    t0 = time.perf_counter()
    out2 = codec.decode(lost2, {i: got[i] for i in plan2}, cs)
    walls["lrc_global_read_s"] = time.perf_counter() - t0
    lrc_launches = gf_cuda.launches
    check(lrc_launches > 0, "LRC on cuda never launched B1")
    for i in range(8):
        check(np.array_equal(got[i], want[i]), f"lrc chunk {i} vs numpy")
    emit(flush_profile(lambda: codec.encode(list(range(8)), obj),
                       "lrc_encode_profile"))
    ref2 = host.decode(lost2, {i: want[i] for i in plan2}, cs)
    for i in lost2:
        check(np.array_equal(out2[i], want[i]) and
              np.array_equal(ref2[i], want[i]), f"lrc global read of {i}")
    emit({"phase": "plugins", "corpus_profiles": len(dirs),
          "corpus_failures": len(failures), "corpus_launches": corpus_launches,
          "lrc_profile": kml, "lrc_object_bytes": LRC_OBJECT,
          "lrc_chunk_size": cs, "lrc_local_plans": reads,
          "lrc_global_plan": sorted(plan2), "lrc_launches": lrc_launches,
          "wall_s": walls, "ok": True})
    return {"corpus_launches": corpus_launches, "lrc_launches": lrc_launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from ceph_tpu_torch.bench.b5_ab import device_ms
    from ceph_tpu_torch.bench.ec_bench import time_cuda
    from ceph_tpu_torch.models import instance
    from ceph_tpu_torch.ops import (crc32c_cuda, crc32c_torch, cuda_build,
                                    gf256, gf_cuda, gf_torch)
    from ceph_tpu_torch.osd import ec_util
    from ceph_tpu_torch.utils import checksum

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device -----------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    hbm, hbm_src = hbm_rate()
    emit({"phase": "device", "name": name,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "hbm_bytes_per_s": hbm, "hbm_source": hbm_src,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build_all(["gf_matvec", "crc32c_rows", "clay_encode",
                                 "clay_transform", "gf_block_sparse",
                                 "gf_xor"])
    build_s = time.perf_counter() - t0
    for kname, log in logs.items():
        print(f"--- nvcc {kname} ---\n{log}", file=sys.stderr)
    emit({"phase": "build", "seconds": build_s, "kernels": sorted(logs),
          "dir": str(cuda_build.BUILD_DIR)})

    # -- 3. kernels against their plain versions -------------------------
    rng = np.random.default_rng(SEED)
    isa = gf256.rs_matrix_isa(K, M)
    gen = gf256.systematic_generator(isa)
    mats = {f"encode m={mm}": gf256.rs_matrix_isa(K, mm) for mm in (1, 2, 3)}
    for e in (1, 2, 3):
        mats[f"decode e={e}"] = gf256.decode_matrix(
            gen, list(range(e, e + K)), list(range(e)))
    for mm in B1_ROWS:
        mats[f"random {mm}x8"] = rng.integers(0, 256, (mm, K), dtype=np.uint8)
    mats["random 32x128"] = rng.integers(0, 256, (32, 128), dtype=np.uint8)
    b1_err, b1_cases = 0, 0
    for label, mat in mats.items():
        kk = mat.shape[1]
        for n in B1_N + ("offset",):
            if n == "offset":    # one byte off 16-byte alignment: byte path
                raw = torch.randint(0, 256, (kk * 4096 + 1,),
                                    dtype=torch.uint8, device=dev)
                d = raw[1:].view(kk, 4096)
            else:
                d = torch.randint(0, 256, (kk, n), dtype=torch.uint8,
                                  device=dev)
            got = gf_cuda.matvec_device(mat, d)
            torch.cuda.synchronize()
            err = max_err(got, gf_torch.matvec(mat, d))
            check(err == 0, f"B1 {label} N={n} differs from plain")
            b1_err, b1_cases = max(b1_err, err), b1_cases + 1
    small = rng.integers(0, 256, (K, 4099), dtype=np.uint8)
    check(np.array_equal(
        gf_cuda.matvec_device(isa, torch.from_numpy(small).to(dev)).cpu()
        .numpy(), gf256.gf_matvec_chunks(isa, small)), "B1 vs host oracle")
    main_rows = OBJECTS * (K + M) * (OBJECT_BYTES // K) // 512
    # B2's tile (rows a warp reduces together) +- 1, one grid-stride round
    # of its one-block-an-SM grid and past it
    tile = crc32c_cuda.ROWS
    wrap = torch.cuda.get_device_properties(dev).multi_processor_count * \
        crc32c_cuda.THREADS // 32 * tile
    b2_rows = (1, tile - 1, tile, tile + 1, 1000, 65536 + 3, wrap, wrap + 1,
               2 * wrap + tile + 3, main_rows)
    b2_err, b2_cases = 0, 0
    for rows in b2_rows:
        x = torch.randint(0, 256, (rows, 512), dtype=torch.uint8, device=dev)
        got = crc32c_cuda.crc_rows(x)
        torch.cuda.synchronize()
        err = max_err(got, crc32c_torch.crc_rows(x))
        check(err == 0, f"B2 rows={rows} differs from plain")
        b2_err, b2_cases = max(b2_err, err), b2_cases + 1
    raw = torch.zeros(4 * 512 + 1, dtype=torch.uint8, device=dev)
    try:
        crc32c_cuda.crc_rows(raw[1:].view(4, 512))
        b2_unaligned = "launched"
    except ValueError as exc:
        b2_unaligned = f"raised: {exc}"
    check(b2_unaligned.startswith("raised"),
          "B2 took a pointer one byte off alignment")
    xs = rng.integers(0, 256, (33, 512), dtype=np.uint8)
    want = checksum.crc32c_rows(xs, 0) ^ np.uint32(crc32c_torch.zeros_crc(512, 0))
    check(crc32c_cuda.crc_rows(torch.from_numpy(xs).to(dev)).cpu().tolist()
          == want.astype(np.int64).tolist(), "B2 vs host oracle")
    emit({"phase": "kernels", "gf_matvec_matrices": list(mats),
          "gf_matvec_n": list(B1_N) + ["offset 4096"],
          "gf_matvec_cases": b1_cases,
          "gf_matvec_max_abs_err": b1_err, "crc32c_rows_cases": b2_cases,
          "crc32c_rows_max_abs_err": b2_err, "crc32c_rows_rows": b2_rows,
          "crc32c_rows_unaligned": b2_unaligned, "tolerance": 0})

    # -- 4. main path ----------------------------------------------------
    codec = instance().factory(
        "isa", {"k": str(K), "m": str(M), "technique": "reed_sol_van"},
        device=dev)
    check(codec.resolved_backend == "cuda", "codec does not resolve to B1")
    sinfo = ec_util.StripeInfo(stripe_width=K * CHUNK, chunk_size=CHUNK)
    batch = rng.integers(0, 256, OBJECTS * OBJECT_BYTES, dtype=np.uint8)
    bufs = [batch[i * OBJECT_BYTES:(i + 1) * OBJECT_BYTES]
            for i in range(OBJECTS)]

    def flush():
        b = ec_util.StripeBatcher(sinfo, codec)
        for op, buf in enumerate(bufs):
            b.append(op, buf)
        return b.flush(with_crcs=True)

    gf_cuda.reset_launches()
    crc32c_cuda.reset_launches()
    t0 = time.perf_counter()
    results = flush()
    first_flush_s = time.perf_counter() - t0
    flush_launches = {"gf_matvec": gf_cuda.launches,
                      "crc32c_rows": crc32c_cuda.launches}
    streams = {i: np.concatenate([r[1][i] for r in results])
               for i in range(K + M)}
    reads = {}
    for lost in ([0], [0, 1]):
        avail = {i: streams[i] for i in range(K + M) if i not in lost}
        t0 = time.perf_counter()
        out = ec_util.decode(sinfo, codec, avail, lost)
        reads[f"e={len(lost)}"] = time.perf_counter() - t0
        for i in lost:
            check(np.array_equal(out[i], streams[i]),
                  f"degraded read of shard {i} with {lost} lost")
    launches = {"gf_matvec": gf_cuda.launches,
                "crc32c_rows": crc32c_cuda.launches}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")

    check([r[0] for r in results] == list(range(OBJECTS)), "op order")
    data_shards = np.ascontiguousarray(
        batch.reshape(-1, K, CHUNK).transpose(1, 0, 2).reshape(K, -1))
    host_parity = gf256.gf_matvec_chunks(isa, data_shards)
    for i in range(K):
        check(np.array_equal(streams[i], data_shards[i]), f"data shard {i}")
    for j in range(M):
        check(np.array_equal(streams[K + j], host_parity[j]),
              f"parity shard {K + j} vs host oracle")
    seg = OBJECT_BYTES // K
    segs = np.stack([streams[i][o * seg:(o + 1) * seg]
                     for o in range(OBJECTS) for i in range(K + M)])
    host_crcs = checksum.crc32c_rows(segs, ec_util.HINFO_SEED)
    got_crcs = []
    for _op, shards, crcs in results:
        check(crcs is not None, "fused flush returned no crcs")
        hi = ec_util.HashInfo(K + M)
        hi.append_linear(0, crcs, len(shards[0]))
        got_crcs += [hi.get_chunk_hash(i) for i in range(K + M)]
    check(got_crcs == host_crcs.tolist(), "shard crcs vs host crc32c")
    emit({"phase": "main_path", "profile": "isa reed_sol_van k=8 m=3",
          "objects": OBJECTS, "object_bytes": OBJECT_BYTES,
          "chunk_size": CHUNK, "flush_bytes": OBJECTS * OBJECT_BYTES,
          "crc_segments_checked": len(got_crcs), "flush_launches":
          flush_launches, "launches": launches,
          "first_flush_s": first_flush_s, "degraded_read_s": reads,
          "ok": True})

    # -- 5. times ----------------------------------------------------------
    gen_t = torch.Generator(device=dev)
    gen_t.manual_seed(SEED)
    data = torch.randint(0, 256, (K, RESIDENT_LANES), dtype=torch.uint8,
                         device=dev, generator=gen_t)
    timings = {}
    for label, mat in (("encode", isa),
                       ("decode e=1", gf256.decode_matrix(
                           gen, list(range(1, K + 1)), [0])),
                       ("decode e=2", gf256.decode_matrix(
                           gen, list(range(2, K + 2)), [0, 1]))):
        # through the entry point (the span PREV_B1_MS was taken on) and
        # as the profiler's device time of the kernel
        s = time_cuda(lambda: gf_cuda.matvec_device(mat, data), 20)
        check(torch.equal(gf_cuda.matvec_device(mat, data),
                          gf_torch.matvec(mat, data)), f"B1 {label} resident")
        t_bytes = (K + mat.shape[0]) * RESIDENT_LANES / hbm
        t_ops = 2 * 64 * mat.size * RESIDENT_LANES / H100_INT8_OPS_PER_S
        bits = int(np.unpackbits(mat).sum())
        timings[label] = {
            "ms": s * 1e3, "prev_ms": PREV_B1_MS[label],
            "device_ms": device_ms(lambda: gf_cuda.matvec_device(mat, data),
                                   kernel="gf_matvec"),
            "GBps": K * RESIDENT_LANES / s / 1e9,
            "plain_ms": time_cuda(lambda: gf_torch.matvec(mat, data), 2,
                                  3) * 1e3,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # 8 plane-word XORs per set coefficient bit per 32 lanes
            "xor_floor_ms": 8 * bits * RESIDENT_LANES / 32
            / H100_INT32_OPS_PER_S * 1e3,
            "coef_bits": bits, "launch_plan": gf_cuda.launch_plan(
                RESIDENT_LANES, mat.shape[0])._asdict()}
    plain_b1 = timings["encode"]["plain_ms"] / 1e3
    n = RESIDENT_LANES
    b1_bound_bytes = (K + M) * n / hbm
    b1_bound_ops = 2 * 8 * M * 8 * K * n / H100_INT8_OPS_PER_S
    del data
    rows_x = torch.randint(0, 256, (main_rows, 512), dtype=torch.uint8,
                           device=dev, generator=gen_t)
    # B2 through the entry point (the span PREV_B2_MS was taken on), its C
    # launcher alone into a preallocated output, and the profiler's device
    # time of the kernel; held against plain at this shape
    b2_s = time_cuda(lambda: crc32c_cuda.crc_rows(rows_x), 20)
    plain_rows = crc32c_torch.crc_rows(rows_x)
    check(torch.equal(crc32c_cuda.crc_rows(rows_x), plain_rows),
          "B2 at the timed shape differs from plain")
    del plain_rows
    b2_lib, b2_fn = crc32c_cuda._lib()
    b2_out = torch.empty(main_rows, dtype=torch.int64, device=dev)
    b2_args = (rows_x.data_ptr(),
               crc32c_cuda._basis().on(dev)["basis"].data_ptr(),
               b2_out.data_ptr(), main_rows,
               torch.cuda.current_stream(dev).cuda_stream)
    b2_wrapper_s = time_cuda(lambda: cuda_build.check(
        b2_lib, b2_fn(*b2_args), "crc32c_rows launch"), 20)
    b2_dev_ms = device_ms(lambda: crc32c_cuda.crc_rows(rows_x),
                          kernel="crc32c_rows_kernel")
    plain_b2 = time_cuda(lambda: crc32c_torch.crc_rows(rows_x), 2, 3)
    # 512 bytes read and one int64 written a row
    b2_bound_bytes = main_rows * (512 + 8) / hbm
    b2_bound_ops = 2 * 4096 * 32 * main_rows / H100_INT8_OPS_PER_S
    del rows_x, b2_out
    # stage 2: the fused flush's combine of 1408 segments of 256 rows
    n_seg, seg_rows = OBJECTS * (K + M), OBJECT_BYTES // K // 512
    rowc = torch.randint(0, 1 << 32, (n_seg, seg_rows), dtype=torch.int64,
                         device=dev, generator=gen_t)
    check(torch.equal(crc32c_torch.combine_rows(rowc).cpu(),
                      crc32c_torch.combine_rows(rowc.cpu())),
          "stage-2 combine on the card differs from the CPU")
    stage2 = {"shape": [n_seg, seg_rows],
              "ms": time_cuda(lambda: crc32c_torch.combine_rows(rowc),
                              20) * 1e3,
              "device_ms": device_ms(
                  lambda: crc32c_torch.combine_rows(rowc), kernel="")}
    del rowc
    walls = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(3):
        t0 = time.perf_counter()
        flush()
        walls.append(time.perf_counter() - t0)
    flush_s = statistics.median(walls)
    emit(flush_profile(flush))
    emit({"phase": "times", "card": smi,
          "b1_resident_bytes": K * RESIDENT_LANES, "b1": timings,
          "b1_plain_ms": plain_b1 * 1e3,
          "b1_bound_ms": max(b1_bound_bytes, b1_bound_ops) * 1e3,
          "b2_rows": main_rows, "b2_ms": b2_s * 1e3, "b2_prev_ms": PREV_B2_MS,
          "b2_wrapper_ms": b2_wrapper_s * 1e3, "b2_device_ms": b2_dev_ms,
          "b2_GBps": main_rows * 512 / b2_s / 1e9,
          "b2_plain_ms": plain_b2 * 1e3,
          "b2_bound_ms": max(b2_bound_bytes, b2_bound_ops) * 1e3,
          "stage2_combine": stage2,
          "fused_flush_s": flush_s, "fused_flush_runs_s": walls,
          "fused_flush_GBps": OBJECTS * OBJECT_BYTES / flush_s / 1e9,
          "fused_flush_peak_mem_bytes": torch.cuda.max_memory_allocated(dev)})

    # -- 5 (scrub). the deep-scrub verify program at phase 5d's batch shape:
    # a PG's 16 objects of 11 shards of 128 KiB, seeded bytes, their parity
    # and one flip (timed here, with the other kernel times: phase 5d runs
    # in a child that takes no profiler session, and runs last)
    vdata = np.random.default_rng(SEED + 18).integers(
        0, 256, (SCRUB_BATCH_OBJECTS, K, OBJECT_BYTES // K), dtype=np.uint8)
    vbatch = np.concatenate(
        [vdata, np.stack([gf256.gf_matvec_chunks(isa, d) for d in vdata])],
        axis=1)
    vbatch[0, 0, 0] ^= 1
    del vdata
    emit({"phase": "scrub_times", "card": smi,
          "verify": verify_times(dev, isa, vbatch, hbm, profiled=True)})
    del vbatch

    # -- 5b. the device engine ---------------------------------------------
    del results, streams
    engine_phase(dev, codec, sinfo, smi, flush_s)

    # -- 6-8. Clay -------------------------------------------------------
    clay = clay_phases(dev, hbm, smi)

    # -- 9-11. the XOR-strip codec (B6) ------------------------------------
    gen_s = torch.Generator(device=dev)
    gen_s.manual_seed(SEED + 4)
    b6_err = strip_kernel_checks(dev, gen_s, np.random.default_rng(SEED + 4))
    st = strip_main_path(dev, data_shards)
    b6_launches = st["launches"]
    b6 = strip_times(dev, hbm, smi, st, timings["encode"]["ms"])["encode"]
    del st

    # -- 12. the plugin layer: corpus and LRC ------------------------------
    plugin_phases(dev)

    # -- 13. the engine under torch.profiler ------------------------------
    engine_profile_phase(dev, codec, sinfo)

    # -- 5c-5h. the cluster phases, each in a child process on the card,
    # after every profiler session of this process: sessions after a
    # cluster child have come back empty (phase 8) --------------------------
    # 5c. the OSD chain: a MiniCluster pool on the card
    threaded = phase_in_child(CLUSTER_CHILD_ARG, "cluster")
    cluster_launches = threaded["launches"]
    # 5e. the same pool on crimson OSDs, beside 5c's threaded steps
    crimson = phase_in_child(CRIMSON_CHILD_ARG, "crimson")
    emit(crimson_vs_threaded(crimson, threaded, smi))
    # 5f. degraded serving under cephx
    serving = phase_in_child(SERVING_CHILD_ARG, "serving")
    serving_launches = {"preload": serving["preload"]} | {
        p["phase"]: p["launches"] for p in serving["phases"]}
    # 5g. the mgr's default modules with the closed-loop tuner live
    mgr = phase_in_child(MGR_CHILD_ARG, "mgr")
    check(mgr["build_ledger"]["compile_cache_misses"] == 0 and
          mgr["build_ledger"]["compile_cache_hits"] > 0,
          f"5g ran nvcc for a library phase 2 built: {mgr['build_ledger']}")
    mgr_launches = mgr["launches"] | {
        "traced_burst": mgr["traced_burst"]["launches"]}
    # 5h. 5c's deployment under the lock witness and lock timing
    witness = phase_in_child(WITNESS_CHILD_ARG, "witness")
    emit(witness_vs_cluster(witness, threaded, smi))
    witness_launches = witness["launches"]
    # 5d. deep scrub over BlockStore
    scrub_launches = phase_in_child(SCRUB_CHILD_ARG, "scrub")["launches"]

    # -- 9. summary --------------------------------------------------------
    emit({"kernels": [
        {"name": "gf_matvec (B1)", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/gf_matvec.cu",
         "replaces": "ceph_tpu/ops/gf_pallas.py:71",
         "launches": launches["gf_matvec"], "max_abs_err": b1_err,
         "ms": timings["encode"]["ms"], "plain_ms": plain_b1 * 1e3,
         "bound_ms": max(b1_bound_bytes, b1_bound_ops) * 1e3,
         "bound_by": "bytes" if b1_bound_bytes >= b1_bound_ops
         else "operations",
         "library_ms": None, "pass": True,
         "device_ms": timings["encode"]["device_ms"],
         "cluster_launches": {step: n["gf_matvec"] for step, n
                              in cluster_launches.items()},
         "crimson_launches": {step: n["gf_matvec"] for step, n
                              in crimson["launches"].items()},
         "serving_launches": {step: n["gf_matvec"] for step, n
                              in serving_launches.items()},
         "mgr_launches": {step: n["gf_matvec"] for step, n
                          in mgr_launches.items()},
         "witness_launches": {step: n["gf_matvec"] for step, n
                              in witness_launches.items()},
         "scrub_launches": {step: n["gf_matvec"] for step, n
                            in scrub_launches.items()},
         "decode": {label: {key: timings[label][key] for key in
                            ("ms", "device_ms", "bound_ms")}
                    for label in ("decode e=1", "decode e=2")}},
        {"name": "crc32c_rows (B2)", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/crc32c_rows.cu",
         "replaces": "ceph_tpu/ops/crc32c_device.py:165",
         "launches": launches["crc32c_rows"], "max_abs_err": b2_err,
         "ms": b2_s * 1e3, "plain_ms": plain_b2 * 1e3,
         "bound_ms": max(b2_bound_bytes, b2_bound_ops) * 1e3,
         "bound_by": "bytes" if b2_bound_bytes >= b2_bound_ops
         else "operations",
         "library_ms": None, "pass": True,
         "wrapper_ms": b2_wrapper_s * 1e3, "device_ms": b2_dev_ms,
         "cluster_launches": {step: n["crc32c_rows"] for step, n
                              in cluster_launches.items()},
         "crimson_launches": {step: n["crc32c_rows"] for step, n
                              in crimson["launches"].items()},
         "serving_launches": {step: n["crc32c_rows"] for step, n
                              in serving_launches.items()},
         "mgr_launches": {step: n["crc32c_rows"] for step, n
                          in mgr_launches.items()},
         "witness_launches": {step: n["crc32c_rows"] for step, n
                              in witness_launches.items()},
         "scrub_launches": {step: n["crc32c_rows"] for step, n
                            in scrub_launches.items()}},
    ] + clay + [
        {"name": "gf_xor (B6)", "route": "cuda",
         "source": "ceph_tpu_torch/csrc/gf_xor.cu",
         "replaces": "ceph_tpu/ops/gf_xor_pallas.py:50",
         "launches": b6_launches, "max_abs_err": b6_err, "ms": b6["ms"],
         "plain_ms": b6["plain_ms"], "bound_ms": b6["bound_ms"],
         "bound_by": b6["bound_by"], "library_ms": None, "pass": True}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if CLUSTER_CHILD_ARG in sys.argv[1:]:
        raise SystemExit(child_main(cluster_phase))
    if SCRUB_CHILD_ARG in sys.argv[1:]:
        raise SystemExit(child_main(scrub_phase))
    if CRIMSON_CHILD_ARG in sys.argv[1:]:
        raise SystemExit(child_main(crimson_phase))
    if SERVING_CHILD_ARG in sys.argv[1:]:
        raise SystemExit(child_main(serving_phase))
    if MGR_CHILD_ARG in sys.argv[1:]:
        raise SystemExit(child_main(mgr_phase))
    if WITNESS_CHILD_ARG in sys.argv[1:]:
        armed = WITNESS_UNARMED_ARG not in sys.argv[1:]
        raise SystemExit(child_main(
            lambda smi: witness_phase(smi, armed=armed)))
    raise SystemExit(main())
