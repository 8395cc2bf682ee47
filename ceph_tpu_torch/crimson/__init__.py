"""crimson — shard-per-core, run-to-completion OSD (src/crimson/).

The reference's crimson is a seastar rewrite of the OSD built on one
bet: cores never share mutable state. Every PG is pinned to exactly
one reactor from admission to commit reply; cross-core work travels
as messages (``smp::submit_to``); within a reactor nothing preempts
between awaits, so the threaded OSD's synchronous-critical-section
locks disappear. The analog here keeps that discipline in asyncio
and serves the MAINLINE data path:

- ``crimson/osd.py``: admission, per-PG sequencing, the
  run-to-completion EC write/read paths, replica sub-op service,
  batched commit acks (one wakeup per client connection per flush);
- ``crimson/reactor.py``: the reactor (event loop + per-shard
  ``ObjectStore`` + every per-op table) and the per-shard
  ``pg_backend.Listener`` the mainline ``ECBackend`` runs against;
- ``crimson/readpath.py``: the awaitable EC shard-read fan-out
  (retry ladder + version agreement, host-codec reconstruct).

The wire protocol is the mainline one: a stock objecter/load_gen
cannot tell which OSD flavor answered, and crimson + threaded OSDs
interoperate shard-for-shard in one cluster. Still out of scope
(reference parity): peering, recovery, snapshots, tiering, scrub.
"""

from ceph_tpu_torch.crimson.osd import CrimsonOSD  # noqa: F401
from ceph_tpu_torch.crimson.reactor import Reactor, ReactorServices  # noqa: F401
