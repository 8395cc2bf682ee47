"""Local object stores — the src/os/ layer.

``ObjectStore`` is the transactional per-OSD storage interface
(src/os/ObjectStore.h): collections of objects with byte data, xattrs
and omap, mutated only through atomic ``Transaction`` batches. The
implementations, as in the reference (src/os/ObjectStore.cc:62-95
factory):

  - ``MemStore``   — in-RAM fake for tests (src/os/memstore/).
  - ``BlockStore`` — the BlueStore-role durable store: log-structured
    data file + WAL-backed kv metadata + crc32c checksum-on-read
    (src/os/bluestore/).
  - ``KStore``     — everything in the WAL-backed kv (src/os/kstore/).
"""

from ceph_tpu_torch.store.object_store import (  # noqa: F401
    EIOError,
    ObjectStore,
    StoreError,
    Transaction,
    create_store,
)
from ceph_tpu_torch.store.memstore import MemStore  # noqa: F401
from ceph_tpu_torch.store.blockstore import BlockStore  # noqa: F401
