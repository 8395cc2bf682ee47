"""Local object stores — the src/os/ layer.

``ObjectStore`` is the transactional per-OSD storage interface
(src/os/ObjectStore.h): collections of objects with byte data, xattrs
and omap, mutated only through atomic ``Transaction`` batches. The port
has the in-RAM ``MemStore`` (src/os/memstore/); the reference's durable
stores (``BlockStore``, ``KStore``) are not ported yet (ROADMAP A.6).
"""

from ceph_tpu_torch.store.object_store import (  # noqa: F401
    EIOError,
    ObjectStore,
    StoreError,
    Transaction,
    create_store,
)
from ceph_tpu_torch.store.memstore import MemStore  # noqa: F401
