"""statestore — peer-replicated durable training state; the counterpart
of :mod:`moolib_tpu.statestore`, byte- and wire-compatible with it.

Three layers:

- :mod:`~moolib_tpu_torch.statestore.bundle` — the on-disk format: a version
  is a content-hashed chunked bundle (manifest + per-chunk sha256),
  written crash-atomically (stage + fsync + one rename + dir fsync) and
  GC'd crash-atomically (rename-then-delete).
- :class:`~moolib_tpu_torch.statestore.store.StateStore` — local store +
  the ``StateStoreService`` wire family (fetch: versions / manifest /
  chunk; push: offer / ingest / commit) + restore negotiation
  (newest version whose manifest hash agrees on a quorum of holders,
  chunks pulled with hash verification and per-chunk holder failover).
- :class:`~moolib_tpu_torch.statestore.store.Replicator` — attaches to an
  Accumulator's durability hook and streams each committed model
  version to K follower replicas off the training thread.
"""

from .bundle import (
    CHUNK_BYTES_DEFAULT,
    BundleCorrupt,
    StateStoreError,
    WriteFailed,
)
from .store import LOCAL, Negotiated, Replicator, StateStore

__all__ = [
    "CHUNK_BYTES_DEFAULT",
    "LOCAL",
    "BundleCorrupt",
    "Negotiated",
    "Replicator",
    "StateStore",
    "StateStoreError",
    "WriteFailed",
]
