"""Snapshots and crash-consistent durability for the spatial index.

Counterpart of ``repro.checkpoint`` for the index: the snapshot format
(:mod:`repro_torch.checkpoint.spatial`) and :class:`DurableIndex`
(snapshot + mutation WAL).  The reference's ``CheckpointManager`` serves
its training loop, which is not ported yet.
"""

from .durable import DurableIndex, MutationResult, live_ids, mutation_workload
from .spatial import (
    FORMAT_VERSION,
    SnapshotError,
    load_index,
    save_index,
    snapshot_meta,
)

__all__ = [
    "DurableIndex",
    "MutationResult",
    "live_ids",
    "mutation_workload",
    "FORMAT_VERSION",
    "SnapshotError",
    "load_index",
    "save_index",
    "snapshot_meta",
]
