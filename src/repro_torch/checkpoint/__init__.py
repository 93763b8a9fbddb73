"""Snapshots and crash-consistent durability for the spatial index, and
checkpoints of training state.

Counterpart of ``repro.checkpoint``: the snapshot format
(:mod:`repro_torch.checkpoint.spatial`), :class:`DurableIndex` (snapshot +
mutation WAL) and :class:`CheckpointManager` (the training loop's npz
checkpoints, ``launch/train.py``).
"""

from .checkpoint import CheckpointManager
from .durable import DurableIndex, MutationResult, live_ids, mutation_workload
from .spatial import (
    FORMAT_VERSION,
    SnapshotError,
    load_index,
    save_index,
    snapshot_meta,
)

__all__ = [
    "CheckpointManager",
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
