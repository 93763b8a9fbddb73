"""Live-update subsystem: delta buffer, tombstone deletes, merge policy.

Counterpart of ``repro.update``: ``SpatialIndex.insert`` / ``.delete`` /
``.flush`` absorb online mutations without a rebuild per operation, and
every backend's results stay bit-identical to the host mqr
insertion-rule oracle.  :mod:`repro_torch.update.wal` is the mutation
write-ahead log of :class:`repro_torch.checkpoint.DurableIndex`.
"""

from .buffer import AugmentedArrays, BufferFullError, UpdateLog
from .policy import DEFAULT_CAPACITY, MergePolicy, as_policy
from .wal import WalCorruption, WriteAheadLog, read_wal, recover_wal, repair_wal

__all__ = [
    "AugmentedArrays",
    "BufferFullError",
    "UpdateLog",
    "MergePolicy",
    "as_policy",
    "DEFAULT_CAPACITY",
    "WalCorruption",
    "WriteAheadLog",
    "read_wal",
    "recover_wal",
    "repair_wal",
]
