"""Live-update subsystem: delta buffer, tombstone deletes, merge policy.

Counterpart of ``repro.update``: ``SpatialIndex.insert`` / ``.delete`` /
``.flush`` absorb online mutations without a rebuild per operation, and
every backend's results stay bit-identical to the host mqr
insertion-rule oracle.  The reference's write-ahead log (``update/wal.py``)
belongs with durability (ROADMAP queue A item 5) and is not ported here.
"""

from .buffer import AugmentedArrays, BufferFullError, UpdateLog
from .policy import DEFAULT_CAPACITY, MergePolicy, as_policy

__all__ = [
    "AugmentedArrays",
    "BufferFullError",
    "UpdateLog",
    "MergePolicy",
    "as_policy",
    "DEFAULT_CAPACITY",
]
