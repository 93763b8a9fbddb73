"""Merge policy of the live-update subsystem.

A copy of ``repro.update.policy`` (DESIGN.md §8).

The delta buffer absorbs inserts at O(1) and tombstones absorb deletes at
O(1), but both degrade queries: every query pays one flat sweep over the
buffer levels, and tombstoned base slots still stream through the kernel
only to be masked in the epilogue.  The :class:`MergePolicy` decides when
that rent exceeds the cost of compacting everything into a fresh base
build — a size trigger on the buffer fill and a ratio trigger on dead
base objects, with ``auto=False`` leaving compaction entirely to explicit
``SpatialIndex.flush()`` calls (buffer overflow still merges: a full
buffer physically cannot accept the next insert).
"""

from __future__ import annotations

import dataclasses

DEFAULT_CAPACITY = 256


@dataclasses.dataclass(frozen=True)
class MergePolicy:
    """When the delta buffer + tombstones fold into a fresh base build.

    capacity:            delta-buffer slots (device-resident rows swept by
                         every query, so also the flat-scan rent ceiling).
    max_fill:            merge once valid slots / capacity reaches this
                         (1.0 = only when the buffer is full).
    max_tombstone_ratio: merge once dead base objects / base size reaches
                         this (dead slots still stream through the sweep).
    auto:                False = triggers off; merge only on explicit
                         ``flush()`` or physical buffer overflow.
    """

    capacity: int = DEFAULT_CAPACITY
    max_fill: float = 1.0
    max_tombstone_ratio: float = 0.5
    auto: bool = True

    def __post_init__(self):
        if int(self.capacity) < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if not 0.0 < self.max_fill <= 1.0:
            raise ValueError(f"max_fill must be in (0, 1], got {self.max_fill}")
        if not 0.0 < self.max_tombstone_ratio <= 1.0:
            raise ValueError(
                "max_tombstone_ratio must be in (0, 1], got "
                f"{self.max_tombstone_ratio}"
            )

    def should_flush(self, *, fill: float, tombstone_ratio: float) -> bool:
        """Post-mutation check: is it time to compact?"""
        if not self.auto:
            return False
        return fill >= self.max_fill or tombstone_ratio >= self.max_tombstone_ratio


def as_policy(merge=None, capacity=None) -> MergePolicy:
    """Coerce the façade's ``merge=`` / ``capacity=`` build options.

    ``merge`` may be a :class:`MergePolicy`, a kwargs dict for one, or
    None; ``capacity`` (when given) overrides the policy's capacity —
    the common one-knob case ``SpatialIndex.build(..., capacity=512)``.
    """
    if merge is None:
        policy = MergePolicy()
    elif isinstance(merge, MergePolicy):
        policy = merge
    elif isinstance(merge, dict):
        policy = MergePolicy(**merge)
    else:
        raise TypeError(
            f"merge must be a MergePolicy or dict, got {type(merge).__name__}"
        )
    if capacity is not None:
        policy = dataclasses.replace(policy, capacity=int(capacity))
    return policy
