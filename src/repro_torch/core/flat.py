"""Level schedule: the dense per-level form the fused region sweep consumes.

PyTorch counterpart of ``repro.core.flat``'s schedule half (the pointer
trees and ``FlatTree`` are not ported yet; see ROADMAP.md).  A schedule is
a dataclass of torch tensors living on one device; :meth:`to` moves it.

The fused sweep computes, level by level,

    active[l, q, j] = active[l-1, q, parent[l, j]] & overlaps(mbr[l, j], q)

which is the breadth-first frontier of the pointer search, so
``active[l].sum()`` reproduces the paper's per-level disk-access counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# MBR sentinel for padded slots: lo=+inf, hi=-inf never overlaps anything.
NEVER_MBR = np.array([np.inf, np.inf, -np.inf, -np.inf], np.float32)

# Quantized-tile grid: real coordinates land in cells [0, CELLS]; lo=CELLS+1
# is the integer never-overlap sentinel (queries are clipped to <= CELLS).
CELLS = 65534
Q_NEVER_MBR = np.array([CELLS + 1, CELLS + 1, 0, 0], np.uint16)

# Coarse uint8 grid of the hierarchical (compact8) form; that form is not
# ported yet, the constants are kept so the grids stay defined in one place.
CELLS8 = 254
Q8_NEVER_MBR = np.array([CELLS8 + 1, CELLS8 + 1, 0, 0], np.uint8)


def overlaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-boundary rectangle intersection, broadcasting over ``[..., 4]``."""
    return (
        (a[..., 0] <= b[..., 2])
        & (b[..., 0] <= a[..., 2])
        & (a[..., 1] <= b[..., 3])
        & (b[..., 1] <= a[..., 3])
    )


def _move(obj, device):
    """Copy every tensor field of a schedule dataclass to ``device``."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _move(v, device)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass(frozen=True)
class LevelSchedule:
    """Dense per-level form of a spatial tree for the fused level sweep.

    mbr_cm:   (L, 4, W) float32 — node MBRs coordinate-major (lx, ly, hx, hy
              rows; W = max level width).  Unused slots hold ``NEVER_MBR``.
    parent:   (L, W) int32 — slot of the parent in level l-1 (0 at level 0
              and for unused slots; harmless, those never overlap).
    n_real:   (L,) int32 — real (non-padding) slots per level.
    obj_mbr:  (E, 4) float32 — MBR of each object entry.
    obj_level/obj_slot: (E,) int32 — the node holding the entry.
    obj_id:   (E,) int32 — object id the entry resolves to (tree schedules
              may repeat ids).
    n_objects: dense object-id space size.
    root_unconditional: the pointer search visits the root without testing
              its MBR (tree schedules); the group pyramid tests every level.
    test_object_mbr: whether an object hit also requires the entry MBR to
              overlap the query (trees); the pyramid's deepest group is the
              membership test.
    """

    mbr_cm: torch.Tensor
    parent: torch.Tensor
    n_real: torch.Tensor
    obj_mbr: torch.Tensor
    obj_level: torch.Tensor
    obj_slot: torch.Tensor
    obj_id: torch.Tensor
    n_objects: int
    root_unconditional: bool = True
    test_object_mbr: bool = True

    @property
    def levels(self) -> int:
        return self.mbr_cm.shape[0]

    @property
    def width(self) -> int:
        return self.mbr_cm.shape[2]

    @property
    def device(self) -> torch.device:
        return self.mbr_cm.device

    def to(self, device) -> "LevelSchedule":
        return _move(self, device)


@dataclasses.dataclass(frozen=True)
class QuantizedSchedule:
    """Conservatively quantized uint16 tile form of a :class:`LevelSchedule`.

    Node MBRs are snapped outward (lo floor, hi ceil) onto a ``CELLS``-cell
    grid, so the integer sweep keeps a superset of the exact survivors; an
    exact float32 confirming pass against ``confirm_mbr`` makes hit sets
    identical to the float32 path.

    base:        the exact schedule (carries the object table).
    mbr_q:       (L, 4, W) uint16 grid cells.
    parent_q:    (L, W) uint16 parent slots while W <= 65535, else int32.
    origin:      (4,) float32 grid origin (ox, oy, ox, oy).
    inv_cell:    (4,) float32 cells per unit, coordinate-major.
    confirm_mbr: (E, 4) float32 exact box the confirming pass tests.
    cells:       highest real grid cell (the sentinel is cells+1).
    """

    base: LevelSchedule
    mbr_q: torch.Tensor
    parent_q: torch.Tensor
    origin: torch.Tensor
    inv_cell: torch.Tensor
    confirm_mbr: torch.Tensor
    cells: int = CELLS

    @property
    def device(self) -> torch.device:
        return self.mbr_q.device

    def to(self, device) -> "QuantizedSchedule":
        return _move(self, device)


def pyramid_schedule(pyr, obj_mbrs: torch.Tensor) -> LevelSchedule:
    """Lower a :class:`repro_torch.core.bulk.GroupPyramid` to the schedule.

    Dense group ids are the slots; ``bulk.build_pyramid`` already fills
    unused ids with the +inf/-inf sentinel.  Group nesting makes the parent
    map well defined: every member of a level-``l`` group shares one
    level-``l-1`` group, so the scatter below writes one value per slot.
    """
    group_of = pyr.group_of.long()                     # (L, n)
    levels, n = group_of.shape
    parent = torch.zeros((levels, n), dtype=torch.int32, device=group_of.device)
    for l in range(1, levels):
        parent[l, group_of[l]] = pyr.group_of[l - 1]
    return LevelSchedule(
        mbr_cm=pyr.group_mbr.transpose(1, 2).contiguous(),
        parent=parent,
        n_real=(pyr.group_of.amax(dim=1) + 1).to(torch.int32),
        obj_mbr=obj_mbrs.to(torch.float32).contiguous(),
        obj_level=torch.full((n,), levels - 1, dtype=torch.int32,
                             device=group_of.device),
        obj_slot=pyr.group_of[levels - 1].to(torch.int32),
        obj_id=torch.arange(n, dtype=torch.int32, device=group_of.device),
        n_objects=n,
        root_unconditional=False,
        test_object_mbr=False,
    )
