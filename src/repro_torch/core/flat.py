"""Flattened trees and the level schedule the fused region sweep consumes.

PyTorch counterpart of ``repro.core.flat``.  A pointer tree (mqr or R,
built on the host) is flattened into a numpy :class:`FlatTree` and lowered
by :func:`level_schedule`, exactly as the JAX package does it; the group
pyramid lowers by :func:`pyramid_schedule`.  A schedule is a dataclass of
torch tensors living on one device; :meth:`LevelSchedule.to` moves it.

The fused sweep computes, level by level,

    active[l, q, j] = active[l-1, q, parent[l, j]] & overlaps(mbr[l, j], q)

which is the breadth-first frontier of the pointer search, so
``active[l].sum()`` reproduces the paper's per-level disk-access counts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .mqrtree import MQRTree
from .rtree import RTree

EMPTY = -1  # children_idx sentinel: no entry
# children_idx >= 0   -> index of a child node
# children_idx <= -2  -> object id encoded as -(obj + 2)

# MBR sentinel for padded slots: lo=+inf, hi=-inf never overlaps anything.
NEVER_MBR = np.array([np.inf, np.inf, -np.inf, -np.inf], np.float32)

# Quantized-tile grid: real coordinates land in cells [0, CELLS]; lo=CELLS+1
# is the integer never-overlap sentinel (queries are clipped to <= CELLS).
CELLS = 65534
Q_NEVER_MBR = np.array([CELLS + 1, CELLS + 1, 0, 0], np.uint16)

# Coarse uint8 grid of the upper levels of the hierarchical (compact8)
# form: same outward rounding on a 255-cell grid, same sentinel scheme.
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


@dataclasses.dataclass(frozen=True)
class FlatTree:
    """Dense array form of a spatial tree (host numpy, as in the reference).

    node_mbr:      (N, 4)   float32
    children_mbr:  (N, F, 4) float32 (F = max fan-out)
    children_idx:  (N, F)   int32 (see sentinels above)
    n_objects:     int
    root:          int (node index of the root, always 0)
    """

    node_mbr: np.ndarray
    children_mbr: np.ndarray
    children_idx: np.ndarray
    n_objects: int
    root: int = 0


def flatten(tree) -> FlatTree:
    """Flatten an ``MQRTree`` or ``RTree`` into a :class:`FlatTree`."""
    if isinstance(tree, MQRTree):
        fan = 5

        def node_entries(node):
            for _, e in node.entries():
                yield e.mbr, (e.node if e.is_node else None), e.obj

    elif isinstance(tree, RTree):
        fan = tree.M

        def node_entries(node):
            for e in node.entries:
                yield e.mbr, e.child, e.obj

    else:
        raise TypeError(type(tree))

    nodes = []
    index = {}
    # Explicit-stack preorder walk: CENTER chains make the depth unbounded,
    # so recursion could trip Python's recursion limit.
    stack = [tree.root]
    while stack:
        node = stack.pop()
        index[id(node)] = len(nodes)
        nodes.append(node)
        children = [c for _, c, _ in node_entries(node) if c is not None]
        stack.extend(reversed(children))

    n = len(nodes)
    node_mbr = np.zeros((n, 4), np.float32)
    children_mbr = np.zeros((n, fan, 4), np.float32)
    children_idx = np.full((n, fan), EMPTY, np.int32)
    n_objects = 0
    for ni, node in enumerate(nodes):
        mbr = node.mbr if isinstance(tree, MQRTree) else node.mbr()
        node_mbr[ni] = np.asarray(mbr, np.float32)
        for fi, (embr, child, obj) in enumerate(node_entries(node)):
            children_mbr[ni, fi] = np.asarray(embr, np.float32)
            if child is not None:
                children_idx[ni, fi] = index[id(child)]
            else:
                children_idx[ni, fi] = -(obj + 2)
                n_objects = max(n_objects, obj + 1)
    return FlatTree(node_mbr, children_mbr, children_idx, n_objects)


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

    Hierarchical (``compact8``) extension: when ``mbr_q8`` is present,
    levels ``[0, split)`` also carry a coarse uint8 form on a ``cells8``-cell
    grid sharing ``origin``; the hier sweep tests those levels on the coarse
    grid and levels ``[split, L)`` on the fine one.  Both round outward, so
    hit sets stay identical; only ``visits`` may grow.

    mbr_q8:    (split, 4, W) uint8 coarse tiles, or ``None``.
    split:     first level swept on the fine grid (0 = no coarse levels).
    cells8:    highest real coarse cell (the sentinel is cells8+1).
    inv_cell8: (4,) float32 coarse cells per unit, or ``None``.
    """

    base: LevelSchedule
    mbr_q: torch.Tensor
    parent_q: torch.Tensor
    origin: torch.Tensor
    inv_cell: torch.Tensor
    confirm_mbr: torch.Tensor
    cells: int = CELLS
    mbr_q8: torch.Tensor | None = None
    split: int = 0
    cells8: int = CELLS8
    inv_cell8: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.mbr_q.device

    @property
    def levels(self) -> int:
        return self.base.levels

    @property
    def hierarchical(self) -> bool:
        """Whether the uint8 upper-level tiles are materialized."""
        return self.mbr_q8 is not None and self.split > 0

    @property
    def streamed_bytes(self) -> int:
        """Tile and parent bytes one sweep reads (uint8 tiles for the
        upper levels of the hierarchical form)."""
        def nbytes(t):
            return t.numel() * t.element_size()

        if self.hierarchical:
            return (nbytes(self.mbr_q8) + nbytes(self.mbr_q[self.split:])
                    + nbytes(self.parent_q))
        return nbytes(self.mbr_q) + nbytes(self.parent_q)

    def to(self, device) -> "QuantizedSchedule":
        return _move(self, device)


def level_schedule(flat: FlatTree) -> LevelSchedule:
    """Lower a :class:`FlatTree` (mqr or R) to the level schedule, on the
    CPU (the same numpy breadth-first slotting as the JAX package)."""
    n, fan = flat.children_idx.shape
    depth = np.full((n,), -1, np.int64)
    depth[flat.root] = 0
    order = [flat.root]
    head = 0
    parent_of = np.full((n,), -1, np.int64)
    while head < len(order):
        ni = order[head]
        head += 1
        for ci in flat.children_idx[ni]:
            if ci >= 0:
                depth[int(ci)] = depth[ni] + 1
                parent_of[int(ci)] = ni
                order.append(int(ci))
    levels = int(depth.max()) + 1
    width = int(np.bincount(depth, minlength=levels).max())

    slot_of = np.zeros((n,), np.int64)
    fill = np.zeros((levels,), np.int64)
    mbr = np.broadcast_to(NEVER_MBR, (levels, width, 4)).copy()
    parent = np.zeros((levels, width), np.int32)
    for ni in order:  # BFS order => parents are slotted before children
        l = int(depth[ni])
        j = int(fill[l])
        fill[l] += 1
        slot_of[ni] = j
        mbr[l, j] = flat.node_mbr[ni]
        if l > 0:
            parent[l, j] = slot_of[parent_of[ni]]

    is_obj = flat.children_idx <= -2
    node_ids, _ = np.nonzero(is_obj)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype))

    return LevelSchedule(
        mbr_cm=t(mbr.transpose(0, 2, 1), np.float32),
        parent=t(parent, np.int32),
        n_real=t(fill, np.int32),
        obj_mbr=t(flat.children_mbr[is_obj], np.float32),
        obj_level=t(depth[node_ids], np.int32),
        obj_slot=t(slot_of[node_ids], np.int32),
        obj_id=t(-(flat.children_idx[is_obj] + 2), np.int32),
        n_objects=flat.n_objects,
        root_unconditional=True,
        test_object_mbr=True,
    )


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


def ancestor_chains(schedule: LevelSchedule, k_levels: int) -> torch.Tensor:
    """Per-entry ancestor slots: ``(E, k_levels)`` int32 on the schedule's
    device, column ``k`` = the slot of entry ``e``'s ancestor node at level
    ``k``.

    The tree-vs-tree join epilogue looks each entry pair up in the
    synchronized pair mask at ``k = min(level_a, level_b)``; these chains
    are the row/column coordinates of that lookup.  Columns past an
    entry's own level are left 0 — the join never reads them (``min``
    clamps to the shallower entry).  The same bottom-up walk as the JAX
    package's, one vectorized step per level.
    """
    levels = schedule.obj_level.to(torch.int64)
    dev = levels.device
    e = levels.shape[0]
    max_l = int(levels.max()) if e else 0
    chains = torch.zeros((e, max(k_levels, max_l + 1)), dtype=torch.int64, device=dev)
    cur = schedule.obj_slot.to(torch.int64)
    chains[torch.arange(e, device=dev), levels] = cur
    parent = schedule.parent.to(torch.int64)
    for t in range(max_l, 0, -1):
        cur = torch.where(levels >= t, parent[t][cur], cur)  # ancestors at level t-1
        chains[:, t - 1] = torch.where(levels >= t - 1, cur, 0)
    return chains[:, :k_levels].to(torch.int32).contiguous()
