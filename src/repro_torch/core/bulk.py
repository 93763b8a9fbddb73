"""Bulk (bottom-up batched) mqr construction in plain PyTorch.

Counterpart of ``repro.core.bulk``.  The paper's insertion places an entry
by the orientation of its MBR centroid relative to the node-MBR centroid,
and Section 4 property 1 makes the result insertion-order independent, so
the canonical tree is a fixed point computed level by level: each group's
MBR is the bounding box of its members, and members are split by the
Fig. 2 quadrant rule about that box's centroid.

Output is a "group pyramid": ``group_of[l, i]`` is object i's dense group id
at level l and ``group_mbr[l, g]`` that group's MBR (unused ids carry the
+inf/-inf sentinel).  Group 0 at level 0 is the root; an object alone in
its group stops splitting.  :func:`pyramid_search` is the pointer-free
region search over it (the mqr-KV block selection of ``core/kvindex.py``).

:func:`build_pyramid` and :func:`pyramid_search` also take leading row
dimensions: MBRs (R, n, 4) give R pyramids in one pass, each equal to the
pyramid of its row built alone (the reference ``vmap``s the single build).
No step reads a tensor on the host, so a batched build inside a decode
step never waits for the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .flat import overlaps as _overlaps

# Quadrant codes (order irrelevant to correctness; matches the JAX package).
_NE, _NW, _SW, _SE, _EQ = 0, 1, 2, 3, 4


class GroupPyramid(NamedTuple):
    group_of: torch.Tensor   # (L, n) int32 — dense group id per object per level
    group_mbr: torch.Tensor  # (L, n, 4) float32 — MBR per dense group id
    levels: int


def quad_code(acx, acy, bcx, bcy) -> torch.Tensor:
    """Branch-free Fig. 2 orientation table (a = entry, b = node centroid)."""
    gx = acx > bcx
    lx = acx < bcx
    gy = acy > bcy
    ly = acy < bcy
    ex = ~gx & ~lx
    ey = ~gy & ~ly
    ne = gx & ~ly               # Ax>Bx, Ay>=By
    nw = (lx & gy) | (ex & gy)  # Ax<Bx,Ay>By  or  Ax==Bx,Ay>By
    sw = lx & ~gy               # Ax<Bx, Ay<=By
    eq = ex & ey
    # SE is the final else branch
    return torch.where(
        eq, _EQ,
        torch.where(ne, _NE, torch.where(nw, _NW, torch.where(sw, _SW, _SE))),
    )


def _densify(keys: torch.Tensor) -> torch.Tensor:
    """Dense ids in ascending key order along the last dimension, ranked as
    the JAX ``bulk._densify`` ranks them (argsort, a flag where the sorted
    key changes, cumsum); leading dimensions are rows ranked apart.  Sort,
    scan and scatter only: no host sync, unlike ``torch.unique``."""
    order = torch.argsort(keys, dim=-1)
    sk = torch.gather(keys, -1, order)
    new = torch.zeros_like(sk)
    new[..., 1:] = sk[..., 1:] != sk[..., :-1]
    return torch.empty_like(new).scatter_(-1, order, new.cumsum(-1))


def _group_bounds(gid: torch.Tensor, mbrs: torch.Tensor, n: int) -> torch.Tensor:
    """Per-group enclosing MBR, (..., n, 4) for ids (..., n) and MBRs
    (..., n, 4).  Empty groups come out (+inf, +inf, -inf, -inf), as
    ``jax.ops.segment_min/max`` give them."""
    idx = gid[..., None].expand(*gid.shape, 2)
    shape = (*gid.shape[:-1], n, 2)
    lo = torch.full(shape, math.inf, dtype=torch.float32, device=mbrs.device)
    hi = torch.full(shape, -math.inf, dtype=torch.float32, device=mbrs.device)
    lo = lo.scatter_reduce(-2, idx, mbrs[..., :2], "amin", include_self=True)
    hi = hi.scatter_reduce(-2, idx, mbrs[..., 2:], "amax", include_self=True)
    return torch.cat([lo, hi], dim=-1)


def default_levels(n: int) -> int:
    """Pyramid depth shared by every bulk build path: enough 5-way splits to
    separate ``n`` distinct centroids, plus slack for the root and one
    uneven split."""
    return int(math.ceil(math.log(max(n, 2)) / math.log(5))) + 2


def build_pyramid(mbrs: torch.Tensor, levels: int) -> GroupPyramid:
    """Build the mqr group pyramid for ``mbrs`` (n, 4) float32: group_of
    (L, n), group_mbr (L, n, 4).  MBRs (R, n, 4) give R pyramids at once,
    group_of (R, L, n) and group_mbr (R, L, n, 4)."""
    mbrs = mbrs.to(torch.float32)
    n = mbrs.shape[-2]
    cx = (mbrs[..., 0] + mbrs[..., 2]) * 0.5
    cy = (mbrs[..., 1] + mbrs[..., 3]) * 0.5

    gid = torch.zeros(mbrs.shape[:-1], dtype=torch.int64, device=mbrs.device)
    bounds = _group_bounds(gid, mbrs, n)
    group_of = [gid]
    group_mbr = [bounds]
    for _ in range(levels - 1):
        counts = torch.zeros_like(gid).scatter_add_(-1, gid, torch.ones_like(gid))
        multi = torch.gather(counts, -1, gid) > 1
        gb = torch.gather(bounds, -2, gid[..., None].expand(*gid.shape, 4))
        gcx = (gb[..., 0] + gb[..., 2]) * 0.5
        gcy = (gb[..., 1] + gb[..., 3]) * 0.5
        quad = quad_code(cx, cy, gcx, gcy)
        # Singletons keep their slot; keys stay unique per group.
        key = torch.where(multi, gid * 5 + quad, gid * 5)
        gid = _densify(key)
        bounds = _group_bounds(gid, mbrs, n)
        group_of.append(gid)
        group_mbr.append(bounds)
    return GroupPyramid(
        group_of=torch.stack(group_of, dim=-2).to(torch.int32),
        group_mbr=torch.stack(group_mbr, dim=-3),
        levels=levels,
    )


def pyramid_search(pyr: GroupPyramid, region: torch.Tensor) -> torch.Tensor:
    """Pointer-free region search: object i survives iff the group MBR of
    every ancestor level overlaps the region.  For one pyramid, ``region``
    (4,) gives (n,) bool and a batch of regions (G, 4) gives (G, n), one row
    per region.  For rows of pyramids (R, L, n), regions (R, G, 4) give
    (R, G, n): row r's G regions searched in row r's pyramid."""
    gather = pyr.group_of.long()[..., None].expand(*pyr.group_of.shape, 4)
    anc = torch.gather(pyr.group_mbr, -2, gather)  # (..., L, n, 4)
    if anc.dim() > 3:  # rows of pyramids: room for each row's regions
        anc = anc.unsqueeze(-4)
    per_level = _overlaps(anc, region[..., None, None, :])  # (..., L, n)
    return per_level.all(dim=-2)


def pyramid_stats(pyr: GroupPyramid) -> list[int]:
    """Diagnostics: number of distinct groups per level (host-side)."""
    return [int(torch.unique(g).numel()) for g in pyr.group_of]
