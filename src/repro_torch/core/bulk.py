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
    """Dense ids in ascending key order (the numbering of the JAX
    ``bulk._densify``, whose argsort + cumsum ranks keys the same way)."""
    return torch.unique(keys, sorted=True, return_inverse=True)[1]


def _group_bounds(gid: torch.Tensor, mbrs: torch.Tensor, n: int) -> torch.Tensor:
    """Per-group enclosing MBR, (n, 4).  Empty groups come out
    (+inf, +inf, -inf, -inf), as ``jax.ops.segment_min/max`` give them."""
    idx = gid[:, None].expand(-1, 2)
    lo = torch.full((n, 2), math.inf, dtype=torch.float32, device=mbrs.device)
    hi = torch.full((n, 2), -math.inf, dtype=torch.float32, device=mbrs.device)
    lo = lo.scatter_reduce(0, idx, mbrs[:, :2], "amin", include_self=True)
    hi = hi.scatter_reduce(0, idx, mbrs[:, 2:], "amax", include_self=True)
    return torch.cat([lo, hi], dim=1)


def default_levels(n: int) -> int:
    """Pyramid depth shared by every bulk build path: enough 5-way splits to
    separate ``n`` distinct centroids, plus slack for the root and one
    uneven split."""
    return int(math.ceil(math.log(max(n, 2)) / math.log(5))) + 2


def build_pyramid(mbrs: torch.Tensor, levels: int) -> GroupPyramid:
    """Build the mqr group pyramid for ``mbrs`` (n, 4) float32."""
    mbrs = mbrs.to(torch.float32)
    n = mbrs.shape[0]
    cx = (mbrs[:, 0] + mbrs[:, 2]) * 0.5
    cy = (mbrs[:, 1] + mbrs[:, 3]) * 0.5

    gid = torch.zeros((n,), dtype=torch.int64, device=mbrs.device)
    bounds = _group_bounds(gid, mbrs, n)
    group_of = [gid]
    group_mbr = [bounds]
    for _ in range(levels - 1):
        counts = torch.bincount(gid, minlength=n)
        multi = counts[gid] > 1
        gb = bounds[gid]
        gcx = (gb[:, 0] + gb[:, 2]) * 0.5
        gcy = (gb[:, 1] + gb[:, 3]) * 0.5
        quad = quad_code(cx, cy, gcx, gcy)
        # Singletons keep their slot; keys stay unique per group.
        key = torch.where(multi, gid * 5 + quad, gid * 5)
        gid = _densify(key)
        bounds = _group_bounds(gid, mbrs, n)
        group_of.append(gid)
        group_mbr.append(bounds)
    return GroupPyramid(
        group_of=torch.stack(group_of).to(torch.int32),
        group_mbr=torch.stack(group_mbr),
        levels=levels,
    )


def pyramid_search(pyr: GroupPyramid, region: torch.Tensor) -> torch.Tensor:
    """Pointer-free region search: object i survives iff the group MBR of
    every ancestor level overlaps the region.  ``region`` (4,) gives (n,)
    bool; a batch of regions (R, 4) gives (R, n), one row per region."""
    gather = pyr.group_of.long()[:, :, None].expand(-1, -1, 4)
    anc = torch.gather(pyr.group_mbr, 1, gather)  # (L, n, 4)
    per_level = _overlaps(anc, region[..., None, None, :])  # (..., L, n)
    return per_level.all(dim=-2)


def pyramid_stats(pyr: GroupPyramid) -> list[int]:
    """Diagnostics: number of distinct groups per level (host-side)."""
    return [int(torch.unique(g).numel()) for g in pyr.group_of]
