"""Minimum-bounding-rectangle algebra shared by every index in repro_torch.core.

A copy of ``repro.core.mbr`` (the port imports nothing of the JAX package);
the host trees do their arithmetic in float64 numpy, as the reference does.

An MBR is ``(lx, ly, hx, hy)`` with ``lx <= hx`` and ``ly <= hy``.  The
numpy representation used throughout is a float64 array of shape ``(4,)``
(single MBR) or ``(n, 4)`` (a batch).  All functions accept either.

Definitions used by the paper's evaluation (Section 5.2):
  coverage      Sum of node-MBR areas over every node of the tree.
  overcoverage  Whitespace: for each node, area(node MBR) minus the area of
                the union of its entries' MBRs, summed over nodes.
  overlap       For each node, the total pairwise intersection area between
                the MBRs of its entries, summed over nodes.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "make_mbr",
    "merge",
    "merge_many",
    "area",
    "centroid",
    "intersection_area",
    "overlaps",
    "contains",
    "contains_point",
    "union_area",
    "pairwise_overlap_total",
]

LX, LY, HX, HY = 0, 1, 2, 3


def make_mbr(lx: float, ly: float, hx: float, hy: float) -> np.ndarray:
    """Construct a well-formed MBR, swapping coordinates if necessary."""
    return np.array(
        [min(lx, hx), min(ly, hy), max(lx, hx), max(ly, hy)], dtype=np.float64
    )


def merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Smallest MBR enclosing both ``a`` and ``b`` (paper: merge_mbrs)."""
    return np.array(
        [
            min(a[LX], b[LX]),
            min(a[LY], b[LY]),
            max(a[HX], b[HX]),
            max(a[HY], b[HY]),
        ],
        dtype=np.float64,
    )


def merge_many(mbrs: np.ndarray) -> np.ndarray:
    """Enclosing MBR of a non-empty ``(n, 4)`` batch."""
    mbrs = np.asarray(mbrs, dtype=np.float64).reshape(-1, 4)
    return np.array(
        [
            mbrs[:, LX].min(),
            mbrs[:, LY].min(),
            mbrs[:, HX].max(),
            mbrs[:, HY].max(),
        ],
        dtype=np.float64,
    )


def area(m: np.ndarray) -> np.ndarray:
    """Area; zero-extent (point / degenerate line) MBRs have area 0."""
    m = np.asarray(m, dtype=np.float64)
    return (m[..., HX] - m[..., LX]) * (m[..., HY] - m[..., LY])


def centroid(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    return np.stack(
        [(m[..., LX] + m[..., HX]) * 0.5, (m[..., LY] + m[..., HY]) * 0.5],
        axis=-1,
    )


def intersection_area(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection area between (broadcastable batches of) MBRs."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    w = np.minimum(a[..., HX], b[..., HX]) - np.maximum(a[..., LX], b[..., LX])
    h = np.minimum(a[..., HY], b[..., HY]) - np.maximum(a[..., LY], b[..., LY])
    return np.clip(w, 0.0, None) * np.clip(h, 0.0, None)


def overlaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Closed-boundary intersection test (touching rectangles DO overlap).

    The paper's region search descends every entry whose MBR intersects the
    query region, including boundary contact — required for point data whose
    MBRs are degenerate (zero area).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return (
        (a[..., LX] <= b[..., HX])
        & (b[..., LX] <= a[..., HX])
        & (a[..., LY] <= b[..., HY])
        & (b[..., LY] <= a[..., HY])
    )


def contains(outer: np.ndarray, inner: np.ndarray) -> np.ndarray:
    outer = np.asarray(outer, dtype=np.float64)
    inner = np.asarray(inner, dtype=np.float64)
    return (
        (outer[..., LX] <= inner[..., LX])
        & (outer[..., LY] <= inner[..., LY])
        & (outer[..., HX] >= inner[..., HX])
        & (outer[..., HY] >= inner[..., HY])
    )


def contains_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    return (
        (m[..., LX] <= p[..., 0])
        & (p[..., 0] <= m[..., HX])
        & (m[..., LY] <= p[..., 1])
        & (p[..., 1] <= m[..., HY])
    )


def union_area(mbrs: np.ndarray) -> float:
    """Exact area of the union of a set of MBRs (sweep over x slabs).

    Used for overcoverage; n is at most a node's fan-out in the metrics path
    so the O(n^2) slab sweep is fine.
    """
    mbrs = np.asarray(mbrs, dtype=np.float64).reshape(-1, 4)
    if mbrs.shape[0] == 0:
        return 0.0
    xs = np.unique(np.concatenate([mbrs[:, LX], mbrs[:, HX]]))
    total = 0.0
    for x0, x1 in zip(xs[:-1], xs[1:]):
        w = x1 - x0
        if w <= 0:
            continue
        # rectangles spanning this slab
        live = mbrs[(mbrs[:, LX] <= x0) & (mbrs[:, HX] >= x1)]
        if live.shape[0] == 0:
            continue
        # union of y-intervals
        order = np.argsort(live[:, LY])
        y_lo = live[order, LY]
        y_hi = live[order, HY]
        cov = 0.0
        cur_lo, cur_hi = y_lo[0], y_hi[0]
        for lo, hi in zip(y_lo[1:], y_hi[1:]):
            if lo > cur_hi:
                cov += cur_hi - cur_lo
                cur_lo, cur_hi = lo, hi
            else:
                cur_hi = max(cur_hi, hi)
        cov += cur_hi - cur_lo
        total += w * cov
    return float(total)


def pairwise_overlap_total(mbrs: np.ndarray) -> float:
    """Sum of pairwise intersection areas among sibling MBRs."""
    mbrs = np.asarray(mbrs, dtype=np.float64).reshape(-1, 4)
    n = mbrs.shape[0]
    if n < 2:
        return 0.0
    inter = intersection_area(mbrs[:, None, :], mbrs[None, :, :])
    iu = np.triu_indices(n, k=1)
    return float(inter[iu].sum())
