"""Dataset generators of the paper's Section 5.1 (numpy).

A copy of the generators of ``repro.core.datasets`` that the port uses, so
the same seed gives the same data in both packages.  All sets live in a
``[0, EXTENT]^2`` world.
"""

from __future__ import annotations

import numpy as np

EXTENT = 1000.0


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def uniform_squares(n: int, seed: int = 0, side: float = 10.0) -> np.ndarray:
    """n squares of ``side x side`` units, uniformly distributed."""
    r = _rng(seed)
    ll = r.uniform(0.0, EXTENT - side, size=(n, 2))
    return np.concatenate([ll, ll + side], axis=1)


def uniform_points(n: int, seed: int = 0) -> np.ndarray:
    r = _rng(seed)
    p = r.uniform(0.0, EXTENT, size=(n, 2))
    return np.concatenate([p, p], axis=1)


def exponential_squares(
    n: int, seed: int = 0, side: float = 10.0, scale: float = 200.0
) -> np.ndarray:
    r = _rng(seed)
    ll = np.minimum(r.exponential(scale, size=(n, 2)), EXTENT - side)
    return np.concatenate([ll, ll + side], axis=1)


def region_queries(
    data: np.ndarray, n_queries: int, seed: int = 0, target_found: float = 4.0
) -> np.ndarray:
    """Query rectangles sized so a uniform dataset returns ~target_found
    objects, centred at random data centroids."""
    r = _rng(seed + 7)
    n = data.shape[0]
    side = EXTENT * np.sqrt(target_found / max(n, 1))
    centers = data[r.integers(0, n, size=n_queries)]
    cx = (centers[:, 0] + centers[:, 2]) * 0.5
    cy = (centers[:, 1] + centers[:, 3]) * 0.5
    return np.stack(
        [cx - side / 2, cy - side / 2, cx + side / 2, cy + side / 2], axis=1
    )


def dense_region_queries(n_queries: int, seed: int = 0, side: float = 450.0) -> np.ndarray:
    """Fixed large queries anchored near the origin-dense corner (the
    paper's exponential-data search workloads)."""
    r = _rng(seed + 13)
    off = r.uniform(0.0, 80.0, size=(n_queries, 2))
    return np.concatenate([off, off + side], axis=1)

