"""k-nearest-neighbour engines behind ``SpatialIndex.knn``.

Counterpart of ``repro.index.knn``:

* :func:`knn_pointer` — exact best-first branch-and-bound over the pointer
  tree (the host oracle), MBR min-distance priority queue, for both
  pointer structures;
* :func:`knn_brute` / :func:`knn_brute_masked` — exact scans over object
  MBRs (the host path of the pyramid, and of any live index);
* :func:`knn_expanding` — the device path: an expanding-radius *region
  schedule* drives the backend's fused level sweep (kernel #1 on the card)
  until every point has ≥k survivors, one √2-margin confirming round
  closes the corner gap of the square probe, and a top-k distance
  epilogue in torch on the index's device ranks the survivors.
  Exactness: survivors of an L∞ ball of radius r all lie within Euclidean
  distance r·√2, so the kth distance d_k ≤ r·√2, and the confirming
  round's L∞ ball of radius r·√2 ⊇ the Euclidean d_k-ball — no true
  neighbour can be outside the final candidate set.

All engines report distances as Euclidean point-to-MBR min-distances (0
inside the rectangle) and the paper's access counts, and resolve equal
distances by lowest object id.  The host engines are numpy, copied from
the JAX package.
"""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np
import torch

from .trees import node_children as _node_children
from .trees import node_mbr as _node_mbr

# > sqrt(2): covers the square-vs-circle corner gap with float slack.
_CONFIRM_MARGIN = 1.5
# Distance-epilogue elements per query chunk (bounds its temporaries).
_EPILOGUE_ELEMENTS = 1 << 26


def _mindist_np(points: np.ndarray, mbrs: np.ndarray) -> np.ndarray:
    """Euclidean min-distance point→MBR, (Q, 2) × (N, 4) -> (Q, N)."""
    px = points[:, 0][:, None]
    py = points[:, 1][:, None]
    dx = np.maximum(np.maximum(mbrs[None, :, 0] - px, px - mbrs[None, :, 2]), 0.0)
    dy = np.maximum(np.maximum(mbrs[None, :, 1] - py, py - mbrs[None, :, 3]), 0.0)
    return np.sqrt(dx * dx + dy * dy)


def _mindist_point(p: np.ndarray, mbr) -> float:
    dx = max(mbr[0] - p[0], 0.0, p[0] - mbr[2])
    dy = max(mbr[1] - p[1], 0.0, p[1] - mbr[3])
    return float(np.sqrt(dx * dx + dy * dy))


def knn_pointer(tree, points: np.ndarray, k: int):
    """Exact best-first k-NN over an ``MQRTree`` or ``RTree``.

    Returns ``(ids (Q, k) int32, dists (Q, k) float32, visits (Q,) int64)``
    — visits counts expanded nodes, the paper's disk accesses.  Heap keys
    order nodes before objects at the same distance, so every object at
    distance ≤ d is enqueued before any object at distance d is emitted,
    and among equal-distance objects the id is the tiebreak.
    """
    nq = points.shape[0]
    ids = np.zeros((nq, k), np.int32)
    dists = np.zeros((nq, k), np.float32)
    visits = np.zeros((nq,), np.int64)
    for i in range(nq):
        p = points[i]
        # key: (dist, kind, id) — kind 0 = node (expand first), 1 = object.
        heap = [(0.0, 0, 0, tree.root)]
        counter = 1
        got = 0
        while heap and got < k:
            d, kind, key, item = heapq.heappop(heap)
            if kind == 0:
                node = item
                if _node_mbr(node) is None:
                    continue
                visits[i] += 1
                for embr, child, obj in _node_children(node):
                    if child is not None:
                        counter += 1
                        heapq.heappush(heap, (_mindist_point(p, embr), 0, counter, child))
                    else:
                        heapq.heappush(heap, (_mindist_point(p, embr), 1, obj, None))
            else:
                ids[i, got] = key
                dists[i, got] = d
                got += 1
    return ids, dists, visits


def knn_brute(obj_mbrs: np.ndarray, points: np.ndarray, k: int):
    """Exact k-NN by scanning every object MBR (pyramid host path)."""
    obj_mbrs = np.asarray(obj_mbrs)
    return knn_brute_masked(obj_mbrs, np.ones((obj_mbrs.shape[0],), bool), points, k)


def knn_brute_masked(mbr_table: np.ndarray, alive: np.ndarray, points: np.ndarray, k: int):
    """Exact k-NN over the LIVE rows of an id-space MBR table — the host
    path once live updates begin.  Dead and unallocated rows are masked to
    +inf distance, so ids and tie-breaks (lowest global id first, stable
    argsort) resolve exactly as :func:`knn_brute` would on the compacted
    live set."""
    d = _mindist_np(np.asarray(points, np.float64), np.asarray(mbr_table, np.float64))
    d = np.where(alive[None, :], d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    dists = np.take_along_axis(d, order, axis=1).astype(np.float32)
    visits = np.full((points.shape[0],), int(alive.sum()), np.int64)
    return order.astype(np.int32), dists, visits


def topk_mindist(hits: torch.Tensor, obj_mbrs: torch.Tensor, points: torch.Tensor, k: int):
    """Top-k distance epilogue on ``hits``' device: float32 Euclidean
    min-distances of every candidate (``hits``) object (IEEE float32, one
    rounding per operation), non-candidates at +inf, ranked ascending with
    ties by lowest object id.  Returns
    ``(ids (Q, k) int32, dists (Q, k) float32)``.

    ``torch.topk`` promises no order among equal values, so it ranks a
    key that cannot tie: the distance's float32 bits (monotone for
    non-negative floats, +inf included) above the object id.
    """
    nq, n = hits.shape
    ids = torch.empty((nq, k), dtype=torch.int32, device=hits.device)
    dists = torch.empty((nq, k), dtype=torch.float32, device=hits.device)
    obj_id = torch.arange(n, dtype=torch.int64, device=hits.device)
    step = max(1, _EPILOGUE_ELEMENTS // max(n, 1))
    for s in range(0, nq, step):
        px, py = points[s:s + step, 0:1], points[s:s + step, 1:2]
        dx = torch.maximum(obj_mbrs[:, 0] - px, px - obj_mbrs[:, 2]).clamp_min(0.0)
        dy = torch.maximum(obj_mbrs[:, 1] - py, py - obj_mbrs[:, 3]).clamp_min(0.0)
        # The square root is taken in float64 and rounded once: that is
        # the correctly rounded float32 root on every device (PyTorch's
        # vectorized float32 CPU root is not).
        d = torch.sqrt((dx * dx + dy * dy).to(torch.float64)).to(torch.float32)
        d = torch.where(hits[s:s + step], d, torch.inf)
        key = (d.view(torch.int32).to(torch.int64) << 32) | obj_id
        top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        ids[s:s + step] = (top & 0xFFFFFFFF).to(torch.int32)
        dists[s:s + step] = (top >> 32).to(torch.int32).view(torch.float32)
    return ids, dists


def knn_expanding(
    region_fn,
    obj_mbrs: np.ndarray,
    points: np.ndarray,
    k: int,
    *,
    device: torch.device,
    max_rounds: int = 40,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Device k-NN: expanding-radius region schedule + top-k epilogue.

    ``region_fn(queries (Q, 4) float32 numpy) -> (hits (Q, n_obj) bool,
    visits (Q, L))`` is the backend's batched region search, as tensors on
    ``device``.  The radii and probe rectangles are computed in float64 on
    the host exactly as the JAX package does; each round costs one host
    sync, to test ``hits.sum(1) >= k``.  Ties resolve by lowest object id,
    matching :func:`knn_pointer` and :func:`knn_brute`.

    Returns ``(ids (Q, k) int32, dists (Q, k) float32, visits (Q,) int64,
    rounds)``, tensors on ``device``.
    """
    obj_mbrs = np.asarray(obj_mbrs, np.float64)
    points = np.asarray(points, np.float64)
    nq = points.shape[0]
    n = obj_mbrs.shape[0]

    # Initial radius from the density estimate: a square expected to hold
    # ~k objects under a uniform spread of n objects over the data extent.
    extent = max(
        obj_mbrs[:, 2].max() - obj_mbrs[:, 0].min(),
        obj_mbrs[:, 3].max() - obj_mbrs[:, 1].min(),
        1e-6,
    )
    r = np.full((nq,), 0.5 * extent * np.sqrt(k / max(n, 1)) + 1e-6)

    def probe(radius):
        return np.stack([points[:, 0] - radius, points[:, 1] - radius,
                         points[:, 0] + radius, points[:, 1] + radius],
                        axis=1).astype(np.float32)

    total_visits = torch.zeros((nq,), dtype=torch.int64, device=device)
    rounds = 0
    satisfied = np.zeros((nq,), bool)
    for _ in range(max_rounds):
        hits, visits = region_fn(probe(r))
        rounds += 1
        total_visits += visits.sum(dim=1, dtype=torch.int64)
        satisfied = (hits.sum(dim=1) >= k).cpu().numpy()
        if satisfied.all():
            break
        # double only the radii still short of k survivors; satisfied
        # points keep their radius (their result is already final-bound)
        r = np.where(satisfied, r, r * 2.0)
    if not satisfied.all():
        raise RuntimeError(
            f"knn radius expansion did not reach k={k} survivors in {max_rounds} rounds")

    # Confirming round: the square of radius r·√2 covers the Euclidean
    # d_k-ball (see module docstring), making the candidate set exact.
    hits, visits = region_fn(probe(r * _CONFIRM_MARGIN))
    rounds += 1
    total_visits += visits.sum(dim=1, dtype=torch.int64)

    pts = torch.from_numpy(points.astype(np.float32)).to(device)
    mb = torch.from_numpy(obj_mbrs.astype(np.float32)).to(device)
    ids, dists = topk_mindist(hits, mb, pts, k)
    return ids, dists, total_visits, rounds
