"""Port parity: k-nearest-neighbour search of ``repro_torch``.

The same seeded data and points go through the JAX package (``host``:
pointer branch-and-bound / brute force; ``pallas``: expanding-radius
region rounds through the Pallas sweep in interpret mode) and through the
port on the CPU (``device="cpu"``; ``cuda`` runs the rounds through the
sweep's plain version and the top-k epilogue in torch).

Tolerance: exact for ids, visits, rounds and the ``host`` engine's
distances (the same float64 numpy).  The device engine's float32
distances equal the IEEE float32 formula (numpy, separately rounded
operations) bit for bit; against the JAX package's they may differ by
one float32 ulp, because XLA's CPU backend fuses ``dx*dx + dy*dy`` into
one loop that rounds differently (ROADMAP C8).
"""
import functools

import numpy as np
import pytest
import torch

import conftest
from conftest import f32_exact
from repro.index import SpatialIndex as JaxIndex
from repro_torch import SpatialIndex
from repro_torch.index import KNNResult
from repro_torch.index.knn import topk_mindist

STRUCTURES = ("mqr", "rtree", "pyramid")
JAX_BACKEND = {"host": "host", "cuda": "pallas"}
KNN_STATS = ("queries", "node_accesses", "knn_queries", "knn_rounds", "delta_accesses")


def _np(t):
    return t.cpu().numpy()


@functools.lru_cache(maxsize=None)
def _data(kind: str, n: int) -> np.ndarray:
    return f32_exact(conftest.mbr_dataset("test_torch_knn", kind, n))


def _points(n, seed):
    return np.random.default_rng(seed).uniform(50.0, 950.0, (n, 2))


def ieee_f32_dists(mbrs, points, ids):
    """The float32 min-distance of each (point, id), one rounding per
    operation (numpy)."""
    m = np.asarray(mbrs, np.float32)[ids]
    p = np.asarray(points, np.float32)
    px, py = p[:, 0:1], p[:, 1:2]
    zero = np.float32(0)
    dx = np.maximum(np.maximum(m[..., 0] - px, px - m[..., 2]), zero)
    dy = np.maximum(np.maximum(m[..., 1] - py, py - m[..., 3]), zero)
    return np.sqrt(dx * dx + dy * dy)


def assert_same_knn(got: KNNResult, want, backend, table, points, what=""):
    assert isinstance(got, KNNResult)
    assert got.ids.dtype == torch.int32 and got.dists.dtype == torch.float32
    assert got.visits.dtype == torch.int64
    assert np.array_equal(_np(got.ids), want.ids), what
    assert np.array_equal(_np(got.visits), want.visits), what
    if backend == "host":
        assert np.array_equal(_np(got.dists), want.dists), what
    else:
        assert np.array_equal(_np(got.dists), ieee_f32_dists(table, points, want.ids)), what
        ulps = np.abs(_np(got.dists).view(np.int32) - want.dists.view(np.int32))
        assert ulps.max() <= 1, what


@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("backend", ["host", "cuda"])
@pytest.mark.parametrize("structure", STRUCTURES)
def test_knn_matches_reference(structure, backend, live):
    data = _data("uniform_squares", 200)
    pts = _points(7, 11)
    k = 6
    opts = {"capacity": 32} if live else {}
    j = JaxIndex.build(data, structure=structure, backend=JAX_BACKEND[backend], **opts)
    p = SpatialIndex.build(data, structure=structure, backend=backend, device="cpu", **opts)
    if live:
        extra = _data("exponential_squares", 20)
        for idx in (j, p):
            g = idx.insert(extra)
            idx.delete(np.arange(0, 40, 3))
            idx.delete(np.asarray(g[:4]))
    table = p._updates.mbr_table if live else data
    got, want = p.knn(pts, k), j.knn(pts, k)
    assert_same_knn(got, want, backend, table, pts, f"{structure} {backend} live={live}")
    for name in KNN_STATS:
        assert getattr(p.stats, name) == getattr(j.stats, name), name
    if backend == "cuda":
        assert p.stats.knn_rounds >= 2 and p.stats.launches > 0
    if live:
        assert not np.isin(_np(got.ids), np.arange(0, 40, 3)).any()  # tombstoned


@pytest.mark.parametrize("backend", ["host", "cuda"])
@pytest.mark.parametrize("structure", STRUCTURES)
def test_knn_tie_breaking_matches_reference(structure, backend):
    """Equal distances resolve by lowest object id — co-centred squares
    give distance-0 ties at the shared centroid."""
    n, k = 40, 5
    s = np.arange(1, n + 1, dtype=np.float64)[:, None]
    data = np.concatenate([500 - s, 500 - s, 500 + s, 500 + s], axis=1)
    pts = np.array([[500.0, 500.0], [495.0, 505.0], [200.0, 200.0]])
    want = JaxIndex.build(data, structure=structure, backend=JAX_BACKEND[backend]).knn(pts, k)
    got = SpatialIndex.build(data, structure=structure, backend=backend,
                             device="cpu").knn(pts, k)
    assert_same_knn(got, want, backend, data, pts, f"{structure} {backend}")
    assert np.array_equal(_np(got.ids[0]), np.arange(k))
    assert np.array_equal(_np(got.ids[1]), np.arange(4, 4 + k))
    assert np.array_equal(_np(got.ids[2]), np.arange(n - 1, n - 1 - k, -1))


def test_knn_bounds_and_accounting():
    data = _data("uniform_squares", 200)
    idx = SpatialIndex.build(data, device="cpu")
    pts = _points(4, 3)
    res = idx.knn(torch.from_numpy(pts), 3)
    assert idx.stats.knn_queries == 4 and idx.stats.queries == 4
    assert idx.stats.knn_rounds >= 2  # at least one probe + the confirming round
    assert idx.stats.node_accesses == int(res.visits.sum())
    for bad in (0, idx.n_objects + 1):
        with pytest.raises(ValueError, match="outside"):
            idx.knn(pts, bad)


def test_knn_k_equals_n_and_pyramid_brute_force():
    """k = n ranks every object; the pyramid's host engine is the brute
    force scan, in stable-argsort order."""
    data = _data("exponential_squares", 60)
    pts = _points(3, 5)
    for backend in ("host", "cuda"):
        want = JaxIndex.build(data, structure="pyramid",
                              backend=JAX_BACKEND[backend]).knn(pts, 60)
        got = SpatialIndex.build(data, structure="pyramid", backend=backend,
                                 device="cpu").knn(pts, 60)
        assert_same_knn(got, want, backend, data, pts, backend)


def test_topk_epilogue_breaks_ties_by_lowest_id():
    """The device epilogue's key ranks exactly like a stable argsort of
    the float32 distances, with non-candidates last."""
    rng = np.random.default_rng(8)
    mbrs = f32_exact(np.round(rng.uniform(0, 20, (300, 2))))
    mbrs = np.concatenate([mbrs, mbrs + np.round(rng.uniform(0, 3, (300, 2)))], axis=1)
    pts = np.round(rng.uniform(0, 20, (9, 2)))
    hits = rng.uniform(size=(9, 300)) < 0.7
    ids, dists = topk_mindist(torch.from_numpy(hits), torch.from_numpy(mbrs.astype(np.float32)),
                              torch.from_numpy(pts.astype(np.float32)), 25)
    d = ieee_f32_dists(mbrs, pts, np.broadcast_to(np.arange(300), (9, 300)))
    d = np.where(hits, d, np.inf)
    order = np.argsort(d, axis=1, kind="stable")[:, :25]
    assert np.array_equal(_np(ids), order)
    assert np.array_equal(_np(dists), np.take_along_axis(d, order, axis=1))
    assert (np.diff(np.sort(d, axis=1)[:, :25], axis=1) == 0).any()  # ties were present
