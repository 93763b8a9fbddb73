"""Port parity: the ``repro_torch`` SpatialIndex façade == the JAX façade.

On ``device="cpu"`` the port's ``SpatialIndex.build(..., structure=
"pyramid", build="device"|"host")`` answers ``.region / .point / .count``
at ``precision="float32"`` and ``"compact"``; hits and per-level visits
must equal the JAX ``SpatialIndex`` on the ``pallas`` backend (interpret
mode, ``autotune="off"``: the port's fixed tiling) and on the ``host``
oracle, and ``AccessStats`` must count the same queries and node accesses.
(``launches`` differs by design: the port launches one sweep kernel per
level where the TPU launched one per batch.)

Tolerance: exact — boolean masks and integer counts.
"""
import numpy as np
import pytest
import torch

import conftest
from repro.index import SpatialIndex as JaxIndex
from repro_torch import SpatialIndex
from repro_torch.ft import FaultPlan
from repro_torch.index import advertised_pairs, backend_names

N = 700
KIND = "uniform_squares"


def _np(t):
    return t.cpu().numpy()


def _data():
    return conftest.mbr_dataset(__name__, KIND, N)


def _queries():
    return conftest.dataset_queries(__name__, KIND, N, 8)


def _points():
    d = _data()[:8]
    return np.stack([(d[:, 0] + d[:, 2]) / 2, (d[:, 1] + d[:, 3]) / 2], 1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_results():
    """JAX answers per (build, precision), plus the host oracle's."""
    data, qs, pts = _data(), _queries(), _points()
    out = {}
    for build in ("host", "device"):
        for precision in ("float32", "compact"):
            idx = JaxIndex.build(data, structure="pyramid", backend="pallas", build=build,
                                 precision=precision, autotune="off")
            out[build, precision] = (idx.region(qs), idx.point(pts), idx.count(qs), idx.stats)
    host = JaxIndex.build(data, structure="pyramid", backend="host")
    out["host"] = (host.region(qs), host.point(pts), host.count(qs), host.stats)
    return out


@pytest.mark.parametrize("precision", ["float32", "compact"])
@pytest.mark.parametrize("build", ["host", "device"])
def test_region_point_count_match_jax(jax_results, build, precision):
    data, qs, pts = _data(), _queries(), _points()
    idx = SpatialIndex.build(data, structure="pyramid", build=build, precision=precision,
                             device="cpu")
    region, point, count = idx.region(qs), idx.point(pts), idx.count(qs)
    j_region, j_point, j_count, j_stats = jax_results[build, precision]
    assert np.array_equal(_np(region.hits), j_region.hits)
    assert np.array_equal(_np(region.visits_per_level), j_region.visits_per_level)
    assert np.array_equal(_np(point.hits), j_point.hits)
    assert np.array_equal(_np(point.visits_per_level), j_point.visits_per_level)
    assert np.array_equal(_np(count), j_count)
    assert idx.stats.queries == j_stats.queries
    assert idx.stats.node_accesses == j_stats.node_accesses
    assert idx.stats.launches == 3 * idx.schedule.levels
    # hits equal the JAX host oracle too (visits may differ at compact)
    o_region, o_point, _, _ = jax_results["host"]
    assert np.array_equal(_np(region.hits), o_region.hits)
    assert np.array_equal(_np(point.hits), o_point.hits)
    assert np.array_equal(_np(region.ids(0)), j_region.ids(0))


def test_host_backend_matches_jax_host(jax_results):
    idx = SpatialIndex.build(_data(), structure="pyramid", backend="host", device="cpu")
    o_region, o_point, o_count, o_stats = jax_results["host"]
    region = idx.region(_queries())
    assert np.array_equal(_np(region.hits), o_region.hits)
    assert np.array_equal(_np(region.visits_per_level), o_region.visits_per_level)
    assert np.array_equal(_np(idx.point(_points()).hits), o_point.hits)
    assert np.array_equal(_np(idx.count(_queries())), o_count)
    assert (idx.stats.queries, idx.stats.node_accesses) == (o_stats.queries,
                                                            o_stats.node_accesses)
    assert idx.stats.launches == 0


@pytest.mark.parametrize("precision", ["float32", "compact"])
def test_query_block_chunks_are_transparent(precision):
    idx = SpatialIndex.build(_data(), structure="pyramid", precision=precision, device="cpu")
    whole = idx.region(_queries())
    for backend_opts in ({"query_block": 3}, {"block_w": 256, "query_block": 1}):
        chunked = idx.with_backend("cuda", precision=precision, **backend_opts)
        res = chunked.region(_queries())
        assert torch.equal(res.hits, whole.hits)
        assert torch.equal(res.visits_per_level, whole.visits_per_level)
    assert chunked.stats.launches == len(_queries()) * idx.schedule.levels


def test_with_backend_shares_the_build():
    idx = SpatialIndex.build(_data(), structure="pyramid", build="device", device="cpu")
    twin = idx.with_backend("cuda", precision="compact")
    assert twin.artifacts is idx.artifacts
    assert twin.artifacts.quantized is idx.artifacts.quantized
    assert torch.equal(twin.region(_queries()).hits, idx.region(_queries()).hits)


def test_registry():
    assert backend_names() == ["cuda", "host", "serve", "torch"]
    assert advertised_pairs() == [
        (structure, backend) for structure in ("mqr", "pyramid", "rtree")
        for backend in ("cuda", "host", "serve", "torch")
    ]


@pytest.mark.parametrize("opts", [
    {"fault_plan": FaultPlan()},
])
def test_unported_options_raise(opts):
    """Options that the port once refused with NotImplementedError; every
    one of them is ported now, so each builds and takes effect.  The
    test keeps the name it had then."""
    idx = SpatialIndex.build(_data()[:20], device="cpu", **opts)
    assert idx._fault_plan is opts["fault_plan"]


@pytest.mark.parametrize("method,args", [
    ("save", ("x",)),
])
def test_unported_methods_raise(method, args, tmp_path):
    """Methods that the port once refused with NotImplementedError; every
    one of them is ported now and runs.  The test keeps the name it had
    then."""
    idx = SpatialIndex.build(_data()[:20], device="cpu")
    getattr(idx, method)(*(tmp_path / a for a in args))
    back = SpatialIndex.load(tmp_path / "x", device="cpu")
    assert torch.equal(back.region(_queries()).hits, idx.region(_queries()).hits)


def test_bad_options_raise():
    data = _data()[:20]
    with pytest.raises(TypeError):
        SpatialIndex.build(data, device="cpu", interpret=True)
    with pytest.raises(TypeError):
        SpatialIndex.build(data, device="cpu", block_w=128, backend_opts={"block_w": 64})
    with pytest.raises(TypeError):
        SpatialIndex.build(data, device="cpu", max_entries=4)
    with pytest.raises(ValueError):
        SpatialIndex.build(data, device="cpu", precision="float16")
    with pytest.raises(ValueError):
        SpatialIndex.build(data, structure="pyramid", device="cpu", build="gpu")
    with pytest.raises(ValueError):
        SpatialIndex.build(data, device="cpu", backend="pallas")
    with pytest.raises(ValueError):
        SpatialIndex.build(np.array([[1.0, 0.0, 0.0, 1.0]]), device="cpu")


def test_validate_queries():
    from repro_torch.index import InvalidQueryError, validate_queries

    assert validate_queries([[0, 0, 1, 1]]).dtype == np.float32
    with pytest.raises(InvalidQueryError):
        validate_queries([[0, 0, np.nan, 1]])
    with pytest.raises(InvalidQueryError):
        validate_queries([[2, 0, 1, 1]])
