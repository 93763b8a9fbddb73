"""Port parity: the paper's mqr-tree and the R-tree in ``repro_torch``.

The port builds its own pointer trees (``repro_torch.core.mqrtree`` and
``rtree``, host numpy copies of the JAX package's).  Built from the same
data, they must flatten to the same ``FlatTree`` and lower to the same
``LevelSchedule`` as the JAX package's trees, field for field (so the trees
agree node for node); the façade's ``.region / .point / .count`` on those
trees must give the JAX façade's hits and per-level visits at
``precision="float32"``, ``"compact"`` and ``"compact8"``; the host
backend's pointer search must equal the JAX host backend; the Hilbert slot
order must give the JAX schedule and change no hit and no visit; and the
paper's tree metrics must equal the JAX package's.

Tolerance: exact everywhere.  The trees are built with the same float64
numpy arithmetic, schedules hold the same float32/int32 values, and hits
and visits are booleans and integer counts.
"""
import dataclasses

import numpy as np
import pytest
import torch

import conftest
from repro.core import flat as jflat
from repro.core import metrics as jmetrics
from repro.core import mqrtree as jmqr
from repro.core import rtree as jrtree
from repro.index import SpatialIndex as JaxIndex
from repro.kernels import build as jbuild
from repro_torch import SpatialIndex
from repro_torch.core import flat, metrics, mqrtree, rtree
from repro_torch.kernels import ops

N = 500
NQ = 12
# (structure, max_entries): the R-tree also at the smaller fan-out 4
TREES = [("mqr", None), ("rtree", None), ("rtree", 4)]
TREE_IDS = ["mqr", "rtree", "rtree-M4"]
PRECISIONS = ("float32", "compact", "compact8")


def _np(t):
    t = t.cpu()
    return (t.to(torch.int32) if t.dtype == torch.uint16 else t).numpy()


def _data(kind):
    return conftest.mbr_dataset(__name__, kind, N)


def _queries(kind):
    return conftest.dataset_queries(__name__, kind, N, NQ)


def _points(kind):
    d = _data(kind)[:NQ]
    return np.stack([(d[:, 0] + d[:, 2]) / 2, (d[:, 1] + d[:, 3]) / 2], 1).astype(np.float32)


def _opts(max_entries):
    return {} if max_entries is None else {"max_entries": max_entries}


def _jax_tree(structure, max_entries, kind):
    if structure == "mqr":
        return jmqr.build(_data(kind))
    return jrtree.build(_data(kind), **_opts(max_entries))


def _port_tree(structure, max_entries, kind):
    if structure == "mqr":
        return mqrtree.build(_data(kind))
    return rtree.build(_data(kind), **_opts(max_entries))


def assert_schedule_equal(port_sched, jax_sched):
    for f in dataclasses.fields(jax_sched):
        want = getattr(jax_sched, f.name)
        got = getattr(port_sched, f.name)
        if isinstance(got, torch.Tensor):
            got = _np(got)
            assert got.dtype == np.asarray(want).dtype, f.name
            assert np.array_equal(got, np.asarray(want)), f.name
        else:
            assert got == want, f.name


@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("structure,max_entries", TREES, ids=TREE_IDS)
def test_flat_tree_and_schedule_match_jax(structure, max_entries, kind):
    jflat_tree = jflat.flatten(_jax_tree(structure, max_entries, kind))
    pflat_tree = flat.flatten(_port_tree(structure, max_entries, kind))
    for f in ("node_mbr", "children_mbr", "children_idx"):
        want, got = getattr(jflat_tree, f), getattr(pflat_tree, f)
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert (pflat_tree.n_objects, pflat_tree.root) == (jflat_tree.n_objects, jflat_tree.root)
    sched = flat.level_schedule(pflat_tree)
    assert sched.device == torch.device("cpu")
    assert_schedule_equal(sched, jflat.level_schedule(jflat_tree))
    # the façade lowers the same schedule
    idx = SpatialIndex.build(_data(kind), structure=structure, device="cpu",
                             **_opts(max_entries))
    assert_schedule_equal(idx.schedule, jflat.level_schedule(jflat_tree))


@pytest.fixture(scope="module")
def jax_answers():
    """JAX façade answers, built once per (structure, kind, precision)."""
    cache = {}

    def get(structure, max_entries, kind, precision):
        key = (structure, max_entries, kind)
        if key not in cache:
            cache[key] = {"index": JaxIndex.build(
                _data(kind), structure=structure, backend="pallas", autotune="off",
                **_opts(max_entries))}
        per = cache[key]
        if precision not in per:
            ix = per["index"].with_backend("pallas", precision=precision, autotune="off")
            per[precision] = (ix.region(_queries(kind)), ix.point(_points(kind)),
                              ix.count(_queries(kind)), ix.stats)
        return per[precision]

    return get


@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("structure,max_entries", TREES[:2], ids=TREE_IDS[:2])
def test_region_point_count_match_jax(jax_answers, structure, max_entries, kind):
    idx = SpatialIndex.build(_data(kind), structure=structure, device="cpu")
    for precision in PRECISIONS:
        ix = idx.with_backend("cuda", precision=precision)
        region, point = ix.region(_queries(kind)), ix.point(_points(kind))
        count = ix.count(_queries(kind))
        j_region, j_point, j_count, j_stats = jax_answers(structure, max_entries, kind,
                                                          precision)
        assert np.array_equal(_np(region.hits), j_region.hits), precision
        assert np.array_equal(_np(region.visits_per_level), j_region.visits_per_level)
        assert np.array_equal(_np(point.hits), j_point.hits), precision
        assert np.array_equal(_np(point.visits_per_level), j_point.visits_per_level)
        assert np.array_equal(_np(count), j_count)
        assert (ix.stats.queries, ix.stats.node_accesses) == (j_stats.queries,
                                                              j_stats.node_accesses)
        assert ix.stats.launches == 3 * idx.schedule.levels
    # compact and compact8 answer the float32 hit sets
    f32 = idx.with_backend("cuda", precision="float32").region(_queries(kind)).hits
    c8 = idx.with_backend("cuda", precision="compact8").region(_queries(kind)).hits
    assert torch.equal(c8, f32)


def test_rtree_max_entries_region_matches_jax(jax_answers):
    kind = "uniform_squares"
    idx = SpatialIndex.build(_data(kind), structure="rtree", max_entries=4, device="cpu")
    for precision in PRECISIONS:
        region = idx.with_backend("cuda", precision=precision).region(_queries(kind))
        j_region = jax_answers("rtree", 4, kind, precision)[0]
        assert np.array_equal(_np(region.hits), j_region.hits)
        assert np.array_equal(_np(region.visits_per_level), j_region.visits_per_level)


def test_default_build_is_the_mqr_tree():
    """``SpatialIndex.build(mbrs)`` with no other argument builds the
    paper's mqr-tree on the cuda backend, as the JAX default does."""
    kind = "uniform_squares"
    idx = SpatialIndex.build(_data(kind), device="cpu")
    jidx = JaxIndex.build(_data(kind))
    assert (idx.structure, idx.backend) == ("mqr", "cuda")
    assert jidx.structure == "mqr"
    for precision in PRECISIONS:
        got = idx.with_backend("cuda", precision=precision).region(_queries(kind))
        want = jidx.with_backend("pallas", precision=precision).region(_queries(kind))
        assert np.array_equal(_np(got.hits), want.hits)
        assert np.array_equal(_np(got.visits_per_level), want.visits_per_level)


@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("structure,max_entries", TREES, ids=TREE_IDS)
def test_host_pointer_search_matches_jax_host(structure, max_entries, kind):
    idx = SpatialIndex.build(_data(kind), structure=structure, backend="host",
                             device="cpu", **_opts(max_entries))
    jidx = JaxIndex.build(_data(kind), structure=structure, backend="host",
                          **_opts(max_entries))
    for method, arg in (("region", _queries(kind)), ("point", _points(kind))):
        got, want = getattr(idx, method)(arg), getattr(jidx, method)(arg)
        assert np.array_equal(_np(got.hits), want.hits)
        assert np.array_equal(_np(got.visits_per_level), want.visits_per_level)
    assert idx.stats.launches == 0
    # the pointer search and the float32 sweep of its schedule agree
    sweep = idx.with_backend("cuda").region(_queries(kind))
    host = idx.region(_queries(kind))
    assert torch.equal(sweep.hits, host.hits)
    assert torch.equal(sweep.visits_per_level, host.visits_per_level)


@pytest.mark.parametrize("structure", ["mqr", "rtree", "pyramid"])
def test_hilbert_order_matches_jax_and_keeps_answers(structure):
    kind = "exponential_squares"
    data, qs = _data(kind), _queries(kind)
    idx = SpatialIndex.build(data, structure=structure, order="hilbert", device="cpu")
    jidx = JaxIndex.build(data, structure=structure, order="hilbert", backend="pallas",
                          autotune="off")
    assert_schedule_equal(idx.schedule, jidx._artifacts.schedule)
    plain = SpatialIndex.build(data, structure=structure, device="cpu")
    for precision in PRECISIONS:
        got = idx.with_backend("cuda", precision=precision).region(qs)
        want = plain.with_backend("cuda", precision=precision).region(qs)
        assert torch.equal(got.hits, want.hits), precision
        assert torch.equal(got.visits_per_level, want.visits_per_level), precision


def test_hilbert_keys_match_jax():
    rng = np.random.default_rng(5)
    x, y = rng.random(300), rng.random(300)
    x[:4] = [0.0, 1.0, 0.5, 0.5]
    assert np.array_equal(ops.hilbert_keys(x, y), jbuild.hilbert_keys(x, y))
    assert np.array_equal(ops.hilbert_keys(x, y, order=4), jbuild.hilbert_keys(x, y, order=4))


@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("structure,max_entries", TREES, ids=TREE_IDS)
def test_compute_metrics_matches_jax(structure, max_entries, kind):
    got = metrics.compute_metrics(_port_tree(structure, max_entries, kind))
    want = jmetrics.compute_metrics(_jax_tree(structure, max_entries, kind))
    assert got.row() == want.row()


def test_bad_tree_options_raise():
    data = _data("uniform_squares")[:30]
    with pytest.raises(TypeError):
        SpatialIndex.build(data, structure="mqr", levels=3, device="cpu")
    with pytest.raises(TypeError):
        SpatialIndex.build(data, structure="rtree", build="device", device="cpu")
    with pytest.raises(TypeError):
        SpatialIndex.build(data, structure="pyramid", max_entries=4, device="cpu")
    with pytest.raises(ValueError):
        SpatialIndex.build(data, order="z-order", device="cpu")
    with pytest.raises(ValueError):
        SpatialIndex.build(data, structure="pyramid", device="cpu").artifacts.flat
