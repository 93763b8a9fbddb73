"""Port parity: live updates (delta buffer, tombstones, merge) of ``repro_torch``.

The same mutation script runs on a JAX ``SpatialIndex(backend="pallas")``
(interpret mode) and on the port (``device="cpu"``, backends ``cuda`` — the
fused live sweep through the kernels' plain versions — and ``host``, the
numpy composition).  Returned ids, hits in global-id space, visits with
their delta columns, counts, ``n_objects``, ``id_space`` and the live
counters of ``AccessStats`` must be equal, and so must the
``AugmentedArrays`` the live sweep runs on, field for field, at float32
and compact.  The invariants of ``tests/test_live_update.py`` (tombstones
never hit, delete-then-reinsert, overflow merges, policy triggers, manual
mode, option validation, shared state across ``with_backend``, the delta
ledger) are held here against the port's own oracle
(``repro_torch.update.oracle``), which is itself held to the reference's.

Tolerance: exact.  Hits are booleans, visits and counters integers, and
the arrays are the same float32 / uint16 values.
"""
import numpy as np
import pytest
import torch

import conftest
from conftest import f32_exact
from repro.core import datasets as jdatasets
from repro.index import SpatialIndex as JaxIndex
from repro.update import oracle as joracle
from repro_torch import SpatialIndex
from repro_torch.update import BufferFullError, MergePolicy, oracle

PORT_BACKENDS = ("cuda", "host")
HUGE = np.array([[-1e6, -1e6, 1e6, 1e6]], np.float32)
LIVE_STATS = ("queries", "node_accesses", "inserts", "deletes", "flushes",
              "shed_mutations", "delta_accesses")


def _np(t):
    t = t.cpu()
    return (t.to(torch.int32) if t.dtype == torch.uint16 else t).numpy()


def _squares(n, seed):
    return f32_exact(jdatasets.uniform_squares(n, seed=seed))


def _queries(data, n, seed):
    return jdatasets.region_queries(data, n, seed=seed).astype(np.float32)


def _centers(data):
    return np.stack([(data[:, 0] + data[:, 2]) / 2,
                     (data[:, 1] + data[:, 3]) / 2], 1).astype(np.float32)


def assert_same_answers(port, jax_idx, queries, points, what=""):
    """region / point / count of a port index == the JAX index's."""
    want_r, want_p = jax_idx.region(queries), jax_idx.point(points)
    got_r, got_p = port.region(queries), port.point(points)
    for got, want in ((got_r, want_r), (got_p, want_p)):
        assert np.array_equal(_np(got.hits), want.hits), what
        assert np.array_equal(_np(got.visits_per_level), want.visits_per_level), what
        assert got.base_levels == want.base_levels, what
        assert np.array_equal(_np(got.delta_visits), want.delta_visits), what
    assert np.array_equal(_np(port.count(queries)), jax_idx.count(queries)), what
    assert (port.n_objects, port.id_space) == (jax_idx.n_objects, jax_idx.id_space), what


def assert_matches_oracle(idx, queries, what=""):
    """Hits of every port backend (and compact) == the port's mqr
    insertion-rule oracle; visits identical across the float32 backends."""
    ref = oracle.hits_mask(idx, queries, idx.id_space)
    first = None
    for backend in PORT_BACKENDS:
        res = idx.with_backend(backend).region(queries)
        assert np.array_equal(_np(res.hits), ref), f"{what} {backend} vs oracle"
        if first is None:
            first = res
        else:
            assert torch.equal(res.visits_per_level.cpu(), first.visits_per_level.cpu())
    compact = idx.with_backend("cuda", precision="compact").region(queries)
    assert np.array_equal(_np(compact.hits), ref), f"{what} compact vs oracle"


# ---------------------------------------------------------------------------
# One mutation script on the JAX package and on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,precision", [
    ("cuda", "float32"), ("cuda", "compact"), ("host", "float32"),
])
@pytest.mark.parametrize("structure", ["pyramid", "mqr"])
def test_mutation_script_matches_jax(structure, precision, backend):
    data = _squares(160, 3)
    qs = _queries(data, 5, 7)
    pts = _centers(data)[:4]
    opts = {} if backend == "host" else {"precision": precision, "autotune": "off"}
    jopts = {"backend": "pallas", "precision": precision, "autotune": "off"}
    port = SpatialIndex.build(data, structure=structure, backend=backend, device="cpu",
                              capacity=32, **opts)
    jax_idx = JaxIndex.build(data, structure=structure, capacity=32, **jopts)
    steps = [
        ("insert", _squares(20, 4)),
        ("delete", [0, 7, 11]),
        ("delete_new", [0, 5]),
        ("insert", _squares(12, 5)),   # 14 free slots: fits
        ("insert", _squares(10, 6)),   # 2 free slots: folds into a merge
        ("delete", [20, 30, 181]),
        ("flush", None),
        ("insert", _squares(40, 8)),   # larger than the capacity: merges
        ("delete", [3, 170]),
    ]
    new_ids = None
    for op, arg in steps:
        if op == "insert":
            got, want = port.insert(arg), jax_idx.insert(arg)
            assert np.array_equal(got, want)
            new_ids = want
        elif op == "delete":
            port.delete(arg)
            jax_idx.delete(arg)
        elif op == "delete_new":
            port.delete(new_ids[arg])
            jax_idx.delete(new_ids[arg])
        else:
            assert port.flush() == jax_idx.flush()
        assert_same_answers(port, jax_idx, qs, pts, f"after {op}")
    for f in LIVE_STATS:
        assert getattr(port.stats, f) == getattr(jax_idx.stats, f), f
    assert port.stats.flushes == 3


@pytest.mark.parametrize("precision", ["float32", "compact"])
@pytest.mark.parametrize("structure", ["pyramid", "mqr", "rtree"])
def test_augmented_arrays_match_jax(structure, precision):
    data = _squares(150, 9)
    port = SpatialIndex.build(data, structure=structure, device="cpu", capacity=40)
    jax_idx = JaxIndex.build(data, structure=structure, backend="pallas", capacity=40)
    for idx in (port, jax_idx):
        gids = idx.insert(_squares(25, 10))
        idx.delete([2, 9, int(gids[1]), int(gids[7])])
    got = port._updates.augmented(precision)
    want = jax_idx._updates.augmented(precision)
    assert got.statics == want.statics
    assert (got.levels, got.base_levels, got.n_objects) == (
        want.levels, want.base_levels, want.n_objects)
    assert len(got.arrays) == len(want.arrays)
    for i, (g, w) in enumerate(zip(got.arrays, want.arrays)):
        w = np.asarray(w)
        assert g.dtype == torch.from_numpy(w).dtype, i
        assert g.shape == w.shape and np.array_equal(_np(g), w), i
    # cached per epoch; a mutation makes new arrays
    assert port._updates.augmented(precision) is got
    port.delete([3])
    assert port._updates.augmented(precision) is not got
    assert np.array_equal(port._updates.delta_id_mask(), jax_idx._updates.delta_id_mask()[
        : port._updates.id_capacity])


@pytest.mark.parametrize("flush", ["auto", "always"])
def test_extend_matches_jax(flush):
    data = _squares(120, 11)
    qs = _queries(data, 4, 12)
    port = SpatialIndex.build(data, structure="pyramid", device="cpu", capacity=16)
    jax_idx = JaxIndex.build(data, structure="pyramid", backend="pallas", capacity=16)
    batch = _squares(10, 13)
    p2, j2 = port.extend(batch, flush=flush), jax_idx.extend(batch, flush=flush)
    assert port._updates is None and port.n_objects == 120  # the source is untouched
    assert_same_answers(p2, j2, qs, _centers(data)[:2], f"extend {flush}")
    assert (p2._updates is None) == (j2._updates is None)
    with pytest.raises(ValueError, match="flush"):
        port.extend(batch, flush="never")


def test_live_metrics_and_oracle_match_jax():
    data = _squares(90, 14)
    qs = _queries(data, 6, 15)
    port = SpatialIndex.build(data, structure="mqr", device="cpu", capacity=16)
    jax_idx = JaxIndex.build(data, structure="mqr", backend="pallas", capacity=16)
    assert port.live_metrics().row() == jax_idx.live_metrics().row()  # pristine
    for idx in (port, jax_idx):
        idx.insert(_squares(8, 16))
        idx.delete([1, 2, 3, 91])
    assert port.live_metrics().row() == jax_idx.live_metrics().row()
    assert np.array_equal(oracle.hits_mask(port, qs, port.id_space),
                          joracle.hits_mask(jax_idx, qs, jax_idx.id_space))
    assert oracle.region_sets(port._updates, qs) == joracle.region_sets(jax_idx._updates, qs)
    assert oracle.live_tree(port) is oracle.live_tree(port)  # cached per epoch


# ---------------------------------------------------------------------------
# The reference's live-update invariants, on the port
# ---------------------------------------------------------------------------


def test_mixed_workload_matches_oracle():
    rng = np.random.default_rng(0)
    data = f32_exact(conftest.mbr_dataset(__name__, "uniform_squares", 200))
    idx = SpatialIndex.build(data, structure="pyramid", device="cpu",
                             merge=dict(capacity=96, max_tombstone_ratio=0.95))
    log = idx._ensure_log()
    midbuffer = 0
    for r in range(8):
        idx.insert(_squares(40, 1000 + r))
        if r in (3, 6):
            midbuffer += log.n_delta > 0
            qs = _queries(log.mbr_table[log.alive], 4, 50 + r)
            assert_matches_oracle(idx, qs, f"round {r}")
        live = np.nonzero(log.alive)[0]
        idx.delete(rng.choice(live, size=30, replace=False))
    assert midbuffer >= 1, "no checkpoint landed mid-buffer"
    assert (idx.stats.inserts, idx.stats.deletes) == (8 * 40, 8 * 30)
    assert idx.stats.flushes > 0
    qs = _queries(log.mbr_table[log.alive], 4, 99)
    pre = idx.region(qs)
    assert idx.flush()
    assert log.n_delta == 0 and log.dead_base == 0
    post = idx.region(qs)
    for i in range(qs.shape[0]):
        assert torch.equal(pre.ids(i), post.ids(i)), "merge changed hits"
    assert_matches_oracle(idx, qs, "post-flush")


@pytest.mark.parametrize("structure", ["mqr", "pyramid"])
def test_tombstoned_ids_never_hit_anywhere(structure):
    data = _squares(160, 3)
    idx = SpatialIndex.build(data, structure=structure, device="cpu", capacity=32)
    gids = idx.insert(_squares(20, 4))
    dead = [0, 7, 11, int(gids[0]), int(gids[5])]
    idx.delete(dead)
    centers = _centers(data)[:8]
    for backend in PORT_BACKENDS:
        tw = idx.with_backend(backend)
        r = tw.region(HUGE)
        assert not r.hits[:, dead].any(), f"{backend} region leaked a tombstone"
        assert int(r.hits.sum()) == idx.n_objects, f"{backend} missed live objects"
        assert not tw.point(centers).hits[:, dead].any()
    compact = idx.with_backend("cuda", precision="compact").region(HUGE)
    assert not compact.hits[:, dead].any()


def test_delete_then_reinsert_roundtrips():
    data = _squares(100, 5)
    idx = SpatialIndex.build(data, structure="mqr", device="cpu", capacity=16)
    q = np.asarray(data[3], np.float32)[None, :]
    assert idx.region(q).hits[0, 3]
    idx.delete([3])
    assert not idx.region(q).hits[0, 3]
    (new_gid,) = idx.insert(data[3][None, :])
    assert new_gid == 100  # ids never recycle
    res = idx.region(q)
    assert res.hits[0, new_gid] and not res.hits[0, 3]
    assert idx.n_objects == 100
    idx.flush()
    res = idx.region(q)
    assert res.hits[0, new_gid] and not res.hits[0, 3]
    assert_matches_oracle(idx, q, "reinsert")


def test_buffer_overflow_merges_automatically():
    data = _squares(120, 6)
    idx = SpatialIndex.build(data, structure="pyramid", device="cpu",
                             merge=dict(capacity=24, max_fill=1.0))
    qs = _queries(data, 5, 7)
    seen = []
    for i in range(4):  # 4 × 10 inserts through a 24-slot buffer
        idx.insert(_squares(10, 60 + i))
        seen.append([set(idx.region(qs).ids(j).tolist()) for j in range(qs.shape[0])])
    assert idx.stats.flushes >= 1, "overflow must have merged"
    assert [set(idx.region(qs).ids(j).tolist()) for j in range(qs.shape[0])] == seen[-1]
    assert_matches_oracle(idx, qs, "overflow")
    gids = idx.insert(_squares(40, 70))  # larger than the capacity
    assert gids.shape == (40,) and idx._updates.n_delta == 0
    assert_matches_oracle(idx, qs, "oversized batch")


def test_merge_policy_triggers_and_manual_mode():
    data = _squares(80, 8)
    idx = SpatialIndex.build(data, structure="mqr", backend="host", device="cpu",
                             merge=dict(capacity=10, max_fill=0.5))
    idx.insert(_squares(5, 9))  # fill trigger
    assert idx.stats.flushes == 1 and idx._updates.n_delta == 0
    idx = SpatialIndex.build(data, structure="mqr", backend="host", device="cpu",
                             merge=dict(capacity=10, max_tombstone_ratio=0.1))
    idx.delete(np.arange(8))  # tombstone-ratio trigger
    assert idx.stats.flushes == 1 and idx._updates.dead_base == 0
    assert idx.n_objects == 72
    idx = SpatialIndex.build(data, structure="mqr", backend="host", device="cpu",
                             merge=MergePolicy(capacity=10, max_fill=0.5, auto=False))
    idx.insert(_squares(9, 10))
    idx.delete(np.arange(40))
    assert idx.stats.flushes == 0 and idx._updates.pending
    with pytest.raises(BufferFullError, match="auto=False"):
        idx.insert(_squares(2, 11))  # one free slot: no implicit merge
    assert idx.flush() and not idx._updates.pending
    assert not idx.flush()  # nothing pending: no-op


def test_admission_shed_drops_unbufferable_batches():
    data = _squares(60, 12)
    idx = SpatialIndex.build(data, structure="pyramid", device="cpu", capacity=8,
                             admission="shed")
    assert idx.insert(_squares(6, 13)).shape == (6,)
    assert idx.insert(_squares(4, 14)).size == 0  # 2 free slots: shed
    assert (idx.stats.shed_mutations, idx.stats.inserts) == (4, 6)
    assert idx.n_objects == 66
    assert idx.insert(_squares(9, 15)).shape == (9,)  # oversized: merges anyway
    with pytest.raises(ValueError, match="admission"):
        SpatialIndex.build(data, device="cpu", admission="queue")


def test_update_option_routing_and_validation():
    data = _squares(40, 11)
    with pytest.raises(ValueError, match="capacity"):
        SpatialIndex.build(data, device="cpu", capacity=0)
    with pytest.raises(ValueError, match="max_fill"):
        SpatialIndex.build(data, device="cpu", merge=dict(max_fill=1.5))
    with pytest.raises(TypeError, match="MergePolicy"):
        SpatialIndex.build(data, device="cpu", merge=42)
    with pytest.raises(TypeError):
        SpatialIndex.build(data, device="cpu").with_backend("cuda", capacity=8)
    with pytest.raises(TypeError, match="update option"):
        SpatialIndex.build(data, device="cpu", backend_opts={"capacity": 8})
    idx = SpatialIndex.build(data, structure="mqr", backend="host", device="cpu")
    assert idx.insert(np.zeros((0, 4))).size == 0
    idx.delete(np.zeros((0,), np.int64))
    assert idx._updates is None and idx.id_space == 40
    with pytest.raises(ValueError, match="inverted"):
        idx.insert(np.array([[1.0, 1.0, 0.0, 0.0]]))
    with pytest.raises(KeyError, match="not live"):
        idx.delete([40])
    idx.delete([0])
    epoch = idx._updates.epoch
    idx.delete(np.zeros((0,), np.int64))
    assert idx._updates.epoch == epoch
    with pytest.raises(KeyError, match="not live"):
        idx.delete([0])
    with pytest.raises(KeyError, match="duplicate"):
        idx.delete([1, 1])
    with pytest.raises(ValueError, match="no live objects"):
        idx.delete(np.arange(1, 40))
        idx.flush()
    gids = idx.insert(_squares(3, 99))  # folds straight into a merge
    assert idx.n_objects == 3
    assert np.array_equal(_np(idx.region(HUGE).ids(0)), gids)


def test_with_backend_shares_live_state():
    data = _squares(60, 12)
    idx = SpatialIndex.build(data, structure="mqr", device="cpu", capacity=16)
    twin = idx.with_backend("host")
    gids = idx.insert(_squares(4, 13))
    twin.delete([gids[0], 2])  # mutate through the twin
    a, b = idx.region(HUGE), twin.region(HUGE)
    assert torch.equal(a.hits, b.hits)
    assert torch.equal(a.visits_per_level, b.visits_per_level)
    idx.flush()  # picked up lazily by the twin
    assert torch.equal(twin.region(HUGE).ids(0), a.ids(0))
    assert twin.artifacts is idx.artifacts


def test_access_stats_delta_ledger():
    data = _squares(70, 17)
    idx = SpatialIndex.build(data, structure="pyramid", device="cpu", capacity=16)
    idx.insert(_squares(6, 18))
    res = idx.region(HUGE)
    assert res.base_levels == idx.schedule.levels
    assert int(res.delta_visits[0]) == 6  # every valid slot was accessed
    assert idx.stats.delta_accesses == 6
    assert idx.stats.node_accesses == int(res.visits_per_level.sum())
    assert idx.stats.launches == idx.schedule.levels + 1  # one flat delta level
    idx.flush()
    assert int(idx.region(HUGE).delta_visits[0]) == 0


def test_snapshot_and_restore_are_independent_and_exact():
    data = _squares(50, 19)
    idx = SpatialIndex.build(data, structure="pyramid", device="cpu", capacity=8)
    idx.insert(_squares(5, 20))
    idx.delete([1, 51])
    log = idx._updates
    copy = log.snapshot()
    copy.delete([2])
    assert log.alive[2] and not copy.alive[2]
    restored = type(log).restore(log.base, log.policy, log._rebuild,
                                 log.state_arrays(), log.state_scalars())
    for k, v in log.state_arrays().items():
        assert np.array_equal(restored.state_arrays()[k], v), k
    assert restored.state_scalars() == log.state_scalars()
    assert restored._slot_of == log._slot_of
