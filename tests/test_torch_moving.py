"""Port parity: the moving-object workload of ``repro_torch.launch.moving``.

The same ``MovingConfig`` and seed run through ``repro.launch.moving``
(JAX package, its Pallas sweeps in interpret mode or its ``host``
backend) and through the port's copy on the CPU (``device="cpu"``).  Both
draw everything from one numpy ``default_rng(seed)`` in the same order,
so the moved slots, old and new global ids, region hits, join pairs and
pair visits must be equal tick for tick, across overflow merges, and
under ``rebuild_per_tick``.  Every answer is also held to a brute-force
float32 overlap of the workload's current boxes.

Tolerance: exact (ids, booleans and integer counts).
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from repro.launch import moving as jmoving
from repro_torch.launch import moving

STATS = ("inserts", "deletes", "flushes", "joins", "queries", "node_accesses",
         "delta_accesses")


def _np(t):
    return t.cpu().numpy()


def _overlap_np(a, b):
    return ((a[..., 0] <= b[..., 2]) & (b[..., 0] <= a[..., 2])
            & (a[..., 1] <= b[..., 3]) & (b[..., 1] <= a[..., 3]))


def brute_force(w, res):
    """(region hits, join pairs) the tick must answer: float32 overlap of
    the current boxes, at each object's current global id."""
    idx = w.query_index
    boxes = w.boxes().astype(np.float32)
    hits = np.zeros((w.queries.shape[0], idx.id_space), bool)
    hits[:, w.gid] = _overlap_np(boxes[None, :, :], w.queries[:, None, :])
    pairs = np.zeros((idx.id_space, w.zone_mbrs.shape[0]), bool)
    pairs[w.gid] = _overlap_np(boxes[:, None, :], w.zone_mbrs.astype(np.float32)[None, :, :])
    return hits, pairs


def assert_same_tick(got, want, what=""):
    assert got.tick == want.tick
    for name in ("moved", "old_gids", "new_gids"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), f"{what} {name}"
    assert (got.join is None) == (want.join is None)
    if want.join is not None:
        assert np.array_equal(_np(got.region.hits), want.region.hits), what
        assert np.array_equal(_np(got.region.visits_per_level),
                              want.region.visits_per_level), what
        assert np.array_equal(_np(got.join.pairs), want.join.pairs), what
        assert np.array_equal(_np(got.join.pair_visits), want.join.pair_visits), what


@pytest.mark.parametrize("backend", ["cuda", "host"])
@pytest.mark.parametrize("structure", ["pyramid", "mqr"])
def test_workload_matches_reference_through_merges(structure, backend):
    """A capacity small enough that the buffer overflows mid-run: every
    tick equals the reference and the brute force, and merges happen."""
    cfg = dict(n_objects=64, moves_per_tick=8, n_zones=10, query_every=2, seed=3)
    jax_backend = "pallas" if backend == "cuda" else "host"
    jw = jmoving.MovingWorkload(jmoving.MovingConfig(**cfg), structure=structure,
                                backend=jax_backend, capacity=24)
    pw = moving.MovingWorkload(moving.MovingConfig(**cfg), structure=structure,
                               backend=backend, capacity=24, device="cpu")
    assert np.array_equal(pw.zone_mbrs, jw.zone_mbrs)
    assert np.array_equal(pw.queries, jw.queries)
    for _ in range(14):
        got, want = pw.tick(), jw.tick()
        assert_same_tick(got, want, f"{structure} {backend} tick {got.tick}")
        if got.join is not None:
            hits, pairs = brute_force(pw, got)
            assert np.array_equal(_np(got.region.hits), hits)
            assert np.array_equal(_np(got.join.pairs), pairs)
            assert not got.join.pairs[np.asarray(pw.dead_gids)].any()
    assert pw.index.stats.flushes >= 2, "the buffer never overflowed"
    for name in STATS:
        assert getattr(pw.index.stats, name) == getattr(jw.index.stats, name), name
    assert pw.zones.device == pw.device == torch.device("cpu")


def test_explicit_flush_moves_no_pair():
    cfg = moving.MovingConfig(n_objects=48, moves_per_tick=6, query_every=1, seed=11)
    w = moving.MovingWorkload(cfg, capacity=64, device="cpu")
    w.run(5)   # leave real state in the delta buffer
    before = w.index.join(w.zones)
    assert int(before.delta_tests.sum()) > 0
    na = before.pairs.shape[0]
    assert w.index.flush()
    after = w.index.join(w.zones)
    assert torch.equal(after.pairs[:na], before.pairs) and not after.pairs[na:].any()
    assert int(after.delta_tests.sum()) == 0


@pytest.mark.parametrize("structure", ["pyramid", "mqr"])
def test_rebuild_per_tick_matches_reference_and_live_path(structure):
    """The naive baseline equals the reference's, and gives the live
    path's answers per object slot (the id spaces differ)."""
    cfg = dict(n_objects=40, moves_per_tick=5, query_every=4, seed=7)
    jw = jmoving.MovingWorkload(jmoving.MovingConfig(**cfg), structure=structure,
                                backend="host", rebuild_per_tick=True)
    base = moving.MovingWorkload(moving.MovingConfig(**cfg), structure=structure,
                                 rebuild_per_tick=True, device="cpu")
    live = moving.MovingWorkload(moving.MovingConfig(**cfg), structure=structure,
                                 capacity=64, device="cpu")
    for _ in range(12):
        rb, rj, rl = base.tick(), jw.tick(), live.tick()
        assert np.array_equal(rb.moved, rj.moved) and np.array_equal(rb.moved, rl.moved)
        assert (rb.join is None) == (rj.join is None) == (rl.join is None)
        if rl.join is None:
            continue
        assert np.array_equal(_np(rb.region.hits), rj.region.hits)
        assert np.array_equal(_np(rb.join.pairs), rj.join.pairs)
        assert np.array_equal(_np(rl.region.hits)[:, live.gid], _np(rb.region.hits)[:, base.gid])
        assert np.array_equal(_np(rl.join.pairs)[live.gid], _np(rb.join.pairs)[base.gid])
    assert base.index._updates is None  # no delta buffer on the baseline


def test_workload_is_replayable_and_takes_an_index():
    cfg = moving.MovingConfig(n_objects=32, moves_per_tick=4, query_every=3, seed=21)
    a = moving.MovingWorkload(cfg, backend="host", capacity=48, device="cpu")
    b = moving.MovingWorkload(cfg, backend="host", capacity=48, device="cpu")
    c = moving.MovingWorkload(cfg, index=b.index._snapshot())
    assert c.query_index is not b.index and c.device == b.device
    for _ in range(9):
        ra, rb, rc = a.tick(), b.tick(), c.tick()
        assert np.array_equal(ra.moved, rb.moved) and np.array_equal(ra.new_gids, rc.new_gids)
        if ra.join is not None:
            assert torch.equal(ra.join.pairs, rb.join.pairs)
            assert torch.equal(ra.region.hits, rc.region.hits)


def test_cli_runs_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        moving.main(["--ticks", "20", "--objects", "48", "--device", "cpu"])
    text = out.getvalue()
    assert "20 ticks" in text and "device=cpu" in text and "object×zone pairs" in text
