"""Port parity: the autotuned tiling of ``repro_torch`` (``kernels/autotune.py``
and the ``cuda`` backend's ``autotune`` / ``block_w=None`` defaults).

The tuner only changes WHICH plan runs, never the answer, so these tests
check the selection machinery against the JAX package (same candidate
grids, same shape keys) and check both plans explicitly — the fused sweep
(``levels_in_grid=True``) and the per-level ``mbr_scan`` plan (False) —
against the JAX answers.  They never assert which candidate wins.

One deliberate difference from the reference: the JAX ``tune`` skips any
candidate that raises; the port's ``tune`` skips only a ``ValueError``
(refused by an argument check before any launch) and lets every other
error through, so a kernel that fails to launch on the card is never
hidden behind another candidate.

Tolerance: exact — hits are booleans, visits integer counts.
"""
import numpy as np
import pytest
import torch

import conftest
from repro.index import SpatialIndex as JaxIndex
from repro.kernels import autotune as jtune
from repro_torch import SpatialIndex
from repro_torch.kernels import autotune

N = 1400  # a pyramid this size is W = N >= AUTO_MIN_WIDTH wide


def _np(t):
    return t.cpu().numpy()


def _data(kind="uniform_squares", n=N):
    return conftest.mbr_dataset(__name__, kind, n)


def _queries(kind="uniform_squares", n=N, nq=12):
    return conftest.dataset_queries(__name__, kind, n, nq)


SHAPES = [(200, 8), (2048, 64), (4096, 100), (10 ** 6, 256), (1, 1)]


@pytest.mark.parametrize("width,nq", SHAPES)
@pytest.mark.parametrize("precision,stream,live", [
    ("float32", False, False), ("compact", False, False), ("compact8", False, False),
    ("float32", True, False), ("float32", False, True),
])
def test_candidates_match_jax(width, nq, precision, stream, live):
    got = autotune.candidates(width, nq, precision=precision, stream=stream, live=live)
    want = jtune.candidates(width, nq, precision=precision, stream=stream, live=live)
    assert [(c.block_w, c.query_block, c.levels_in_grid) for c in got] == \
           [(c.block_w, c.query_block, c.levels_in_grid) for c in want]
    assert autotune.TileConfig() in got


@pytest.mark.parametrize("width,nq", SHAPES)
def test_shape_key_and_constants_match_jax(width, nq):
    for precision in ("float32", "compact", "compact8"):
        for stream in (False, True):
            assert autotune.shape_key(width, 11, nq, precision, stream) == \
                jtune.shape_key(width, 11, nq, precision, stream)
    assert (autotune.AUTO_MIN_WIDTH, autotune.PROBE_QUERIES, autotune.DEFAULT_BLOCK_WS) == \
        (jtune.AUTO_MIN_WIDTH, jtune.PROBE_QUERIES, jtune.DEFAULT_BLOCK_WS)


def test_tune_picks_a_timed_candidate_and_syncs():
    calls = []
    cands = [autotune.TileConfig(64), autotune.TileConfig(128)]
    best, timings = autotune.tune(lambda c: lambda: calls.append(c), cands,
                                  iters=3, sync=lambda: calls.append("sync"))
    assert best in cands and set(timings) == set(cands)
    assert calls.count(cands[0]) == 4 and calls.count(cands[1]) == 4  # warm-up + 3
    assert calls.count("sync") == 2 * 3 * len(cands)


def test_tune_skips_value_error_but_not_runtime_error():
    """The deliberate difference from the JAX ``tune``: only a ValueError
    (an argument check before any launch) skips a candidate; a launch
    error propagates instead of being hidden."""
    bad, good = autotune.TileConfig(100), autotune.TileConfig(128)

    def refuse(cfg):
        def run():
            if cfg == bad:
                raise ValueError("block_w must be a multiple of 32")
        return run

    best, timings = autotune.tune(refuse, [bad, good])
    assert best == good and bad not in timings

    def launch_fails(cfg):
        def run():
            if cfg == bad:
                raise RuntimeError("level_sweep: CUDA error 9 (invalid configuration)")
        return run

    with pytest.raises(RuntimeError, match="CUDA error"):
        autotune.tune(launch_fails, [good, bad])
    # the reference skips both kinds
    assert jtune.tune(launch_fails, [good, bad])[0] == good
    # every candidate refused: the fixed default wins
    assert autotune.tune(refuse, [bad])[0] == autotune.TileConfig()


@pytest.mark.parametrize("structure", ["pyramid", "mqr"])
def test_both_plans_give_the_jax_answer(structure):
    """Fused sweep and per-level plan, at several block widths and with
    query chunks: hits and visits equal the JAX answer whichever wins."""
    n = N if structure == "pyramid" else 400
    data, qs = _data(n=n), _queries(n=n, nq=40)
    want = JaxIndex.build(data, structure=structure, backend="pallas",
                          autotune="off").region(qs)
    idx = SpatialIndex.build(data, structure=structure, device="cpu")
    backend = idx._backend
    for cfg in autotune.candidates(idx.schedule.width, len(qs)):
        hits, visits, launches = backend._run(torch.from_numpy(qs), cfg)
        assert np.array_equal(_np(hits), want.hits), cfg
        assert np.array_equal(_np(visits), want.visits_per_level), cfg
        chunks = 1 if cfg.query_block is None else -(-len(qs) // cfg.query_block)
        assert launches == chunks * idx.schedule.levels


@pytest.mark.parametrize("precision", ["float32", "compact", "compact8"])
def test_autotune_on_caches_in_artifacts_and_twins_share(precision):
    data, qs = _data(n=300), _queries(n=300)
    idx = SpatialIndex.build(data, structure="pyramid", autotune="on", precision=precision,
                             device="cpu")
    assert idx.artifacts.tuned == {}
    first = idx.region(qs)
    (key, cfg), = idx.artifacts.tuned.items()
    assert key == autotune.shape_key(idx.schedule.width, idx.schedule.levels, len(qs),
                                     precision, False)
    assert idx._backend.config == cfg
    if precision != "float32":
        assert cfg.levels_in_grid  # the per-level plan is float32 only
    twin = idx.with_backend("cuda", autotune="on", precision=precision)
    assert twin.artifacts.tuned is idx.artifacts.tuned
    again = twin.region(qs)
    assert list(idx.artifacts.tuned.values()) == [cfg]  # reused, not re-timed
    assert twin._backend.config == cfg
    assert torch.equal(again.hits, first.hits)
    assert torch.equal(again.visits_per_level, first.visits_per_level)
    fixed = idx.with_backend("cuda", autotune="off", precision=precision).region(qs)
    assert torch.equal(first.hits, fixed.hits)
    assert torch.equal(first.visits_per_level, fixed.visits_per_level)


def test_auto_tunes_only_wide_schedules():
    narrow = SpatialIndex.build(_data(n=300), structure="pyramid", device="cpu")
    narrow.region(_queries(n=300))
    assert narrow.artifacts.tuned == {}
    assert narrow._backend.config == autotune.TileConfig()
    wide = SpatialIndex.build(_data(), structure="pyramid", device="cpu")
    assert wide.schedule.width >= autotune.AUTO_MIN_WIDTH
    res = wide.region(_queries())
    assert len(wide.artifacts.tuned) == 1
    want = JaxIndex.build(_data(), structure="pyramid", backend="pallas",
                          autotune="off").region(_queries())
    assert np.array_equal(_np(res.hits), want.hits)
    assert np.array_equal(_np(res.visits_per_level), want.visits_per_level)


@pytest.mark.parametrize("opts,cfg", [
    ({"block_w": 256}, autotune.TileConfig(256)),
    ({"query_block": 4}, autotune.TileConfig(128, 4)),
    ({"autotune": "off"}, autotune.TileConfig()),
])
def test_explicit_tiling_pins_the_fixed_config(opts, cfg):
    idx = SpatialIndex.build(_data(), structure="pyramid", device="cpu", **opts)
    idx.region(_queries())
    assert idx.artifacts.tuned == {}
    assert idx._backend.config == cfg


def test_backend_option_errors():
    data = _data(n=50)
    with pytest.raises(ValueError):
        SpatialIndex.build(data, device="cpu", autotune="sometimes")
    with pytest.raises(ValueError):  # as in the reference
        SpatialIndex.build(data, device="cpu", stream=True, precision="compact8")
    # stream=True builds and answers as the resident sweep does
    streamed = SpatialIndex.build(data, device="cpu", stream=True)
    resident = streamed.with_backend("cuda")
    qs = _queries(n=50)
    got, want = streamed.region(qs), resident.region(qs)
    assert torch.equal(got.hits, want.hits)
    assert torch.equal(got.visits_per_level, want.visits_per_level)
    assert streamed._backend.stream and not resident._backend.stream


@pytest.mark.parametrize("width,nq", SHAPES)
def test_distinct_plans_keep_one_per_level_plan_per_query_block(width, nq):
    """The port's per-level plan does not depend on ``block_w`` (its
    ``mbr_scan`` picks its own tile), so the backend times one per
    ``query_block``: the first, in the reference's order; every fused
    candidate stays."""
    cands = autotune.candidates(width, nq)
    got = autotune.distinct_plans(cands)
    per_level = [c for c in cands if not c.levels_in_grid]
    firsts = {}
    for c in per_level:
        firsts.setdefault(c.query_block, c)
    assert got == [c for c in cands if c.levels_in_grid or firsts[c.query_block] == c]
    assert sorted((c.query_block or 0) for c in got if not c.levels_in_grid) == \
        sorted((qb or 0) for qb in firsts)
    assert len(cands) - len(got) == len(per_level) - len(firsts)
