"""Port parity: the streaming sweep (``stream=True``) and its parent windows.

* ``parent_windows`` of ``repro_torch`` returns the JAX ``(win_off, win_w)``
  for pyramid, mqr and R-tree schedules at ``block_w`` 128 and 256, with
  and without ``uncond_from`` (and for the live layout's extra levels).
* ``level_sweep(stream=True)`` on CPU tensors runs
  ``level_sweep_stream_torch`` — the plain version the CUDA kernel is held
  against on the card — and must give the JAX streaming mask (interpret
  mode), which equals the resident mask.
* ``pyramid_scan`` / ``pyramid_scan_compact`` with ``stream=True`` give the
  JAX hits and per-level visits, on the Hilbert-ordered tree too (whose
  parent window is the full width), and so does ``fused_search_live`` /
  ``fused_search_compact_live`` with delta levels.
* The plain skip count is pinned on hand-built cases: statically empty
  tiles at every level, and a query set that hits nothing.
* The façade with ``stream=True`` gives the JAX hits and visits over
  ``{mqr, rtree, pyramid} × {float32, compact}``, and folds the skip count
  into ``AccessStats.tiles_skipped``.

Tolerance: exact.  Masks are booleans of float32 or integer compares on
the same inputs; visits, windows and skip counts are integers.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import conftest
from repro.index import SpatialIndex as JaxIndex
from repro.kernels import ops as jops
from repro.kernels import pyramid_scan as jscan
from repro.kernels import quantize as jquant
from repro_torch import SpatialIndex, convert
from repro_torch.kernels import ops
from repro_torch.kernels.pyramid_scan import _quantize_queries

N = 300
KIND = "uniform_squares"
STRUCTURES = ("pyramid", "mqr", "rtree")
PRECISIONS = ("float32", "compact")

_SCHEDULES = {}


def _np(t):
    t = t.cpu()
    return (t.to(torch.int32) if t.dtype == torch.uint16 else t).numpy()


def _data():
    return conftest.mbr_dataset(__name__, KIND, N)


def _queries():
    return conftest.dataset_queries(__name__, KIND, N, 6)


def _jax_schedule(structure, order=None):
    key = (structure, order)
    if key not in _SCHEDULES:
        idx = JaxIndex.build(_data(), structure=structure, backend="pallas", order=order)
        _SCHEDULES[key] = idx.artifacts.schedule
    return _SCHEDULES[key]


def _carry(js):
    return convert.schedule_from_numpy(dataclasses.asdict(js), device="cpu")


def _carry_q(jq):
    return convert.quantized_from_numpy(dataclasses.asdict(jq), device="cpu")


def _sweep_inputs(structure, precision):
    """(JAX queries, tiles, parents), the port's, and the schedule."""
    js = _jax_schedule(structure)
    qs = _queries()
    if precision == "float32":
        s = _carry(js)
        return ((jnp.asarray(qs), jnp.asarray(js.mbr_cm), jnp.asarray(js.parent)),
                (torch.from_numpy(qs), s.mbr_cm, s.parent), js)
    jq = jquant.quantize_schedule(js, engine="jnp")
    jqq = jscan._quantize_queries(jnp.asarray(qs), jnp.asarray(jq.origin),
                                  jnp.asarray(jq.inv_cell), jq.cells)
    q = _carry_q(jq)
    qq = _quantize_queries(torch.from_numpy(qs), q.origin, q.inv_cell, q.cells)
    return ((jqq, jnp.asarray(jq.mbr_q), jnp.asarray(jq.parent_q)),
            (qq, q.mbr_q, q.parent_q), js)


# ---------------------------------------------------------------------------
# parent_windows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("uncond", [None, "mid"])
@pytest.mark.parametrize("block_w", [128, 256])
@pytest.mark.parametrize("structure", STRUCTURES)
def test_parent_windows_match_jax(structure, block_w, uncond):
    js = _jax_schedule(structure)
    uncond_from = None if uncond is None else max(js.levels // 2, 1)
    want_off, want_w = jscan.parent_windows(js.parent, js.n_real, block_w=block_w,
                                            uncond_from=uncond_from)
    s = _carry(js)
    for parent, n_real in ((js.parent, js.n_real), (s.parent, s.n_real),
                           (s.parent.to(torch.uint16), s.n_real)):
        off, w = ops.parent_windows(parent, n_real, block_w=block_w,
                                    uncond_from=uncond_from)
        assert off.dtype == np.int32 and w == want_w
        assert np.array_equal(off, want_off)


@pytest.mark.parametrize("structure", STRUCTURES)
def test_parent_windows_of_the_live_layout_match_jax(structure):
    """Extra flat levels (the delta buffer) past the schedule's own."""
    js = _jax_schedule(structure)
    levels = js.levels + 2
    parent = np.concatenate([js.parent, np.zeros((2, js.width), js.parent.dtype)])
    want = jscan.parent_windows(parent, js.n_real, block_w=128, uncond_from=js.levels,
                                levels=levels)
    got = ops.parent_windows(torch.from_numpy(parent), torch.from_numpy(js.n_real),
                             block_w=128, uncond_from=js.levels, levels=levels)
    assert got[1] == want[1] and np.array_equal(got[0], want[0])


# ---------------------------------------------------------------------------
# The sweep and the scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_level_sweep_stream_matches_jax(structure, precision):
    (jq, jtiles, jparent), (q, tiles, parent), js = _sweep_inputs(structure, precision)
    win_off, win_w = jscan.parent_windows(js.parent, js.n_real, block_w=128)
    want = np.asarray(jscan.level_sweep(
        jq, jtiles, jparent, root_unconditional=js.root_unconditional, interpret=True,
        stream=True, win_off=jnp.asarray(win_off), win_w=win_w))
    resident = ops.level_sweep(q, tiles, parent, root_unconditional=js.root_unconditional)
    t_off = torch.from_numpy(win_off)
    got = ops.level_sweep(q, tiles, parent, root_unconditional=js.root_unconditional,
                          stream=True, win_off=t_off, win_w=win_w)
    act, skipped = ops.level_sweep_stream(q, tiles, parent, t_off, win_w,
                                          root_unconditional=js.root_unconditional)
    assert got.dtype == torch.bool
    assert np.array_equal(_np(got), want)
    assert torch.equal(got, resident) and torch.equal(act, resident)
    assert skipped.dtype == torch.int64 and skipped.shape == ()
    assert int(skipped) >= int((t_off < 0).sum())


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_scan_stream_matches_jax(structure, precision):
    js = _jax_schedule(structure)
    qs = _queries()
    s = _carry(js)
    if precision == "float32":
        want = jops.pyramid_scan(js, qs, interpret=True, stream=True)
        got = ops.pyramid_scan(s, torch.from_numpy(qs), stream=True)
    else:
        jq = jquant.quantize_schedule(js, engine="jnp")
        want = jops.pyramid_scan_compact(jq, qs, interpret=True, stream=True)
        got = ops.pyramid_scan_compact(_carry_q(jq), torch.from_numpy(qs), stream=True)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("block_w", [64, 256])
def test_stream_block_w_invariant(block_w):
    """The tiling changes which tiles are skipped, never the answers."""
    js = _jax_schedule("mqr")
    qs = _queries()
    want = jops.pyramid_scan(js, qs, interpret=True)
    got = ops.pyramid_scan(_carry(js), torch.from_numpy(qs), stream=True, block_w=block_w)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))


def test_hilbert_full_width_window():
    """A Hilbert-ordered tree scatters parents: the window is the whole
    padded width, and the answers are still the JAX package's."""
    js = _jax_schedule("mqr", order="hilbert")
    s = _carry(js)
    win_off, win_w = ops.parent_windows(s.parent, s.n_real, block_w=128)
    assert win_w == -(-s.width // 128) * 128
    qs = _queries()
    want = jops.pyramid_scan(js, qs, interpret=True, stream=True)
    got = ops.pyramid_scan(s, torch.from_numpy(qs), stream=True)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), np.asarray(w))
    idx = SpatialIndex.build(_data(), order="hilbert", device="cpu", stream=True)
    ref = JaxIndex.build(_data(), backend="pallas").region(qs)
    res = idx.region(qs)
    assert np.array_equal(_np(res.hits), ref.hits)
    assert np.array_equal(_np(res.visits_per_level), ref.visits_per_level)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("structure", ["pyramid", "mqr"])
def test_fused_search_live_stream_matches_jax(structure, precision):
    """The live layout (base levels + flat delta levels, tombstones) swept
    by the streaming sweep, on the arrays a JAX live index made."""
    data = conftest.f32_exact(_data())
    j = JaxIndex.build(data, structure=structure, backend="pallas", capacity=24)
    gids = j.insert(conftest.f32_exact(conftest.mbr_dataset(__name__, "uniform_points", 10)))
    j.delete([1, 4, int(gids[2])])
    aug = j._updates.augmented(precision)
    base = j._updates.base.schedule
    win_off, win_w = jscan.parent_windows(aug.arrays[1], base.n_real, block_w=128,
                                          uncond_from=aug.base_levels, levels=aug.levels)
    qs = _queries()
    fn, tfn = ((jops.fused_search_live, ops.fused_search_live) if precision == "float32"
               else (jops.fused_search_compact_live, ops.fused_search_compact_live))
    want = fn(jnp.asarray(qs), *[jnp.asarray(a) for a in aug.arrays], interpret=True,
              stream=True, win_off=jnp.asarray(win_off), win_w=win_w, **aug.statics)
    t_arrays = [torch.from_numpy(np.ascontiguousarray(a)) for a in aug.arrays]
    skipped = torch.zeros((), dtype=torch.int64)
    got = tfn(torch.from_numpy(qs), *t_arrays, stream=True,
              win_off=torch.from_numpy(win_off), win_w=win_w, skipped=skipped,
              **aug.statics)
    resident = tfn(torch.from_numpy(qs), *t_arrays, **aug.statics)
    for g, r, w in zip(got, resident, want):
        assert np.array_equal(_np(g), np.asarray(w))
        assert torch.equal(g, r)
    assert int(skipped) >= int((win_off < 0).sum())


# ---------------------------------------------------------------------------
# The plain skip rule, pinned
# ---------------------------------------------------------------------------


def test_skip_count_is_the_statically_empty_tiles_when_everything_survives():
    """A query covering every object keeps every gated window alive, so
    exactly the statically empty tiles (win_off < 0, every level) skip."""
    s = _carry(_jax_schedule("pyramid"))
    huge = torch.tensor([[-1e9, -1e9, 1e9, 1e9]], dtype=torch.float32)
    win_off, win_w = ops.stream_windows(s.parent, s.n_real, block_w=128, device="cpu")
    empty = int((win_off < 0).sum())
    assert empty > 0
    act, skipped = ops.level_sweep_stream(huge, s.mbr_cm, s.parent, win_off, win_w,
                                          root_unconditional=False)
    assert int(skipped) == empty
    assert torch.equal(act, ops.level_sweep(huge, s.mbr_cm, s.parent,
                                            root_unconditional=False))


@pytest.mark.parametrize("structure", ["pyramid", "mqr"])
def test_skip_count_when_nothing_survives(structure):
    """A query far from every object: every tile is skipped but the
    non-empty tiles of level 0 (never gated) and, on a tree, the level-1
    tile whose window holds the root (always active)."""
    s = _carry(_jax_schedule(structure))
    far = torch.tensor([[5e6, 5e6, 5e6 + 1, 5e6 + 1]], dtype=torch.float32)
    win_off, win_w = ops.stream_windows(s.parent, s.n_real, block_w=128, device="cpu")
    levels, tiles = win_off.shape
    act, skipped = ops.level_sweep_stream(far, s.mbr_cm, s.parent, win_off, win_w,
                                          root_unconditional=s.root_unconditional)
    fetched = int((win_off[0] >= 0).sum()) + int(s.root_unconditional)
    assert int(skipped) == levels * tiles - fetched
    assert int(act.sum()) == (1 if s.root_unconditional else 0)
    assert torch.equal(act, ops.level_sweep(far, s.mbr_cm, s.parent,
                                            root_unconditional=s.root_unconditional))


def test_skipped_accumulates_and_stream_needs_windows():
    s = _carry(_jax_schedule("mqr"))
    q = torch.from_numpy(_queries())
    win_off, win_w = ops.stream_windows(s.parent, s.n_real, block_w=128, device="cpu")
    _, once = ops.level_sweep_stream(q, s.mbr_cm, s.parent, win_off, win_w)
    acc = torch.zeros((), dtype=torch.int64)
    for _ in range(3):
        ops.level_sweep_stream(q, s.mbr_cm, s.parent, win_off, win_w, skipped=acc)
    assert int(acc) == 3 * int(once)
    with pytest.raises(ValueError, match="win_off"):
        ops.level_sweep(q, s.mbr_cm, s.parent, stream=True)
    with pytest.raises(ValueError, match="win_off"):
        ops.level_sweep_stream(q, s.mbr_cm, s.parent, win_off[:, :-1], win_w,
                               block_w=64)


# ---------------------------------------------------------------------------
# The façade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_facade_stream_matches_jax(structure, precision):
    qs = _queries()
    j = JaxIndex.build(_data(), structure=structure, backend="pallas", autotune="off")
    want = j.with_backend("pallas", stream=True, precision=precision,
                          autotune="off").region(qs)
    idx = SpatialIndex.build(_data(), structure=structure, device="cpu", stream=True,
                             precision=precision, autotune="off")
    res = idx.region(qs)
    assert np.array_equal(_np(res.hits), want.hits)
    assert np.array_equal(_np(res.visits_per_level), want.visits_per_level)
    # the skip count is the plain rule's, folded into the stats
    s = idx.artifacts.schedule
    tiles, parent = s.mbr_cm, s.parent
    q = torch.from_numpy(qs)
    if precision == "compact":
        qsched = idx.artifacts.quantized
        tiles, parent = qsched.mbr_q, qsched.parent_q
        q = _quantize_queries(q, qsched.origin, qsched.inv_cell, qsched.cells)
    win_off, win_w = ops.stream_windows(s.parent, s.n_real, block_w=128, device="cpu")
    _, skipped = ops.level_sweep_stream_torch(q, tiles, parent, win_off, win_w,
                                              root_unconditional=s.root_unconditional)
    assert idx.stats.tiles_skipped == int(skipped)
    assert idx.stats.node_accesses == int(want.visits_per_level.sum())


def test_stream_compact8_rejected():
    with pytest.raises(ValueError, match="compact8"):
        SpatialIndex.build(_data(), device="cpu",
                           backend_opts={"stream": True, "precision": "compact8"})
