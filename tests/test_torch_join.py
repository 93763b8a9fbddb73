"""Port parity: the tree-vs-tree spatial join of ``repro_torch``.

The same seeded arrays go through the JAX package (its Pallas pair sweep
in interpret mode, or its ``host``/``lax`` engines, which its own tests
hold equal to the kernel) and through the port on the CPU (``device="cpu"``:
backend ``cuda`` runs the pair sweep's plain version and the torch
epilogue, backend ``host`` the numpy engine).  Pair sets, per-level pair
visits, ancestor chains, joint grids and sweep masks must be equal.

Tolerance: exact.  Masks are booleans, visits and chains integers.  The
adversarial-geometry cases are held to the numpy float32 oracle, not to
the JAX package, whose CPU float32 compares flush subnormals (ROADMAP C1).
"""
import contextlib
import functools
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

import conftest
from conftest import f32_exact
from repro.core import datasets as jdatasets
from repro.core import flat as jflat
from repro.core import mqrtree as jmqrtree
from repro.index import SpatialIndex as JaxIndex
from repro.index import join as jjoin
from repro.kernels import fallback as jfallback
from repro.kernels import join_scan as jjoin_scan
from repro_torch import SpatialIndex
from repro_torch.core import mqrtree as pmqrtree
from repro_torch.core.flat import ancestor_chains
from repro_torch.index import JoinResult
from repro_torch.index import join as pjoin
from repro_torch.kernels import join_scan, ops

STRUCTURES = ("mqr", "rtree", "pyramid")
# port engine -> (port backend, precision, JAX backend holding the reference)
ENGINES = {
    "cuda-float32": ("cuda", "float32", "host"),
    "cuda-compact": ("cuda", "compact", "pallas"),
    "host": ("host", "float32", "host"),
}
JOIN_STATS = ("joins", "queries", "node_accesses", "delta_accesses")


def _np(t):
    return t.cpu().numpy()


def _overlap_np(a, b):
    return ((a[..., 0] <= b[..., 2]) & (b[..., 0] <= a[..., 2])
            & (a[..., 1] <= b[..., 3]) & (b[..., 1] <= a[..., 3]))


def oracle_pairs(left, right) -> np.ndarray:
    """Brute-force float32 nested-loop join over two port indexes' live
    object sets."""

    def side(idx):
        log = idx._updates
        if log is None:
            t = np.asarray(idx.artifacts.mbrs, np.float32)
            return t, np.ones((t.shape[0],), bool)
        return log.mbr_table.astype(np.float32), log.alive

    ta, aa = side(left)
    tb, ab = side(right)
    return _overlap_np(ta[:, None, :], tb[None, :, :]) & aa[:, None] & ab[None, :]


@functools.lru_cache(maxsize=None)
def _data(tag: str, kind: str, n: int) -> np.ndarray:
    return f32_exact(conftest.mbr_dataset(f"test_torch_join/{tag}", kind, n))


def _pair(left_structure, right_structure, jax_backend, port_backend, precision):
    """The same two data sets as (JAX left, JAX right, port left, port right)."""
    da = _data("a", "uniform_squares", 150)
    db = _data("b", "exponential_squares", 120)
    jopts = {} if precision == "float32" else {"precision": precision}
    popts = {} if port_backend == "host" else {"precision": precision}
    return (JaxIndex.build(da, structure=left_structure, backend=jax_backend, **jopts),
            JaxIndex.build(db, structure=right_structure, backend="host"),
            SpatialIndex.build(da, structure=left_structure, backend=port_backend,
                               device="cpu", **popts),
            SpatialIndex.build(db, structure=right_structure, backend="host", device="cpu"))


def assert_same_join(got: JoinResult, want, what=""):
    assert isinstance(got, JoinResult)
    assert np.array_equal(_np(got.pairs), want.pairs), what
    assert got.pair_visits.dtype == torch.int64
    assert np.array_equal(_np(got.pair_visits), want.pair_visits), what
    assert got.base_levels == want.base_levels, what


# ---------------------------------------------------------------------------
# kernel level: the plain pair sweep against the Pallas kernel
# ---------------------------------------------------------------------------


def _sweep_inputs(tiles: str, symmetric: bool):
    """(a_cm, a_parent, b_cm, b_parent) numpy arrays of two JAX schedules
    (one, for the symmetric sweep) trimmed to K, on the joint uint16 grid
    for ``tiles="u16"``."""
    left = JaxIndex.build(_data("a", "uniform_squares", 90), structure="mqr", backend="host")
    right = left if symmetric else JaxIndex.build(
        _data("b", "exponential_squares", 70), structure="rtree", backend="host")
    sa, sb = jjoin._side_state(left), jjoin._side_state(right)
    k = min(sa.sched.levels, sb.sched.levels)
    a_cm, b_cm = sa.sched.mbr_cm[:k], sb.sched.mbr_cm[:k]
    if tiles == "u16":
        origin, inv_cell = jjoin._joint_grid(sa, sb)
        a_cm = jjoin._quantize_cm(a_cm, origin, inv_cell)
        b_cm = jjoin._quantize_cm(b_cm, origin, inv_cell)
    return a_cm, sa.sched.parent[:k], b_cm, sb.sched.parent[:k]


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.astype(np.int32)).to(torch.uint16)
    return torch.from_numpy(a)


def _ragged_inputs(tiles: str, symmetric: bool, widths):
    """(a_cm, a_parent, b_cm, b_parent) numpy arrays of two synthetic
    3-level schedules of widths (Wa, Wb), neither a multiple of 16: boxes
    that shrink with depth, some empty slots, random parents."""
    rng = np.random.default_rng(conftest.derived_seed(__name__, f"{tiles}{widths}"))

    def side(w):
        c = rng.random((3, 2, w))
        half = rng.random((3, 2, w)) * np.array([0.5, 0.25, 0.125])[:, None, None]
        cm = np.concatenate([c - half, c + half], axis=1).astype(np.float32)
        empty = np.broadcast_to((rng.random((3, w)) < 0.1)[:, None], (3, 2, w))
        cm[:, :2][empty], cm[:, 2:][empty] = np.inf, -np.inf
        if tiles == "u16":
            cm = np.rint(np.clip(np.nan_to_num(cm, posinf=1.0, neginf=0.0), 0, 1) * 65535)
            cm = cm.astype(np.uint16)
        return cm, rng.integers(0, w, (3, w), dtype=np.int32)

    a_cm, a_par = side(widths[0])
    b_cm, b_par = (a_cm, a_par) if symmetric else side(widths[1])
    return a_cm, a_par, b_cm, b_par


# (tiles, symmetric, block, widths): the two JAX schedules of _sweep_inputs
# (widths None) at two block sizes, and synthetic widths that are not
# multiples of 16 (the card's wide mask stores shift such rows).
PAIR_SWEEP_CASES = [(t, s, b, None) for t in ("f32", "u16") for s in (False, True)
                    for b in (32, 64)] + [
    ("f32", False, 32, (1, 129)), ("u16", False, 64, (129, 1)),
    ("f32", False, 64, (15, 17)), ("u16", False, 32, (17, 15)),
    ("u16", False, 32, (129, 17)), ("f32", True, 32, (17, 17)),
    ("u16", True, 64, (15, 15)), ("f32", True, 64, (129, 129))]


@pytest.mark.parametrize(
    "tiles, symmetric, block, widths", PAIR_SWEEP_CASES,
    ids=[f"{t}-{s}-{b}" + (f"-{w[0]}x{w[1]}" if w else "")
         for t, s, b, w in PAIR_SWEEP_CASES])
def test_pair_sweep_matches_pallas_kernel(tiles, symmetric, block, widths):
    """Every level of the port's mask equals the Pallas kernel's, at two
    of its block sizes (the mask cannot depend on the tile shape), and at
    widths that are not multiples of 16."""
    if widths is None:
        a_cm, a_par, b_cm, b_par = _sweep_inputs(tiles, symmetric)
    else:
        a_cm, a_par, b_cm, b_par = _ragged_inputs(tiles, symmetric, widths)
    want = np.asarray(jjoin_scan.pair_sweep(
        a_cm, a_par, b_cm, b_par, block_a=block, block_b=block, interpret=True,
        symmetric=symmetric))
    got = ops.pair_sweep(_t(a_cm), _t(a_par), _t(b_cm), _t(b_par), symmetric=symmetric)
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    for k in range(want.shape[0]):
        assert np.array_equal(_np(got[k]), want[k]), f"level {k}"
    assert want[1:].any()  # the recurrence is exercised below the root pair


def test_pair_sweep_argument_checks():
    a_cm, a_par, b_cm, b_par = (_t(a) for a in _sweep_inputs("f32", False))
    with pytest.raises(TypeError):
        ops.pair_sweep(a_cm, a_par, b_cm.to(torch.int32).to(torch.uint16), b_par)
    with pytest.raises(TypeError):
        ops.pair_sweep(a_cm, a_par.to(torch.int64), b_cm, b_par)
    with pytest.raises(ValueError):
        ops.pair_sweep(a_cm[1:], a_par[1:], b_cm, b_par)
    with pytest.raises(ValueError):
        ops.pair_sweep(a_cm, a_par, b_cm, b_par, symmetric=True)
    with pytest.raises(ValueError):
        ops.pair_sweep(a_cm.transpose(1, 2), a_par, b_cm, b_par)


@pytest.mark.parametrize("k_levels", ["1", "K", "L"])
@pytest.mark.parametrize("structure", STRUCTURES)
def test_ancestor_chains_match_reference(structure, k_levels):
    data = _data("a", "exponential_squares", 150)
    jsched = JaxIndex.build(data, structure=structure, backend="host").artifacts.schedule
    psched = SpatialIndex.build(data, structure=structure, device="cpu").schedule
    levels = jsched.levels
    k = {"1": 1, "K": max(1, levels - 2), "L": levels}[k_levels]
    want = jflat.ancestor_chains(jsched, k)
    got = ancestor_chains(psched, k)
    assert got.dtype == torch.int32
    assert np.array_equal(_np(got), want)


# ---------------------------------------------------------------------------
# the façade: structure × structure × engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("right_structure", STRUCTURES)
@pytest.mark.parametrize("left_structure", STRUCTURES)
def test_join_matches_reference(left_structure, right_structure, engine):
    port_backend, precision, jax_backend = ENGINES[engine]
    jl, jr, pl, pr = _pair(left_structure, right_structure, jax_backend, port_backend,
                           precision)
    got = pl.join(pr)
    assert_same_join(got, jl.join(jr), f"{left_structure}×{right_structure} {engine}")
    assert np.array_equal(_np(got.pairs), oracle_pairs(pl, pr))
    assert got.pairs.device == pl.device and got.n_pairs > 0


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("structure", STRUCTURES)
def test_self_join_matches_reference(structure, engine):
    """``idx.join(idx)`` takes the symmetric sweep (fewer pair tests than
    a full sweep over an equal twin, same pairs), as the reference."""
    port_backend, precision, jax_backend = ENGINES[engine]
    jl, _, pl, _ = _pair(structure, "mqr", jax_backend, port_backend, precision)
    fast = pl.join(pl)
    assert_same_join(fast, jl.join(jl), f"{structure} {engine}")
    twin = pl.with_backend(port_backend, **pl._backend_opts)
    full = pl.join(twin)  # another object: the full sweep
    assert torch.equal(fast.pairs, full.pairs)
    assert int(fast.sweep_visits.sum()) < int(full.sweep_visits.sum())
    assert torch.equal(fast.delta_tests, full.delta_tests)


def test_self_join_visits_do_not_depend_on_block_size():
    """The slot-granular triangle: the port's pairs and visits equal the
    Pallas kernel's at every block size."""
    data = _data("a", "uniform_squares", 150)
    port = SpatialIndex.build(data, device="cpu")
    got = port.join(port)
    for opts in ({"block_w": 32}, {"block_w": 64}, {}):
        ref = JaxIndex.build(data, backend="pallas", **opts)
        assert_same_join(got, ref.join(ref), str(opts))


def test_join_mixed_depths_and_transpose():
    da = _data("a", "exponential_squares", 300)   # deep mqr
    db = _data("b", "uniform_squares", 40)        # shallow pyramid
    jl = JaxIndex.build(da, backend="pallas")
    jr = JaxIndex.build(db, structure="pyramid", backend="host")
    pl = SpatialIndex.build(da, device="cpu")
    pr = SpatialIndex.build(db, structure="pyramid", backend="host", device="cpu")
    got = pl.join(pr)
    assert got.base_levels == min(pl.schedule.levels, pr.schedule.levels)
    assert_same_join(got, jl.join(jr))
    assert_same_join(pr.with_backend("cuda").join(pl),
                     jr.with_backend("pallas").join(jl), "transpose")


def test_join_epilogue_chunking_is_invisible(monkeypatch):
    """Row chunks of any size give the same pairs and visits, and a
    self-join's chunked mirrored lookup equals the JAX package's host rung
    (whole arrays, scatter-max) on the same arguments."""
    idx = SpatialIndex.build(_data("a", "uniform_squares", 150), device="cpu")
    other = SpatialIndex.build(_data("b", "uniform_squares", 110), structure="rtree",
                               device="cpu")
    for right in (idx, other):
        side_a, side_b = pjoin._side_state(idx, idx.device), pjoin._side_state(right,
                                                                               idx.device)
        k = min(side_a.sched.levels, side_b.sched.levels)
        args = (
            side_a.sched.mbr_cm[:k], side_a.sched.parent[:k],
            ancestor_chains(side_a.sched, k), side_a.sched.obj_level, side_a.entry_gid,
            side_b.sched.mbr_cm[:k], side_b.sched.parent[:k],
            ancestor_chains(side_b.sched, k), side_b.sched.obj_level, side_b.entry_gid,
            *(torch.from_numpy(a) for a in (side_a.table, side_b.table, side_a.alive,
                                             side_b.alive, side_a.delta, side_b.delta)),
        )
        sym = right is idx
        whole = ops.fused_join(*args, symmetric=sym)
        host_rung = jfallback.fused_join_np(*(_np(a) for a in args), symmetric=sym)
        for chunk in (1, 977, 50_000):
            monkeypatch.setattr(join_scan, "EPILOGUE_CHUNK_BYTES", chunk)
            got = ops.fused_join(*args, symmetric=sym)
            assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
        monkeypatch.undo()
        assert np.array_equal(_np(whole[0]), np.asarray(host_rung[0]))
        assert np.array_equal(_np(whole[1]), np.asarray(host_rung[1]))


@pytest.mark.parametrize("shape", [(0,), (1,), (254,), (255,), (256,), (3, 7, 511)])
def test_count_true_matches_sum(shape):
    mask = torch.from_numpy(np.random.default_rng(len(shape)).uniform(size=shape) < 0.6)
    got = join_scan.count_true(mask)
    assert got.dtype == torch.int64 and int(got) == int(mask.sum())
    assert int(join_scan.count_true(torch.ones(shape, dtype=torch.bool))) == mask.numel()


def test_compact_joint_grid_matches_reference():
    """The joint uint16 grid (float64 on the host) and the quantized level
    tiles equal the JAX package's, on live sides."""
    jl, jr, pl, pr = _pair("mqr", "rtree", "pallas", "cuda", "compact")
    extra = _data("c", "uniform_squares", 20)
    for j, p in ((jl, pl), (jr, pr)):
        j.insert(extra)
        p.insert(extra)
        j.delete(np.arange(5))
        p.delete(np.arange(5))
    ja, jb = jjoin._side_state(jl), jjoin._side_state(jr)
    pa, pb = pjoin._side_state(pl, pl.device), pjoin._side_state(pr, pl.device)
    want_grid = jjoin._joint_grid(ja, jb)
    got_grid = pjoin._joint_grid(pa, pb)
    for g, w in zip(got_grid, want_grid):
        assert np.array_equal(g, w)
    k = min(ja.sched.levels, jb.sched.levels)
    for js, ps in ((ja, pa), (jb, pb)):
        want = jjoin._quantize_cm(js.sched.mbr_cm[:k], *want_grid)
        got = pjoin._quantize_cm(ps.sched.mbr_cm[:k], *got_grid)
        assert got.dtype == torch.uint16
        assert np.array_equal(_np(got.to(torch.int32)), want.astype(np.int32))
    assert_same_join(pl.join(pr), jl.join(jr), "live compact")


# ---------------------------------------------------------------------------
# live sides
# ---------------------------------------------------------------------------


def _mutate(idx, ins_a, ins_b, right=None):
    ga = idx.insert(ins_a)
    idx.delete(np.arange(10))
    idx.delete(np.asarray(ga[:5]))
    if right is not None:
        gb = right.insert(ins_b)
        right.delete(np.asarray(gb[:3]))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_join_live_midbuffer_tombstones_and_flush(engine):
    port_backend, precision, jax_backend = ENGINES[engine]
    da = _data("a", "uniform_squares", 120)
    db = _data("b", "uniform_squares", 100)
    ins_a = f32_exact(jdatasets.uniform_squares(30, seed=5))
    ins_b = f32_exact(jdatasets.uniform_squares(25, seed=6))
    jopts = {} if precision == "float32" else {"precision": precision}
    popts = {} if port_backend == "host" else {"precision": precision}
    jl = JaxIndex.build(da, structure="pyramid", backend=jax_backend, capacity=64, **jopts)
    jr = JaxIndex.build(db, structure="mqr", backend="host", capacity=64)
    pl = SpatialIndex.build(da, structure="pyramid", backend=port_backend, device="cpu",
                            capacity=64, **popts)
    pr = SpatialIndex.build(db, structure="mqr", backend="host", device="cpu", capacity=64)
    _mutate(jl, ins_a, ins_b, jr)
    _mutate(pl, ins_a, ins_b, pr)

    got = pl.join(pr)
    assert_same_join(got, jl.join(jr), "mid-buffer")
    assert np.array_equal(_np(got.pairs), oracle_pairs(pl, pr))
    assert int(got.delta_tests.sum()) > 0
    assert not got.pairs[:10].any()  # tombstoned ids pair with nothing
    assert_same_join(pl.join(pl), jl.join(jl), "live self-join")

    for idx in (jl, jr, pl, pr):
        idx.flush()
    post = pl.join(pr)
    assert_same_join(post, jl.join(jr), "flushed")
    na, nb = got.pairs.shape
    assert torch.equal(post.pairs[:na, :nb], got.pairs)
    assert int(post.delta_tests.sum()) == 0


# ---------------------------------------------------------------------------
# API contract, stats, guards
# ---------------------------------------------------------------------------


def test_join_stats_ledger():
    """``joins``, ``queries``, ``node_accesses`` and ``delta_accesses``
    equal the reference's (``launches`` counts one per swept level here,
    ROADMAP C7)."""
    da = _data("a", "uniform_squares", 90)
    db = _data("b", "uniform_squares", 70)
    jl = JaxIndex.build(da, backend="pallas", capacity=16)
    jr = JaxIndex.build(db, backend="host")
    pl = SpatialIndex.build(da, device="cpu", capacity=16)
    pr = SpatialIndex.build(db, backend="host", device="cpu")
    first = pl.join(pr)
    assert_same_join(first, jl.join(jr))
    jl.insert(db[:4])
    pl.insert(db[:4])
    res = pl.join(pr)
    assert_same_join(res, jl.join(jr))
    assert int(res.delta_tests.sum()) > 0
    for name in JOIN_STATS:
        assert getattr(pl.stats, name) == getattr(jl.stats, name), name
    assert pl.stats.launches == 2 * res.base_levels
    assert res.n_pairs == len(res.pair_list())
    assert np.array_equal(_np(res.pair_list()), np.argwhere(_np(res.pairs)))
    assert np.array_equal(_np(res.sweep_visits), _np(res.pair_visits[:res.base_levels]))


def test_join_unknown_predicate_and_serve_raise():
    """An unknown predicate raises; the ``serve`` backend, once refused
    with NotImplementedError, now joins through its ladder and gives the
    ``cuda`` backend's pairs.  The test keeps the name it had then."""
    idx = SpatialIndex.build(_data("a", "uniform_squares", 40), device="cpu")
    with pytest.raises(ValueError, match="predicate"):
        idx.join(idx, predicate="within")
    assert pjoin.PREDICATES == jjoin.PREDICATES
    served = SpatialIndex.build(_data("a", "uniform_squares", 40), backend="serve", device="cpu")
    other = SpatialIndex.build(_data("b", "uniform_squares", 30), device="cpu")
    assert torch.equal(served.join(other).pairs, idx.join(other).pairs)
    assert served.stats.rung_dispatches == {"cuda": 1}


def test_size_guard_raises_before_allocating():
    """A mask (or an epilogue) larger than free memory fails loudly with
    its size, before anything of that size is allocated."""
    wide = 1 << 20
    cm = torch.zeros((1, 4, wide), dtype=torch.float32)
    parent = torch.zeros((1, wide), dtype=torch.int32)
    with pytest.raises(ValueError, match="pair mask needs 1,099,511,627,776 bytes"):
        ops.pair_sweep(cm, parent, cm, parent)
    small = torch.zeros((1, 4, 2), dtype=torch.float32)
    sp = torch.zeros((1, 2), dtype=torch.int32)
    anc = torch.zeros((2, 1), dtype=torch.int32)
    lvl = torch.zeros((2,), dtype=torch.int32)
    gid = torch.arange(2, dtype=torch.int32)
    table = torch.zeros((wide, 4), dtype=torch.float32)
    flags = torch.zeros((wide,), dtype=torch.bool)
    with pytest.raises(ValueError, match="epilogue needs"):
        ops.fused_join(small, sp, anc, lvl, gid, small, sp, anc, lvl, gid,
                       table, table, flags, flags, flags, flags)


def test_epilogue_rejects_repeated_gids():
    side = SpatialIndex.build(_data("a", "uniform_squares", 40), structure="pyramid",
                              device="cpu")
    s = side.schedule
    k = s.levels
    act = ops.pair_sweep(s.mbr_cm, s.parent, s.mbr_cm, s.parent)
    table = s.obj_mbr
    flags = torch.zeros((table.shape[0],), dtype=torch.bool)
    gid = s.obj_id.clone()
    gid[1] = gid[0]
    with pytest.raises(ValueError, match="repeats a global id"):
        ops.join_epilogue(act, ancestor_chains(s, k), s.obj_level, gid,
                          ancestor_chains(s, k), s.obj_level, s.obj_id,
                          table, table, ~flags, ~flags, flags, flags)


# ---------------------------------------------------------------------------
# adversarial geometry, against the numpy float32 oracle (not JAX, C1)
# ---------------------------------------------------------------------------


def _all_engines(data, structure="mqr"):
    idx = SpatialIndex.build(data, structure=structure, device="cpu")
    return [idx, idx.with_backend("cuda", precision="compact"), idx.with_backend("host")]


def _check_oracle(left, right):
    res = left.join(right)
    assert np.array_equal(_np(res.pairs), oracle_pairs(left, right))
    return res


def test_join_cocentred_stacks():
    rng = np.random.default_rng(conftest.derived_seed("test_torch_join", "cocentred"))
    centres = rng.uniform(100, 900, size=(6, 2))
    sides = np.arange(1, 9, dtype=np.float64)[:, None]
    da = f32_exact(np.concatenate([np.concatenate([c - sides, c + sides], axis=1)
                                   for c in centres]))
    db = f32_exact(np.concatenate([np.concatenate([c - 2 * sides, c + 2 * sides], axis=1)
                                   for c in centres + rng.uniform(-30, 30, centres.shape)]))
    right = SpatialIndex.build(db, backend="host", device="cpu")
    for left in _all_engines(da):
        _check_oracle(left, right)
        _check_oracle(left, left)


def test_join_degenerate_zero_area():
    pts = f32_exact(np.array([[10.0, 10, 10, 10], [20, 5, 20, 25],
                              [5, 20, 25, 20], [30, 30, 30, 30]]))
    boxes = f32_exact(np.array([[0.0, 0, 10, 10], [15, 0, 20, 30], [26, 26, 29, 29]]))
    right = SpatialIndex.build(boxes, structure="rtree", backend="host", device="cpu")
    for left in _all_engines(pts):
        res = _check_oracle(left, right)
        assert res.pairs[0, 0] and res.pairs[1, 1] and not res.pairs[:, 2].any()


def test_join_grid_aligned_boundaries():
    xs, ys = np.meshgrid(np.arange(4) * 10.0, np.arange(4) * 10.0)
    ll = np.stack([xs.ravel(), ys.ravel()], axis=1)
    da = f32_exact(np.concatenate([ll, ll + 10.0], axis=1))
    db = f32_exact(np.concatenate([ll + 10.0, ll + 20.0], axis=1))
    right = SpatialIndex.build(db, backend="host", device="cpu")
    for left in _all_engines(da):
        _check_oracle(left, right)


def test_self_join_points_is_identity():
    """The paper's zero-overlap claim (§4): distinct points overlap only
    themselves, so a self-join is exactly the identity."""
    pts = f32_exact(conftest.mbr_dataset("test_torch_join", "uniform_points", 150))
    assert np.unique(pts, axis=0).shape[0] == pts.shape[0]
    for idx in _all_engines(pts)[:2]:
        assert np.array_equal(_np(idx.join(idx).pairs), np.eye(150, dtype=bool))


_coord = st.floats(min_value=-1e6, max_value=1e6, allow_nan=False, allow_infinity=False,
                   width=32)
_rect = st.tuples(_coord, _coord, _coord, _coord).map(
    lambda t: (min(t[0], t[2]), min(t[1], t[3]), max(t[0], t[2]), max(t[1], t[3])))
_SUBNORMAL = (0.0, -1.0, 0.0, -1.4e-45)


# Two copies of one box and a third box make the mqr-tree insertion cycle
# until its safety valve, in the JAX package and in the port (ROADMAP C9).
_CYCLES = [(0.0, -4.0, 6.0, 1.0)] * 2 + [(0.0, -1.0, 1.0, 0.0)]


@contextlib.contextmanager
def _safety_valve(ops: int):
    """Lower the mqr-tree insertion's safety valve in the port and in the
    JAX package alike.  A 16-object build that converges takes at most a
    few hundred insertion steps; one that cycles spins through the default
    1e6 (about 50 s) before it gives up."""
    with mock.patch.object(pmqrtree, "_MAX_REINSERT_OPS", ops), \
            mock.patch.object(jmqrtree, "_MAX_REINSERT_OPS", ops):
        yield


def _build_as_reference(data, structure, **opts):
    """The port's index over ``data``, or None where the mqr-tree
    insertion gives up; the JAX package's build must then give up too."""
    try:
        return SpatialIndex.build(data, structure=structure, device="cpu", **opts)
    except RuntimeError as err:
        assert structure == "mqr" and "did not converge" in str(err)
        with pytest.raises(RuntimeError, match="did not converge"):
            JaxIndex.build(data, structure=structure, backend="host")
        return None


@settings(max_examples=20, deadline=None)
@given(rects_a=st.lists(_rect, min_size=16, max_size=16),
       rects_b=st.lists(_rect, min_size=12, max_size=12),
       structure=st.sampled_from(["mqr", "rtree", "pyramid"]))
@example(rects_a=[_SUBNORMAL] + [(0.0, 0.0, 0.0, 0.0)] * 15,
         rects_b=[(0.0, 0.0, 0.0, 0.0), _SUBNORMAL] * 6, structure="mqr")
@example(rects_a=_CYCLES, rects_b=[(0.0, 0.0, 1.0, 1.0)] * 12, structure="mqr")
def test_join_matches_oracle_on_adversarial_geometry(rects_a, rects_b, structure):
    """Arbitrary finite geometry (huge magnitudes, subnormals, degenerate
    and co-located boxes): the join equals the float32 overlap on the
    exact and compact paths and on the host engine.  Where the mqr-tree
    build gives up on an input, the JAX package's gives up on it too."""
    da, db = np.asarray(rects_a, np.float64), np.asarray(rects_b, np.float64)
    want = _overlap_np(da.astype(np.float32)[:, None, :], db.astype(np.float32)[None, :, :])
    with _safety_valve(10_000):
        right = _build_as_reference(db, structure, backend="host")
        left = _build_as_reference(da, structure)
    if left is None or right is None:
        assert structure == "mqr"
        return
    for engine in (left, left.with_backend("cuda", precision="compact"),
                   left.with_backend("host")):
        assert np.array_equal(_np(engine.join(right).pairs), want)
