"""Port parity: the compact8 sweep, the one-level scan and the per-level plan.

* ``quantize_schedule(upper8=True)`` of ``repro_torch`` gives the JAX
  ``QuantizedSchedule`` fields, the uint8 upper tiles included.
* ``level_sweep_hier`` on CPU tensors runs ``level_sweep_hier_torch`` — the
  plain version the CUDA kernel is held against on the card — and must give
  the JAX ``level_sweep_hier`` mask (interpret mode) on compact8 schedules
  carried across with ``repro_torch.convert``, with and without flat levels
  (``uncond_from``), with uint16 and int32 parents.
* the JAX hierarchical mask is zero at and past each level's ``n_real``,
  the rule by which the CUDA kernel skips padding tiles;
* ``pyramid_scan_compact8`` gives the JAX hits and per-level visits,
  including the ``split == 0`` case that sweeps as plain compact.
* ``mbr_scan`` (plain version ``mbr_scan_torch``) gives the JAX ``mbr_scan``
  mask (interpret mode), sentinel rows included.
* ``per_level_region_search`` gives the JAX hits, visits and launch count.

Tolerance: exact everywhere.  Masks are booleans of float32 or integer
compares on the same inputs, the grids are the same float32 arithmetic,
visits are integer sums.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import conftest
from repro.core import bulk as jbulk
from repro.core import flat as jflat
from repro.core import mqrtree as jmqr
from repro.core import rtree as jrtree
from repro.kernels import mbr_scan as jmbr
from repro.kernels import pyramid_scan as jscan
from repro.kernels import quantize as jquant
from repro_torch import convert
from repro_torch.core.flat import NEVER_MBR
from repro_torch.kernels import ops
from repro_torch.kernels.pyramid_scan import _quantize_queries

N = {"pyramid": 600, "mqr": 300, "rtree": 300}
STRUCTURES = ("pyramid", "mqr", "rtree")


def _np(t):
    t = t.cpu()
    return (t.to(torch.int32) if t.dtype == torch.uint16 else t).numpy()


def _data(structure, kind):
    return conftest.mbr_dataset(__name__, kind, N[structure])


def _queries(structure, kind):
    return conftest.dataset_queries(__name__, kind, N[structure], 10)


_SCHEDULES = {}


def _jax_schedule(structure, kind):
    key = (structure, kind)
    if key not in _SCHEDULES:
        data = _data(structure, kind)
        if structure == "mqr":
            s = jflat.level_schedule(jflat.flatten(jmqr.build(data)))
        elif structure == "rtree":
            s = jflat.level_schedule(jflat.flatten(jrtree.build(data)))
        else:
            d32 = np.asarray(data, np.float32)
            pyr = jbulk.build_pyramid(jnp.asarray(d32), levels=jbulk.default_levels(len(d32)))
            s = jflat.pyramid_schedule(pyr, d32)
        _SCHEDULES[key] = s
    return _SCHEDULES[key]


def _carry(js):
    return convert.schedule_from_numpy(dataclasses.asdict(js), device="cpu")


def _carry_q(jq):
    return convert.quantized_from_numpy(dataclasses.asdict(jq), device="cpu")


@pytest.mark.parametrize("split", [None, 1])
@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_quantize_schedule_upper8_matches_jax(structure, kind, split):
    js = _jax_schedule(structure, kind)
    jq = jquant.quantize_schedule(js, engine="jnp", upper8=True, split=split)
    for q in (ops.quantize_schedule(_carry(js), upper8=True, split=split), _carry_q(jq)):
        assert q.hierarchical and q.split == jq.split
        assert q.mbr_q8.dtype == torch.uint8
        for f in ("mbr_q8", "mbr_q", "parent_q", "origin", "inv_cell", "inv_cell8",
                  "confirm_mbr"):
            want = np.asarray(getattr(jq, f))
            got = _np(getattr(q, f))
            assert got.shape == want.shape and np.array_equal(got, want), f
        assert (q.cells, q.cells8) == (jq.cells, jq.cells8)
        assert q.streamed_bytes == jq.streamed_bytes


def _assert_upper8_matches(q, jq):
    assert q.split == jq.split and (q.mbr_q8 is None) == (jq.mbr_q8 is None)
    for f in ("mbr_q8", "mbr_q", "inv_cell8"):
        want = getattr(jq, f)
        if want is not None:
            want, got = np.asarray(want), _np(getattr(q, f))
            assert got.shape == want.shape and np.array_equal(got, want), f
    assert q.streamed_bytes == jq.streamed_bytes


@pytest.mark.parametrize("split", ["L-1", "L"])
@pytest.mark.parametrize("structure", STRUCTURES)
def test_quantize_schedule_upper8_matches_jax_at_deep_splits(structure, split):
    """The uint8 tiles come from the same launch as the uint16 ones on the
    card; on the CPU both engines still give JAX's ``mbr_q8`` and ``mbr_q``
    at split L - 1 and L (every level coarse)."""
    js = _jax_schedule(structure, "uniform_squares")
    k = js.levels - 1 if split == "L-1" else js.levels
    jq = jquant.quantize_schedule(js, engine="jnp", upper8=True, split=k)
    for engine in ("kernel", "torch"):
        q = ops.quantize_schedule(_carry(js), engine=engine, upper8=True, split=k)
        assert q.mbr_q8.dtype == torch.uint8 and q.mbr_q8.shape[0] == k
        _assert_upper8_matches(q, jq)


@pytest.mark.parametrize("split", [None, 1])
def test_quantize_schedule_upper8_matches_jax_at_one_level(split):
    """L = 1: split 0 by default (no coarse tiles), or 1 = L when asked."""
    data = np.asarray(_data("pyramid", "uniform_squares")[:50], np.float32)
    js = jflat.pyramid_schedule(jbulk.build_pyramid(jnp.asarray(data), levels=1), data)
    jq = jquant.quantize_schedule(js, engine="jnp", upper8=True, split=split)
    for engine in ("kernel", "torch"):
        _assert_upper8_matches(
            ops.quantize_schedule(_carry(js), engine=engine, upper8=True, split=split), jq)


def test_quantize_schedule_without_upper8_has_no_coarse_tiles():
    js = _jax_schedule("mqr", "uniform_squares")
    q = ops.quantize_schedule(_carry(js), split=2)
    jq = jquant.quantize_schedule(js, engine="jnp", split=2)
    assert (q.split, q.mbr_q8, q.hierarchical) == (jq.split, None, False)
    assert q.streamed_bytes == jq.streamed_bytes


@pytest.mark.parametrize("parent32", [False, True], ids=["u16-parent", "i32-parent"])
@pytest.mark.parametrize("uncond", [None, "last"])
@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_level_sweep_hier_matches_jax(structure, kind, uncond, parent32):
    js = _jax_schedule(structure, kind)
    jq = jquant.quantize_schedule(js, engine="jnp", upper8=True)
    qs_np = _queries(structure, kind)
    qs = jnp.asarray(qs_np)
    jq8 = jscan._quantize_queries(qs, jnp.asarray(jq.origin), jnp.asarray(jq.inv_cell8),
                                  jq.cells8)
    jq16 = jscan._quantize_queries(qs, jnp.asarray(jq.origin), jnp.asarray(jq.inv_cell),
                                   jq.cells)
    uncond_from = None if uncond is None else js.levels - 1
    want = np.asarray(jscan.level_sweep_hier(
        jq8, jq16, jnp.asarray(jq.mbr_q8), jnp.asarray(jq.mbr_q[jq.split:]),
        jnp.asarray(jq.parent_q), split=jq.split,
        root_unconditional=js.root_unconditional, interpret=True,
        uncond_from=uncond_from))
    q = _carry_q(jq)
    tq = torch.from_numpy(qs_np)
    q8 = _quantize_queries(tq, q.origin, q.inv_cell8, q.cells8)
    q16 = _quantize_queries(tq, q.origin, q.inv_cell, q.cells)
    assert np.array_equal(_np(q8), np.asarray(jq8))
    assert np.array_equal(_np(q16), np.asarray(jq16))
    parent = q.parent_q.to(torch.int32) if parent32 else q.parent_q
    got = ops.level_sweep_hier(q8, q16, q.mbr_q8, q.mbr_q[q.split:], parent,
                               split=q.split, root_unconditional=js.root_unconditional,
                               uncond_from=uncond_from)
    assert got.dtype == torch.bool
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("uncond", [None, "last"])
@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_level_sweep_hier_is_zero_past_n_real(structure, kind, uncond):
    """The rule kernel #3 skips tiles by: in the JAX hierarchical mask
    (interpret mode), every slot at or past a level's ``n_real`` is zero,
    for region queries and for queries over the whole domain (which every
    real node overlaps), so a tile past ``n_real`` may store zeros unread."""
    js = _jax_schedule(structure, kind)
    jq = jquant.quantize_schedule(js, engine="jnp", upper8=True)
    qs = _queries(structure, kind).copy()
    data = np.asarray(_data(structure, kind), np.float32)
    qs[::3] = np.concatenate([data[:, :2].min(axis=0) - 1.0, data[:, 2:].max(axis=0) + 1.0])
    qs = jnp.asarray(qs)
    q8 = jscan._quantize_queries(qs, jnp.asarray(jq.origin), jnp.asarray(jq.inv_cell8),
                                 jq.cells8)
    q16 = jscan._quantize_queries(qs, jnp.asarray(jq.origin), jnp.asarray(jq.inv_cell),
                                  jq.cells)
    mask = np.asarray(jscan.level_sweep_hier(
        q8, q16, jnp.asarray(jq.mbr_q8), jnp.asarray(jq.mbr_q[jq.split:]),
        jnp.asarray(jq.parent_q), split=jq.split, root_unconditional=js.root_unconditional,
        interpret=True, uncond_from=None if uncond is None else js.levels - 1))
    n_real = np.asarray(js.n_real)
    assert n_real.shape == (js.levels,) and (n_real <= js.width).all()
    for l in range(js.levels):
        assert not mask[l, :, n_real[l]:].any(), l
    assert mask.any()  # the whole-domain queries reach real nodes


@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_pyramid_scan_compact8_matches_jax(structure, kind):
    js = _jax_schedule(structure, kind)
    jq = jquant.quantize_schedule(js, engine="jnp", upper8=True)
    qs = _queries(structure, kind)
    want_h, want_v = jscan.pyramid_scan_compact8(jq, qs, interpret=True)
    f32_h, f32_v = jscan.pyramid_scan(js, qs, interpret=True)
    for q in (_carry_q(jq), ops.quantize_schedule(_carry(js), upper8=True)):
        for engine in ("kernel", "torch"):
            hits, visits = ops.pyramid_scan_compact8(q, torch.from_numpy(qs), engine=engine)
            assert np.array_equal(_np(hits), np.asarray(want_h))
            assert np.array_equal(_np(visits), np.asarray(want_v))
            assert np.array_equal(_np(hits), np.asarray(f32_h))
    # the coarse grid admits at least the float32 sweep's nodes
    assert (np.asarray(want_v) >= np.asarray(f32_v)).all()


def test_compact8_single_level_sweeps_as_compact():
    """A one-level schedule has split == 0: compact8 falls back to the
    plain compact sweep, as the reference does."""
    data = np.asarray(_data("pyramid", "uniform_squares")[:50], np.float32)
    js = jflat.pyramid_schedule(jbulk.build_pyramid(jnp.asarray(data), levels=1), data)
    jq = jquant.quantize_schedule(js, engine="jnp", upper8=True)
    assert jq.split == 0 and not jq.hierarchical
    qs = _queries("pyramid", "uniform_squares")
    want_h, want_v = jscan.pyramid_scan_compact8(jq, qs, interpret=True)
    q = ops.quantize_schedule(_carry(js), upper8=True)
    assert q.split == 0 and q.mbr_q8 is None
    hits, visits = ops.pyramid_scan_compact8(q, torch.from_numpy(qs))
    assert np.array_equal(_np(hits), np.asarray(want_h))
    assert np.array_equal(_np(visits), np.asarray(want_v))


def test_compact8_needs_the_hierarchical_form():
    q = ops.quantize_schedule(_carry(_jax_schedule("mqr", "uniform_squares")))
    with pytest.raises(ValueError):
        ops.pyramid_scan_compact8(q, torch.zeros((2, 4)))


def test_level_sweep_hier_rejects_bad_args():
    q = ops.quantize_schedule(_carry(_jax_schedule("mqr", "uniform_squares")), upper8=True)
    qq = torch.zeros((3, 4), dtype=torch.int32)
    args = (qq, qq, q.mbr_q8, q.mbr_q[q.split:], q.parent_q)
    with pytest.raises(ValueError):
        ops.level_sweep_hier(*args, split=q.split + 1)
    with pytest.raises(ValueError):
        ops.level_sweep_hier(*args, split=q.split, block_w=100)
    with pytest.raises(TypeError):
        ops.level_sweep_hier(qq.float(), qq, *args[2:], split=q.split)
    with pytest.raises(TypeError):
        ops.level_sweep_hier(qq, qq, q.mbr_q8.to(torch.int32), *args[3:], split=q.split)
    with pytest.raises(TypeError):
        ops.level_sweep_hier(*args[:4], q.parent_q.to(torch.int64), split=q.split)


# (kind, N, Q): each dataset at the pyramid's size with 10 queries, and
# the card's edge widths and query counts (not multiples of 16) on uniform
# squares, with NaN rows and whole-domain queries.
MBR_SCAN_CASES = ([(kind, None, None) for kind in conftest.DATASET_KINDS]
                  + [("uniform_squares", n, nq) for n in (1, 15, 17, 129) for nq in (1, 9, 17)])
MBR_SCAN_IDS = [kind if n is None else f"{kind}-N{n}-Q{nq}" for kind, n, nq in MBR_SCAN_CASES]


@pytest.mark.parametrize("kind,n,nq", MBR_SCAN_CASES, ids=MBR_SCAN_IDS)
def test_mbr_scan_matches_jax(kind, n, nq):
    if n is None:
        mbrs = np.asarray(_data("pyramid", kind), np.float32).copy()
        qs = _queries("pyramid", kind)
        mbrs[::7] = NEVER_MBR  # sentinel rows never overlap
    else:
        mbrs = np.asarray(conftest.mbr_dataset(__name__, kind, n), np.float32).copy()
        qs = conftest.dataset_queries(__name__, kind, n, nq).copy()
        qs[::5] = np.concatenate([mbrs[:, :2].min(axis=0) - 1.0,
                                  mbrs[:, 2:].max(axis=0) + 1.0])
        mbrs[6::7] = NEVER_MBR
        mbrs[5::11, 1] = np.nan  # a NaN coordinate never passes its compare
    want = np.asarray(jmbr.mbr_scan(jnp.asarray(mbrs), jnp.asarray(qs), interpret=True))
    tm, tq = torch.from_numpy(mbrs), torch.from_numpy(qs)
    for got in (ops.mbr_scan(tm, tq), ops.mbr_scan_torch(tm, tq),
                ops.mbr_scan_cm(tm.T.contiguous(), tq)):
        assert got.dtype == torch.bool
        assert np.array_equal(_np(got), want)


def test_mbr_scan_rejects_bad_args():
    m = torch.zeros((5, 4))
    with pytest.raises(TypeError):
        ops.mbr_scan(m.double(), torch.zeros((2, 4)))
    with pytest.raises(ValueError):
        ops.mbr_scan(m[:, :3].contiguous(), torch.zeros((2, 4)))
    with pytest.raises(ValueError):
        ops.mbr_scan_cm(m, torch.zeros((2, 4)))


@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_per_level_region_search_matches_jax(structure, kind):
    js = _jax_schedule(structure, kind)
    qs = _queries(structure, kind)
    want_h, want_v, want_n = jscan.per_level_region_search(js, qs, interpret=True)
    fused_h, fused_v = jscan.pyramid_scan(js, qs, interpret=True)
    s = _carry(js)
    for engine in ("kernel", "torch"):
        hits, visits, n = ops.per_level_region_search(s, torch.from_numpy(qs),
                                                      engine=engine)
        assert np.array_equal(_np(hits), want_h)
        assert np.array_equal(_np(visits), want_v)
        assert n == want_n == js.levels
        assert np.array_equal(_np(hits), np.asarray(fused_h))
        assert np.array_equal(_np(visits), np.asarray(fused_v))
