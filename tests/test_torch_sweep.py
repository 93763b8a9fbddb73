"""Port parity: the fused level sweep and region scans of ``repro_torch``.

``level_sweep`` on CPU tensors runs ``level_sweep_torch`` — the plain
version the CUDA kernel is held against on the card — and must give the
JAX ``level_sweep`` mask (interpret mode) on pyramid schedules and on mqr
tree schedules carried across with ``repro_torch.convert`` (root visited
unconditionally, object MBRs tested), for float32 and uint16 tiles, and
with flat levels (``uncond_from`` < L).  ``pyramid_scan`` and
``pyramid_scan_compact`` must give the JAX hits and per-level visits.

Tolerance: exact.  Masks are booleans of float32 or integer compares on the
same inputs; visits are integer sums.

One deliberate difference: on a query with a subnormal coordinate the port
follows exact IEEE compares, like the numpy brute force; the JAX float32
path on the CPU answers such a query differently (it most likely flushes
subnormals to zero), so that case is held against numpy only.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import conftest
from repro.core import bulk as jbulk
from repro.core import flat as jflat
from repro.core import mqrtree
from repro.kernels import pyramid_scan as jscan
from repro.kernels import quantize as jquant
from repro_torch import SpatialIndex, convert
from repro_torch.kernels import ops
from repro_torch.kernels.pyramid_scan import _hits_epilogue, _quantize_queries

N = {"pyramid": 600, "mqr": 200}


def _np(t):
    t = t.cpu()
    return (t.to(torch.int32) if t.dtype == torch.uint16 else t).numpy()


def _jax_schedule(structure, kind):
    data = conftest.mbr_dataset(__name__, kind, N[structure])
    if structure == "mqr":
        return jflat.level_schedule(jflat.flatten(mqrtree.build(data)))
    d32 = np.asarray(data, np.float32)
    pyr = jbulk.build_pyramid(jnp.asarray(d32), levels=jbulk.default_levels(len(d32)))
    return jflat.pyramid_schedule(pyr, d32)


def _queries(kind, structure):
    return conftest.dataset_queries(__name__, kind, N[structure], 6)


def _carry(js):
    return convert.schedule_from_numpy(dataclasses.asdict(js), device="cpu")


@pytest.mark.parametrize("uncond", [None, "last"])
@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("structure", ["pyramid", "mqr"])
def test_level_sweep_f32_matches_jax(structure, kind, uncond):
    js = _jax_schedule(structure, kind)
    qs = _queries(kind, structure)
    uncond_from = None if uncond is None else js.levels - 1
    want = np.asarray(jscan.level_sweep(
        jnp.asarray(qs), jnp.asarray(js.mbr_cm), jnp.asarray(js.parent),
        root_unconditional=js.root_unconditional, interpret=True,
        uncond_from=uncond_from))
    s = _carry(js)
    got = ops.level_sweep(torch.from_numpy(qs), s.mbr_cm, s.parent,
                          root_unconditional=s.root_unconditional,
                          uncond_from=uncond_from)
    assert got.dtype == torch.bool
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("uncond", [None, 1])
@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("structure", ["pyramid", "mqr"])
def test_level_sweep_u16_matches_jax(structure, kind, uncond):
    js = _jax_schedule(structure, kind)
    jq = jquant.quantize_schedule(js, engine="jnp")
    qs = _queries(kind, structure)
    jqq = jscan._quantize_queries(jnp.asarray(qs), jnp.asarray(jq.origin),
                                  jnp.asarray(jq.inv_cell), jq.cells)
    want = np.asarray(jscan.level_sweep(
        jqq, jnp.asarray(jq.mbr_q), jnp.asarray(jq.parent_q),
        root_unconditional=js.root_unconditional, interpret=True,
        uncond_from=uncond))
    q = convert.quantized_from_numpy(dataclasses.asdict(jq), device="cpu")
    qq = _quantize_queries(torch.from_numpy(qs), q.origin, q.inv_cell, q.cells)
    assert np.array_equal(_np(qq), np.asarray(jqq))
    assert q.parent_q.dtype == torch.uint16
    got = ops.level_sweep(qq, q.mbr_q, q.parent_q,
                          root_unconditional=js.root_unconditional,
                          uncond_from=uncond)
    assert np.array_equal(_np(got), want)
    # int32 parents give the same mask (the layout of widths > 65535)
    got32 = ops.level_sweep(qq, q.mbr_q, q.parent_q.to(torch.int32),
                            root_unconditional=js.root_unconditional,
                            uncond_from=uncond)
    assert torch.equal(got32, got)


@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("structure", ["pyramid", "mqr"])
def test_pyramid_scan_matches_jax(structure, kind):
    js = _jax_schedule(structure, kind)
    qs = _queries(kind, structure)
    s = _carry(js)
    want_h, want_v = jscan.pyramid_scan(js, qs, interpret=True)
    for engine in ("kernel", "torch"):
        hits, visits = ops.pyramid_scan(s, torch.from_numpy(qs), engine=engine)
        assert np.array_equal(_np(hits), np.asarray(want_h))
        assert np.array_equal(_np(visits), np.asarray(want_v))
        assert visits.dtype == torch.int32


@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("structure", ["pyramid", "mqr"])
def test_pyramid_scan_compact_matches_jax(structure, kind):
    js = _jax_schedule(structure, kind)
    jq = jquant.quantize_schedule(js, engine="jnp")
    qs = _queries(kind, structure)
    want_h, want_v = jscan.pyramid_scan_compact(jq, qs, interpret=True)
    carried = convert.quantized_from_numpy(dataclasses.asdict(jq), device="cpu")
    requantized = ops.quantize_schedule(_carry(js))
    for q in (carried, requantized):
        hits, visits = ops.pyramid_scan_compact(q, torch.from_numpy(qs))
        assert np.array_equal(_np(hits), np.asarray(want_h))
        assert np.array_equal(_np(visits), np.asarray(want_v))


def test_hits_epilogue_ors_repeated_ids():
    """Tree schedules may repeat object ids: an id hits when ANY of its
    entries does (the numpy oracle's maximum.at), whatever the order."""
    rng = np.random.default_rng(0)
    act = rng.random((3, 4, 5)) < 0.5
    obj_level = np.array([0, 1, 2, 2, 1, 0], np.int32)
    obj_slot = np.array([0, 1, 4, 3, 1, 2], np.int32)
    obj_id = np.array([2, 0, 2, 1, 2, 0], np.int32)
    want = np.zeros((4, 3), bool)
    np.maximum.at(want, (slice(None), obj_id), act[obj_level, :, obj_slot].T)
    hits, visits = _hits_epilogue(
        torch.from_numpy(act), torch.zeros((4, 4)), None, torch.from_numpy(obj_level),
        torch.from_numpy(obj_slot), torch.from_numpy(obj_id), 3)
    assert np.array_equal(_np(hits), want)
    assert np.array_equal(_np(visits), act.sum(axis=2).T)


def _brute(rects, queries):
    r, q = rects[None, :, :], queries[:, None, :]
    return ((r[..., 0] <= q[..., 2]) & (q[..., 0] <= r[..., 2])
            & (r[..., 1] <= q[..., 3]) & (q[..., 1] <= r[..., 3]))


@pytest.mark.parametrize("precision", ["float32", "compact"])
@pytest.mark.parametrize("build", ["host", "device"])
def test_subnormal_query_matches_numpy_oracle(build, precision):
    """Hypothesis' falsifying example for the JAX float32 path: rectangles
    (0, 0, 0, 0) and the query (0, -1, 0, -1.4e-45).  ``0 <= -1.4e-45`` is
    false, so nothing overlaps; the JAX float32 path on the CPU reports a
    hit here (subnormals flushed), the port follows the exact compare."""
    rects = np.zeros((3, 4), np.float32)
    qs = np.array([[0.0, -1.0, 0.0, -1.4e-45], [0.0, 0.0, 0.0, 0.0]], np.float32)
    assert qs[0, 3] != 0.0  # a real subnormal, not flushed by numpy
    want = _brute(rects, qs)
    assert not want[0].any() and want[1].all()
    idx = SpatialIndex.build(rects, structure="pyramid", build=build, precision=precision,
                             device="cpu")
    got = idx.region(qs)
    assert np.array_equal(_np(got.hits), want)
    # the sweep on its own agrees too
    act = ops.level_sweep(torch.from_numpy(qs), idx.schedule.mbr_cm, idx.schedule.parent,
                          root_unconditional=False)
    assert not act[-1, 0].any()


def test_level_sweep_rejects_mismatched_types():
    s = ops.device_schedule(np.array([[0, 0, 1, 1]], np.float32), device="cpu")
    q = torch.zeros((2, 4))
    with pytest.raises(TypeError):
        ops.level_sweep(q.to(torch.int32), s.mbr_cm, s.parent)
    with pytest.raises(TypeError):
        ops.level_sweep(q, s.mbr_cm, s.parent.to(torch.int64))
    with pytest.raises(ValueError):
        ops.level_sweep(q, s.mbr_cm, s.parent, block_w=100)
    with pytest.raises(ValueError):
        ops.level_sweep(q[:, :3].contiguous(), s.mbr_cm, s.parent)
