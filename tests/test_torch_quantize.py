"""Port parity: the uint16 tile quantizer of ``repro_torch`` == the JAX one.

``quantize_cm`` on a CPU tensor runs ``quantize_cm_torch`` — the plain
version the CUDA kernel is held against on the card — and must equal the
JAX ``quantize_cm_jnp`` and its Pallas kernel ``quantize_cm_pallas``
(interpret mode), sentinel slots included.  ``quantize_schedule`` must
produce the JAX ``QuantizedSchedule`` fields.

Tolerance: exact.  The grid is float32 subtract, multiply, floor/ceil and
clip on the same IEEE inputs, then an integer cast: both sides round the
same way at every step.
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
from repro.kernels import quantize as jquant
from repro_torch import convert
from repro_torch.core.flat import CELLS, Q_NEVER_MBR
from repro_torch.kernels import ops, quantize


def _np(t):
    t = t.cpu()
    return (t.to(torch.int32) if t.dtype == torch.uint16 else t).numpy()


def _jax_pyramid(kind, n):
    data = np.asarray(conftest.mbr_dataset(__name__, kind, n), np.float32)
    pyr = jbulk.build_pyramid(jnp.asarray(data), levels=jbulk.default_levels(n))
    return jflat.pyramid_schedule(pyr, data)


def _jax_mqr(kind, n):
    data = conftest.mbr_dataset(__name__, kind, n)
    return jflat.level_schedule(jflat.flatten(mqrtree.build(data)))


@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
@pytest.mark.parametrize("make", [_jax_pyramid, _jax_mqr], ids=["pyramid", "mqr"])
def test_quantize_cm_matches_jax(kind, make):
    js = make(kind, 300)
    sched = convert.schedule_from_numpy(dataclasses.asdict(js), device="cpu")
    origin, inv_cell = quantize.grid_params(sched)
    jo, ji = jquant.grid_params(js)
    assert np.array_equal(_np(origin), jo) and np.array_equal(_np(inv_cell), ji)
    got = ops.quantize_cm(sched.mbr_cm, origin, inv_cell)
    assert got.dtype == torch.uint16
    want_jnp = np.asarray(jquant.quantize_cm_jnp(js.mbr_cm, jnp.asarray(jo), jnp.asarray(ji)))
    want_pallas = np.asarray(jquant.quantize_cm_pallas(
        js.mbr_cm, jnp.asarray(jo), jnp.asarray(ji), interpret=True))
    assert np.array_equal(_np(got), want_jnp)
    assert np.array_equal(_np(got), want_pallas)
    # the schedule's unused slots are present and map to the sentinel
    unused = ~np.isfinite(js.mbr_cm[:, 0, :])
    assert unused.any()
    assert (want_jnp.transpose(0, 2, 1)[unused] == Q_NEVER_MBR).all()


def test_quantize_cm_edge_values():
    """Sentinels, values outside the grid and a degenerate axis."""
    mbr = np.array([[[np.inf, -5.0, 0.0, 1e30],
                     [np.inf, 0.5, 7.25, 3.0],
                     [-np.inf, 2.0, 1e-3, 9.0],
                     [-np.inf, 1e9, -1.0, 3.0]]], np.float32)
    origin = np.array([0.0, 3.0, 0.0, 3.0], np.float32)
    inv = np.array([CELLS / 8.0, 1e30, CELLS / 8.0, 1e30], np.float32)
    got = ops.quantize_cm(torch.from_numpy(mbr), torch.from_numpy(origin),
                          torch.from_numpy(inv))
    want = np.asarray(jquant.quantize_cm_jnp(mbr, jnp.asarray(origin), jnp.asarray(inv)))
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("make", [_jax_pyramid, _jax_mqr], ids=["pyramid", "mqr"])
def test_quantize_schedule_matches_jax(make):
    js = make("uniform_squares", 400)
    jq = jquant.quantize_schedule(js, engine="jnp")
    sched = convert.schedule_from_numpy(dataclasses.asdict(js), device="cpu")
    for engine in ("kernel", "torch"):
        q = ops.quantize_schedule(sched, engine=engine)
        for f in ("mbr_q", "parent_q", "origin", "inv_cell", "confirm_mbr"):
            want = np.asarray(getattr(jq, f))
            got = getattr(q, f)
            assert str(got.dtype).split(".")[-1] == want.dtype.name, f
            assert np.array_equal(_np(got), want), f
        assert q.cells == jq.cells
    # carried across directly, the JAX quantized schedule is the same object
    carried = convert.quantized_from_numpy(dataclasses.asdict(jq), device="cpu")
    for f in ("mbr_q", "parent_q", "origin", "inv_cell", "confirm_mbr"):
        assert np.array_equal(_np(getattr(carried, f)), np.asarray(getattr(jq, f))), f


def test_wide_schedule_keeps_int32_parents():
    """W > 65535 keeps int32 parent slots, as in the JAX package."""
    n = 70_000
    rng = np.random.default_rng(3)
    ll = rng.uniform(0, 990, size=(n, 2)).astype(np.float32)
    sched = ops.device_schedule(np.concatenate([ll, ll + 10], 1), levels=2, device="cpu")
    q = ops.quantize_schedule(sched)
    assert q.parent_q.dtype == torch.int32 and q.mbr_q.dtype == torch.uint16
