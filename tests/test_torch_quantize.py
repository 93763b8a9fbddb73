"""Port parity: the uint16 tile quantizer of ``repro_torch`` == the JAX one.

``quantize_cm`` on a CPU tensor runs ``quantize_cm_torch`` — the plain
version the CUDA kernel is held against on the card — and must equal the
JAX ``quantize_cm_jnp`` and its Pallas kernel ``quantize_cm_pallas``
(interpret mode), sentinel slots included, with and without ``n_real``
and the uint8 tiles of the upper levels.  ``quantize_schedule`` must
produce the JAX ``QuantizedSchedule`` fields.  Every schedule the port
makes keeps its padding past ``n_real`` as ``NEVER_MBR`` (the rule by
which the kernel writes those slots without reading them), and the new
arguments are checked before any launch.

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
from repro_torch import SpatialIndex, convert
from repro_torch.core.flat import CELLS, CELLS8, NEVER_MBR, Q_NEVER_MBR
from repro_torch.kernels import _lib, ops, quantize


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


# ---------------------------------------------------------------------------
# Padding past n_real, the uint8 tiles, and the arguments of the kernel
# ---------------------------------------------------------------------------


def _live_after_merge(structure):
    data = conftest.f32_exact(conftest.mbr_dataset(__name__, "uniform_squares", 300))
    build = {"build": "device"} if structure == "pyramid" else {}
    idx = SpatialIndex.build(data, structure=structure, device="cpu", capacity=16, **build)
    idx.insert(data[:5] + 0.5)
    idx.delete(list(range(0, 300, 7)))
    assert idx.flush()
    return idx.schedule


PADDING_SOURCES = {
    "host pyramid": lambda d: SpatialIndex.build(d, structure="pyramid", build="host",
                                                 device="cpu").schedule,
    "device pyramid": lambda d: ops.device_schedule(d, device="cpu"),
    "mqr": lambda d: SpatialIndex.build(d, device="cpu").schedule,
    "rtree": lambda d: SpatialIndex.build(d, structure="rtree", device="cpu").schedule,
    "hilbert pyramid": lambda d: ops.hilbert_permute(ops.device_schedule(d, device="cpu")),
    "hilbert mqr": lambda d: SpatialIndex.build(d, device="cpu", order="hilbert").schedule,
    "live pyramid after a merge": lambda d: _live_after_merge("pyramid"),
    "live mqr after a merge": lambda d: _live_after_merge("mqr"),
}


@pytest.mark.parametrize("source", PADDING_SOURCES)
def test_schedule_padding_past_n_real_is_never_mbr(source):
    """``mbr_cm[l, :, n_real[l]:]`` is ``NEVER_MBR`` bit for bit in every
    schedule the port makes, so the kernel may write those slots unread."""
    data = np.asarray(conftest.mbr_dataset(__name__, "exponential_squares", 300), np.float32)
    s = PADDING_SOURCES[source](data)
    bits = s.mbr_cm.contiguous().view(torch.int32)
    never = torch.from_numpy(NEVER_MBR).view(torch.int32)[:, None]
    n_real = s.n_real.tolist()
    assert len(n_real) == s.levels and sum(s.width - nr for nr in n_real) > 0
    for l, nr in enumerate(n_real):
        assert 0 < nr <= s.width, (l, nr)
        assert torch.equal(bits[l, :, nr:], never.expand(4, s.width - nr)), (source, l)
        assert not torch.equal(bits[l, :, nr - 1], never[:, 0]), (source, l)


@pytest.mark.parametrize("split", [None, 0, 1, "L"])
@pytest.mark.parametrize("make", [_jax_pyramid, _jax_mqr], ids=["pyramid", "mqr"])
def test_quantize_cm_with_n_real_and_uint8_matches_jax(make, split):
    """``n_real`` (ignored by the plain version) and the uint8 tiles of
    levels ``[0, split)`` beside the uint16 ones: both equal the JAX
    quantizers, the uint8 side ``quantize_cm_jnp`` at ``CELLS8``."""
    js = make("uniform_squares", 300)
    sched = convert.schedule_from_numpy(dataclasses.asdict(js), device="cpu")
    origin, inv_cell = quantize.grid_params(sched)
    _, inv_cell8 = quantize.grid_params(sched, cells=CELLS8)
    jo, ji = (jnp.asarray(x) for x in jquant.grid_params(js))
    want = np.asarray(jquant.quantize_cm_jnp(js.mbr_cm, jo, ji))
    assert np.array_equal(want, np.asarray(
        jquant.quantize_cm_pallas(js.mbr_cm, jo, ji, interpret=True)))
    if split is None:
        got = ops.quantize_cm(sched.mbr_cm, origin, inv_cell, n_real=sched.n_real)
        assert np.array_equal(_np(got), want)
        return
    k = sched.levels if split == "L" else split
    got16, got8 = ops.quantize_cm(sched.mbr_cm, origin, inv_cell, n_real=sched.n_real,
                                  split=k, inv_cell8=inv_cell8)
    want8 = np.asarray(jquant.quantize_cm_jnp(
        js.mbr_cm[:k], jo, jnp.asarray(jquant.grid_params(js, cells=CELLS8)[1]),
        cells=CELLS8, dtype=jnp.uint8))
    assert np.array_equal(_np(got16), want)
    assert got8.dtype == torch.uint8 and got8.shape == (k, 4, sched.width)
    assert np.array_equal(_np(got8), want8)
    plain = quantize.quantize_cm_torch(sched.mbr_cm, origin, inv_cell, split=k,
                                       inv_cell8=inv_cell8)
    assert all(torch.equal(a, b) for a, b in zip((got16, got8), plain))


def test_quantize_cm_edge_values_inside_n_real():
    """+inf lo values, -inf, 1e30 and values past the grid INSIDE
    ``n_real`` quantize by their own value, on both grids; the slot past
    ``n_real`` holds ``NEVER_MBR``."""
    inf = np.inf
    mbr = np.array([[[inf, -5.0, 1e30, inf],
                     [0.25, inf, -inf, inf],
                     [-inf, 2.0, 1e30, -inf],
                     [9.0, -1e30, 7.5, -inf]],
                    [[-1e30, 4.0, inf, inf],
                     [1.0, 1.0, 3.0, inf],
                     [inf, 4.5, 8.0, -inf],
                     [2.0, 2.0, 9.0, -inf]]], np.float32)
    origin = np.array([0.0, 1.0, 0.0, 1.0], np.float32)
    inv = np.array([CELLS / 8.0, CELLS / 8.0, CELLS / 8.0, CELLS / 8.0], np.float32)
    inv8 = np.array([CELLS8 / 8.0, 1e30, CELLS8 / 8.0, 1e30], np.float32)
    n_real = torch.tensor([3, 3], dtype=torch.int32)
    t = torch.from_numpy
    got16, got8 = ops.quantize_cm(t(mbr), t(origin), t(inv), n_real=n_real, split=2,
                                  inv_cell8=t(inv8))
    want16 = np.asarray(jquant.quantize_cm_jnp(mbr, jnp.asarray(origin), jnp.asarray(inv)))
    want8 = np.asarray(jquant.quantize_cm_jnp(mbr, jnp.asarray(origin), jnp.asarray(inv8),
                                              cells=CELLS8, dtype=jnp.uint8))
    assert np.array_equal(_np(got16), want16) and np.array_equal(_np(got8), want8)
    assert (want16[:, :, 3] == Q_NEVER_MBR).all()
    assert want16[0, 0, 0] == CELLS + 1 and want16[0, 0, 2] == CELLS  # +inf lo, 1e30


def _bad_arg_cases():
    """(label, kwargs of quantize_cm over a (2, 4, 5) grid, message)."""
    f32 = torch.ones(4, dtype=torch.float32)
    n_ok = torch.tensor([5, 2], dtype=torch.int32)
    return {
        "n_real dtype": (dict(n_real=n_ok.to(torch.int64)), "n_real"),
        "n_real float": (dict(n_real=n_ok.float()), "n_real"),
        "n_real shape": (dict(n_real=torch.tensor([5, 2, 1], dtype=torch.int32)), "n_real"),
        "n_real 2-D": (dict(n_real=n_ok[None, :]), "n_real"),
        "n_real layout": (dict(n_real=torch.tensor([5, 9, 2, 9], dtype=torch.int32)[::2]),
                          "n_real"),
        "n_real device": (dict(n_real=n_ok.to("meta")), "n_real"),
        "n_real past W": (dict(n_real=torch.tensor([5, 6], dtype=torch.int32)), "n_real"),
        "n_real negative": (dict(n_real=torch.tensor([-1, 2], dtype=torch.int32)), "n_real"),
        "split below 0": (dict(split=-1, inv_cell8=f32), "split"),
        "split past L": (dict(split=3, inv_cell8=f32), "split"),
        "split alone": (dict(split=1), "inv_cell8"),
        "inv_cell8 alone": (dict(inv_cell8=f32), "inv_cell8"),
        "inv_cell8 dtype": (dict(split=1, inv_cell8=f32.double()), "inv_cell8"),
        "inv_cell8 shape": (dict(split=1, inv_cell8=torch.ones(3)), "inv_cell8"),
        "inv_cell8 device": (dict(split=1, inv_cell8=f32.to("meta")), "inv_cell8"),
    }


BAD_ARGS = _bad_arg_cases()


@pytest.mark.parametrize("case", BAD_ARGS)
def test_quantize_cm_rejects_bad_args_before_any_launch(case, monkeypatch):
    """Each new argument's fault is a ValueError that names it, raised
    before the kernel library is reached."""
    def no_launch():
        raise AssertionError("quantize_cm reached the kernel library")

    monkeypatch.setattr(_lib, "load", no_launch)
    kw, name = BAD_ARGS[case]
    with pytest.raises(ValueError, match=name):
        ops.quantize_cm(torch.zeros((2, 4, 5)), torch.zeros(4), torch.ones(4), **kw)
