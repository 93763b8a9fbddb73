"""Port parity of the level sweeps at the edge shapes of their card check.

``chip_smoke.py`` holds the CUDA kernels #1 (``level_sweep``), #2
(``level_sweep_stream``) and #3 (``level_sweep_hier``) to their plain
versions on the card, by equality, at widths 1, 3, 17, 129 and 4,097 and the
trees' 13,534 and 14,237, query counts 1, 9, 33 and 257 and ``block_w`` 64 to
512.  Here those plain versions are held to the JAX package (interpret mode,
as its own tests run it) at the same odd widths, query counts and tilings,
so the chain "kernel == plain on the card, plain == JAX on the CPU" covers
the shapes:

* ``level_sweep_torch`` against the JAX ``level_sweep``: float32 tiles with
  int32 parents, uint16 tiles with uint16 and with int32 parents;
* ``level_sweep_stream_torch`` against the JAX ``level_sweep(stream=True)``
  mask, every tile and parent type #2 takes, and its skip count against the
  rule of ROADMAP C6 transcribed in numpy over the JAX mask;
* ``level_sweep_hier_torch`` against the JAX ``level_sweep_hier``, with
  uint16 and int32 parents, and the wrapper with and without ``n_real``;

each at ``root_unconditional`` False and True and ``uncond_from`` None, 1
and L - 1 (spread over the shapes so the suite's time barely moves).  The
schedules are JAX pyramids of W objects (width W), carried across with
``repro_torch.convert``; the queries mix region queries, a box over the
whole domain (every gate is read) and points.

Tolerance: exact.  Masks are booleans of float32 or integer compares on the
same inputs; skip counts are integers.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import conftest
from repro.core import bulk as jbulk
from repro.core import flat as jflat
from repro.kernels import pyramid_scan as jscan
from repro.kernels import quantize as jquant
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.kernels.pyramid_scan import _quantize_queries

# (W, Q, block_w): each width, query count and tiling of the card check.
SHAPES = (
    (1, 1, 64),
    (3, 257, 512),
    (17, 9, 128),
    (129, 33, 256),
    (4097, 257, 64),
    (4097, 1, 512),
    (13534, 9, 128),
    (14237, 33, 256),
)
# (root_unconditional, uncond_from); "last" is L - 1.
MODES = ((False, None), (True, 1), (False, "last"), (True, None), (False, 1), (True, "last"))
# Shape i takes modes i and i + 3, so every mode meets several shapes.
CASES = [(shape, MODES[(i + k) % len(MODES)])
         for i, shape in enumerate(SHAPES) for k in (0, 3)]
IDS = [f"W{w}-Q{q}-bw{bw}-root{int(root)}-uncond{u}"
       for (w, q, bw), (root, u) in CASES]

_CACHE = {}


def _np(t):
    t = t.cpu()
    return (t.to(torch.int32) if t.dtype == torch.uint16 else t).numpy()


def _queries(data, n):
    """Region queries sized for ~4 hits; every 7th a box over the whole
    domain and every 11th from the 4th a point at an object's centre."""
    q = conftest.dataset_queries(__name__, "uniform_squares", data.shape[0], n).copy()
    q[::7] = np.concatenate([data[:, :2].min(axis=0) - 1.0, data[:, 2:].max(axis=0) + 1.0])
    pick = data[np.arange(3, n, 11) % data.shape[0]]
    c = np.stack([(pick[:, 0] + pick[:, 2]) * 0.5, (pick[:, 1] + pick[:, 3]) * 0.5], axis=1)
    q[3::11] = np.concatenate([c, c], axis=1)
    return q.astype(np.float32)


def _inputs(width, nq):
    """JAX schedule, its compact8 lowering and queries at one shape, and
    the port's copies: a dict of both sides' sweep arguments."""
    key = (width, nq)
    if key not in _CACHE:
        data = np.asarray(conftest.mbr_dataset(__name__, "uniform_squares", width), np.float32)
        pyr = jbulk.build_pyramid(jnp.asarray(data), levels=jbulk.default_levels(width))
        js = jflat.pyramid_schedule(pyr, data)
        jq = jquant.quantize_schedule(js, engine="jnp", upper8=True)
        qs = _queries(data, nq)
        jqq = jscan._quantize_queries(jnp.asarray(qs), jnp.asarray(jq.origin),
                                      jnp.asarray(jq.inv_cell), jq.cells)
        jqq8 = jscan._quantize_queries(jnp.asarray(qs), jnp.asarray(jq.origin),
                                       jnp.asarray(jq.inv_cell8), jq.cells8)
        s = convert.schedule_from_numpy(dataclasses.asdict(js), device="cpu")
        q = convert.quantized_from_numpy(dataclasses.asdict(jq), device="cpu")
        tq = torch.from_numpy(qs)
        qq = _quantize_queries(tq, q.origin, q.inv_cell, q.cells)
        qq8 = _quantize_queries(tq, q.origin, q.inv_cell8, q.cells8)
        assert np.array_equal(_np(qq), np.asarray(jqq))
        assert np.array_equal(_np(qq8), np.asarray(jqq8))
        assert q.parent_q.dtype == torch.uint16 and s.width == width
        _CACHE[key] = dict(
            js=js, jq=jq, levels=js.levels,
            jax_f32=(jnp.asarray(qs), jnp.asarray(js.mbr_cm), jnp.asarray(js.parent)),
            jax_u16=(jqq, jnp.asarray(jq.mbr_q), jnp.asarray(jq.parent_q)),
            jax_hier=(jqq8, jqq, jnp.asarray(jq.mbr_q8), jnp.asarray(jq.mbr_q[jq.split:]),
                      jnp.asarray(jq.parent_q)),
            f32=(tq, s.mbr_cm), u16=(qq, q.mbr_q), parents=(s.parent, q.parent_q),
            hier=(qq8, qq, q.mbr_q8, q.mbr_q[q.split:]), split=q.split, n_real=s.n_real,
        )
    return _CACHE[key]


def _mode(inp, mode):
    root, uncond = mode
    return root, (inp["levels"] - 1 if uncond == "last" else uncond)


def _skip_rule(mask, win_off, win_w, uncond_from):
    """ROADMAP C6 over a (L, Q, W) mask: tile t of level l is skipped when
    win_off[l, t] < 0, or when 0 < l < uncond_from and no query survived at
    level l - 1 in [win_off[l, t], win_off[l, t] + win_w) (clipped to W)."""
    levels, _, width = mask.shape
    uncond = levels if uncond_from is None else uncond_from
    alive = mask.any(axis=1)  # (L, W)
    count = 0
    for l in range(levels):
        for off in win_off[l]:
            if off < 0:
                count += 1
            elif 0 < l < uncond and not alive[l - 1, min(off, width):min(off + win_w, width)].any():
                count += 1
    return count


@pytest.mark.parametrize("shape,mode", CASES, ids=IDS)
def test_level_sweep_edges_match_jax(shape, mode):
    width, nq, block_w = shape
    inp = _inputs(width, nq)
    root, uncond = _mode(inp, mode)
    kw = dict(root_unconditional=root, uncond_from=uncond)
    p32, p16 = inp["parents"]
    for jax_args, port, parents in (("jax_f32", inp["f32"], (p32,)),
                                    ("jax_u16", inp["u16"], (p16, p16.to(torch.int32)))):
        want = np.asarray(jscan.level_sweep(*inp[jax_args], block_w=block_w, interpret=True,
                                            **kw))
        for parent in parents:
            got = ops.level_sweep(*port, parent, block_w=block_w, **kw)
            assert got.shape == want.shape
            assert np.array_equal(_np(got), want), (jax_args, parent.dtype)


@pytest.mark.parametrize("shape,mode", CASES, ids=IDS)
def test_level_sweep_stream_edges_match_jax(shape, mode):
    width, nq, block_w = shape
    inp = _inputs(width, nq)
    root, uncond = _mode(inp, mode)
    kw = dict(root_unconditional=root, uncond_from=uncond)
    js = inp["js"]
    win_off, win_w = jscan.parent_windows(js.parent, js.n_real, block_w=block_w,
                                          uncond_from=uncond)
    t_off = torch.from_numpy(win_off)
    p32, p16 = inp["parents"]
    for jax_args, port, parents in (("jax_f32", inp["f32"], (p32, p32.to(torch.uint16))),
                                    ("jax_u16", inp["u16"], (p16, p16.to(torch.int32)))):
        want = np.asarray(jscan.level_sweep(*inp[jax_args], block_w=block_w, interpret=True,
                                            stream=True, win_off=jnp.asarray(win_off),
                                            win_w=win_w, **kw))
        want_skipped = _skip_rule(want, win_off, win_w, uncond)
        for parent in parents:
            act, skipped = ops.level_sweep_stream_torch(*port, parent, t_off, win_w,
                                                        block_w=block_w, **kw)
            assert np.array_equal(_np(act), want), (jax_args, parent.dtype)
            assert int(skipped) == want_skipped
            # the wrapper on a CPU tensor takes the same plain version
            got, n = ops.level_sweep_stream(*port, parent, t_off, win_w, block_w=block_w, **kw)
            assert torch.equal(got, act) and int(n) == want_skipped


@pytest.mark.parametrize("shape,mode", CASES, ids=IDS)
def test_level_sweep_hier_edges_match_jax(shape, mode):
    width, nq, block_w = shape
    inp = _inputs(width, nq)
    root, uncond = _mode(inp, mode)
    kw = dict(root_unconditional=root, uncond_from=uncond)
    split = inp["split"]
    want = np.asarray(jscan.level_sweep_hier(*inp["jax_hier"], split=split, block_w=block_w,
                                             interpret=True, **kw))
    _, p16 = inp["parents"]
    for parent in (p16, p16.to(torch.int32)):
        got = ops.level_sweep_hier_torch(*inp["hier"], parent, split=split, **kw)
        assert np.array_equal(_np(got), want), parent.dtype
        # the wrapper, with the schedule's n_real (which lets the kernel skip
        # padding tiles) and without it
        for n_real in (None, inp["n_real"]):
            assert torch.equal(ops.level_sweep_hier(*inp["hier"], parent, split=split,
                                                    block_w=block_w, n_real=n_real, **kw), got)
