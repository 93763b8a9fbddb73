"""Port parity: the device pyramid build of ``repro_torch`` == the JAX build.

``build_levels_torch`` (the plain version the CUDA kernel is held against
on the card, and what ``build_levels`` runs for a CPU tensor) must emit the
same four arrays as the JAX package's ``build_levels_jnp``, its Pallas
kernel ``build_levels_pallas`` (interpret mode) and the host lowering
``flat.pyramid_schedule(bulk.build_pyramid(...))``, for every dataset kind
at edge sizes around the 128-slot tile.

Tolerance: exact.  Every compared quantity is an integer (group ids,
parents, level widths) or a float32 min/max of input coordinates, and
neither rounds.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import conftest
from repro.core import bulk as jbulk
from repro.core import flat as jflat
from repro.kernels import build as jbuild
from repro_torch.core import bulk, flat
from repro_torch.kernels import build, ops

SIZES = (1, 2, 5, 127, 128, 129, 1000)


def _data(kind, n):
    return np.asarray(conftest.mbr_dataset(__name__, kind, n), np.float32)


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
def test_build_levels_matches_jax(kind, n):
    data = _data(kind, n)
    levels = jbulk.default_levels(n)
    assert bulk.default_levels(n) == levels
    got = build.build_levels(torch.from_numpy(data), levels=levels)
    plain = build.build_levels_torch(torch.from_numpy(data), levels=levels)
    want_jnp = jbuild.build_levels_jnp(jnp.asarray(data), levels=levels)
    want_pallas = jbuild.build_levels_pallas(jnp.asarray(data), levels=levels,
                                             interpret=True)
    jpyr = jbulk.build_pyramid(jnp.asarray(data), levels=levels)
    jhost = jflat.pyramid_schedule(jpyr, data)
    want_host = (jpyr.group_of, jhost.mbr_cm, jhost.parent, jhost.n_real)
    names = ("group_of", "mbr_cm", "parent", "n_real")
    for name, g, p, wj, wp, wh in zip(names, got, plain, want_jnp, want_pallas, want_host):
        for label, want in (("jnp", wj), ("pallas", wp), ("host lowering", wh)):
            want = np.asarray(want)
            assert _np(g).dtype == want.dtype, (name, label)
            assert np.array_equal(_np(g), want), f"{name} != JAX {label} ({kind}, n={n})"
        assert np.array_equal(_np(p), _np(g)), name


@pytest.mark.parametrize("n", (5, 129, 1000))
@pytest.mark.parametrize("kind", conftest.DATASET_KINDS)
def test_device_schedule_matches_host_lowering(kind, n):
    """The port's device schedule == the JAX host lowering, field by field,
    and == the port's own host lowering."""
    data = _data(kind, n)
    levels = jbulk.default_levels(n)
    jpyr = jbulk.build_pyramid(jnp.asarray(data), levels=levels)
    want = dataclasses.asdict(jflat.pyramid_schedule(jpyr, data))
    dev = ops.device_schedule(data, levels=levels, device="cpu")
    host = flat.pyramid_schedule(bulk.build_pyramid(torch.from_numpy(data), levels),
                                 torch.from_numpy(data))
    for f in ("mbr_cm", "parent", "n_real", "obj_mbr", "obj_level", "obj_slot", "obj_id"):
        assert np.array_equal(_np(getattr(dev, f)), np.asarray(want[f])), f
        assert np.array_equal(_np(getattr(host, f)), np.asarray(want[f])), f
    for s in (dev, host):
        assert s.n_objects == want["n_objects"]
        assert s.root_unconditional is want["root_unconditional"] is False
        assert s.test_object_mbr is want["test_object_mbr"] is False


def test_group_bounds_empty_groups_are_sentinels():
    """Unused group ids come out (+inf, +inf, -inf, -inf), as
    jax.ops.segment_min/max give them."""
    mbrs = torch.tensor([[0.0, 0.0, 1.0, 1.0], [2.0, 2.0, 3.0, 3.0]])
    got = bulk._group_bounds(torch.tensor([1, 1]), mbrs, 3)
    assert torch.equal(got[0], torch.from_numpy(jflat.NEVER_MBR))
    assert torch.equal(got[2], torch.from_numpy(jflat.NEVER_MBR))
    assert torch.equal(got[1], torch.tensor([0.0, 0.0, 3.0, 3.0]))


def test_quad_code_matches_jax():
    """Every orientation, ties on either axis included."""
    vals = np.array([-1.0, 0.0, 1.0], np.float32)
    ax, ay = np.meshgrid(vals, vals)
    ax, ay = ax.ravel(), ay.ravel()
    zero = np.zeros_like(ax)
    want = np.asarray(jbulk.quad_code(jnp.asarray(ax), jnp.asarray(ay),
                                      jnp.asarray(zero), jnp.asarray(zero)))
    got = bulk.quad_code(*(torch.from_numpy(v) for v in (ax, ay, zero, zero)))
    assert np.array_equal(_np(got), want)


def test_device_schedule_rejects_bad_input():
    with pytest.raises(ValueError):
        ops.device_schedule(np.zeros((0, 4)), device="cpu")
    with pytest.raises(ValueError):
        ops.device_schedule(np.zeros((3, 4)), engine="pallas", device="cpu")
    with pytest.raises(TypeError):
        build.build_levels(torch.zeros((3, 4), dtype=torch.float64), levels=2)


def _level_keys(data, group_of, mbr_cm, l):
    """Level l's keys as the reference forms them, gid*5 + the quadrant code
    of an object's centroid about its group's MBR centroid for multi-member
    groups of level l-1 and gid*5 for singletons, and as the CUDA kernel
    does, gid*5 + the code for every object (float32 arithmetic)."""
    g = group_of[l - 1].astype(np.int64)
    counts = np.bincount(g, minlength=data.shape[0])
    half = np.float32(0.5)
    cx, cy = (data[:, 0] + data[:, 2]) * half, (data[:, 1] + data[:, 3]) * half
    gb = mbr_cm[l - 1][:, g]
    gcx, gcy = (gb[0] + gb[2]) * half, (gb[1] + gb[3]) * half
    quad = np.asarray(jbulk.quad_code(*(jnp.asarray(v) for v in (cx, cy, gcx, gcy))))
    return np.where(counts[g] > 1, g * 5 + quad, g * 5), g * 5 + quad


KEY_SPACE_SIZES = (1, 4, 6, 24, 26, 124, 126, 624, 626)


@pytest.mark.parametrize("deep", [False, True])
@pytest.mark.parametrize("n", KEY_SPACE_SIZES)
@pytest.mark.parametrize("kind", conftest.DATASET_KINDS + ("duplicates",))
def test_level_key_space_bounds(kind, n, deep):
    """The bounds the device build sizes each level by, held on the JAX
    build: at level l, n_real[l] <= min(n, 5^l) groups, every key lies
    below K_l = min(5n, 5^l) (so a level's presence bytes and scan cover
    K_l keys, not 5n), and the keys' dense ranks are level l's group ids,
    for the reference's keys and for the kernel's, which give a singleton
    its quadrant code (always EQ: its group MBR is its own box) instead of
    0 and so need no member counts.  n runs around 5^k; ``deep`` builds 20
    levels, where 5^l passes int32."""
    if kind == "duplicates":  # every object one box: one group at every level
        data = np.tile(_data("uniform_squares", 1), (n, 1))
    else:
        data = _data(kind, n)
    levels = 20 if deep else jbulk.default_levels(n)
    group_of, mbr_cm, _, n_real = (np.asarray(a) for a in
                                   jbuild.build_levels_jnp(jnp.asarray(data), levels=levels))
    assert n_real[0] == 1
    for l in range(1, levels):
        assert n_real[l] <= min(n, 5 ** l), (l, n_real[l])
        for keys in _level_keys(data, group_of, mbr_cm, l):
            assert 0 <= keys.min() and keys.max() < min(5 * n, 5 ** l), (l, keys.max())
            ranks = np.unique(keys, return_inverse=True)[1].reshape(-1)
            assert np.array_equal(ranks, group_of[l]), l
            assert n_real[l] == np.unique(keys).size
