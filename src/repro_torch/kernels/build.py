"""Device bulk build of the mqr group pyramid, straight to a LevelSchedule.

Counterpart of ``repro.kernels.build``.  Two engines, identical outputs:

* ``engine="kernel"`` — :func:`build_levels`, which launches
  ``csrc/build_levels.cu`` for a CUDA tensor (any n: the TPU kernel's
  ``PALLAS_BUILD_MAX_N`` VMEM cap does not exist on the card) and takes
  the plain version for a CPU tensor;
* ``engine="torch"`` — :func:`build_levels_torch`, the plain PyTorch fixed
  point of :func:`repro_torch.core.bulk.build_pyramid` lowered by
  :func:`repro_torch.core.flat.pyramid_schedule` (the counterpart of
  ``build_levels_jnp``).

Both emit exactly the level arrays of
``flat.pyramid_schedule(bulk.build_pyramid(...))``.

:func:`hilbert_permute` is the build-time Hilbert slot order
(``order="hilbert"``), host numpy as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bulk
from repro_torch.core.flat import LevelSchedule, pyramid_schedule

from . import _lib

ENGINES = ("kernel", "torch")


def build_levels_torch(mbrs: torch.Tensor, *, levels: int):
    """Plain version: ``(group_of (L, n) i32, mbr_cm (L, 4, n) f32,
    parent (L, n) i32, n_real (L,) i32)``."""
    pyr = bulk.build_pyramid(mbrs, levels)
    s = pyramid_schedule(pyr, mbrs)
    return pyr.group_of, s.mbr_cm, s.parent, s.n_real


def build_levels(mbrs: torch.Tensor, *, levels: int):
    """Build the level arrays of ``mbrs`` (n, 4) float32; same return
    contract as :func:`build_levels_torch`.  A CUDA tensor goes to the
    kernel, a CPU tensor to the plain version."""
    _lib.require(mbrs, "mbrs", torch.float32)
    if mbrs.dim() != 2 or mbrs.shape[1] != 4:
        raise ValueError(f"mbrs must be (n, 4), got {tuple(mbrs.shape)}")
    if mbrs.device.type == "cpu":
        return build_levels_torch(mbrs, levels=levels)
    if mbrs.device.type != "cuda":
        raise ValueError(f"build_levels runs on cuda or cpu, not {mbrs.device}")
    n = mbrs.shape[0]
    if not 0 < n < 2 ** 31 // 5:
        raise ValueError(f"build_levels supports 0 < n < {2 ** 31 // 5}, got {n}")
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    lib = _lib.load()
    dev = mbrs.device
    group_of = torch.empty((levels, n), dtype=torch.int32, device=dev)
    mbr_cm = torch.empty((levels, 4, n), dtype=torch.float32, device=dev)
    parent = torch.empty((levels, n), dtype=torch.int32, device=dev)
    n_real = torch.empty((levels,), dtype=torch.int32, device=dev)
    workspace = torch.empty(
        (lib.repro_build_levels_workspace(n),), dtype=torch.uint8, device=dev
    )
    rc = lib.repro_build_levels(
        mbrs.data_ptr(), group_of.data_ptr(), mbr_cm.data_ptr(),
        parent.data_ptr(), n_real.data_ptr(), workspace.data_ptr(),
        n, levels, _lib.stream_of(mbrs),
    )
    _lib.check(rc, "build_levels")
    _lib.counters.add("build_levels")
    return group_of, mbr_cm, parent, n_real


def device_schedule(mbrs, *, levels: int | None = None, engine: str = "kernel",
                    device=None) -> LevelSchedule:
    """Bulk build straight to a :class:`LevelSchedule` on ``device`` —
    no host pointer tree.  ``mbrs`` is (n, 4) array-like or a tensor."""
    from .ops import resolve_device

    if engine not in ENGINES:
        raise ValueError(f"unknown build engine {engine!r}; expected one of {ENGINES}")
    dev = resolve_device(device)
    if isinstance(mbrs, torch.Tensor):
        obj = mbrs.to(device=dev, dtype=torch.float32).reshape(-1, 4).contiguous()
    else:
        obj = torch.from_numpy(
            np.ascontiguousarray(np.asarray(mbrs, np.float32).reshape(-1, 4))
        ).to(dev)
    n = obj.shape[0]
    if n == 0:
        raise ValueError("device_schedule needs at least one MBR")
    if levels is None:
        levels = bulk.default_levels(n)
    fn = build_levels if engine == "kernel" else build_levels_torch
    group_of, mbr_cm, parent, n_real = fn(obj, levels=levels)
    return LevelSchedule(
        mbr_cm=mbr_cm,
        parent=parent,
        n_real=n_real,
        obj_mbr=obj,
        obj_level=torch.full((n,), levels - 1, dtype=torch.int32, device=dev),
        obj_slot=group_of[levels - 1].clone(),
        obj_id=torch.arange(n, dtype=torch.int32, device=dev),
        n_objects=n,
        root_unconditional=False,
        test_object_mbr=False,
    )


# ---------------------------------------------------------------------------
# Build-time Hilbert slot ordering (host numpy, as in the reference)
# ---------------------------------------------------------------------------


def hilbert_keys(x, y, order: int = 16) -> np.ndarray:
    """Vectorized Hilbert-curve index of points normalized to [0, 1]
    (bitwise xy->d walk over ``order`` bits; ties are broken by the
    caller's stable argsort)."""
    n = 1 << order
    x = np.clip((np.asarray(x, np.float64) * n).astype(np.int64), 0, n - 1)
    y = np.clip((np.asarray(y, np.float64) * n).astype(np.int64), 0, n - 1)
    d = np.zeros_like(x)
    s = n >> 1
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        # rotate the quadrant: reflect when rx==1, then swap axes (ry==0)
        swap = ry == 0
        refl = swap & (rx == 1)
        xr = np.where(refl, s - 1 - x, x)
        yr = np.where(refl, s - 1 - y, y)
        x = np.where(swap, yr, xr)
        y = np.where(swap, xr, yr)
        s >>= 1
    return d


def hilbert_permute(schedule: LevelSchedule, order: int = 16) -> LevelSchedule:
    """Renumber every level's real slots along the Hilbert curve of their
    MBR centers (a within-level bijection; padded slots stay in place).

    Parents are remapped through the previous level's permutation and
    object entry slots through their own level's, so hits and per-level
    visits are unchanged; only which slots share a thread block changes.
    Computed in numpy on the host (as in the JAX package); the result lies
    on the schedule's device."""
    mbr_cm = schedule.mbr_cm.cpu().numpy()
    parent0 = schedule.parent.cpu().numpy()
    obj_slot0 = schedule.obj_slot.cpu().numpy()
    n_real = schedule.n_real.cpu().numpy()
    obj = schedule.obj_mbr.cpu().numpy().astype(np.float64)
    lo = obj[:, :2].min(axis=0)
    span = np.maximum(obj[:, 2:].max(axis=0) - lo, 1e-30)
    mbr = np.array(mbr_cm, copy=True)
    parent = np.array(parent0, copy=True)
    obj_slot = np.array(obj_slot0, copy=True)
    obj_level = schedule.obj_level.cpu().numpy()
    prev_perm = None  # old slot -> new slot, previous level
    for l in range(schedule.levels):
        nr = int(n_real[l])
        cx = (mbr_cm[l, 0, :nr] + mbr_cm[l, 2, :nr]) / 2.0
        cy = (mbr_cm[l, 1, :nr] + mbr_cm[l, 3, :nr]) / 2.0
        keys = hilbert_keys((cx - lo[0]) / span[0], (cy - lo[1]) / span[1], order=order)
        by_key = np.argsort(keys, kind="stable")  # new slot -> old slot
        perm = np.empty(nr, np.int64)
        perm[by_key] = np.arange(nr)              # old slot -> new slot
        mbr[l, :, :nr] = mbr_cm[l][:, by_key]
        if l > 0:
            old_parent = np.asarray(parent0[l, :nr], np.int64)
            parent[l, :nr] = prev_perm[old_parent[by_key]].astype(parent0.dtype)
        mask = obj_level == l
        if mask.any():
            obj_slot[mask] = perm[obj_slot0[mask].astype(np.int64)].astype(obj_slot.dtype)
        prev_perm = perm
    dev = schedule.device
    return dataclasses.replace(
        schedule,
        mbr_cm=torch.from_numpy(mbr).to(dev),
        parent=torch.from_numpy(parent).to(dev),
        obj_slot=torch.from_numpy(obj_slot).to(dev),
    )
