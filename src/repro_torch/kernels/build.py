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
"""

from __future__ import annotations

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
