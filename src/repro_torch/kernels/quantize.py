"""Conservative uint16 quantization of MBR tile grids.

Counterpart of ``repro.kernels.quantize``.  The schedule's float32 node
MBRs are snapped to a ``CELLS``-cell uint16 grid with OUTWARD rounding (lo
floor, hi ceil), so every quantized box contains its exact box and the
quantized sweep keeps a superset of the exact survivors.  The grid derives
from the object-MBR union (the root box); unused slots (lo = +inf) map to
the integer never-overlap sentinel ``Q_NEVER_MBR``.

The coarse uint8 tiles of ``compact8`` come from the plain quantizer at
``cells=CELLS8``, as in the JAX package (which uses no Pallas kernel
there); the uint16 tiles go through ``csrc/quantize.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.flat import (
    CELLS,
    CELLS8,
    Q_NEVER_MBR,
    LevelSchedule,
    QuantizedSchedule,
)

from . import _lib

ENGINES = ("kernel", "torch")


def grid_params(schedule: LevelSchedule, cells: int = CELLS):
    """Per-axis grid of the object-MBR union: ``(origin (4,) f32,
    inv_cell (4,) f32)`` on the schedule's device, laid out (x, y, x, y).

    The scale is computed in float64 on the host from the four exact
    float32 extremes, as the JAX package does, then rounded to float32.
    A degenerate (zero-extent) axis gets a capped scale, not inf.
    """
    obj = schedule.obj_mbr
    lo = obj[:, :2].amin(dim=0).cpu().numpy().astype(np.float64)
    hi = obj[:, 2:].amax(dim=0).cpu().numpy().astype(np.float64)
    with np.errstate(divide="ignore"):
        inv = np.minimum(cells / np.maximum(hi - lo, 0.0), 1e30)
    origin = np.concatenate([lo, lo]).astype(np.float32)
    inv_cell = np.concatenate([inv, inv]).astype(np.float32)
    dev = schedule.device
    return torch.from_numpy(origin).to(dev), torch.from_numpy(inv_cell).to(dev)


def quantize_cm_torch(mbr_cm: torch.Tensor, origin: torch.Tensor,
                      inv_cell: torch.Tensor, *, cells: int = CELLS,
                      dtype: torch.dtype = torch.uint16) -> torch.Tensor:
    """Plain version: (L, 4, W) float32 -> (L, 4, W) ``dtype`` grid cells
    (uint16, or uint8 on the coarse ``CELLS8`` grid)."""
    t = (mbr_cm - origin[None, :, None]) * inv_cell[None, :, None]
    is_lo = (torch.arange(4, device=mbr_cm.device) < 2)[None, :, None]
    cell = torch.where(is_lo, torch.floor(t), torch.ceil(t)).clamp(0.0, float(cells))
    cell = torch.where(is_lo & (mbr_cm == float("inf")), float(cells + 1), cell)
    # uint16 has little op support: go through int32 (exact for [0, 65535])
    return cell.to(torch.int32).to(dtype)


def quantize_rows(mbrs: np.ndarray, origin: np.ndarray,
                  inv_cell: np.ndarray) -> np.ndarray:
    """Conservative uint16 quantization of row-major (N, 4) MBRs onto an
    EXISTING schedule grid: the delta-buffer lowering of the live path
    (host numpy, a copy of the reference's).

    Delta rows may extend past the grid domain (inserts land anywhere).
    Clipping lo-after-floor and hi-after-ceil into ``[0, CELLS]`` keeps the
    conservative-superset property, because queries are clipped into the
    same range and clip is monotone; the exact confirming pass removes the
    extra boundary candidates.  Same float32 arithmetic as
    :func:`quantize_cm_torch`.  Rows with ``lo == +inf`` (empty slots) map
    to ``Q_NEVER_MBR``.
    """
    m = np.asarray(mbrs, np.float32)
    origin = np.asarray(origin, np.float32)
    inv_cell = np.asarray(inv_cell, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        t = (m - origin[None, :]) * inv_cell[None, :]
        cell = np.concatenate([np.floor(t[:, :2]), np.ceil(t[:, 2:])], axis=1)
    cell = np.clip(cell, 0.0, float(CELLS))
    out = cell.astype(np.uint16)
    out[np.isposinf(m[:, 0])] = Q_NEVER_MBR
    return out


def quantize_cm(mbr_cm: torch.Tensor, origin: torch.Tensor,
                inv_cell: torch.Tensor, *, cells: int = CELLS) -> torch.Tensor:
    """Quantize (L, 4, W) float32 tiles to uint16.  A CUDA tensor goes to
    ``csrc/quantize.cu``, a CPU tensor to :func:`quantize_cm_torch`."""
    _lib.require(mbr_cm, "mbr_cm", torch.float32)
    if mbr_cm.dim() != 3 or mbr_cm.shape[1] != 4:
        raise ValueError(f"mbr_cm must be (L, 4, W), got {tuple(mbr_cm.shape)}")
    _lib.require(origin, "origin", torch.float32, (4,))
    _lib.require(inv_cell, "inv_cell", torch.float32, (4,))
    if not 0 < cells < 65535:
        raise ValueError(f"cells must be in (0, 65535), got {cells}")
    if mbr_cm.device.type == "cpu":
        _lib.require_device({"origin": origin, "inv_cell": inv_cell}, mbr_cm.device)
        return quantize_cm_torch(mbr_cm, origin, inv_cell, cells=cells)
    if mbr_cm.device.type != "cuda":
        raise ValueError(f"quantize_cm runs on cuda or cpu, not {mbr_cm.device}")
    _lib.require_device({"origin": origin, "inv_cell": inv_cell}, mbr_cm.device)
    lib = _lib.load()
    out = torch.empty(mbr_cm.shape, dtype=torch.uint16, device=mbr_cm.device)
    rc = lib.repro_quantize_cm(
        mbr_cm.data_ptr(), origin.data_ptr(), inv_cell.data_ptr(),
        out.data_ptr(), mbr_cm.numel(), mbr_cm.shape[2], cells,
        _lib.stream_of(mbr_cm),
    )
    _lib.check(rc, "quantize_cm")
    _lib.counters.add("quantize_cm")
    return out


def quantize_schedule(schedule: LevelSchedule, *, engine: str = "kernel",
                      upper8: bool = False, split: int | None = None
                      ) -> QuantizedSchedule:
    """Lower a :class:`LevelSchedule` to its compact uint16 tile form.

    ``upper8=True`` also materializes coarse uint8 tiles for the levels
    ``[0, split)`` (default all but the deepest) on a ``CELLS8``-cell grid
    sharing the same origin: the form ``pyramid_scan_compact8`` sweeps.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown quantize engine {engine!r}; expected one of {ENGINES}")
    origin, inv_cell = grid_params(schedule)
    fn = quantize_cm if engine == "kernel" else quantize_cm_torch
    mbr_q = fn(schedule.mbr_cm, origin, inv_cell)
    # Parent slots stream as uint16 while the level width fits; wider
    # schedules (pyramid width == n > 65535) keep int32 parents.
    pdtype = torch.uint16 if schedule.width <= 65535 else torch.int32
    if schedule.test_object_mbr:
        confirm = schedule.obj_mbr
    else:
        # Pyramid schedules: the entry's deepest group MBR is the exact
        # membership box, nested inside every ancestor.
        confirm = schedule.mbr_cm[
            schedule.obj_level.long(), :, schedule.obj_slot.long()
        ].contiguous()
    mbr_q8 = inv_cell8 = None
    if split is None:
        split = max(schedule.levels - 1, 0) if upper8 else 0
    if upper8 and split > 0:
        _, inv_cell8 = grid_params(schedule, cells=CELLS8)
        mbr_q8 = quantize_cm_torch(schedule.mbr_cm[:split], origin, inv_cell8,
                                   cells=CELLS8, dtype=torch.uint8)
    return QuantizedSchedule(
        base=schedule,
        mbr_q=mbr_q,
        parent_q=schedule.parent.to(pdtype),
        origin=origin,
        inv_cell=inv_cell,
        confirm_mbr=confirm,
        cells=CELLS,
        mbr_q8=mbr_q8,
        split=split if upper8 else 0,
        cells8=CELLS8,
        inv_cell8=inv_cell8,
    )
