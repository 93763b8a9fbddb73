"""Conservative uint16 quantization of MBR tile grids.

Counterpart of ``repro.kernels.quantize``.  The schedule's float32 node
MBRs are snapped to a ``CELLS``-cell uint16 grid with OUTWARD rounding (lo
floor, hi ceil), so every quantized box contains its exact box and the
quantized sweep keeps a superset of the exact survivors.  The grid derives
from the object-MBR union (the root box); unused slots (lo = +inf) map to
the integer never-overlap sentinel ``Q_NEVER_MBR``.

The coarse uint8 tiles of ``compact8`` are the same function at
``cells=CELLS8``; the JAX package computes them with ``quantize_cm_jnp``
(no Pallas kernel there).  On the card both come from one launch of
``csrc/quantize.cu``, which reads no padding slot of a level past the
schedule's ``n_real``.
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


def _grid_torch(mbr_cm: torch.Tensor, origin: torch.Tensor, inv_cell: torch.Tensor,
                cells: int, dtype: torch.dtype) -> torch.Tensor:
    t = (mbr_cm - origin[None, :, None]) * inv_cell[None, :, None]
    is_lo = (torch.arange(4, device=mbr_cm.device) < 2)[None, :, None]
    cell = torch.where(is_lo, torch.floor(t), torch.ceil(t)).clamp(0.0, float(cells))
    cell = torch.where(is_lo & (mbr_cm == float("inf")), float(cells + 1), cell)
    # uint16 has little op support: go through int32 (exact for [0, 65535])
    return cell.to(torch.int32).to(dtype)


def quantize_cm_torch(mbr_cm: torch.Tensor, origin: torch.Tensor,
                      inv_cell: torch.Tensor, *, cells: int = CELLS,
                      n_real: torch.Tensor | None = None, split: int | None = None,
                      inv_cell8: torch.Tensor | None = None):
    """Plain version of :func:`quantize_cm`, same arguments and results:
    (L, 4, W) float32 -> (L, 4, W) uint16 grid cells, and with ``split``
    also the (split, 4, W) uint8 cells of levels ``[0, split)`` on the
    ``CELLS8`` grid.  ``n_real`` is taken and ignored: the slots past it
    are padding, which quantizes to the sentinel either way."""
    mbr_q = _grid_torch(mbr_cm, origin, inv_cell, cells, torch.uint16)
    if split is None:
        return mbr_q
    return mbr_q, _grid_torch(mbr_cm[:split], origin, inv_cell8, CELLS8, torch.uint8)


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


def _require_arg(t, name: str, dtype: torch.dtype, shape: tuple,
                 device: torch.device) -> None:
    """The optional arguments of :func:`quantize_cm`: a ValueError for a
    wrong type, shape, layout or device."""
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise ValueError(f"{name} must be a {dtype} tensor, got "
                         f"{t.dtype if isinstance(t, torch.Tensor) else type(t).__name__}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def quantize_cm(mbr_cm: torch.Tensor, origin: torch.Tensor,
                inv_cell: torch.Tensor, *, cells: int = CELLS,
                n_real: torch.Tensor | None = None, split: int | None = None,
                inv_cell8: torch.Tensor | None = None):
    """Quantize (L, 4, W) float32 tiles to uint16 grid cells.

    ``n_real`` (L,) int32: the real slots of each level, every slot at or
    past ``n_real[l]`` holding ``NEVER_MBR`` (a schedule's padding).  On
    the card those slots are written as the sentinel without being read.
    ``split`` (in ``[0, L]``) with ``inv_cell8`` (4,) float32: also
    quantize levels ``[0, split)`` onto the ``CELLS8`` grid as uint8, from
    the same loads, and return ``(mbr_q, mbr_q8)``.

    A CUDA tensor goes to ``csrc/quantize.cu`` (one launch), a CPU tensor
    to :func:`quantize_cm_torch`.  Every argument is checked first.
    """
    _lib.require(mbr_cm, "mbr_cm", torch.float32)
    if mbr_cm.dim() != 3 or mbr_cm.shape[1] != 4:
        raise ValueError(f"mbr_cm must be (L, 4, W), got {tuple(mbr_cm.shape)}")
    levels, _, width = mbr_cm.shape
    dev = mbr_cm.device
    _lib.require(origin, "origin", torch.float32, (4,))
    _lib.require(inv_cell, "inv_cell", torch.float32, (4,))
    _lib.require_device({"origin": origin, "inv_cell": inv_cell}, dev)
    if not 0 < cells < 65535:
        raise ValueError(f"cells must be in (0, 65535), got {cells}")
    if (split is None) != (inv_cell8 is None):
        raise ValueError("split and inv_cell8 go together")
    if split is not None:
        if not 0 <= split <= levels:
            raise ValueError(f"split must be in [0, {levels}], got {split}")
        _require_arg(inv_cell8, "inv_cell8", torch.float32, (4,), dev)
    if n_real is not None:
        _require_arg(n_real, "n_real", torch.int32, (levels,), dev)
        values = n_real.tolist()  # one small copy to the host
        if any(not 0 <= v <= width for v in values):
            raise ValueError(f"n_real must lie in [0, W = {width}], got {values}")
    kw = dict(cells=cells, n_real=n_real, split=split, inv_cell8=inv_cell8)
    if dev.type == "cpu":
        return quantize_cm_torch(mbr_cm, origin, inv_cell, **kw)
    if dev.type != "cuda":
        raise ValueError(f"quantize_cm runs on cuda or cpu, not {dev}")
    mbr_q = torch.empty(mbr_cm.shape, dtype=torch.uint16, device=dev)
    mbr_q8 = (None if split is None else
              torch.empty((split, 4, width), dtype=torch.uint8, device=dev))
    _quantize_cm_into(mbr_q, mbr_q8, mbr_cm, origin, inv_cell, **kw)
    return mbr_q if split is None else (mbr_q, mbr_q8)


def _quantize_cm_into(mbr_q: torch.Tensor, mbr_q8: torch.Tensor | None,
                      mbr_cm: torch.Tensor, origin: torch.Tensor, inv_cell: torch.Tensor, *,
                      cells: int, n_real: torch.Tensor | None, split: int | None,
                      inv_cell8: torch.Tensor | None) -> None:
    """Kernel #5 into ``mbr_q`` ((L, 4, W) uint16) and, with ``split``,
    ``mbr_q8`` ((split, 4, W) uint8), contiguous on the tiles' card; the
    other arguments as :func:`quantize_cm` checks them.  The kernel stores
    every output element and reads none, so what the outputs held does not
    matter, and their bases need no alignment (``chip_smoke.py`` fills
    them first, and offsets them)."""
    _require_arg(mbr_q, "mbr_q", torch.uint16, tuple(mbr_cm.shape), mbr_cm.device)
    if split is not None:
        _require_arg(mbr_q8, "mbr_q8", torch.uint8, (split, 4, mbr_cm.shape[2]),
                     mbr_cm.device)
    lib = _lib.load()
    rc = lib.repro_quantize_cm(
        mbr_cm.data_ptr(), origin.data_ptr(), inv_cell.data_ptr(),
        None if inv_cell8 is None else inv_cell8.data_ptr(),
        None if n_real is None else n_real.data_ptr(), mbr_q.data_ptr(),
        mbr_q8.data_ptr() if split else None, mbr_cm.shape[0], mbr_cm.shape[2],
        split or 0, cells, CELLS8, _lib.stream_of(mbr_cm),
    )
    _lib.check(rc, "quantize_cm")
    _lib.counters.add("quantize_cm")


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
    if split is None:
        split = max(schedule.levels - 1, 0) if upper8 else 0
    # The schedule's padding lies past n_real as NEVER_MBR: the kernel
    # writes it without reading it.
    kw = dict(n_real=schedule.n_real)
    inv_cell8 = None
    if upper8 and split > 0:
        _, inv_cell8 = grid_params(schedule, cells=CELLS8)
        kw.update(split=split, inv_cell8=inv_cell8)
    fn = quantize_cm if engine == "kernel" else quantize_cm_torch
    tiles = fn(schedule.mbr_cm, origin, inv_cell, **kw)
    mbr_q, mbr_q8 = tiles if inv_cell8 is not None else (tiles, None)
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
