"""Fused multi-level region search over a level schedule.

Counterpart of ``repro.kernels.pyramid_scan`` (the resident sweep; the
HBM-streaming and uint8 hierarchical variants are not ported yet).

:func:`level_sweep` computes the (L, Q, W) per-level active mask with the
recurrence of ``_act_formula``; on a CUDA tensor it launches
``csrc/level_sweep.cu`` once per level, on a CPU tensor it runs
:func:`level_sweep_torch`.  A plain-torch epilogue reduces the mask to
object hits and per-level access counts, identical to the host pointer
search / ``bulk.pyramid_search``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.flat import LevelSchedule, QuantizedSchedule, overlaps

from . import _lib

ENGINES = ("kernel", "torch")


def _sweep_dtypes(queries, mbr_cm, parent):
    """Validate the tile / query / parent type combination the kernel
    takes; returns ``(tile_u16, parent_u16)``."""
    if mbr_cm.dtype == torch.float32:
        if queries.dtype != torch.float32:
            raise TypeError("float32 tiles need float32 queries")
        if parent.dtype != torch.int32:
            raise TypeError("float32 tiles need int32 parents")
        return False, False
    if mbr_cm.dtype == torch.uint16:
        if queries.dtype != torch.int32:
            raise TypeError("uint16 tiles need int32 (grid-cell) queries")
        if parent.dtype not in (torch.int32, torch.uint16):
            raise TypeError(f"parent must be int32 or uint16, got {parent.dtype}")
        return True, parent.dtype == torch.uint16
    raise TypeError(f"mbr_cm must be float32 or uint16, got {mbr_cm.dtype}")


def _check_sweep_args(queries, mbr_cm, parent):
    if mbr_cm.dim() != 3 or mbr_cm.shape[1] != 4:
        raise ValueError(f"mbr_cm must be (L, 4, W), got {tuple(mbr_cm.shape)}")
    levels, _, width = mbr_cm.shape
    tile_u16, parent_u16 = _sweep_dtypes(queries, mbr_cm, parent)
    _lib.require(queries, "queries", queries.dtype, (queries.shape[0], 4))
    _lib.require(mbr_cm, "mbr_cm", mbr_cm.dtype)
    _lib.require(parent, "parent", parent.dtype, (levels, width))
    _lib.require_device({"queries": queries, "parent": parent}, mbr_cm.device)
    return tile_u16, parent_u16


def level_sweep_torch(queries: torch.Tensor, mbr_cm: torch.Tensor,
                      parent: torch.Tensor, *, root_unconditional: bool = True,
                      uncond_from: int | None = None) -> torch.Tensor:
    """Plain version of the sweep: (L, Q, W) bool active mask.

    uint16 tiles and parents are widened to int32 before any compare or
    index (uint16 has little op support in PyTorch)."""
    levels, _, width = mbr_cm.shape
    nq = queries.shape[0]
    uncond = levels if uncond_from is None else uncond_from
    tiles = mbr_cm if mbr_cm.dtype == torch.float32 else mbr_cm.to(torch.int32)
    par = parent.to(torch.int64)
    qlx, qly, qhx, qhy = (queries[:, c:c + 1] for c in range(4))
    act = torch.empty((levels, nq, width), dtype=torch.bool, device=mbr_cm.device)
    for l in range(levels):
        m = tiles[l]
        ov = (m[0] <= qhx) & (qlx <= m[2]) & (m[1] <= qhy) & (qly <= m[3])
        if l == 0:
            if root_unconditional:
                act[0] = False
                act[0, :, 0] = True
            else:
                act[0] = ov
        elif l >= uncond:
            act[l] = ov  # flat appendix levels: no parent gate
        else:
            act[l] = ov & act[l - 1][:, par[l]]
    return act


def level_sweep(queries: torch.Tensor, mbr_cm: torch.Tensor,
                parent: torch.Tensor, *, block_w: int = 128,
                root_unconditional: bool = True,
                uncond_from: int | None = None) -> torch.Tensor:
    """Run the fused sweep; returns the (L, Q, W) bool active mask.

    Tiles are float32 (with float32 queries and int32 parents) or uint16
    (with int32 grid-cell queries and uint16 or int32 parents).
    ``uncond_from`` marks the first flat level (no parent gate); ``None``
    keeps the whole sweep hierarchical.  ``block_w`` is the kernel's thread
    block width over slots (a multiple of 32, at most 1024).
    """
    tile_u16, parent_u16 = _check_sweep_args(queries, mbr_cm, parent)
    if block_w % 32 or not 32 <= block_w <= 1024:
        raise ValueError(f"block_w must be a multiple of 32 in [32, 1024], got {block_w}")
    if mbr_cm.device.type == "cpu":
        return level_sweep_torch(
            queries, mbr_cm, parent, root_unconditional=root_unconditional,
            uncond_from=uncond_from,
        )
    if mbr_cm.device.type != "cuda":
        raise ValueError(f"level_sweep runs on cuda or cpu, not {mbr_cm.device}")
    levels, _, width = mbr_cm.shape
    nq = queries.shape[0]
    uncond = levels if uncond_from is None else uncond_from
    lib = _lib.load()
    act = torch.empty((levels, nq, width), dtype=torch.uint8, device=mbr_cm.device)
    rc = lib.repro_level_sweep(
        queries.data_ptr(), mbr_cm.data_ptr(), parent.data_ptr(), act.data_ptr(),
        int(tile_u16), int(parent_u16), nq, levels, width,
        int(root_unconditional), uncond, block_w, _lib.stream_of(mbr_cm),
    )
    _lib.check(rc, "level_sweep")
    _lib.counters.add("level_sweep_u16" if tile_u16 else "level_sweep_f32", levels)
    return act.view(torch.bool)


def _quantize_queries(queries: torch.Tensor, origin: torch.Tensor,
                      inv_cell: torch.Tensor, cells: int) -> torch.Tensor:
    """Outward query quantization onto a schedule grid (floor lo, ceil hi,
    clip into the domain) -> (Q, 4) int32 grid cells."""
    t = (queries - origin[None, :]) * inv_cell[None, :]
    qq = torch.cat([torch.floor(t[:, :2]), torch.ceil(t[:, 2:])], dim=1)
    return qq.clamp(0.0, float(cells)).to(torch.int32).contiguous()


def _hits_epilogue(act, queries, gate_mbr, obj_level, obj_slot, obj_id,
                   n_objects: int):
    """(L, Q, W) active mask -> ``(hits (Q, n_objects) bool, visits (Q, L)
    int32)``.

    Unused slots carry sentinel MBRs and are never active, so a plain sum
    counts exactly the visited real nodes.  Entry e hits iff its holding
    node is active and (when ``gate_mbr`` is given) its exact float32 MBR
    overlaps the query.  Tree schedules may repeat object ids, so entries
    are OR-reduced per id with an integer ``index_add_`` (never a plain
    assignment, whose duplicate writes would race)."""
    visits = act.sum(dim=2, dtype=torch.int32).T.contiguous()        # (Q, L)
    hit = act[obj_level.long(), :, obj_slot.long()]                  # (E, Q)
    if gate_mbr is not None:
        hit = hit & overlaps(gate_mbr[:, None, :], queries[None, :, :])
    acc = torch.zeros((max(n_objects, 1), queries.shape[0]), dtype=torch.int32,
                      device=act.device)
    acc.index_add_(0, obj_id, hit.to(torch.int32))
    return (acc > 0).T.contiguous(), visits


def _sweep(engine: str, queries, mbr_cm, parent, *, block_w, root_unconditional):
    if engine == "kernel":
        return level_sweep(queries, mbr_cm, parent, block_w=block_w,
                           root_unconditional=root_unconditional)
    if engine == "torch":
        return level_sweep_torch(queries, mbr_cm, parent,
                                 root_unconditional=root_unconditional)
    raise ValueError(f"unknown sweep engine {engine!r}; expected one of {ENGINES}")


def pyramid_scan(schedule: LevelSchedule, queries: torch.Tensor, *,
                 block_w: int = 128, engine: str = "kernel"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused region search over a :class:`LevelSchedule` with (Q, 4)
    float32 ``queries`` on the schedule's device.  Returns ``(hits (Q,
    n_objects) bool, visits (Q, L) int32)``, identical to the host
    pointer search (tree schedules) / ``bulk.pyramid_search`` (pyramid).
    ``engine="torch"`` sweeps with the plain version on any device."""
    queries = queries.to(device=schedule.device, dtype=torch.float32).contiguous()
    act = _sweep(
        engine, queries, schedule.mbr_cm, schedule.parent, block_w=block_w,
        root_unconditional=schedule.root_unconditional,
    )
    return _hits_epilogue(
        act, queries, schedule.obj_mbr if schedule.test_object_mbr else None,
        schedule.obj_level, schedule.obj_slot, schedule.obj_id,
        schedule.n_objects,
    )


def pyramid_scan_compact(qsched: QuantizedSchedule, queries: torch.Tensor, *,
                         block_w: int = 128, engine: str = "kernel"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused region search over uint16 tiles + exact float32 confirming
    pass.  Queries are quantized outward, so the integer sweep's survivors
    are a superset of the exact sweep's; the confirming pass against
    ``confirm_mbr`` makes hit sets identical to :func:`pyramid_scan`.
    ``visits`` counts the (conservative) accesses this path performed."""
    queries = queries.to(device=qsched.device, dtype=torch.float32).contiguous()
    qq = _quantize_queries(queries, qsched.origin, qsched.inv_cell, qsched.cells)
    base = qsched.base
    act = _sweep(
        engine, qq, qsched.mbr_q, qsched.parent_q, block_w=block_w,
        root_unconditional=base.root_unconditional,
    )
    return _hits_epilogue(
        act, queries, qsched.confirm_mbr, base.obj_level, base.obj_slot,
        base.obj_id, base.n_objects,
    )
