"""Fused multi-level region search over a level schedule.

Counterpart of ``repro.kernels.pyramid_scan`` (the resident sweeps; the
HBM-streaming variant is not ported yet).

:func:`level_sweep` computes the (L, Q, W) per-level active mask with the
recurrence of ``_act_formula``; :func:`level_sweep_hier` does the same
over uint8 upper and uint16 lower tiles (``precision="compact8"``).  On a
CUDA tensor each launches ``csrc/level_sweep.cu`` once per level, on a CPU
tensor it runs its plain version.  A plain-torch epilogue reduces the mask
to object hits and per-level access counts, identical to the host pointer
search / ``bulk.pyramid_search``.  :func:`per_level_region_search` is the
per-level launch plan: one ``mbr_scan`` launch per level, the frontier
combined on the device.
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


def _overlap_level(queries: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """(Q, 4) queries vs one (4, W) coordinate-major tile -> (Q, W) bool.
    Narrow integer tiles are widened to int32 first (uint16 has little op
    support in PyTorch)."""
    if tile.dtype != torch.float32:
        tile = tile.to(torch.int32)
    qlx, qly, qhx, qhy = (queries[:, c:c + 1] for c in range(4))
    return (tile[0] <= qhx) & (qlx <= tile[2]) & (tile[1] <= qhy) & (qly <= tile[3])


def _sweep_levels_torch(ov_of, levels: int, nq: int, width: int, parent,
                        *, root_unconditional: bool, uncond_from: int | None):
    """The recurrence of ``_act_formula`` over ``ov_of(l)`` -> (L, Q, W)."""
    uncond = levels if uncond_from is None else uncond_from
    par = parent.to(torch.int64)
    act = torch.empty((levels, nq, width), dtype=torch.bool, device=parent.device)
    for l in range(levels):
        ov = ov_of(l)
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


def level_sweep_torch(queries: torch.Tensor, mbr_cm: torch.Tensor,
                      parent: torch.Tensor, *, root_unconditional: bool = True,
                      uncond_from: int | None = None) -> torch.Tensor:
    """Plain version of the sweep: (L, Q, W) bool active mask."""
    levels, _, width = mbr_cm.shape
    return _sweep_levels_torch(
        lambda l: _overlap_level(queries, mbr_cm[l]), levels, queries.shape[0],
        width, parent, root_unconditional=root_unconditional,
        uncond_from=uncond_from,
    )


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
    _lib.require_block(block_w, "block_w")
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
    if parent_u16:
        _lib.counters.add("level_sweep_u16p", levels)
    return act.view(torch.bool)


def _check_hier_args(q8, q16, mbr8, mbr16, parent, split):
    if mbr8.dim() != 3 or mbr8.shape[1] != 4 or mbr16.dim() != 3 or mbr16.shape[1] != 4:
        raise ValueError(f"mbr8 and mbr16 must be (L, 4, W), got {tuple(mbr8.shape)} "
                         f"and {tuple(mbr16.shape)}")
    if mbr8.shape[0] != split or split < 1:
        raise ValueError(f"split must equal mbr8's level count (>= 1), got {split} "
                         f"for {mbr8.shape[0]} uint8 levels")
    if mbr8.shape[2] != mbr16.shape[2]:
        raise ValueError("mbr8 and mbr16 must have the same width")
    levels, width = split + mbr16.shape[0], mbr16.shape[2]
    _lib.require(q8, "q8", torch.int32, (q16.shape[0], 4))
    _lib.require(q16, "q16", torch.int32, (q16.shape[0], 4))
    _lib.require(mbr8, "mbr8", torch.uint8)
    _lib.require(mbr16, "mbr16", torch.uint16)
    if parent.dtype not in (torch.int32, torch.uint16):
        raise TypeError(f"parent must be int32 or uint16, got {parent.dtype}")
    _lib.require(parent, "parent", parent.dtype, (levels, width))
    _lib.require_device({"q8": q8, "q16": q16, "mbr16": mbr16, "parent": parent},
                        mbr8.device)
    return levels, width


def level_sweep_hier_torch(q8: torch.Tensor, q16: torch.Tensor, mbr8: torch.Tensor,
                           mbr16: torch.Tensor, parent: torch.Tensor, *, split: int,
                           root_unconditional: bool = True,
                           uncond_from: int | None = None) -> torch.Tensor:
    """Plain version of the hierarchical sweep: (L, Q, W) bool mask."""
    levels, width = split + mbr16.shape[0], mbr16.shape[2]

    def ov_of(l):
        if l < split:
            return _overlap_level(q8, mbr8[l])
        return _overlap_level(q16, mbr16[l - split])

    return _sweep_levels_torch(
        ov_of, levels, q16.shape[0], width, parent,
        root_unconditional=root_unconditional, uncond_from=uncond_from,
    )


def level_sweep_hier(q8: torch.Tensor, q16: torch.Tensor, mbr8: torch.Tensor,
                     mbr16: torch.Tensor, parent: torch.Tensor, *, split: int,
                     block_w: int = 128, root_unconditional: bool = True,
                     uncond_from: int | None = None) -> torch.Tensor:
    """Hierarchical two-grid sweep; returns the (L, Q, W) bool mask.

    Levels ``< split`` test ``mbr8`` (split, 4, W) uint8 tiles against the
    coarse int32 queries ``q8``; levels ``>= split`` test ``mbr16``
    (L - split, 4, W) uint16 tiles against the fine queries ``q16``.
    ``parent`` is (L, W) int32 or uint16; ``uncond_from`` and ``block_w``
    as in :func:`level_sweep`.
    """
    levels, width = _check_hier_args(q8, q16, mbr8, mbr16, parent, split)
    _lib.require_block(block_w, "block_w")
    if mbr8.device.type == "cpu":
        return level_sweep_hier_torch(
            q8, q16, mbr8, mbr16, parent, split=split,
            root_unconditional=root_unconditional, uncond_from=uncond_from,
        )
    if mbr8.device.type != "cuda":
        raise ValueError(f"level_sweep_hier runs on cuda or cpu, not {mbr8.device}")
    nq = q16.shape[0]
    uncond = levels if uncond_from is None else uncond_from
    parent_u16 = parent.dtype == torch.uint16
    act = torch.empty((levels, nq, width), dtype=torch.uint8, device=mbr8.device)
    rc = _lib.load().repro_level_sweep_hier(
        q8.data_ptr(), q16.data_ptr(), mbr8.data_ptr(), mbr16.data_ptr(),
        parent.data_ptr(), act.data_ptr(), int(parent_u16), nq, levels, split,
        width, int(root_unconditional), uncond, block_w, _lib.stream_of(mbr8),
    )
    _lib.check(rc, "level_sweep_hier")
    _lib.counters.add("level_sweep_hier", levels)
    if parent_u16:
        _lib.counters.add("level_sweep_hier_u16p", levels)
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


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown sweep engine {engine!r}; expected one of {ENGINES}")


def _sweep(engine: str, queries, mbr_cm, parent, *, block_w, root_unconditional):
    _check_engine(engine)
    if engine == "kernel":
        return level_sweep(queries, mbr_cm, parent, block_w=block_w,
                           root_unconditional=root_unconditional)
    return level_sweep_torch(queries, mbr_cm, parent,
                             root_unconditional=root_unconditional)


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


def pyramid_scan_compact8(qsched: QuantizedSchedule, queries: torch.Tensor, *,
                          block_w: int = 128, engine: str = "kernel"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused region search over the hierarchical form of a
    :class:`QuantizedSchedule` (``quantize_schedule(..., upper8=True)``):
    uint8 tiles on the coarse grid for the upper ``split`` levels, uint16
    below, exact float32 confirming pass.  Hit sets equal every other
    precision; ``visits`` counts this path's (conservative) accesses.  A
    single-level schedule (``split == 0``) sweeps as plain compact."""
    if not qsched.hierarchical and qsched.levels > 1:
        raise ValueError("pyramid_scan_compact8 needs quantize_schedule(..., upper8=True)")
    _check_engine(engine)
    queries = queries.to(device=qsched.device, dtype=torch.float32).contiguous()
    base = qsched.base
    split = qsched.split
    qq16 = _quantize_queries(queries, qsched.origin, qsched.inv_cell, qsched.cells)
    if split == 0:
        act = _sweep(engine, qq16, qsched.mbr_q, qsched.parent_q, block_w=block_w,
                     root_unconditional=base.root_unconditional)
    else:
        qq8 = _quantize_queries(queries, qsched.origin, qsched.inv_cell8, qsched.cells8)
        fn = level_sweep_hier if engine == "kernel" else level_sweep_hier_torch
        kw = {"block_w": block_w} if engine == "kernel" else {}
        act = fn(qq8, qq16, qsched.mbr_q8, qsched.mbr_q[split:], qsched.parent_q,
                 split=split, root_unconditional=base.root_unconditional, **kw)
    return _hits_epilogue(
        act, queries, qsched.confirm_mbr, base.obj_level, base.obj_slot,
        base.obj_id, base.n_objects,
    )


def per_level_region_search(schedule: LevelSchedule, queries: torch.Tensor, *,
                            block_w: int = 128, engine: str = "kernel"
                            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The per-level launch plan: ONE ``mbr_scan`` launch per level over the
    float32 tiles, with the survivor frontier combined on the device by
    torch ops (no host round trip and no sync between levels).  Returns
    ``(hits, visits, n_launches)`` with hits and visits equal to
    :func:`pyramid_scan`.  ``block_w`` is ``mbr_scan``'s block width."""
    from .mbr_scan import mbr_scan_cm, mbr_scan_torch

    _check_engine(engine)
    queries = queries.to(device=schedule.device, dtype=torch.float32).contiguous()
    levels, _, width = schedule.mbr_cm.shape

    def ov_of(l):
        if engine == "kernel":
            return mbr_scan_cm(schedule.mbr_cm[l], queries, block_n=block_w)
        return mbr_scan_torch(schedule.mbr_cm[l].T, queries)

    act = _sweep_levels_torch(
        ov_of, levels, queries.shape[0], width, schedule.parent,
        root_unconditional=schedule.root_unconditional, uncond_from=None,
    )
    launches = levels  # level 0 is scanned even where the root is unconditional
    hits, visits = _hits_epilogue(
        act, queries, schedule.obj_mbr if schedule.test_object_mbr else None,
        schedule.obj_level, schedule.obj_slot, schedule.obj_id, schedule.n_objects,
    )
    return hits, visits, launches
