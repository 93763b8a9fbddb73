"""Fused multi-level region search over a level schedule.

Counterpart of ``repro.kernels.pyramid_scan``: the resident sweeps, the
streaming sweep with its dead-window skip, and the live-update sweeps.

:func:`level_sweep` computes the (L, Q, W) per-level active mask with the
recurrence of ``_act_formula``; :func:`level_sweep_hier` does the same
over uint8 upper and uint16 lower tiles (``precision="compact8"``);
:func:`level_sweep_stream` (``stream=True``) computes the same mask and
skips the tiles :func:`parent_windows` proves dead, counting them.  On a
CUDA tensor each launches ``csrc/level_sweep.cu`` once per level, on a CPU
tensor it runs its plain version.  A plain-torch epilogue reduces the mask
to object hits and per-level access counts, identical to the host pointer
search / ``bulk.pyramid_search``, and masks tombstoned ids on the live
path (:func:`fused_search_live`, :func:`fused_search_compact_live`, whose
delta-buffer levels are flat: ``uncond_from = base_levels``).
:func:`per_level_region_search` is the per-level launch plan: one
``mbr_scan`` launch per level, the frontier combined on the device.
With :func:`repro_torch.obs.collect_launch_reports` armed, the kernel
engine of :func:`pyramid_scan`, :func:`pyramid_scan_compact` and
:func:`pyramid_scan_compact8` emits one
:class:`~repro_torch.obs.LaunchReport` a call (the card's bytes,
:mod:`repro_torch.obs.counters`); disarmed, that costs one flag check.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.flat import LevelSchedule, QuantizedSchedule, overlaps
from repro_torch.obs import counters as _obs_counters

from . import _lib

ENGINES = ("kernel", "torch")


def _sweep_dtypes(queries, mbr_cm, parent, stream=False):
    """Validate the tile / query / parent type combination the kernel
    takes; returns ``(tile_u16, parent_u16)``.  The streaming kernel also
    takes float32 tiles with uint16 parents."""
    if mbr_cm.dtype == torch.float32:
        if queries.dtype != torch.float32:
            raise TypeError("float32 tiles need float32 queries")
        if parent.dtype == torch.uint16 and stream:
            return False, True
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


def _check_sweep_args(queries, mbr_cm, parent, stream=False):
    if mbr_cm.dim() != 3 or mbr_cm.shape[1] != 4:
        raise ValueError(f"mbr_cm must be (L, 4, W), got {tuple(mbr_cm.shape)}")
    levels, _, width = mbr_cm.shape
    tile_u16, parent_u16 = _sweep_dtypes(queries, mbr_cm, parent, stream)
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
                uncond_from: int | None = None, stream: bool = False,
                win_off: torch.Tensor | None = None,
                win_w: int | None = None) -> torch.Tensor:
    """Run the fused sweep; returns the (L, Q, W) bool active mask.

    Tiles are float32 (with float32 queries and int32 parents) or uint16
    (with int32 grid-cell queries and uint16 or int32 parents).
    ``uncond_from`` marks the first flat level (no parent gate); ``None``
    keeps the whole sweep hierarchical.  ``block_w`` is the kernel's thread
    block width over slots (a multiple of 32, at most 1024).

    ``stream=True`` runs :func:`level_sweep_stream` (the same mask, bit for
    bit, with the dead-window skip); it needs the ``(win_off, win_w)`` pair
    of :func:`parent_windows` computed with the same ``block_w`` and
    ``uncond_from``.
    """
    if stream:
        if win_off is None or win_w is None:
            raise ValueError("stream=True needs (win_off, win_w) from parent_windows()")
        return level_sweep_stream(
            queries, mbr_cm, parent, win_off, win_w, block_w=block_w,
            root_unconditional=root_unconditional, uncond_from=uncond_from,
        )[0]
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


def parent_windows(parent, n_real, *, block_w: int, uncond_from: int | None = None,
                   levels: int | None = None, win_unit: int = 128
                   ) -> Tuple[np.ndarray, int]:
    """Per-tile parent-window metadata for the streaming sweep (host
    numpy, a copy of the reference's).

    For every (level, tile) of the padded grid, the window ``[off, off +
    win_w)`` covers the parent slots of the tile's real entries, with ONE
    ``win_w`` (the widest span over all tiles, rounded up to ``win_unit``
    and capped at the padded width, so adversarial orderings degrade to a
    full-width window rather than a wrong answer).  Statically empty tiles
    (every slot past ``n_real[l]``) get ``off = -1`` at every level.
    ``parent`` and ``n_real`` may be tensors on any device.

    Returns ``(win_off (levels, T) int32, win_w int)``.
    """
    if isinstance(parent, torch.Tensor):
        parent = parent.cpu().to(torch.int64).numpy()
    if isinstance(n_real, torch.Tensor):
        n_real = n_real.cpu().numpy()
    parent = np.asarray(parent)
    n_real = np.asarray(n_real)
    n_levels, w = parent.shape
    if levels is None:
        levels = n_levels
    if uncond_from is None:
        uncond_from = n_levels
    pad = (-w) % block_w
    wp = w + pad
    n_tiles = wp // block_w
    big = np.iinfo(np.int64).max
    tmin = np.full((levels, n_tiles), big, np.int64)
    tmax = np.full((levels, n_tiles), -1, np.int64)
    gate_top = min(n_levels, uncond_from, len(n_real), levels)
    for l in range(1, gate_top):
        nr = int(n_real[l])
        p = parent[l].astype(np.int64)
        valid = np.arange(w) < nr
        lo = np.concatenate([np.where(valid, p, big), np.full(pad, big)])
        hi = np.concatenate([np.where(valid, p, -1), np.full(pad, -1)])
        tmin[l] = lo.reshape(n_tiles, block_w).min(axis=1)
        tmax[l] = hi.reshape(n_tiles, block_w).max(axis=1)
    spans = np.where(tmax >= tmin, tmax - tmin + 1, 1)
    span = max(1, int(spans.max()))
    win_w = min(wp, int(-(-span // win_unit)) * win_unit)
    win_w = max(win_w, min(wp, win_unit))
    off = np.where(tmin == big, 0, np.minimum(tmin, wp - win_w))
    off = np.clip(off, 0, max(wp - win_w, 0)).astype(np.int32)
    tidx = np.arange(n_tiles) * block_w
    for l in range(min(levels, n_levels, len(n_real))):
        off[l, tidx >= int(n_real[l])] = -1
    return np.ascontiguousarray(off), win_w


def _check_windows(win_off, win_w, levels: int, width: int, block_w: int, device):
    n_tiles = -(-width // block_w)
    _lib.require(win_off, "win_off", torch.int32, (levels, n_tiles))
    _lib.require_device({"win_off": win_off}, device)
    if int(win_w) < 1:
        raise ValueError(f"win_w must be >= 1, got {win_w}")


def _stream_skips(act_prev: torch.Tensor | None, win_off_l: torch.Tensor,
                  win_w: int, width: int) -> torch.Tensor:
    """The dead-window rule for one level: (T,) bool, True where the tile
    is skipped.  ``act_prev`` is level l-1's (Q, W) mask when level l is
    gated, else None (then only statically empty tiles are skipped)."""
    skip = win_off_l < 0
    if act_prev is None:
        return skip
    alive = act_prev.any(dim=0).to(torch.int64)                       # (W,)
    prefix = torch.cat([alive.new_zeros(1), torch.cumsum(alive, 0)])  # (W+1,)
    off = win_off_l.to(torch.int64)
    lo = off.clamp(0, width)
    hi = (off + int(win_w)).clamp(0, width)
    return skip | (prefix[hi] == prefix[lo])


def level_sweep_stream_torch(queries: torch.Tensor, mbr_cm: torch.Tensor,
                             parent: torch.Tensor, win_off: torch.Tensor,
                             win_w: int, *, block_w: int = 128,
                             root_unconditional: bool = True,
                             uncond_from: int | None = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the streaming sweep: ``(act (L, Q, W) bool,
    tiles_skipped int64 0-d)``.

    Level by level, tile t of level l is skipped when ``win_off[l, t] < 0``
    or when the level is gated (``0 < l < uncond_from``) and no slot of
    level l-1 in ``[win_off[l, t], win_off[l, t] + win_w)`` survived for any
    query; a skipped tile's mask is zero, the rest follow the recurrence of
    :func:`level_sweep_torch`.
    """
    levels, _, width = mbr_cm.shape
    uncond = levels if uncond_from is None else uncond_from
    par = parent.to(torch.int64)
    nq = queries.shape[0]
    act = torch.empty((levels, nq, width), dtype=torch.bool, device=mbr_cm.device)
    skipped = torch.zeros((), dtype=torch.int64, device=mbr_cm.device)
    for l in range(levels):
        gated = 0 < l < uncond
        skip = _stream_skips(act[l - 1] if gated else None, win_off[l], win_w, width)
        skipped += skip.sum()
        if l == 0 and root_unconditional:
            a = torch.zeros((nq, width), dtype=torch.bool, device=mbr_cm.device)
            a[:, 0] = True
        else:
            a = _overlap_level(queries, mbr_cm[l])
            if gated:
                a = a & act[l - 1][:, par[l]]
        cols = skip.repeat_interleave(block_w)[:width]
        act[l] = a & ~cols[None, :]
    return act, skipped


def level_sweep_stream(queries: torch.Tensor, mbr_cm: torch.Tensor,
                       parent: torch.Tensor, win_off: torch.Tensor, win_w: int, *,
                       block_w: int = 128, root_unconditional: bool = True,
                       uncond_from: int | None = None,
                       skipped: torch.Tensor | None = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streaming sweep (``stream=True``): ``(act (L, Q, W) bool,
    skipped int64 0-d)``.  The mask equals :func:`level_sweep`'s bit for
    bit; ``skipped`` counts the (level, tile) pairs whose tile and parent
    reads the dead-window rule saved (see :func:`level_sweep_stream_torch`).
    ``win_off`` is the (L, T) int32 tensor and ``win_w`` the width from
    :func:`parent_windows` at this ``block_w`` and ``uncond_from``.

    Pass ``skipped`` (a 0-d int64 tensor on the sweep's device) to add the
    count to it, as the kernel does with an atomic, without a host sync.
    Tiles are float32 or uint16, each with int32 or uint16 parents.
    """
    tile_u16, parent_u16 = _check_sweep_args(queries, mbr_cm, parent, stream=True)
    _lib.require_block(block_w, "block_w")
    levels, _, width = mbr_cm.shape
    _check_windows(win_off, win_w, levels, width, block_w, mbr_cm.device)
    win_w = min(int(win_w), -(-width // block_w) * block_w)
    if skipped is None:
        skipped = torch.zeros((), dtype=torch.int64, device=mbr_cm.device)
    else:
        _lib.require(skipped, "skipped", torch.int64, ())
        _lib.require_device({"skipped": skipped}, mbr_cm.device)
    if mbr_cm.device.type == "cpu":
        act, n = level_sweep_stream_torch(
            queries, mbr_cm, parent, win_off, win_w, block_w=block_w,
            root_unconditional=root_unconditional, uncond_from=uncond_from,
        )
        skipped += n
        return act, skipped
    if mbr_cm.device.type != "cuda":
        raise ValueError(f"level_sweep_stream runs on cuda or cpu, not {mbr_cm.device}")
    nq = queries.shape[0]
    uncond = levels if uncond_from is None else uncond_from
    lib = _lib.load()
    act = torch.empty((levels, nq, width), dtype=torch.uint8, device=mbr_cm.device)
    workspace = torch.empty((lib.repro_level_sweep_stream_workspace(width),),
                            dtype=torch.uint8, device=mbr_cm.device)
    rc = lib.repro_level_sweep_stream(
        queries.data_ptr(), mbr_cm.data_ptr(), parent.data_ptr(), act.data_ptr(),
        win_off.data_ptr(), win_w, skipped.data_ptr(), workspace.data_ptr(),
        int(tile_u16), int(parent_u16), nq, levels, width,
        int(root_unconditional), uncond, block_w, _lib.stream_of(mbr_cm),
    )
    _lib.check(rc, "level_sweep_stream")
    _lib.counters.add("level_sweep_stream_u16" if tile_u16 else "level_sweep_stream_f32",
                      levels)
    if parent_u16:
        _lib.counters.add("level_sweep_stream_u16p", levels)
    return act.view(torch.bool), skipped


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
                           uncond_from: int | None = None,
                           n_real: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the hierarchical sweep: (L, Q, W) bool mask.
    ``n_real`` is taken and ignored: the slots past it are padding, whose
    tiles never overlap a query, so the mask is zero there either way."""
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
                     uncond_from: int | None = None,
                     n_real: torch.Tensor | None = None) -> torch.Tensor:
    """Hierarchical two-grid sweep; returns the (L, Q, W) bool mask.

    Levels ``< split`` test ``mbr8`` (split, 4, W) uint8 tiles against the
    coarse int32 queries ``q8``; levels ``>= split`` test ``mbr16``
    (L - split, 4, W) uint16 tiles against the fine queries ``q16``.
    ``parent`` is (L, W) int32 or uint16; ``uncond_from`` and ``block_w``
    as in :func:`level_sweep`.  ``n_real`` (L,) int32, a schedule's real
    slots a level: on the card the slots at or past ``n_real[l]`` of a
    tested level are stored zero without being computed, and the tiles
    wholly past it are not read, so the mask there must be zero for every
    query, as it is where those slots are a schedule's padding
    (never-overlap tiles).  On the card, levels of a few waves of blocks
    (the trees') are swept in one launch (and one memset of its flags),
    wider ones (the pyramid's) one launch a level.
    """
    levels, width = _check_hier_args(q8, q16, mbr8, mbr16, parent, split)
    _lib.require_block(block_w, "block_w")
    if n_real is not None:
        _lib.require(n_real, "n_real", torch.int32, (levels,))
        _lib.require_device({"n_real": n_real}, mbr8.device)
    if mbr8.device.type == "cpu":
        return level_sweep_hier_torch(
            q8, q16, mbr8, mbr16, parent, split=split,
            root_unconditional=root_unconditional, uncond_from=uncond_from,
        )
    if mbr8.device.type != "cuda":
        raise ValueError(f"level_sweep_hier runs on cuda or cpu, not {mbr8.device}")
    act = torch.empty((levels, q16.shape[0], width), dtype=torch.uint8, device=mbr8.device)
    _level_sweep_hier_into(act, q8, q16, mbr8, mbr16, parent, split=split, block_w=block_w,
                           root_unconditional=root_unconditional, uncond_from=uncond_from,
                           n_real=n_real)
    return act.view(torch.bool)


def _level_sweep_hier_into(act: torch.Tensor, q8: torch.Tensor, q16: torch.Tensor,
                           mbr8: torch.Tensor, mbr16: torch.Tensor, parent: torch.Tensor, *,
                           split: int, block_w: int, root_unconditional: bool,
                           uncond_from: int | None, n_real: torch.Tensor | None) -> None:
    """Kernel #3 into ``act``, an (L, Q, W) uint8 tensor on the card, the
    other arguments as :func:`level_sweep_hier` checks them.  The kernel
    stores every byte of ``act`` and reads none before it is stored, so
    what ``act`` held does not matter (``chip_smoke.py`` fills it with
    0xFF to show that)."""
    levels, nq, width = act.shape
    if act.dtype != torch.uint8 or not act.is_contiguous() or act.device != mbr8.device:
        raise ValueError("act must be a contiguous uint8 tensor on the tiles' device")
    uncond = levels if uncond_from is None else uncond_from
    parent_u16 = parent.dtype == torch.uint16
    lib = _lib.load()
    scratch = torch.empty((lib.repro_level_sweep_hier_scratch(nq, width, levels, block_w),),
                          dtype=torch.uint8, device=mbr8.device)
    rc = lib.repro_level_sweep_hier(
        q8.data_ptr(), q16.data_ptr(), mbr8.data_ptr(), mbr16.data_ptr(),
        parent.data_ptr(), act.data_ptr(), None if n_real is None else n_real.data_ptr(),
        scratch.data_ptr(), int(parent_u16), nq, levels, split, width,
        int(root_unconditional), uncond, block_w, _lib.stream_of(mbr8),
    )
    _lib.check(rc, "level_sweep_hier")
    _lib.counters.add("level_sweep_hier", levels)
    if parent_u16:
        _lib.counters.add("level_sweep_hier_u16p", levels)


def _quantize_queries(queries: torch.Tensor, origin: torch.Tensor,
                      inv_cell: torch.Tensor, cells: int) -> torch.Tensor:
    """Outward query quantization onto a schedule grid (floor lo, ceil hi,
    clip into the domain) -> (Q, 4) int32 grid cells."""
    t = (queries - origin[None, :]) * inv_cell[None, :]
    qq = torch.cat([torch.floor(t[:, :2]), torch.ceil(t[:, 2:])], dim=1)
    return qq.clamp(0.0, float(cells)).to(torch.int32).contiguous()


def _hits_epilogue(act, queries, gate_mbr, obj_level, obj_slot, obj_id,
                   n_objects: int, alive=None):
    """(L, Q, W) active mask -> ``(hits (Q, n_objects) bool, visits (Q, L)
    int32)``.

    Unused slots carry sentinel MBRs and are never active, so a plain sum
    counts exactly the visited real nodes.  Entry e hits iff its holding
    node is active and (when ``gate_mbr`` is given) its exact float32 MBR
    overlaps the query.  Tree schedules may repeat object ids, so entries
    are OR-reduced per id with an integer ``index_add_`` (never a plain
    assignment, whose duplicate writes would race).  ``alive`` (a
    (n_objects,) bool tombstone mask, live path) drops deleted ids."""
    visits = act.sum(dim=2, dtype=torch.int32).T.contiguous()        # (Q, L)
    hit = act[obj_level.long(), :, obj_slot.long()]                  # (E, Q)
    if gate_mbr is not None:
        hit = hit & overlaps(gate_mbr[:, None, :], queries[None, :, :])
    acc = torch.zeros((max(n_objects, 1), queries.shape[0]), dtype=torch.int32,
                      device=act.device)
    acc.index_add_(0, obj_id, hit.to(torch.int32))
    hits = acc > 0
    if alive is not None:
        hits &= alive[:, None]
    return hits.T.contiguous(), visits


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown sweep engine {engine!r}; expected one of {ENGINES}")


def _sweep(engine: str, queries, mbr_cm, parent, *, block_w, root_unconditional,
           uncond_from=None, stream=False, win_off=None, win_w=None, skipped=None):
    """One sweep by ``engine``; ``stream=True`` runs the streaming sweep
    (its plain version for ``engine="torch"``) and adds its skip count to
    ``skipped`` when given."""
    _check_engine(engine)
    if stream:
        if win_off is None or win_w is None:
            raise ValueError("stream=True needs (win_off, win_w) from parent_windows()")
        if engine == "kernel":
            return level_sweep_stream(
                queries, mbr_cm, parent, win_off, win_w, block_w=block_w,
                root_unconditional=root_unconditional, uncond_from=uncond_from,
                skipped=skipped)[0]
        act, n = level_sweep_stream_torch(
            queries, mbr_cm, parent, win_off, win_w, block_w=block_w,
            root_unconditional=root_unconditional, uncond_from=uncond_from)
        if skipped is not None:
            skipped += n
        return act
    if engine == "kernel":
        return level_sweep(queries, mbr_cm, parent, block_w=block_w,
                           root_unconditional=root_unconditional,
                           uncond_from=uncond_from)
    return level_sweep_torch(queries, mbr_cm, parent,
                             root_unconditional=root_unconditional,
                             uncond_from=uncond_from)


def _armed(engine: str) -> bool:
    """Whether this sweep emits a :class:`repro_torch.obs.LaunchReport`:
    the side channel is armed and the kernel engine runs (the reports
    describe the card's kernels; a plain version emits none)."""
    return engine == "kernel" and _obs_counters.collecting()


def _call_counter(armed: bool, stream: bool, skipped, device):
    """The skip counter to sweep with: a fresh one for an armed streaming
    sweep, whose report needs this call's count alone, else ``skipped``."""
    if armed and stream:
        return torch.zeros((), dtype=torch.int64, device=device)
    return skipped


def stream_windows(parent, n_real, *, block_w: int, device,
                   uncond_from: int | None = None, levels: int | None = None):
    """:func:`parent_windows` with ``win_off`` as an int32 tensor on
    ``device``: ``(win_off, win_w)``."""
    win_off, win_w = parent_windows(parent, n_real, block_w=block_w,
                                    uncond_from=uncond_from, levels=levels)
    return torch.from_numpy(win_off).to(device), win_w


def pyramid_scan(schedule: LevelSchedule, queries: torch.Tensor, *,
                 block_w: int = 128, engine: str = "kernel", stream: bool = False,
                 win_off: torch.Tensor | None = None, win_w: int | None = None,
                 skipped: torch.Tensor | None = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused region search over a :class:`LevelSchedule` with (Q, 4)
    float32 ``queries`` on the schedule's device.  Returns ``(hits (Q,
    n_objects) bool, visits (Q, L) int32)``, identical to the host
    pointer search (tree schedules) / ``bulk.pyramid_search`` (pyramid).
    ``engine="torch"`` sweeps with the plain version on any device.

    ``stream=True`` sweeps with :func:`level_sweep_stream`: the same hits
    and visits.  Its windows are computed here unless ``(win_off, win_w)``
    are given; its skip count is added to ``skipped`` when given."""
    queries = queries.to(device=schedule.device, dtype=torch.float32).contiguous()
    if stream and win_off is None:
        win_off, win_w = stream_windows(schedule.parent, schedule.n_real,
                                        block_w=block_w, device=schedule.device)
    armed = _armed(engine)
    count = _call_counter(armed, stream, skipped, schedule.device)
    act = _sweep(
        engine, queries, schedule.mbr_cm, schedule.parent, block_w=block_w,
        root_unconditional=schedule.root_unconditional, stream=stream,
        win_off=win_off, win_w=win_w, skipped=count,
    )
    if armed:  # side channel: the kernel path only
        if stream and skipped is not None:
            skipped += count
        _obs_counters.emit(_obs_counters.scan_report_float32(
            schedule, queries, block_w=block_w, stream=stream, win_off=win_off,
            skipped=count))
    return _hits_epilogue(
        act, queries, schedule.obj_mbr if schedule.test_object_mbr else None,
        schedule.obj_level, schedule.obj_slot, schedule.obj_id,
        schedule.n_objects,
    )


def pyramid_scan_compact(qsched: QuantizedSchedule, queries: torch.Tensor, *,
                         block_w: int = 128, engine: str = "kernel",
                         stream: bool = False, win_off: torch.Tensor | None = None,
                         win_w: int | None = None,
                         skipped: torch.Tensor | None = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused region search over uint16 tiles + exact float32 confirming
    pass.  Queries are quantized outward, so the integer sweep's survivors
    are a superset of the exact sweep's; the confirming pass against
    ``confirm_mbr`` makes hit sets identical to :func:`pyramid_scan`.
    ``visits`` counts the (conservative) accesses this path performed.
    ``stream``, ``win_off``, ``win_w`` and ``skipped`` as in
    :func:`pyramid_scan`."""
    queries = queries.to(device=qsched.device, dtype=torch.float32).contiguous()
    qq = _quantize_queries(queries, qsched.origin, qsched.inv_cell, qsched.cells)
    base = qsched.base
    if stream and win_off is None:
        win_off, win_w = stream_windows(qsched.parent_q, base.n_real,
                                        block_w=block_w, device=qsched.device)
    armed = _armed(engine)
    count = _call_counter(armed, stream, skipped, qsched.device)
    act = _sweep(
        engine, qq, qsched.mbr_q, qsched.parent_q, block_w=block_w,
        root_unconditional=base.root_unconditional, stream=stream,
        win_off=win_off, win_w=win_w, skipped=count,
    )
    if armed:  # side channel: the kernel path only
        if stream and skipped is not None:
            skipped += count
        _obs_counters.emit(_obs_counters.scan_report_compact(
            qsched, queries, block_w=block_w, stream=stream, win_off=win_off,
            skipped=count))
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
                 split=split, root_unconditional=base.root_unconditional,
                 n_real=base.n_real, **kw)
    if _armed(engine):  # side channel: the kernel path only
        _obs_counters.emit(_obs_counters.scan_report_compact8(qsched, queries,
                                                              block_w=block_w))
    return _hits_epilogue(
        act, queries, qsched.confirm_mbr, base.obj_level, base.obj_slot,
        base.obj_id, base.n_objects,
    )


def fused_search_live(queries: torch.Tensor, mbr_cm, parent, obj_mbr, obj_level,
                      obj_slot, obj_id, alive, *, n_objects: int, base_levels: int,
                      block_w: int = 128, root_unconditional: bool = True,
                      test_object_mbr: bool = True, engine: str = "kernel",
                      stream: bool = False, win_off: torch.Tensor | None = None,
                      win_w: int | None = None, skipped: torch.Tensor | None = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused sweep over base levels + appended flat delta levels (the
    live-update layout of ``repro.update``): levels ``>= base_levels`` are
    swept without the parent gate, entries scatter into the global-id hit
    mask, and ``alive`` masks tombstoned ids.  Returns ``(hits (Q,
    n_objects), visits (Q, L + D))``; visit columns past ``base_levels``
    are delta-buffer accesses.  ``stream=True`` needs ``(win_off, win_w)``
    from :func:`parent_windows` with ``uncond_from=base_levels``."""
    queries = queries.to(device=mbr_cm.device, dtype=torch.float32).contiguous()
    act = _sweep(
        engine, queries, mbr_cm, parent, block_w=block_w,
        root_unconditional=root_unconditional, uncond_from=base_levels,
        stream=stream, win_off=win_off, win_w=win_w, skipped=skipped,
    )
    return _hits_epilogue(
        act, queries, obj_mbr if test_object_mbr else None, obj_level, obj_slot,
        obj_id, n_objects, alive=alive,
    )


def fused_search_compact_live(queries: torch.Tensor, mbr_q, parent_q, confirm_mbr,
                              obj_level, obj_slot, obj_id, origin, inv_cell, alive, *,
                              n_objects: int, cells: int, base_levels: int,
                              block_w: int = 128, root_unconditional: bool = True,
                              engine: str = "kernel", stream: bool = False,
                              win_off: torch.Tensor | None = None,
                              win_w: int | None = None,
                              skipped: torch.Tensor | None = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact (uint16-tile) twin of :func:`fused_search_live`: delta rows
    quantized onto the base grid (``quantize.quantize_rows``) sweep as flat
    levels of the same integer sweep, every entry is confirmed against its
    exact float32 MBR, and tombstones are masked, so hit sets equal the
    float32 live path."""
    queries = queries.to(device=mbr_q.device, dtype=torch.float32).contiguous()
    qq = _quantize_queries(queries, origin, inv_cell, cells)
    act = _sweep(
        engine, qq, mbr_q, parent_q, block_w=block_w,
        root_unconditional=root_unconditional, uncond_from=base_levels,
        stream=stream, win_off=win_off, win_w=win_w, skipped=skipped,
    )
    return _hits_epilogue(
        act, queries, confirm_mbr, obj_level, obj_slot, obj_id, n_objects,
        alive=alive,
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
