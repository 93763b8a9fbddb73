"""Per-launch kernel counter ledger: the bytes the card's sweeps move.

Counterpart of ``repro.obs.counters``, in two parts.

* The ledger math, copied from the reference and held equal to it
  (``tests/test_torch_counters.py``): :func:`survivor_recurrence`,
  :func:`tile_bytes_per_query`, :func:`stream_fetch_bytes`,
  :func:`quantize_queries_grid`.  They are numpy and shape-generic; they
  model the TPU kernel's tile fetches and serve comparisons with the
  reference's benchmarks, not the port's own reports.
* :class:`LaunchReport`, :func:`merge_reports` and the side channel
  (:func:`collect_launch_reports`, :func:`collecting`, :func:`emit`,
  :func:`drain`), copied, with :func:`pending` and ``drain(since)``
  added so that a backend takes only its own reports off the channel
  (ROADMAP C23); and the report functions, derived again for the card.  The reference's count the TPU kernel's DMA (a resident
  ``pallas_call`` fetches its whole grid every launch); the port's count
  the bytes that ``csrc/level_sweep.cu`` loads and stores (ROADMAP C19):

  - ``bytes_streamed``: the MBR lanes and parents the sweep reads, each
    counted once a call (a tile that several query chunks read counts
    once, as the kernel table's bound counts inputs), queries not
    included;
  - ``mask_bytes``: the (L, Q, W) mask written, every byte, plus at most
    one byte of level l-1's mask per computed slot and query of each gated
    level (the kernel reads a slot's parent byte only where the slot
    overlaps its query, so this term is an upper bound);
  - ``tiles_fetched`` / ``tiles_total``: the (level, ``block_w`` tile)
    pairs whose lanes were read, of all of them.

  Each report function's docstring states its formula.  Nothing here
  replays the survivor recurrence: ``survivors_per_level`` comes from the visits'
  column sums, made on the device (the façade fills it in), and the
  streaming sweep's fetch count is the kernel's own device count of the
  tiles it skipped (ROADMAP C6).

The side channel is opt-in and disarmed by default: each emitting wrapper
then costs one flag check.  Armed, a report function reads a few small
device values (``n_real``, a skip count) and so waits for the device; that is
for forensics and tests, not the hot path.  The ``cuda`` backend, the
``cuda`` rung of the ``serve`` backend and the ``host`` twins emit; the
plain versions (``engine="torch"``: the ``torch`` backend and rung), the
per-level ``mbr_scan`` plan and the live sweeps do not.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# the ledger math (copied from the reference; the TPU kernel's fetch model)
# ---------------------------------------------------------------------------

def survivor_recurrence(mbr_grid, parent, qq_per_level, *,
                        root_unconditional=True):
    """Yield ``(l, tested, act)`` of the quantized sweep's own recurrence.

    ``mbr_grid`` is the integer (L, 4, W) grid the sweep actually tests,
    ``qq_per_level(l)`` the matching outward-quantized queries for level
    ``l`` — so survivors here are the kernel's own, conservative widening
    included.
    """
    levels, _, w = mbr_grid.shape
    prev = None
    for l in range(levels):
        qq = qq_per_level(l)
        rm = mbr_grid[l].T[None, :, :]  # (1, W, 4)
        ov = (
            (rm[..., 0] <= qq[:, None, 2]) & (qq[:, None, 0] <= rm[..., 2])
            & (rm[..., 1] <= qq[:, None, 3]) & (qq[:, None, 1] <= rm[..., 3])
        )
        if l == 0:
            tested = np.ones((qq.shape[0], w), bool)
            if root_unconditional:
                # the kernel's root mask is slot 0 only (_act_formula)
                act = np.zeros_like(ov)
                act[:, 0] = True
            else:
                act = ov
        else:
            tested = prev[:, parent[l]]
            act = tested & ov
        yield l, tested, act
        prev = act


def tile_bytes_per_query(mbr_grid, parent, n_real, qq, *, split,
                         levels8_bytes=384, levels16_bytes=640, tile=64,
                         root_unconditional=True, qq8=None):
    """Visited-tile HBM traffic of one quantized sweep, per query.

    The fetch model is the paper's disk-access ledger at tile grain: a
    64-slot tile is fetched at level ``l`` when any of its *real* slots
    (``n_real[l]`` — padding slots alias parent 0 and must not count)
    must be tested, i.e. its parent survived level ``l-1``; every tile at
    the root.  A uint16 tile costs 64·4·2 B of MBR lanes + 64·2 B of
    parent row = 640 B; a uint8 upper tile (levels < split) 64·4·1 +
    64·2 = 384 B, tested against the coarse-grid queries ``qq8``.
    """
    n_q = qq.shape[0]
    total = 0.0
    sweep = survivor_recurrence(
        mbr_grid, parent, lambda l: qq8 if l < split else qq,
        root_unconditional=root_unconditional,
    )
    for l, tested, _ in sweep:
        nr = int(n_real[l])
        tr = tested[:, :nr]
        pad = (-nr) % tile
        fetched = np.pad(tr, ((0, 0), (0, pad))).reshape(
            n_q, -1, tile).any(axis=2).sum()
        total += float(fetched) * (levels8_bytes if l < split
                                   else levels16_bytes)
    return total / n_q


def stream_fetch_bytes(mbr_grid, parent, qq, win_off, win_w, *,
                       block_w=128, slot_bytes=10,
                       root_unconditional=True):
    """Per-launch HBM tile traffic of the TPU's dead-window-skip streamed
    sweep.

    Mirrors the reference ``_stream_sweep_kernel``'s fetch rule exactly:
    the (block_w)-slot tile at (l, t) is DMA'd iff it is not statically
    empty (``win_off[l, t] == -1`` marks tiles wholly past ``n_real``)
    AND (``l == 0``, or ``t == 0`` — a level boundary's window cannot be
    read a step early — or the parent window ``[win_off[l, t], +win_w)``
    holds a survivor for ANY query in the batch).  Returns
    ``(tile_bytes, mask_bytes, fetched, total_tiles, survivors)`` where
    ``mask_bytes`` is the survivor-window traffic (window reads for
    non-empty gated tiles + write-back of every tile) that the streaming
    design pays for unbounded capacity, and ``survivors`` the per-level
    active-slot totals of the recurrence (summed over the query batch).
    The card's kernel #2 has no ``t == 0`` rule (ROADMAP C6).
    """
    levels, _, w = mbr_grid.shape
    n_q = qq.shape[0]
    wp = ((w + block_w - 1) // block_w) * block_w
    n_tiles = wp // block_w
    fetched, windows, prev = 0, 0, None
    survivors: List[int] = []
    for l, _, act in survivor_recurrence(
            mbr_grid, parent, lambda l: qq,
            root_unconditional=root_unconditional):
        survivors.append(int(act.sum()))
        for t in range(n_tiles):
            off = int(win_off[l, t])
            if off < 0:
                continue  # statically empty: never DMA'd
            if l > 0:
                windows += 1
            if l == 0 or t == 0:
                fetched += 1
                continue
            pv = np.pad(prev, ((0, 0), (0, wp - w)))
            alive = pv.any(axis=0)  # batch union: one DMA serves all q
            if alive[off:off + win_w].any():
                fetched += 1
        prev = act
    total_tiles = levels * n_tiles
    mask_bytes = (windows * n_q * win_w * 4          # window reads
                  + total_tiles * n_q * block_w * 4)  # mask write-back
    return (float(fetched * block_w * slot_bytes), float(mask_bytes),
            fetched, total_tiles, tuple(survivors))


def quantize_queries_grid(queries, origin, inv_cell, cells):
    """Outward-quantize float queries onto an integer grid — exactly the
    transform the compact kernels apply (floor lo, ceil hi, clip)."""
    queries = np.asarray(queries)
    origin = np.asarray(origin)
    inv_cell = np.asarray(inv_cell)
    t = (queries - origin[None, :]) * inv_cell[None, :]
    qq = np.concatenate([np.floor(t[:, :2]), np.ceil(t[:, 2:])], axis=1)
    return np.clip(qq, 0.0, float(cells)).astype(np.int64)


# ---------------------------------------------------------------------------
# LaunchReport + side channel
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LaunchReport:
    """One sweep call (its launches, one a level), in the card's bytes.

    ``bytes_streamed`` is the tile and parent bytes the call read, for the
    whole query batch (divide by ``queries`` for bytes a query);
    ``mask_bytes`` the mask bytes written and the parent-mask bytes read
    (an upper bound, see the module docstring); ``survivors_per_level`` the
    per-level active counts summed over the batch (the column sums of
    ``visits``).  ``launches`` counts sweep calls here (a call is one
    launch a level on the card, ROADMAP C3).
    """

    kind: str                      # "float32" | "compact" | "compact8" | "host-twin"
    stream: bool
    queries: int
    block_w: int
    bytes_streamed: float
    mask_bytes: float = 0.0
    tiles_fetched: int = 0
    tiles_total: int = 0
    survivors_per_level: Optional[Tuple[int, ...]] = None
    query_block: Optional[int] = None
    backend: Optional[str] = None
    launches: int = 1

    @property
    def tiles_skipped(self) -> int:
        return max(self.tiles_total - self.tiles_fetched, 0)

    @property
    def bytes_per_query(self) -> float:
        return self.bytes_streamed / self.queries if self.queries else 0.0

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["tiles_skipped"] = self.tiles_skipped
        if self.survivors_per_level is not None:
            d["survivors_per_level"] = list(self.survivors_per_level)
        return d


def merge_reports(reports) -> Optional[LaunchReport]:
    """Fold the reports of one logical query batch (the ``cuda`` backend
    chunks by ``query_block``, emitting one report per chunk)."""
    reports = [r for r in reports if r is not None]
    if not reports:
        return None
    out = dataclasses.replace(reports[0])
    for r in reports[1:]:
        out.queries += r.queries
        out.launches += r.launches
        out.bytes_streamed += r.bytes_streamed
        out.mask_bytes += r.mask_bytes
        out.tiles_fetched += r.tiles_fetched
        out.tiles_total += r.tiles_total
        if out.survivors_per_level is not None and \
                r.survivors_per_level is not None:
            out.survivors_per_level = tuple(
                a + b for a, b in
                zip(out.survivors_per_level, r.survivors_per_level))
        elif r.survivors_per_level is not None:
            out.survivors_per_level = r.survivors_per_level
    return out


_collecting = False
_pending: List[LaunchReport] = []


def collect_launch_reports(on: bool = True) -> None:
    """Arm (or disarm) the side channel; drains any stale reports."""
    global _collecting, _pending
    _collecting = bool(on)
    _pending = []


def collecting() -> bool:
    return _collecting


def emit(report: LaunchReport) -> None:
    _pending.append(report)


def pending() -> int:
    """The number of reports on the side channel: a mark for
    :func:`drain`."""
    return len(_pending)


def drain(since: int = 0) -> List[LaunchReport]:
    """Take the reports emitted after the first ``since`` off the side
    channel (all of them by default); earlier ones stay."""
    global _pending
    out, _pending = _pending[since:], _pending[:since]
    return out


# ---------------------------------------------------------------------------
# report functions: the card's kernels #1, #2 and #3 (csrc/level_sweep.cu)
# ---------------------------------------------------------------------------

def _tiles(slots: int, block_w: int) -> int:
    return -(-int(slots) // block_w)


def _elem(t) -> int:
    return int(t.element_size()) if hasattr(t, "element_size") else int(t.dtype.itemsize)


def resident_sweep_report(kind: str, n_q: int, width: int, lane_bytes: Sequence[int],
                          parent_bytes: int, *, block_w: int, root_only: bool,
                          n_real: Optional[Sequence[int]] = None) -> LaunchReport:
    """Kernels #1 (``n_real`` None) and #3 (the schedule's ``n_real``).

    Level l (0 <= l < L) is tested unless it is the root of a tree
    schedule (``root_only``: slot 0 is active without a read); level l is
    gated for l >= 1.  A tested level reads ``read_l`` slots: W on #1; on
    #3, whose tiles wholly at or past ``n_real[l]`` are not read, ``read_l
    = min(W, ceil(n_real[l] / block_w) * block_w)``, and it computes
    ``real_l = min(W, n_real[l])`` slots (W on #1).  With ``lane_bytes[l]``
    the four coordinates of a slot (16 float32, 8 uint16, 4 uint8) and
    ``parent_bytes`` a parent (4 int32, 2 uint16)::

        bytes_streamed = sum_{tested l} read_l * lane_bytes[l]
                         + sum_{l >= 1} read_l * parent_bytes
        mask_bytes     = L * Q * W + sum_{l >= 1} Q * real_l
        tiles_fetched  = sum_{tested l} ceil(read_l / block_w)
        tiles_total    = L * ceil(W / block_w)
    """
    levels = len(lane_bytes)
    first = int(bool(root_only))
    if n_real is None:
        read = real = [int(width)] * levels
    else:
        real = [min(int(width), int(n)) for n in n_real]
        read = [min(int(width), _tiles(n, block_w) * block_w) for n in real]
    streamed = sum(read[l] * int(lane_bytes[l]) for l in range(first, levels))
    streamed += sum(read[l] * int(parent_bytes) for l in range(1, levels))
    mask = levels * n_q * int(width) + sum(n_q * real[l] for l in range(1, levels))
    return LaunchReport(
        kind, False, int(n_q), int(block_w), float(streamed), mask_bytes=float(mask),
        tiles_fetched=sum(_tiles(read[l], block_w) for l in range(first, levels)),
        tiles_total=levels * _tiles(width, block_w),
    )


def stream_sweep_report(kind: str, n_q: int, levels: int, width: int, lane_bytes: int,
                        parent_bytes: int, *, block_w: int, root_only: bool,
                        skipped: int, level0_tiles: int) -> LaunchReport:
    """Kernel #2 (``stream=True``).  ``skipped`` is the kernel's own count
    of the (level, tile) pairs it skipped in this call; ``level0_tiles``
    the level-0 tiles that are not statically empty (``win_off[0] >= 0``).
    A tile not skipped is read whole (``block_w`` slots, the last tile of a
    row included), its parents too on a gated level (l >= 1); a tree's
    root level is not read at all::

        T              = ceil(W / block_w)
        tiles_total    = L * T
        tiles_fetched  = L * T - skipped - (level0_tiles if root_only else 0)
        gated_fetched  = tiles_fetched - (0 if root_only else level0_tiles)
        bytes_streamed = block_w * (tiles_fetched * lane_bytes
                                    + gated_fetched * parent_bytes)
        mask_bytes     = L * Q * W + (L - 1) * Q * W

    The (W,) survivor rows and prefix scans of the skip rule are not
    counted.
    """
    total = levels * _tiles(width, block_w)
    fetched = total - int(skipped) - (int(level0_tiles) if root_only else 0)
    gated = fetched - (0 if root_only else int(level0_tiles))
    streamed = block_w * (fetched * int(lane_bytes) + gated * int(parent_bytes))
    mask = levels * n_q * int(width) + (levels - 1) * n_q * int(width)
    return LaunchReport(kind, True, int(n_q), int(block_w), float(streamed),
                        mask_bytes=float(mask), tiles_fetched=fetched, tiles_total=total)


def _stream_report(kind, tiles, parent, n_q, *, block_w, root_only, win_off, skipped):
    levels, _, width = tiles.shape
    level0 = int((win_off[0] >= 0).sum())
    return stream_sweep_report(kind, n_q, levels, width, 4 * _elem(tiles), _elem(parent),
                               block_w=block_w, root_only=root_only, skipped=int(skipped),
                               level0_tiles=level0)


def scan_report_float32(schedule, queries, *, block_w, stream,
                        win_off=None, skipped=None) -> LaunchReport:
    """Float32 tiles (16 lane bytes a slot), int32 parents: #1
    (:func:`resident_sweep_report`, ``n_real`` None), or #2 with
    ``stream=True`` (:func:`stream_sweep_report`; ``skipped`` this call's
    count, ``win_off`` its windows)."""
    n_q = int(queries.shape[0])
    root_only = bool(schedule.root_unconditional)
    if stream:
        return _stream_report("float32", schedule.mbr_cm, schedule.parent, n_q,
                              block_w=block_w, root_only=root_only, win_off=win_off,
                              skipped=skipped)
    levels, _, width = schedule.mbr_cm.shape
    return resident_sweep_report("float32", n_q, width, [16] * levels,
                                 _elem(schedule.parent), block_w=block_w,
                                 root_only=root_only)


def scan_report_compact(qsched, queries, *, block_w, stream,
                        win_off=None, skipped=None) -> LaunchReport:
    """uint16 tiles (8 lane bytes a slot), uint16 or int32 parents: #1 or
    #2, as :func:`scan_report_float32`."""
    n_q = int(queries.shape[0])
    root_only = bool(qsched.base.root_unconditional)
    if stream:
        return _stream_report("compact", qsched.mbr_q, qsched.parent_q, n_q,
                              block_w=block_w, root_only=root_only, win_off=win_off,
                              skipped=skipped)
    levels, _, width = qsched.mbr_q.shape
    return resident_sweep_report("compact", n_q, width, [8] * levels,
                                 _elem(qsched.parent_q), block_w=block_w,
                                 root_only=root_only)


def scan_report_compact8(qsched, queries, *, block_w) -> LaunchReport:
    """#3 over uint8 tiles (4 lane bytes a slot) for the levels below
    ``split`` and uint16 (8) below them, with the schedule's ``n_real``
    (:func:`resident_sweep_report`).  A single-level schedule (``split ==
    0``) sweeps with #1 as plain compact (``n_real`` None)."""
    n_q = int(queries.shape[0])
    levels, _, width = qsched.mbr_q.shape
    split = int(qsched.split)
    n_real = None
    if split:
        n_real = [int(n) for n in qsched.base.n_real.tolist()]
    return resident_sweep_report("compact8", n_q, width,
                                 [4 if l < split else 8 for l in range(levels)],
                                 _elem(qsched.parent_q), block_w=block_w,
                                 root_only=bool(qsched.base.root_unconditional),
                                 n_real=n_real)


def host_twin_report(queries, mbr_cm, parent, *, stream) -> LaunchReport:
    """The numpy degradation twins read every tile and parent of every
    level once a sweep: ``bytes_streamed`` is the bytes of the tile arrays
    (``mbr_cm``, one array or a sequence of them: compact8's uint8 and
    uint16 levels) plus the parents'; one "tile" a level."""
    tiles = mbr_cm if isinstance(mbr_cm, (list, tuple)) else (mbr_cm,)
    nbytes = sum(int(np.asarray(t).nbytes) for t in tiles) + int(np.asarray(parent).nbytes)
    levels = sum(int(t.shape[0]) for t in tiles)
    n_q = int(np.asarray(queries).shape[0])
    return LaunchReport("host-twin", bool(stream), n_q, int(tiles[-1].shape[2]),
                        float(nbytes), tiles_fetched=levels, tiles_total=levels,
                        backend="host")
