"""Autotuned tiling for the fused region-search sweep.

Counterpart of ``repro.kernels.autotune``.  It times a small candidate grid
of

* ``block_w``        — the sweep kernel's thread-block width over slots,
* ``query_block``    — split the query batch into chunks of this many rows
                       (``None`` = the whole batch at once),
* ``levels_in_grid`` — the fused per-level sweep (True) against the
                       per-level ``mbr_scan`` plan (False; float32
                       non-streamed paths only),

on a probe slice of the first real query batch and returns the winner as
a :class:`TileConfig`.  ``repro_torch.index.backends.CudaBackend`` caches
winners in ``BuildArtifacts.tuned`` keyed by :func:`shape_key`, so every
backend over the same artifacts (``with_backend`` twins too) reuses them.

Timing is wall clock around each call with a device synchronize on both
sides (pass ``sync``), after one warm-up call, best of ``iters``.

One deliberate difference from the reference: the JAX ``tune`` skips any
candidate that raises.  On the card that would hide a kernel that fails to
launch, so this ``tune`` skips only a ``ValueError`` (what the wrappers'
own argument checks raise before a launch, e.g. a tile shape they refuse);
a launch error (``RuntimeError``) or any other exception propagates.

A second one: the ``cuda`` backend times :func:`distinct_plans` of the
grid, one per-level plan per ``query_block``, because the port's
``mbr_scan`` picks its own tile and that plan's ``block_w`` changes
nothing.  ``candidates`` stays equal to the reference's (ROADMAP C10).
"""

from __future__ import annotations

import dataclasses
import time

__all__ = [
    "TileConfig",
    "DEFAULT_BLOCK_WS",
    "AUTO_MIN_WIDTH",
    "PROBE_QUERIES",
    "shape_key",
    "candidates",
    "distinct_plans",
    "tune",
]

DEFAULT_BLOCK_WS = (64, 128, 256, 512)

# autotune="auto" only spends tuning time when the slot grid is at least
# this wide; narrower schedules sweep quickly at any tile shape.
AUTO_MIN_WIDTH = 1024

# Probe slice of the first query batch used for timing.
PROBE_QUERIES = 16


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One point of the tiling candidate grid (the default is the fixed
    configuration)."""

    block_w: int = 128
    query_block: int | None = None
    levels_in_grid: bool = True


def _bucket(v: int) -> int:
    """Next power of two >= v (>= 1)."""
    return 1 << max(int(v - 1).bit_length(), 0) if v > 1 else 1


def shape_key(width: int, levels: int, n_queries: int, precision: str,
              stream: bool):
    """Cache key of a tuning measurement in ``BuildArtifacts.tuned``: width
    and query count bucketed to the next power of two; levels, precision
    and the streaming flag exact."""
    return (_bucket(width), int(levels), _bucket(n_queries), str(precision),
            bool(stream))


def candidates(width: int, n_queries: int, *, precision: str = "float32",
               stream: bool = False, live: bool = False,
               block_ws=DEFAULT_BLOCK_WS):
    """The candidate grid for one shape.  Always contains the fixed
    default :class:`TileConfig`, so tuning never loses to it."""
    bws = [bw for bw in block_ws if bw <= max(_bucket(width), 128)]
    if not bws:
        bws = [128]
    qbs = [None]
    if n_queries > 32:
        qbs.append(32)
    out = []
    for bw in bws:
        for qb in qbs:
            out.append(TileConfig(bw, qb, True))
            # The per-level launch plan only exists for the plain float32
            # sweep (no delta levels, no quantized tiles, no streaming).
            if precision == "float32" and not stream and not live:
                out.append(TileConfig(bw, qb, False))
    default = TileConfig()
    if default not in out:
        out.insert(0, default)
    return out


def distinct_plans(cands):
    """``cands`` without the per-level plans (``levels_in_grid=False``) that
    differ from an earlier one only in ``block_w``.  The port's
    ``mbr_scan`` picks its tile from the query count, so those run the
    same kernels; the first of them stands for all.  ``candidates`` itself
    stays equal to the reference's."""
    seen, out = set(), []
    for c in cands:
        if not c.levels_in_grid:
            if c.query_block in seen:
                continue
            seen.add(c.query_block)
        out.append(c)
    return out


def tune(make_run, cands, *, iters: int = 2, sync=None):
    """Time every candidate and return ``(best_cfg, {cfg: seconds})``.

    ``make_run(cfg)`` returns a zero-argument callable running the search
    under that configuration; ``sync`` (e.g. ``torch.cuda.synchronize``)
    is called before and after each timed call so the time covers the
    device's work.  One warm-up call per candidate; the score is the best
    of ``iters`` timed calls.  A candidate whose call raises ``ValueError``
    (refused by an argument check before any launch) is skipped; any other
    exception propagates.  If every candidate is skipped, the fixed
    default wins.
    """
    sync = sync or (lambda: None)
    timings: dict[TileConfig, float] = {}
    best = None
    for cfg in cands:
        try:
            fn = make_run(cfg)
            fn()  # warm-up
        except ValueError:
            continue
        t = min(_timed(fn, sync) for _ in range(max(iters, 1)))
        timings[cfg] = t
        if best is None or t < timings[best]:
            best = cfg
    if best is None:
        best = TileConfig()
    return best, timings


def _timed(fn, sync) -> float:
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - t0
