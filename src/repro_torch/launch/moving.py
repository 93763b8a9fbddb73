"""Moving-object workload: continuous queries over a churning index.

Counterpart of ``repro.launch.moving``.  Objects move every tick, and the
index must keep answering a CONTINUOUS query set while absorbing the
churn — what a vehicle-tracking or geofencing service sees:

* every tick a batch of movers advances (constant velocity, bouncing off
  the ``[0, extent]²`` walls) and re-indexes as one batch **delete** + one
  batch **insert** through the ``UpdateLog`` — tombstone + delta buffer,
  no rebuild; the merge policy (or a full buffer) compacts mid-workload,
  which must not move any answer;
* every ``query_every`` ticks the continuous query set runs: a fixed batch
  of region rectangles plus a spatial join of the moving set against a
  static ZONE index (``SpatialIndex.join``), both honouring the delta
  buffer and tombstones mid-tick.

All motion comes from one numpy ``default_rng(seed)`` drawn in the JAX
package's order, so a seed replays its scenario exactly.  The workload
drives any index-like with ``insert/delete/region/join`` (``index=``
takes one): a plain :class:`~repro_torch.index.SpatialIndex` or a
:class:`~repro_torch.checkpoint.DurableIndex`, whose ``FaultPlan`` kills
then land mid-tick and whose recovery resumes from the last durable
mutation.  ``rebuild_per_tick=True`` is the naive baseline: every tick
rebuilds the whole index instead of going through the delta buffer.

    PYTHONPATH=src python -m repro_torch.launch.moving --ticks 200
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.datasets import EXTENT
from repro_torch.index import SpatialIndex


def _f32_exact(a):
    """float32-exact float64 coordinates: device (f32) and host oracle
    (f64) paths see bit-identical geometry."""
    return np.float64(np.float32(a))


@dataclasses.dataclass(frozen=True)
class MovingConfig:
    """Shape of the moving-object scenario (all coordinates in the
    ``[0, extent]²`` world of ``core.datasets``)."""

    n_objects: int = 128
    n_zones: int = 12
    moves_per_tick: int = 8
    half_side: float = 5.0      # object half-extent (0 -> point objects)
    zone_side: float = 150.0
    speed: float = 11.0         # max |velocity component| per tick
    extent: float = EXTENT
    n_queries: int = 4
    query_side: float = 120.0
    query_every: int = 1        # run the continuous query set every k ticks
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TickResult:
    """What one tick did: which objects moved (old and new global ids)
    and — on query ticks — the continuous query answers."""

    tick: int
    moved: np.ndarray            # (m,) object slots that moved
    old_gids: np.ndarray         # (m,) ids tombstoned this tick
    new_gids: np.ndarray         # (m,) ids inserted this tick
    region: Optional[object]     # RegionResult | None (non-query tick)
    join: Optional[object]       # JoinResult | None


class MovingWorkload:
    """Seeded, replayable moving-object scenario over a live index, on
    ``device`` (the CUDA card unless ``device="cpu"``; with ``index=``,
    that index's device)."""

    def __init__(
        self,
        config: MovingConfig = MovingConfig(),
        *,
        index=None,
        structure: str = "mqr",
        backend: str = "cuda",
        capacity: int = 128,
        rebuild_per_tick: bool = False,
        device=None,
        **build_opts,
    ):
        self.config = config
        self.rebuild_per_tick = rebuild_per_tick
        rng = np.random.default_rng(config.seed)
        n, h, ext = config.n_objects, config.half_side, config.extent
        self.pos = rng.uniform(h, ext - h, size=(n, 2))
        self.vel = rng.uniform(-config.speed, config.speed, size=(n, 2))
        self._rng = rng
        self._structure = structure
        self._backend = backend
        self._build_opts = dict(build_opts)

        if index is not None:
            self.index = index
        elif rebuild_per_tick:
            self.index = SpatialIndex.build(self.boxes(), structure=structure,
                                            backend=backend, device=device, **build_opts)
        else:
            self.index = SpatialIndex.build(self.boxes(), structure=structure,
                                            backend=backend, capacity=capacity,
                                            device=device, **build_opts)
        self.device = self.index.device
        # current global id of each object slot
        self.gid = np.arange(n, dtype=np.int64)
        self.dead_gids: list = []   # every id ever tombstoned by a move

        # static zone index: the join's right-hand side
        zones_ll = rng.uniform(0.0, ext - config.zone_side, size=(config.n_zones, 2))
        self.zone_mbrs = _f32_exact(
            np.concatenate([zones_ll, zones_ll + config.zone_side], axis=1))
        self.zones = SpatialIndex.build(self.zone_mbrs, structure="mqr", backend="host",
                                        device=self.device)
        # continuous region query set, fixed for the whole run
        qc = rng.uniform(0.0, ext - config.query_side, size=(config.n_queries, 2))
        self.queries = np.concatenate([qc, qc + config.query_side], axis=1).astype(np.float32)
        self.t = 0

    # -- geometry ------------------------------------------------------
    def boxes(self, slots=None) -> np.ndarray:
        """float32-exact MBRs of the (chosen) objects' current positions."""
        p = self.pos if slots is None else self.pos[slots]
        h = self.config.half_side
        return _f32_exact(np.concatenate([p - h, p + h], axis=1))

    def _advance(self, slots) -> None:
        """Constant-velocity motion with wall bounce, objects ``slots``."""
        h, ext = self.config.half_side, self.config.extent
        p = self.pos[slots] + self.vel[slots]
        v = self.vel[slots]
        lo, hi = h, ext - h
        over_lo, over_hi = p < lo, p > hi
        p = np.where(over_lo, 2 * lo - p, p)
        p = np.where(over_hi, 2 * hi - p, p)
        v = np.where(over_lo | over_hi, -v, v)
        self.pos[slots] = np.clip(p, lo, hi)
        self.vel[slots] = v

    # -- index-protocol shims (SpatialIndex | DurableIndex) ------------
    @staticmethod
    def _ids(result) -> np.ndarray:
        """Unwrap ``DurableIndex.MutationResult.ids`` / pass gid arrays."""
        return np.asarray(getattr(result, "ids", result), np.int64)

    @property
    def query_index(self) -> SpatialIndex:
        """The underlying ``SpatialIndex`` (unwraps ``DurableIndex``)."""
        return getattr(self.index, "index", self.index)

    # -- the tick ------------------------------------------------------
    def tick(self) -> TickResult:
        """One step: move a batch, re-index it, answer the continuous
        query set (on query ticks)."""
        cfg = self.config
        self.t += 1
        m = min(cfg.moves_per_tick, cfg.n_objects)
        moved = np.sort(self._rng.choice(cfg.n_objects, size=m, replace=False))
        self._advance(moved)
        old = self.gid[moved].copy()
        if self.rebuild_per_tick:
            # naive baseline: full rebuild instead of delta-buffer churn
            self.index = SpatialIndex.build(self.boxes(), structure=self._structure,
                                            backend=self._backend, device=self.device,
                                            **self._build_opts)
            self.gid = np.arange(cfg.n_objects, dtype=np.int64)
            new = self.gid[moved]  # rebuild renumbers from zero
        else:
            self.index.delete(old)
            new = self._ids(self.index.insert(self.boxes(moved)))
            self.dead_gids.extend(old.tolist())
        self.gid[moved] = new

        region = join = None
        if self.t % cfg.query_every == 0:
            region = self.index.region(self.queries)
            join = self.index.join(self.zones)
        return TickResult(tick=self.t, moved=moved, old_gids=old, new_gids=new,
                          region=region, join=join)

    def run(self, ticks: int) -> TickResult:
        """Run ``ticks`` ticks; returns the last tick's result."""
        last = None
        for _ in range(ticks):
            last = self.tick()
        return last


def main(argv=None):  # pragma: no cover - CLI demo
    import argparse
    import time

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--objects", type=int, default=128)
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the kernels' plain versions (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = MovingConfig(n_objects=args.objects, seed=args.seed, query_every=10)
    w = MovingWorkload(cfg, backend=args.backend, device=args.device)
    t0 = time.time()
    last = w.run(args.ticks)
    if w.device.type == "cuda":
        torch.cuda.synchronize(w.device)
    dt = time.time() - t0
    idx = w.query_index
    print(f"{args.ticks} ticks in {dt:.2f}s ({args.ticks / dt:.1f} ticks/s) on "
          f"backend={args.backend}, device={w.device}: {idx.stats.inserts} inserts, "
          f"{idx.stats.deletes} deletes, {idx.stats.flushes} merges, "
          f"{idx.stats.joins} joins")
    if last.join is not None:
        print(f"final continuous answers: {int(last.region.counts.sum())} region hits, "
              f"{last.join.n_pairs} object×zone pairs "
              f"({int(last.join.pair_visits.sum())} pair tests)")


if __name__ == "__main__":  # pragma: no cover
    main()
