"""Built-in query backends of the :class:`SpatialIndex` registry.

Two engines over the same search semantics:

* ``host`` — the oracle: per-level pointer search over the built mqr or
  R-tree, and the numpy level sweep of the schedule for the pyramid (which
  has no pointers), as the JAX package's ``host`` backend;
* ``cuda`` — the fused sweep of :mod:`repro_torch.kernels.pyramid_scan`
  (the counterpart of the JAX ``pallas`` backend), at
  ``precision="float32"``, ``"compact"`` or ``"compact8"``, with tiling
  autotuned (:mod:`repro_torch.kernels.autotune`) or fixed.

Every adapter returns ``(hits (Q, n_obj) bool, visits (Q, L) int32,
launches int, tiles_skipped)`` with identical hits and per-level access
counts; ``tiles_skipped`` is the streaming sweep's count of skipped
(level, tile) pairs as a 0-d int64 tensor on the device, or None where no
streaming sweep ran.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import mbr as M
from repro_torch.core.flat import LevelSchedule
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import (
    AUTO_MIN_WIDTH,
    PROBE_QUERIES,
    TileConfig,
    candidates,
    distinct_plans,
    shape_key,
    tune,
)

from .registry import register_backend
from .trees import node_children, node_mbr, tree_height

ALL_STRUCTURES = ("mqr", "rtree", "pyramid")
PRECISIONS = ("float32", "compact", "compact8")
AUTOTUNE = ("auto", "on", "off")


def _overlap_np(a, b):
    """Closed-boundary rectangle intersection, broadcasting (numpy)."""
    return (
        (a[..., 0] <= b[..., 2])
        & (b[..., 0] <= a[..., 2])
        & (a[..., 1] <= b[..., 3])
        & (b[..., 1] <= a[..., 3])
    )


def schedule_region_numpy(schedule: LevelSchedule, queries: np.ndarray):
    """Reference level sweep over a :class:`LevelSchedule`, pure numpy.

    ``active[l] = active[l-1][parent] & overlaps`` (level 0 unconditional at
    the root slot for tree schedules).  Returns numpy ``(hits, visits (Q,
    L))``."""
    queries = np.asarray(queries, np.float32)
    nq = queries.shape[0]
    mbr_cm = schedule.mbr_cm.cpu().numpy()
    parent = schedule.parent.cpu().numpy()
    obj_level = schedule.obj_level.cpu().numpy()
    obj_slot = schedule.obj_slot.cpu().numpy()
    obj_id = schedule.obj_id.cpu().numpy()
    levels, _, w = mbr_cm.shape
    mbr = mbr_cm.transpose(0, 2, 1)  # (L, W, 4)
    acts = np.zeros((levels, nq, w), bool)
    for l in range(levels):
        ov = _overlap_np(mbr[l][None, :, :], queries[:, None, :])
        if l == 0:
            if schedule.root_unconditional:
                act = np.zeros((nq, w), bool)
                act[:, 0] = True
            else:
                act = ov
        else:
            act = ov & acts[l - 1][:, parent[l]]
        acts[l] = act
    visits = acts.sum(axis=2).T.astype(np.int32)
    entry_act = acts[obj_level, :, obj_slot].T  # (Q, E)
    if schedule.test_object_mbr:
        obj_mbr = schedule.obj_mbr.cpu().numpy()
        entry_act = entry_act & _overlap_np(obj_mbr[None, :, :], queries[:, None, :])
    hits = np.zeros((nq, max(schedule.n_objects, 1)), bool)
    np.maximum.at(hits, (slice(None), obj_id), entry_act)
    return hits, visits


@register_backend(
    "host",
    structures=ALL_STRUCTURES,
    doc="per-level pointer search on the CPU (numpy sweep for the pyramid); "
        "the oracle",
)
class HostBackend:
    def __init__(self, artifacts):
        self.n_objects = artifacts.n_objects
        self.tree = artifacts.pointer_tree
        if self.tree is not None:
            self.levels = tree_height(self.tree)
        else:
            self.schedule = artifacts.schedule.to("cpu")

    def region(self, queries: torch.Tensor):
        queries = queries.cpu().numpy()
        if self.tree is None:
            hits, visits = schedule_region_numpy(self.schedule, queries)
        else:
            hits, visits = self._pointer_search(queries)
        return torch.from_numpy(hits), torch.from_numpy(visits), 0, None

    def _pointer_search(self, queries: np.ndarray):
        nq = queries.shape[0]
        hits = np.zeros((nq, max(self.n_objects, 1)), bool)
        visits = np.zeros((nq, self.levels), np.int32)
        for i, q in enumerate(queries):
            qq = np.asarray(q, np.float64)
            stack = [(self.tree.root, 0)]
            while stack:
                node, d = stack.pop()
                if node_mbr(node) is None:
                    continue
                visits[i, d] += 1
                for embr, child, obj in node_children(node):
                    if not M.overlaps(embr, qq):
                        continue
                    if child is not None:
                        stack.append((child, d + 1))
                    else:
                        hits[i, obj] = True
        return hits, visits


@register_backend(
    "cuda",
    structures=ALL_STRUCTURES,
    doc="fused level sweep (csrc/level_sweep.cu on the card, its plain "
        "version on the CPU); precision='compact' sweeps conservative "
        "uint16 tiles, 'compact8' adds coarse uint8 upper-level tiles, both "
        "with an exact float32 confirming pass; stream=True runs the "
        "streaming sweep with its dead-window skip; block_w=None autotunes",
)
class CudaBackend:
    """Fused-sweep adapter with autotuned tiling, as the JAX ``pallas``
    backend.

    ``block_w=None`` (the default) leaves the tiling to the autotuner:
    ``autotune="auto"`` times the candidate grid of
    :mod:`repro_torch.kernels.autotune` on the first query batch once the
    slot grid is at least ``AUTO_MIN_WIDTH`` wide, ``"on"`` always does,
    ``"off"`` (or an explicit ``block_w`` or ``query_block``) pins the
    fixed configuration.  Winners are cached in ``BuildArtifacts.tuned``.
    A config with ``levels_in_grid=False`` runs the per-level ``mbr_scan``
    plan.  ``launches`` counts the kernel launches of the sweep: one per
    level per chunk (the TPU kernel made one per chunk).  ``stream=True``
    sweeps with ``level_sweep_stream`` (not with ``compact8``, as in the
    reference); its parent windows are computed once per ``block_w``.
    """

    def __init__(self, artifacts, *, block_w: int | None = None,
                 precision: str = "float32", stream: bool = False,
                 autotune: str = "auto", query_block: int | None = None):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
        if autotune not in AUTOTUNE:
            raise ValueError(f"unknown autotune {autotune!r}; expected one of {AUTOTUNE}")
        if stream and precision == "compact8":
            raise ValueError("stream=True is not supported with precision='compact8'")
        if query_block is not None and query_block < 1:
            raise ValueError(f"query_block must be >= 1, got {query_block}")
        self.precision = precision
        self.schedule = artifacts.schedule
        if precision == "compact":
            self.qschedule = artifacts.quantized
        elif precision == "compact8":
            self.qschedule = artifacts.quantized8
        else:
            self.qschedule = None
        self.block_w = block_w
        self.query_block = query_block
        self.stream = stream
        self.autotune = autotune
        self._tuned = artifacts.tuned
        self._windows: dict = {}  # block_w -> (win_off, win_w) of stream=True
        self.config: TileConfig | None = None  # the tiling of the last batch

    def _config(self, queries: torch.Tensor) -> TileConfig:
        fixed = TileConfig(128 if self.block_w is None else self.block_w,
                           self.query_block, True)
        if (self.autotune == "off" or self.block_w is not None
                or self.query_block is not None):
            return fixed
        width = self.schedule.width
        if self.autotune == "auto" and width < AUTO_MIN_WIDTH:
            return fixed
        nq = queries.shape[0]
        key = shape_key(width, self.schedule.levels, nq, self.precision, self.stream)
        cfg = self._tuned.get(key)
        if cfg is None:
            probe = queries[:PROBE_QUERIES]
            cands = distinct_plans(candidates(width, nq, precision=self.precision,
                                              stream=self.stream))
            dev = self.schedule.device
            sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else None
            cfg, _ = tune(lambda c: lambda: self._run(probe, c), cands, sync=sync)
            self._tuned[key] = cfg
        return cfg

    def _stream_kw(self, block_w: int, skipped) -> dict:
        """Keyword arguments of a scan: the streaming sweep's windows at
        this ``block_w`` (computed once) and its skip counter."""
        if not self.stream:
            return {}
        if block_w not in self._windows:
            self._windows[block_w] = ops.stream_windows(
                self.schedule.parent, self.schedule.n_real, block_w=block_w,
                device=self.schedule.device)
        win_off, win_w = self._windows[block_w]
        return dict(stream=True, win_off=win_off, win_w=win_w, skipped=skipped)

    def _run_one(self, queries: torch.Tensor, cfg: TileConfig, skipped=None):
        if not cfg.levels_in_grid:
            # Per-level launch plan (float32, not streamed; the candidate
            # grid never proposes it elsewhere): hits and visits equal the
            # fused sweep.
            return ops.per_level_region_search(self.schedule, queries,
                                               block_w=cfg.block_w)
        if self.precision == "compact":
            hits, visits = ops.pyramid_scan_compact(
                self.qschedule, queries, block_w=cfg.block_w,
                **self._stream_kw(cfg.block_w, skipped))
        elif self.precision == "compact8":
            hits, visits = ops.pyramid_scan_compact8(
                self.qschedule, queries, block_w=cfg.block_w)
        else:
            hits, visits = ops.pyramid_scan(self.schedule, queries, block_w=cfg.block_w,
                                            **self._stream_kw(cfg.block_w, skipped))
        return hits, visits, self.schedule.levels

    def _run(self, queries: torch.Tensor, cfg: TileConfig, skipped=None):
        qb = cfg.query_block
        if qb and queries.shape[0] > qb:
            parts = [self._run_one(queries[i:i + qb], cfg, skipped)
                     for i in range(0, queries.shape[0], qb)]
            return (torch.cat([p[0] for p in parts]),
                    torch.cat([p[1] for p in parts]),
                    sum(p[2] for p in parts))
        return self._run_one(queries, cfg, skipped)

    def region(self, queries: torch.Tensor):
        self.config = self._config(queries)
        skipped = (torch.zeros((), dtype=torch.int64, device=self.schedule.device)
                   if self.stream else None)
        hits, visits, launches = self._run(queries, self.config, skipped)
        return hits, visits, launches, skipped
