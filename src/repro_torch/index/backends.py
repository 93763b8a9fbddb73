"""Built-in query backends of the :class:`SpatialIndex` registry.

Four engines over the same search semantics:

* ``host`` — the oracle: per-level pointer search over the built mqr or
  R-tree, and the numpy level sweep of the schedule for the pyramid (which
  has no pointers; the serving ladder's host twin,
  :func:`repro_torch.kernels.fallback.search_f32_np`), as the JAX
  package's ``host`` backend;
* ``torch`` — the plain PyTorch sweep (``engine="torch"``) on the index's
  device, float32, no options: the counterpart of the JAX ``lax`` backend,
  chosen by name only;
* ``cuda`` — the fused sweep of :mod:`repro_torch.kernels.pyramid_scan`
  (the counterpart of the JAX ``pallas`` backend), at
  ``precision="float32"``, ``"compact"`` or ``"compact8"``, with tiling
  autotuned (:mod:`repro_torch.kernels.autotune`) or fixed;
* ``serve`` — the batching
  :class:`~repro_torch.launch.spatial_serve.SpatialServer` (LRU cache,
  dedupe, the cuda → torch → host ladder) as a backend adapter.

Every adapter returns ``(hits (Q, n_obj) bool, visits (Q, L) int32,
launches int, tiles_skipped)`` with identical hits and per-level access
counts; ``tiles_skipped`` is the streaming sweep's count of skipped
(level, tile) pairs as a 0-d int64 tensor on the device, or None where no
streaming sweep ran.  Each ``region`` runs in a ``backend.<name>`` trace
span (:mod:`repro_torch.obs.trace`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import mbr as M
from repro_torch.kernels import fallback, ops
from repro_torch.kernels.autotune import (
    AUTO_MIN_WIDTH,
    PROBE_QUERIES,
    TileConfig,
    candidates,
    distinct_plans,
    shape_key,
    tune,
)
from repro_torch.obs import trace as _obs_trace

from .registry import register_backend
from .trees import node_children, node_mbr, tree_height

ALL_STRUCTURES = ("mqr", "rtree", "pyramid")
PRECISIONS = ("float32", "compact", "compact8")
AUTOTUNE = ("auto", "on", "off")


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
        with _obs_trace.span("backend.host", queries=queries.shape[0]):
            return self._region(queries)

    def _region(self, queries: torch.Tensor):
        queries = queries.cpu().numpy()
        if self.tree is None:
            hits, visits = fallback.search_f32_np(queries, self.schedule)
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
        with _obs_trace.span("backend.cuda", queries=queries.shape[0],
                             precision=self.precision, stream=self.stream):
            self.config = self._config(queries)
            skipped = (torch.zeros((), dtype=torch.int64, device=self.schedule.device)
                       if self.stream else None)
            hits, visits, launches = self._run(queries, self.config, skipped)
        return hits, visits, launches, skipped


@register_backend(
    "torch",
    structures=ALL_STRUCTURES,
    doc="the plain PyTorch level sweep (the kernels' plain versions) on the "
        "index's device; float32, no options; as the JAX lax backend",
)
class TorchBackend:
    """Plain-sweep adapter: :func:`repro_torch.kernels.ops.pyramid_scan`
    with ``engine="torch"``.  It launches none of the hand-written kernels,
    so it reports 0 launches; a caller chooses it by name only, and no
    other backend falls back to it (the ``serve`` ladder's ``torch`` rung
    runs the same sweep and counts it as a degraded batch)."""

    def __init__(self, artifacts):
        self.schedule = artifacts.schedule

    def region(self, queries: torch.Tensor):
        with _obs_trace.span("backend.torch", queries=queries.shape[0]):
            hits, visits = ops.pyramid_scan(self.schedule, queries, engine="torch")
        return hits, visits, 0, None


@register_backend(
    "serve",
    structures=ALL_STRUCTURES,
    doc="batching SpatialServer: LRU cache + dedupe + the cuda -> torch -> "
        "host degradation ladder; precision='compact'/'compact8' serve the "
        "quantized tile forms",
)
class ServeBackend:
    """:class:`repro_torch.launch.spatial_serve.SpatialServer` as a
    backend.  ``launches`` are the server's card launches of the batch (one
    per level on the ``cuda`` rung, none below it); :meth:`drain_health`
    hands the ladder's ledger to ``AccessStats``."""

    def __init__(self, artifacts, *, query_block: int = 16, cache_size: int = 4096,
                 block_w: int = 128, precision: str = "float32", ladder=None,
                 max_retries: int = 2, backoff: float = 0.05, fault_plan=None):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
        # Imported here: launch.spatial_serve builds on the index package.
        from repro_torch.launch.spatial_serve import LADDER, SpatialServer

        if precision == "compact":
            quantized = artifacts.quantized
        elif precision == "compact8":
            quantized = artifacts.quantized8
        else:
            quantized = None
        self.server = SpatialServer(
            artifacts.schedule, device=artifacts.device, query_block=query_block,
            cache_size=cache_size,
            block_w=block_w, precision=precision, quantized=quantized,
            ladder=LADDER if ladder is None else ladder, max_retries=max_retries,
            backoff=backoff, fault_plan=fault_plan,
        )

    def region(self, queries: torch.Tensor):
        with _obs_trace.span("backend.serve", queries=queries.shape[0]):
            before = self.server.stats.kernel_launches
            hits, visits = self.server.search(queries)
            return hits, visits, self.server.stats.kernel_launches - before, None

    def bind_fault_plan(self, plan) -> None:
        self.server.bind_fault_plan(plan)

    def drain_health(self) -> dict:
        return self.server.drain_health()
