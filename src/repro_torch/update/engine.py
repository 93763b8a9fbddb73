"""Update-aware query engines: how each façade backend sweeps base ∪ delta.

Counterpart of ``repro.update.engine``.  One
:class:`LiveEngine` per ``SpatialIndex``; all engines over the same
:class:`repro_torch.update.buffer.UpdateLog` answer from the same live
state, so hit sets and per-level visit counts agree bit-for-bit across
backends:

* ``host`` — the pristine backend sweeps the frozen base (positional
  ids), then :meth:`UpdateLog.compose` lifts the result into global-id
  space: delta overlap scan + tombstone mask + appended delta visit
  columns, in numpy.
* ``cuda`` — one fused sweep: :func:`repro_torch.kernels.ops.fused_search_live`
  sweeps base levels and the delta buffer's flat levels together and
  masks tombstones in the epilogue (compact precision uses the quantized
  twin with its exact confirming pass).  ``compact8`` normalises to
  ``compact`` (delta rows ride the fine uint16 grid); the live sweep is
  always the resident kernel, with ``block_w or 128`` and no query
  chunking, as in the reference.
* ``torch`` — the same fused live sweep with ``engine="torch"`` (the
  plain versions) on the index's device, float32; the reference's ``lax``
  composes on the host instead, with the same answers.
* ``serve`` — a :class:`repro_torch.launch.spatial_serve.SpatialServer`
  bound to the augmented arrays: a fresh server per base epoch (a merge
  changes the shapes), and :meth:`SpatialServer.rebind` per mutation
  epoch, whose epoch tag keeps LRU entries cached under older epochs from
  being served.  compact8 normalises to compact here too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops

from .buffer import UpdateLog


class LiveEngine:
    """Region queries over base ∪ delta − tombstones for one backend."""

    def __init__(self, log: UpdateLog, backend: str, backend_opts: dict):
        self.log = log
        self.backend = backend
        self.opts = dict(backend_opts)
        self._serve: Optional[Tuple[Tuple[int, str], object]] = None

    def bind_fault_plan(self, plan) -> None:
        """Thread a fault-injection plan into the live serve path."""
        self.opts["fault_plan"] = plan
        if self._serve is not None:
            self._serve[1].bind_fault_plan(plan)

    def drain_health(self) -> Optional[dict]:
        """Health-ladder counter deltas from the live server (None when
        this engine has no server)."""
        if self._serve is None:
            return None
        return self._serve[1].drain_health()

    def region(self, queries: torch.Tensor, base_region=None):
        """Returns ``(hits (Q, id_capacity), visits (Q, L+D), launches)``.

        ``base_region`` is the pristine backend's positional region
        callable — required for the composed ``host`` path, ignored by the
        fused paths.
        """
        if self.backend == "host":
            hits_pos, visits, launches = base_region(queries)
            hits, visits = self.log.compose(
                hits_pos.numpy(), visits.numpy(), queries.cpu().numpy()
            )
            return torch.from_numpy(hits), torch.from_numpy(visits), launches
        if self.backend == "cuda":
            return self._fused(queries)
        if self.backend == "torch":
            return self._fused(queries, engine="torch")
        if self.backend == "serve":
            return self._serve_region(queries)
        raise ValueError(f"no live engine for backend {self.backend!r}")

    def _precision(self) -> str:
        precision = self.opts.get("precision", "float32")
        return "compact" if precision == "compact8" else precision

    def _fused(self, queries: torch.Tensor, engine: str = "kernel"):
        precision = self._precision()
        aug = self.log.augmented(precision)
        fn = (ops.fused_search_compact_live if precision == "compact"
              else ops.fused_search_live)
        hits, visits = fn(queries, *aug.arrays, block_w=self.opts.get("block_w") or 128,
                          engine=engine, **aug.statics)
        return hits, visits, aug.levels if engine == "kernel" else 0

    def _serve_region(self, queries: torch.Tensor):
        from repro_torch.launch.spatial_serve import LADDER, SpatialServer

        log = self.log
        precision = self._precision()
        key = (log.base_epoch, precision)
        if self._serve is None or self._serve[0] != key:
            # Fresh server per merge: a flush changes the array shapes.
            aug = log.augmented(precision)
            server = SpatialServer(
                log.base.schedule,
                device=log.base.device,
                query_block=self.opts.get("query_block") or 16,
                cache_size=self.opts.get("cache_size", 4096),
                block_w=self.opts.get("block_w") or 128,
                precision=precision,
                live=aug,
                ladder=self.opts.get("ladder") or LADDER,
                max_retries=self.opts.get("max_retries", 2),
                backoff=self.opts.get("backoff", 0.05),
                fault_plan=self.opts.get("fault_plan"),
            )
            server.rebind(aug.arrays, epoch=log.epoch)
            self._serve = (key, server)
        server = self._serve[1]
        if server.epoch != log.epoch:
            # Same shapes, new delta contents: swap the arrays and advance
            # the epoch tag (stale LRU entries stop matching).
            server.rebind(log.augmented(precision).arrays, epoch=log.epoch)
        before = server.stats.kernel_launches
        hits, visits = server.search(queries)
        return hits, visits, server.stats.kernel_launches - before
