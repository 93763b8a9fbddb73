"""Update-aware query engines: how each façade backend sweeps base ∪ delta.

Counterpart of ``repro.update.engine`` for the port's two backends.  One
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

The reference's ``serve`` engine waits for the port's serving layer
(ROADMAP queue A item 5).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

from .buffer import UpdateLog


class LiveEngine:
    """Region queries over base ∪ delta − tombstones for one backend."""

    def __init__(self, log: UpdateLog, backend: str, backend_opts: dict):
        self.log = log
        self.backend = backend
        self.opts = dict(backend_opts)

    def region(self, queries: torch.Tensor, base_region=None):
        """Returns ``(hits (Q, id_capacity), visits (Q, L+D), launches)``.

        ``base_region`` is the pristine backend's positional region
        callable — required for the composed ``host`` path, ignored by the
        fused ``cuda`` path.
        """
        if self.backend == "host":
            hits_pos, visits, launches = base_region(queries)
            hits, visits = self.log.compose(
                hits_pos.numpy(), visits.numpy(), queries.cpu().numpy()
            )
            return torch.from_numpy(hits), torch.from_numpy(visits), launches
        if self.backend == "cuda":
            return self._fused(queries)
        raise ValueError(f"no live engine for backend {self.backend!r}")

    def _fused(self, queries: torch.Tensor):
        precision = self.opts.get("precision", "float32")
        if precision == "compact8":
            precision = "compact"
        aug = self.log.augmented(precision)
        fn = (ops.fused_search_compact_live if precision == "compact"
              else ops.fused_search_live)
        hits, visits = fn(queries, *aug.arrays,
                          block_w=self.opts.get("block_w") or 128, **aug.statics)
        return hits, visits, aug.levels
