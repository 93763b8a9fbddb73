"""Built-in query backends of the :class:`SpatialIndex` registry.

Two engines over the same search semantics:

* ``host`` — the oracle: the level sweep of the schedule in numpy on the
  CPU, the counterpart of the JAX package's ``schedule_region_numpy``;
* ``cuda`` — the fused sweep of :mod:`repro_torch.kernels.pyramid_scan`
  (the counterpart of the JAX ``pallas`` backend), at
  ``precision="float32"`` or ``"compact"``, with ``query_block`` chunking.

Every adapter returns ``(hits (Q, n_obj) bool, visits (Q, L) int32,
launches int)`` with identical hits and per-level access counts.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.flat import LevelSchedule
from repro_torch.kernels import ops

from .registry import register_backend

ALL_STRUCTURES = ("pyramid",)
PRECISIONS = ("float32", "compact")


def _roadmap(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet; see ROADMAP.md")


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
    doc="numpy level sweep of the schedule on the CPU; the oracle",
)
class HostBackend:
    def __init__(self, artifacts):
        self.schedule = artifacts.schedule.to("cpu")

    def region(self, queries: torch.Tensor):
        hits, visits = schedule_region_numpy(self.schedule, queries.cpu().numpy())
        return torch.from_numpy(hits), torch.from_numpy(visits), 0


@register_backend(
    "cuda",
    structures=ALL_STRUCTURES,
    doc="fused level sweep (csrc/level_sweep.cu on the card, its plain "
        "version on the CPU); precision='compact' sweeps conservative "
        "uint16 tiles with an exact float32 confirming pass",
)
class CudaBackend:
    """Fused-sweep adapter with the fixed tiling of the JAX ``pallas``
    backend's ``autotune="off"``: ``block_w`` is the kernel's thread-block
    width over slots, ``query_block`` splits a batch into chunks of at most
    that many queries.  ``launches`` counts one sweep launch per level per
    chunk (the TPU kernel made one per chunk)."""

    def __init__(self, artifacts, *, block_w: int = 128, precision: str = "float32",
                 stream: bool = False, autotune: str = "off",
                 query_block: int | None = None):
        if precision == "compact8":
            raise _roadmap("precision='compact8'")
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
        if stream:
            raise _roadmap("stream=True (the HBM-streaming sweep)")
        if autotune in ("auto", "on"):
            raise _roadmap(f"autotune={autotune!r}")
        if autotune != "off":
            raise ValueError(f"unknown autotune {autotune!r}")
        if query_block is not None and query_block < 1:
            raise ValueError(f"query_block must be >= 1, got {query_block}")
        self.precision = precision
        self.schedule = artifacts.schedule
        self.qschedule = artifacts.quantized if precision == "compact" else None
        self.block_w = block_w
        self.query_block = query_block

    def _run_one(self, queries: torch.Tensor):
        if self.precision == "compact":
            hits, visits = ops.pyramid_scan_compact(
                self.qschedule, queries, block_w=self.block_w)
        else:
            hits, visits = ops.pyramid_scan(self.schedule, queries, block_w=self.block_w)
        return hits, visits, self.schedule.levels

    def region(self, queries: torch.Tensor):
        qb = self.query_block
        if qb and queries.shape[0] > qb:
            parts = [self._run_one(queries[i:i + qb])
                     for i in range(0, queries.shape[0], qb)]
            return (torch.cat([p[0] for p in parts]),
                    torch.cat([p[1] for p in parts]),
                    sum(p[2] for p in parts))
        return self._run_one(queries)
