"""Live-update state over a frozen base build: delta buffer + tombstones.

Counterpart of ``repro.update.buffer``.  The paper's insertion strategy is
per-object and pointer-chasing; the device pipeline's unit of work is a
whole build.  :class:`UpdateLog` bridges the two the way LSM-ish spatial
systems do (DESIGN.md §8):

* **delta buffer** — a fixed-capacity block of MBR rows + validity mask.
  Inserts land in free slots at O(1); the fused sweep scans the buffer as
  appended FLAT levels of the same sweep that walks the base
  ``LevelSchedule`` (``uncond_from`` in :mod:`repro_torch.kernels.pyramid_scan`).
* **tombstones** — deletes mark an id dead in the ``alive`` bitmap; base
  slots keep streaming through the sweep and are masked in the epilogue,
  delta slots are freed in place.
* **merge** — :meth:`flush` compacts the live set (base survivors + valid
  delta rows, ascending global id = insertion order) into a fresh base
  build via the same build path the index was created with, resetting the
  buffer and tombstones.  :class:`repro_torch.update.policy.MergePolicy`
  decides when this happens automatically.

Object ids are GLOBAL and append-only: the base build's objects keep ids
``0..n-1``, every insert gets the next id, deletes never recycle ids, and
a flush preserves them — so hit masks are comparable across mutations and
bit-identical pre/post merge.  The id space is padded to ``id_capacity``
(grown only at flush) so array shapes stay fixed between merges.

The bookkeeping is host numpy, as in the reference.  What differs is
where the live sweep's arrays are made: the reference rebuilds every
array in numpy at each mutation epoch and uploads it, which at n = 1e6
re-copies ~200 MB of base tiles after every insert.  Here the base
schedule's device tensors stay where they are; each epoch builds only the
delta part (the (D, 4, W) delta tiles from ``capacity`` uploaded rows,
zero parents, the delta object rows and ``alive``) and joins it to the
base on the device.  The result equals the reference's arrays field for
field.

As in the reference, a merge runs inside an ``update.merge`` trace span
(:mod:`repro_torch.obs.trace`), and :attr:`UpdateLog.fault_plan` (a
:class:`repro_torch.ft.FaultPlan`, None in production) is called inside
it, after the new id space is laid out and before the base is rebuilt:
the mid-merge kill window of the durability tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.flat import NEVER_MBR, Q_NEVER_MBR
from repro_torch.obs import trace as _obs_trace

from .policy import MergePolicy


class BufferFullError(RuntimeError):
    """The delta buffer (or its id headroom) cannot absorb a batch and
    the merge policy forbids compacting implicitly (``auto=False``)."""


@dataclasses.dataclass(frozen=True)
class AugmentedArrays:
    """Array bundle for the live fused sweep: base levels + delta levels.

    ``arrays`` are the positional arguments of
    :func:`repro_torch.kernels.ops.fused_search_live`
    (``precision="float32"``) or
    :func:`repro_torch.kernels.ops.fused_search_compact_live` (``"compact"``)
    after ``queries``, as tensors on the base build's device; ``statics``
    are their keyword arguments.  One bundle is built per (mutation epoch
    × precision).
    """

    precision: str
    arrays: Tuple
    statics: dict
    levels: int        # total grid levels, base + delta
    base_levels: int
    n_objects: int     # id-space width of the hit mask


def _overlaps_np(a, b):
    """Closed-boundary rectangle intersection, broadcasting (numpy)."""
    return (
        (a[..., 0] <= b[..., 2])
        & (b[..., 0] <= a[..., 2])
        & (a[..., 1] <= b[..., 3])
        & (b[..., 1] <= a[..., 3])
    )


def _cat(parts):
    """``torch.cat`` along dim 0; uint16 goes through its int16 bits
    (uint16 has little op support on CUDA)."""
    if parts[0].dtype == torch.uint16:
        return torch.cat([p.view(torch.int16) for p in parts]).view(torch.uint16)
    return torch.cat(parts)


def _delta_tiles(rows: np.ndarray, never: np.ndarray, d: int, w: int,
                 dtype: torch.dtype, device) -> torch.Tensor:
    """The delta buffer as (d, 4, w) coordinate-major flat levels: slot s
    holds ``rows[s]`` (row-major (C, 4)) at level s // w, column s % w;
    the rest hold the ``never`` sentinel.  Built on ``device`` from the C
    uploaded rows (int32 for integer tiles, cast at the end)."""
    work = torch.float32 if dtype == torch.float32 else torch.int32
    flat = torch.from_numpy(np.asarray(never)).to(device=device, dtype=work)
    flat = flat.expand(d * w, 4).clone()
    flat[: rows.shape[0]] = torch.from_numpy(np.asarray(rows)).to(device=device,
                                                                  dtype=work)
    tiles = flat.view(d, w, 4).permute(0, 2, 1).contiguous()
    return tiles if dtype == work else tiles.to(dtype)


def _zeros_like_rows(like: torch.Tensor, d: int) -> torch.Tensor:
    """(d, W) zeros of ``like``'s dtype on its device (zero parents of the
    flat delta levels)."""
    if like.dtype == torch.uint16:
        return torch.zeros((d, like.shape[1]), dtype=torch.int16,
                           device=like.device).view(torch.uint16)
    return torch.zeros((d, like.shape[1]), dtype=like.dtype, device=like.device)


class UpdateLog:
    """Shared mutable live-update state (one per logical index).

    ``rebuild`` is the frozen-base build recipe — called with the live
    (n, 4) float64 MBRs at every merge, it must return a fresh
    ``BuildArtifacts``-shaped object (``.schedule`` / ``.quantized`` /
    ``.mbrs`` / ``.n_objects``).  Keeping it a callable keeps this module
    free of façade imports.
    """

    def __init__(self, artifacts, policy: MergePolicy,
                 rebuild: Callable[[np.ndarray], object]):
        self.policy = policy
        self.capacity = int(policy.capacity)
        self._rebuild = rebuild
        self.base = artifacts
        n = int(artifacts.n_objects)
        self.base_gids = np.arange(n, dtype=np.int64)
        self.next_gid = n
        self.id_capacity = n + self.capacity
        self.alive = np.zeros((self.id_capacity,), bool)
        self.alive[:n] = True
        self.mbr_table = np.zeros((self.id_capacity, 4), np.float64)
        self.mbr_table[:n] = np.asarray(artifacts.mbrs, np.float64)
        self.delta_mbrs = np.zeros((self.capacity, 4), np.float64)
        self.delta_gids = np.zeros((self.capacity,), np.int64)
        self.delta_valid = np.zeros((self.capacity,), bool)
        self._slot_of: Dict[int, int] = {}
        self._free = list(range(self.capacity - 1, -1, -1))
        self.dead_base = 0
        self.epoch = 0        # bumps on every mutation
        self.base_epoch = 0   # bumps on every merge (base arrays replaced)
        self.flushes = 0
        # fault-injection hook (repro_torch.ft.FaultPlan): lets the harness
        # stretch merges / kill mid-merge; None in production.
        self.fault_plan = None
        self._reset_caches()

    def _reset_caches(self) -> None:
        self._aug: Dict[str, Tuple[int, AugmentedArrays]] = {}
        self._base_obj_gid: Optional[Tuple[int, torch.Tensor]] = None
        self._oracle: Optional[Tuple[int, object]] = None

    # -- introspection --------------------------------------------------
    @property
    def n_base(self) -> int:
        return int(self.base_gids.shape[0])

    @property
    def n_delta(self) -> int:
        return self.capacity - len(self._free)

    @property
    def n_live(self) -> int:
        return int(self.alive.sum())

    @property
    def fill(self) -> float:
        return self.n_delta / self.capacity

    @property
    def tombstone_ratio(self) -> float:
        return self.dead_base / max(self.n_base, 1)

    @property
    def pending(self) -> bool:
        """Anything buffered that a merge would fold in?"""
        return self.n_delta > 0 or self.dead_base > 0

    # -- mutation -------------------------------------------------------
    def can_buffer(self, n: int) -> bool:
        """Room for ``n`` more inserts without merging?  Checks both free
        slots and id-space headroom (freed slots can be reused faster
        than ids, which never recycle)."""
        return len(self._free) >= n and self.next_gid + n <= self.id_capacity

    def buffer_insert(self, mbrs: np.ndarray) -> np.ndarray:
        """Place ``mbrs`` (n, 4) into free delta slots; returns their new
        global ids.  Caller must have checked :meth:`can_buffer`."""
        mbrs = np.asarray(mbrs, np.float64).reshape(-1, 4)
        n = mbrs.shape[0]
        if not self.can_buffer(n):
            raise BufferFullError(
                f"delta buffer cannot absorb {n} inserts "
                f"({len(self._free)} free slots, "
                f"{self.id_capacity - self.next_gid} ids) — flush first"
            )
        gids = np.arange(self.next_gid, self.next_gid + n, dtype=np.int64)
        self.next_gid += n
        for g, m in zip(gids, mbrs):
            s = self._free.pop()
            self.delta_mbrs[s] = m
            self.delta_gids[s] = g
            self.delta_valid[s] = True
            self._slot_of[int(g)] = s
        self.alive[gids] = True
        self.mbr_table[gids] = mbrs
        self.epoch += 1
        return gids

    def delete(self, gids) -> np.ndarray:
        """Tombstone the given live object ids.

        Base ids stay physically in the frozen build (masked in the scan
        epilogue until the next merge); delta ids free their slot in
        place.  A dead, unknown, or duplicated id raises ``KeyError``
        before anything is mutated.
        """
        gids = np.asarray(gids, np.int64).reshape(-1)
        if gids.size == 0:  # no mutation, no epoch bump
            return gids
        uniq, counts = np.unique(gids, return_counts=True)
        if (counts > 1).any():
            raise KeyError(
                f"duplicate id(s) in delete batch: {uniq[counts > 1].tolist()}"
            )
        bad = uniq[(uniq < 0) | (uniq >= self.next_gid)]
        if bad.size == 0:
            bad = uniq[~self.alive[uniq]]
        if bad.size:
            raise KeyError(f"object id(s) not live: {bad.tolist()}")
        for g in gids:
            g = int(g)
            self.alive[g] = False
            s = self._slot_of.pop(g, None)
            if s is None:
                self.dead_base += 1
            else:
                self.delta_valid[s] = False
                self.delta_mbrs[s] = 0.0
                self.delta_gids[s] = 0
                self._free.append(s)
        self.epoch += 1
        return gids

    def flush(self, force: bool = False) -> bool:
        """Compact buffer + tombstones into a fresh base build.

        No-op (returns False) when nothing is pending unless ``force``.
        """
        if not self.pending and not force:
            return False
        self._merge(extra_mbrs=None)
        return True

    def merge_insert(self, mbrs: np.ndarray) -> np.ndarray:
        """Oversized-batch path: fold ``mbrs`` straight into the merge,
        bypassing the buffer entirely; returns their new global ids."""
        mbrs = np.asarray(mbrs, np.float64).reshape(-1, 4)
        return self._merge(extra_mbrs=mbrs)

    def _merge(self, extra_mbrs: Optional[np.ndarray]) -> np.ndarray:
        extra = 0 if extra_mbrs is None else int(extra_mbrs.shape[0])
        with _obs_trace.span("update.merge", extra=extra, epoch=self.base_epoch):
            return self._merge_impl(extra_mbrs)

    def _merge_impl(self, extra_mbrs: Optional[np.ndarray]) -> np.ndarray:
        if extra_mbrs is not None and extra_mbrs.shape[0]:
            b = extra_mbrs.shape[0]
            extra_gids = np.arange(self.next_gid, self.next_gid + b,
                                   dtype=np.int64)
            self.next_gid += b
        else:
            extra_gids = np.zeros((0,), np.int64)
        new_id_capacity = max(self.id_capacity, self.next_gid + self.capacity)
        if new_id_capacity > self.id_capacity:
            alive = np.zeros((new_id_capacity,), bool)
            alive[: self.id_capacity] = self.alive
            table = np.zeros((new_id_capacity, 4), np.float64)
            table[: self.id_capacity] = self.mbr_table
            self.alive, self.mbr_table = alive, table
            self.id_capacity = new_id_capacity
        if extra_gids.size:
            self.alive[extra_gids] = True
            self.mbr_table[extra_gids] = extra_mbrs
        live = np.nonzero(self.alive)[0]
        if live.size == 0:
            raise ValueError(
                "cannot merge an index with no live objects; re-insert "
                "before flushing or keep the deletes buffered"
            )
        # Ascending global id == original insertion order: the canonical
        # order the host mqr-insertion oracle also uses.
        if self.fault_plan is not None:
            # Mid-merge fault window: the WAL record for the triggering op
            # is durable but the compaction has not replaced the base yet
            # — a kill here must recover by re-running the merge.
            self.fault_plan.merge_event()
        self.base = self._rebuild(self.mbr_table[live])
        self.base_gids = live.astype(np.int64)
        self.delta_mbrs[:] = 0.0
        self.delta_gids[:] = 0
        self.delta_valid[:] = False
        self._slot_of.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        self.dead_base = 0
        self.base_epoch += 1
        self.epoch += 1
        self.flushes += 1
        self._reset_caches()
        return extra_gids

    def snapshot(self) -> "UpdateLog":
        """Independent copy sharing only the frozen base artifacts —
        what ``SpatialIndex.extend`` mutates so the source index stays
        untouched."""
        new = UpdateLog.__new__(UpdateLog)
        new.policy = self.policy
        new.capacity = self.capacity
        new._rebuild = self._rebuild
        new.base = self.base
        new.base_gids = self.base_gids.copy()
        new.next_gid = self.next_gid
        new.id_capacity = self.id_capacity
        new.alive = self.alive.copy()
        new.mbr_table = self.mbr_table.copy()
        new.delta_mbrs = self.delta_mbrs.copy()
        new.delta_gids = self.delta_gids.copy()
        new.delta_valid = self.delta_valid.copy()
        new._slot_of = dict(self._slot_of)
        new._free = list(self._free)
        new.dead_base = self.dead_base
        new.epoch = self.epoch
        new.base_epoch = self.base_epoch
        new.flushes = self.flushes
        new.fault_plan = self.fault_plan
        new._reset_caches()
        return new

    # -- durability ------------------------------------------------------
    def state_arrays(self) -> Dict[str, np.ndarray]:
        """The complete mutable state as named arrays, for an index
        snapshot.  ``base`` itself is snapshotted by the caller (it owns
        the schedule arrays)."""
        return {
            "base_gids": self.base_gids,
            "alive": self.alive,
            "mbr_table": self.mbr_table,
            "delta_mbrs": self.delta_mbrs,
            "delta_gids": self.delta_gids,
            "delta_valid": self.delta_valid,
            "free": np.asarray(self._free, np.int64),
        }

    def state_scalars(self) -> Dict[str, int]:
        return {
            "capacity": self.capacity,
            "next_gid": int(self.next_gid),
            "id_capacity": int(self.id_capacity),
            "dead_base": int(self.dead_base),
            "epoch": int(self.epoch),
            "base_epoch": int(self.base_epoch),
            "flushes": int(self.flushes),
        }

    @classmethod
    def restore(cls, artifacts, policy: MergePolicy, rebuild,
                arrays: Dict[str, np.ndarray],
                scalars: Dict[str, int]) -> "UpdateLog":
        """Rebuild an :class:`UpdateLog` from snapshot state — the exact
        inverse of :meth:`state_arrays`/:meth:`state_scalars`, restoring
        slot layout (including free-slot order) bit-for-bit so replayed
        mutations land exactly where they would have pre-crash."""
        new = cls.__new__(cls)
        new.policy = policy
        new.capacity = int(scalars["capacity"])
        new._rebuild = rebuild
        new.base = artifacts
        new.base_gids = np.asarray(arrays["base_gids"], np.int64).copy()
        new.next_gid = int(scalars["next_gid"])
        new.id_capacity = int(scalars["id_capacity"])
        new.alive = np.asarray(arrays["alive"], bool).copy()
        new.mbr_table = np.asarray(arrays["mbr_table"], np.float64).copy()
        new.delta_mbrs = np.asarray(arrays["delta_mbrs"], np.float64).copy()
        new.delta_gids = np.asarray(arrays["delta_gids"], np.int64).copy()
        new.delta_valid = np.asarray(arrays["delta_valid"], bool).copy()
        new._slot_of = {
            int(g): int(s)
            for s, g in enumerate(new.delta_gids)
            if new.delta_valid[s]
        }
        new._free = [int(s) for s in np.asarray(arrays["free"], np.int64)]
        new.dead_base = int(scalars["dead_base"])
        new.epoch = int(scalars["epoch"])
        new.base_epoch = int(scalars["base_epoch"])
        new.flushes = int(scalars["flushes"])
        new.fault_plan = None
        new._reset_caches()
        return new

    # -- query-side lowerings ------------------------------------------
    def delta_dense_f32(self) -> np.ndarray:
        """(capacity, 4) float32 delta rows; empty slots carry the
        never-overlap sentinel, so they vanish from sweeps and counts."""
        return np.where(
            self.delta_valid[:, None], self.delta_mbrs, NEVER_MBR[None, :]
        ).astype(np.float32)

    def delta_id_mask(self) -> np.ndarray:
        """(id_capacity,) bool — global ids currently living in the delta
        buffer (the join path treats every pair touching one of these rows
        as a candidate)."""
        mask = np.zeros((self.id_capacity,), bool)
        if self.delta_valid.any():
            mask[self.delta_gids[self.delta_valid]] = True
        return mask

    def _delta_geometry(self):
        """Tile the capacity across flat levels of the base width."""
        w = self.base.schedule.width
        d = max(1, math.ceil(self.capacity / w))
        return w, d, d * w

    def _base_entry_gids(self) -> torch.Tensor:
        """Global id of every base schedule entry, on the base build's
        device, made once per merge."""
        if self._base_obj_gid is None or self._base_obj_gid[0] != self.base_epoch:
            sched = self.base.schedule
            gids = torch.from_numpy(self.base_gids).to(sched.device)
            self._base_obj_gid = (self.base_epoch,
                                  gids[sched.obj_id.long()].to(torch.int32))
        return self._base_obj_gid[1]

    def augmented(self, precision: str = "float32") -> AugmentedArrays:
        """The live sweep's arrays for this epoch (cached per precision):
        base schedule levels + the delta buffer as flat levels, object
        table remapped to global ids, ``alive`` tombstone mask — all on the
        base build's device."""
        if precision not in ("float32", "compact"):
            raise ValueError(f"unknown precision {precision!r}")
        cached = self._aug.get(precision)
        if cached is not None and cached[0] == self.epoch:
            return cached[1]
        sched = self.base.schedule
        dev = sched.device
        levels = sched.levels
        w, d, _ = self._delta_geometry()
        dm = self.delta_dense_f32()                                  # (C, 4)
        dm_dev = torch.from_numpy(dm).to(dev)
        slot = torch.arange(self.capacity, dtype=torch.int32, device=dev)
        obj_level = _cat([sched.obj_level, levels + slot // w])
        obj_slot = _cat([sched.obj_slot, slot % w])
        # Empty slots point at id 0 but their sentinel MBR never activates.
        delta_ids = np.where(self.delta_valid, self.delta_gids, 0).astype(np.int32)
        obj_id = _cat([self._base_entry_gids(), torch.from_numpy(delta_ids).to(dev)])
        alive = torch.from_numpy(self.alive.copy()).to(dev)
        statics = dict(
            n_objects=self.id_capacity,
            base_levels=levels,
            root_unconditional=sched.root_unconditional,
        )
        # The live contract is PER-OBJECT exactness, so every hit is
        # confirmed against the entry's own MBR (for pyramid schedules
        # that tightens the group semantics, as in the reference).
        if precision == "float32":
            delta_cm = _delta_tiles(dm, NEVER_MBR, d, w, torch.float32, dev)
            arrays = (
                _cat([sched.mbr_cm, delta_cm]),
                _cat([sched.parent, _zeros_like_rows(sched.parent, d)]),
                _cat([sched.obj_mbr, dm_dev]),
                obj_level, obj_slot, obj_id, alive,
            )
            statics["test_object_mbr"] = True
        else:
            from repro_torch.kernels.quantize import quantize_rows

            qs = self.base.quantized
            dq = quantize_rows(dm, qs.origin.cpu().numpy(), qs.inv_cell.cpu().numpy())
            delta_q = _delta_tiles(dq.astype(np.int32), Q_NEVER_MBR.astype(np.int32),
                                   d, w, torch.uint16, dev)
            arrays = (
                _cat([qs.mbr_q, delta_q]),
                _cat([qs.parent_q, _zeros_like_rows(qs.parent_q, d)]),
                _cat([sched.obj_mbr, dm_dev]),
                obj_level, obj_slot, obj_id, qs.origin, qs.inv_cell, alive,
            )
            statics["cells"] = qs.cells
        aug = AugmentedArrays(
            precision=precision,
            arrays=arrays,
            statics=statics,
            levels=levels + d,
            base_levels=levels,
            n_objects=self.id_capacity,
        )
        self._aug[precision] = (self.epoch, aug)
        return aug

    def compose(self, hits_pos: np.ndarray, visits: np.ndarray,
                queries: np.ndarray):
        """Lift a POSITIONAL base result into the live global-id space —
        the host composition path: scatter base hits to global ids,
        overlay the delta-buffer scan, mask tombstones, and append the
        delta visit columns (same counts as the fused delta levels)."""
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        hits = np.zeros((nq, max(self.id_capacity, 1)), bool)
        hits[:, self.base_gids] = hits_pos[:, : self.n_base]
        dm = self.delta_dense_f32()
        ov = _overlaps_np(dm[None, :, :], queries[:, None, :])      # (Q, C)
        if self.delta_valid.any():
            valid = self.delta_valid
            hits[:, self.delta_gids[valid]] = ov[:, valid]
        hits &= self.alive[None, :]
        # Per-object confirming pass, mirroring the fused live epilogue:
        # structure candidates ∧ exact object-MBR overlap (float32, the
        # device convention) — pyramid group-union semantics never leak.
        table = self.mbr_table.astype(np.float32)
        hits &= _overlaps_np(table[None, :, :], queries[:, None, :])
        w, d, s = self._delta_geometry()
        ovp = np.concatenate(
            [ov, np.zeros((nq, s - self.capacity), bool)], axis=1
        )
        delta_visits = ovp.reshape(nq, d, w).sum(axis=2).astype(visits.dtype)
        return hits, np.concatenate([visits, delta_visits], axis=1)
