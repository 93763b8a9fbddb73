"""Batch tree-vs-tree spatial join behind the ``SpatialIndex`` façade.

Counterpart of ``repro.index.join``.  ``left.join(right)`` pairs two
indexes — any structure × any structure, live or pristine — through one
levelized pair sweep:

* both sides' :class:`~repro_torch.core.flat.LevelSchedule`s are trimmed
  to their common depth ``K = min(levels_a, levels_b)`` and swept
  level-synchronized; the LEFT index's backend picks the engine:
  ``cuda`` runs :func:`repro_torch.kernels.ops.fused_join` (kernel #6,
  one launch per level, with a plain-torch epilogue; its plain version on
  the CPU), ``torch`` the same with the plain pair sweep on the left
  index's device, ``host`` the same function on CPU tensors, and
  ``serve`` walks the degradation ladder :data:`JOIN_LADDER`;
* the right index's arrays move to the left index's device, and the
  result's tensors live there;
* ``precision="compact"`` (on the left index) quantizes BOTH sides' tiles
  outward onto one JOINT uint16 grid over the union of the two live
  object sets, built in float64 on the host; ``compact8`` joins on
  float32 tiles, as in the JAX package;
* live state rides along: the frozen base schedule goes through the sweep,
  delta-buffer rows on either side become unconditional candidate rows,
  and tombstones are masked in the epilogue;
* every engine ends with the same exact float32 object-MBR confirming
  pass, so the pair set equals the brute-force nested-loop oracle on
  every structure × backend × precision; precision and pruning quality
  only move the pair-visit ledger.

The ``serve`` backend walks ``cuda → torch → host`` per join call
(:data:`repro_torch.kernels.fallback.JOIN_FALLBACKS` are the lower rungs),
honouring the left index's bound :class:`repro_torch.ft.FaultPlan`, through
the region server's walk (:func:`repro_torch.kernels.fallback.run_ladder`):
the same trace events, a ``RuntimeWarning`` on every degrade, and rung
dispatches, failures and degraded calls folded into the index's
``AccessStats``.  It has no retries and no sticky floor: a failing rung
degrades at once, and the next call starts at ``cuda`` again, as in the
reference.  On the card only an injected failure degrades; a real kernel
error raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.flat import CELLS, LevelSchedule, ancestor_chains
from repro_torch.kernels import fallback, join_scan, ops
from repro_torch.kernels.quantize import quantize_rows

PREDICATES = ("intersects",)

#: degradation-ladder rung order for serve-backend joins
JOIN_LADDER = ("cuda", "torch", "host")


@dataclasses.dataclass(frozen=True)
class JoinResult:
    """Result of ``left.join(right)``; tensors on the left index's device.

    pairs:       (id_space_left, id_space_right) bool — pair (i, j) is
                 True iff live object ``i`` of the left index and live
                 object ``j`` of the right index overlap (closed
                 boundaries, the paper's region semantics).
    pair_visits: (K + 2,) int64 — tile-pair tests per synchronized sweep
                 level (the join analogue of the paper's disk accesses),
                 then one column per side counting the delta-buffer
                 cross-scan's exact tests.
    base_levels: K, the synchronized sweep depth (== min of the two
                 schedules' level counts).
    """

    pairs: torch.Tensor
    pair_visits: torch.Tensor
    base_levels: int

    @property
    def n_pairs(self) -> int:
        return int(join_scan.count_true(self.pairs))

    @property
    def sweep_visits(self) -> torch.Tensor:
        """Per-level tile-pair tests of the structure sweep alone."""
        return self.pair_visits[: self.base_levels]

    @property
    def delta_tests(self) -> torch.Tensor:
        """(2,) exact tests spent on (left, right) delta-buffer rows."""
        return self.pair_visits[self.base_levels:]

    def pair_list(self) -> torch.Tensor:
        """(P, 2) int64 (left_id, right_id) pairs, lexicographic."""
        return torch.nonzero(self.pairs)


@dataclasses.dataclass(frozen=True)
class _Side:
    """One join operand lowered to the kernel's view of it."""

    sched: LevelSchedule      # on the join's device
    table: np.ndarray         # (N, 4) float32 global-id MBR table
    alive: np.ndarray         # (N,) bool
    delta: np.ndarray         # (N,) bool — ids in the delta buffer
    entry_gid: torch.Tensor   # (E,) int32 — schedule entries -> global ids


def _side_state(idx, device: torch.device) -> _Side:
    """Lower one index (pristine or live) to its join-side arrays on
    ``device``.

    Live indexes expose the frozen base schedule for the structure sweep
    (delta rows become unconditional candidates), the full global-id MBR
    table, the tombstone mask, and the base-entry -> global-id remap — the
    same decomposition ``UpdateLog.augmented`` feeds the live region sweep.
    """
    log = idx._updates
    sched = idx.artifacts.schedule.to(device)
    if log is None:
        table = np.asarray(idx.artifacts.mbrs, np.float32)
        n = table.shape[0]
        return _Side(sched=sched, table=table, alive=np.ones((n,), bool),
                     delta=np.zeros((n,), bool), entry_gid=sched.obj_id)
    return _Side(
        sched=sched,
        table=log.mbr_table.astype(np.float32),
        alive=log.alive.copy(),
        delta=log.delta_id_mask(),
        entry_gid=log._base_entry_gids().to(device),
    )


def _joint_grid(side_a: _Side, side_b: _Side):
    """Shared uint16 grid over the union of both LIVE object sets —
    coordinate-major ``(origin, inv_cell)`` exactly like
    :func:`repro_torch.kernels.quantize.grid_params`, but spanning two
    indexes (float64 on the host).  Integer pair overlap is only
    conservative when both sides round outward onto the SAME grid."""
    rows = np.concatenate(
        [side_a.table[side_a.alive], side_b.table[side_b.alive]], axis=0
    ).astype(np.float64)
    if rows.shape[0] == 0:  # both sides fully tombstoned: any grid works
        return np.zeros((4,), np.float32), np.ones((4,), np.float32)
    lo = rows[:, :2].min(axis=0)
    hi = rows[:, 2:].max(axis=0)
    with np.errstate(divide="ignore"):
        inv = np.minimum(CELLS / np.maximum(hi - lo, 0.0), 1e30)
    origin = np.concatenate([lo, lo]).astype(np.float32)
    inv_cell = np.concatenate([inv, inv]).astype(np.float32)
    return origin, inv_cell


def _quantize_cm(mbr_cm: torch.Tensor, origin, inv_cell) -> torch.Tensor:
    """(K, 4, W) float32 level tiles -> uint16 on the joint grid, via the
    host row quantizer (the same float32 arithmetic as the schedule
    path); returned on ``mbr_cm``'s device."""
    k, _, w = mbr_cm.shape
    rows = mbr_cm.permute(0, 2, 1).reshape(-1, 4).cpu().numpy()
    q = quantize_rows(rows, origin, inv_cell).astype(np.int32)
    q = np.ascontiguousarray(q.reshape(k, w, 4).transpose(0, 2, 1))
    return torch.from_numpy(q).to(mbr_cm.device).to(torch.uint16)


def lower_join(left, right):
    """Lower ``left.join(right)`` to the arguments of
    :func:`repro_torch.kernels.ops.fused_join` on the left index's device;
    returns ``(args, k, symmetric)``.

    Self-join fast path: when both sides are the SAME index object the
    pair mask is symmetric at every level, so only the upper triangle is
    swept and the epilogue mirrors it.  Pairs stay identical to the full
    sweep; only the visit ledger shrinks.  (``with_backend`` makes a new
    object, so ``idx.join(idx.with_backend(...))`` sweeps in full.)
    """
    dev = left.device
    side_a = _side_state(left, dev)
    side_b = _side_state(right, dev)
    k = min(side_a.sched.levels, side_b.sched.levels)
    a_cm = side_a.sched.mbr_cm[:k]
    b_cm = side_b.sched.mbr_cm[:k]
    if left._backend_opts.get("precision", "float32") == "compact":
        origin, inv_cell = _joint_grid(side_a, side_b)
        a_cm = _quantize_cm(a_cm, origin, inv_cell)
        b_cm = _quantize_cm(b_cm, origin, inv_cell)

    def upload(a):
        return torch.from_numpy(a).to(dev)

    args = (
        a_cm, side_a.sched.parent[:k], ancestor_chains(side_a.sched, k),
        side_a.sched.obj_level, side_a.entry_gid,
        b_cm, side_b.sched.parent[:k], ancestor_chains(side_b.sched, k),
        side_b.sched.obj_level, side_b.entry_gid,
        upload(side_a.table), upload(side_b.table),
        upload(side_a.alive), upload(side_b.alive),
        upload(side_a.delta), upload(side_b.delta),
    )
    return args, k, right is left


def join_impl(left, right, predicate: str = "intersects"):
    """Execute ``left.join(right)``; returns ``(JoinResult, launches)``.

    The left index picks the engine (backend, precision) and the device:
    ``cuda`` runs :func:`repro_torch.kernels.ops.fused_join` on the left
    index's device, ``torch`` its plain pair sweep there, ``host`` the
    same function on CPU tensors, ``serve`` the ladder; both sides
    contribute structure + live state.  ``launches`` counts one kernel
    launch per swept level on the ``cuda`` backend and rung (ROADMAP C7).
    """
    if predicate not in PREDICATES:
        raise ValueError(
            f"unknown join predicate {predicate!r}; expected one of {PREDICATES}")
    args, k, symmetric = lower_join(left, right)
    backend = left.spec.name
    if backend != "serve":
        rung = backend if backend in JOIN_LADDER else "host"
        pairs, visits, launches = _dispatch(rung, args, k, symmetric, left.device)
        return JoinResult(pairs, visits, base_levels=k), launches

    # serve: walk the degradation ladder, same health ledger as region;
    # no retries and no sticky floor, as in the reference
    ledger = fallback.LadderLedger()
    try:
        (pairs, visits, launches), _ = fallback.run_ladder(
            JOIN_LADDER, lambda rung: _dispatch(rung, args, k, symmetric, left.device),
            ledger=ledger, device=left.device, fault_plan=left._fault_plan,
            who="SpatialIndex.join")
    finally:
        left.stats.absorb_health(dataclasses.asdict(ledger))
    return JoinResult(pairs, visits, base_levels=k), launches


def _dispatch(rung: str, args, k: int, symmetric: bool, device: torch.device):
    """Run one ladder rung over the lowered join arrays; returns ``(pairs,
    visits, launches)`` on ``device``."""
    if rung == "cuda":
        pairs, visits = ops.fused_join(*args, symmetric=symmetric)
        return pairs, visits, k
    if rung == "torch":
        pairs, visits = fallback.JOIN_FALLBACKS["torch"](*args, symmetric=symmetric)
    else:
        pairs, visits = fallback.JOIN_FALLBACKS["host"](*args, symmetric=symmetric)
    return pairs.to(device), visits.to(device), 0
