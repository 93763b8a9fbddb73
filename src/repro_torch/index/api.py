"""`SpatialIndex` — the façade over the port's build and query paths.

Counterpart of ``repro.index.api`` for the slices ported so far:

    idx = SpatialIndex.build(mbrs)   # the paper's mqr-tree, autotuned sweep
    res = idx.region(queries)        # RegionResult(hits, visits_per_level)
    res = idx.point(points)          # degenerate-rectangle queries
    cnt = idx.count(queries)         # hits per query
    nn  = idx.knn(points, k)         # KNNResult(ids, dists, visits)
    jr  = idx.join(other)            # JoinResult(pairs, pair_visits)
    idx.save(path); SpatialIndex.load(path)   # versioned snapshots

Structures: ``mqr`` (the default, the paper's pointer tree, built on the
host), ``rtree`` (Guttman baseline) and ``pyramid`` (bulk fixed point,
``build="device"`` on the card).  Backends: ``cuda`` (the hand-written
kernels), ``torch`` (their plain versions on the index's device),
``host`` (the numpy / pointer oracle) and ``serve`` (the batching
:class:`repro_torch.launch.spatial_serve.SpatialServer`, whose degradation
ladder walks cuda → torch → host).  Everything runs on the CUDA card unless
``device="cpu"`` is passed (then each kernel's plain PyTorch version
runs); without a card and without that request, building raises.  Results
are torch tensors on the backend's device.

Durability: :meth:`SpatialIndex.save` / :meth:`SpatialIndex.load` write
and read the JAX package's snapshot format (:mod:`repro_torch.checkpoint`),
so a snapshot saved by either package loads in the other; a
:class:`repro_torch.ft.FaultPlan` (``fault_plan=``) threads through the
update log and the serving ladder.  The façade's spans
(``index.region``/``insert``/``delete``/``flush``/``join``/``knn``) go to
:mod:`repro_torch.obs.trace`.

Online mutation (DESIGN.md §8): :meth:`SpatialIndex.insert` /
:meth:`delete` / :meth:`flush` route through :mod:`repro_torch.update` —
inserts land in a delta buffer swept by the same fused sweep as flat
levels, deletes tombstone ids masked in the sweep's epilogue, and a merge
policy decides when to compact into a fresh base build.  Object ids are
global and append-only, so hit masks stay comparable across mutations and
merges.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import bulk, mqrtree, rtree
from repro_torch.core.flat import (
    FlatTree,
    LevelSchedule,
    QuantizedSchedule,
    flatten,
    level_schedule,
    pyramid_schedule,
)
from repro_torch.core.metrics import compute_metrics
from repro_torch.kernels import ops
from repro_torch.obs import trace as _obs_trace
from repro_torch.update import BufferFullError, MergePolicy, UpdateLog, as_policy
from repro_torch.update.engine import LiveEngine
from repro_torch.update.oracle import live_tree

from . import knn as _knn
from .registry import BackendSpec, get_backend

STRUCTURES = ("mqr", "rtree", "pyramid")

# Build-time options; everything else in **opts goes to the backend factory.
_BUILD_OPTS = ("levels", "max_entries", "build", "order")
# Live-update / durability options (structure-agnostic, façade-consumed).
_UPDATE_OPTS = ("capacity", "merge", "admission", "fault_plan")

# Admission policies for mutations that cannot be buffered.
ADMISSION_MODES = ("merge", "shed")


class InvalidQueryError(ValueError):
    """A query rectangle/point rejected at the serving boundary —
    NaN/±inf coordinates or an inverted rectangle."""


def validate_mbrs(mbrs, *, what: str = "mbrs") -> np.ndarray:
    """Reject NaN / ±inf coordinates and inverted rectangles (lo > hi)
    with a ``ValueError``; returns the validated (n, 4) float64 array.
    Degenerate-but-valid points (lo == hi) pass."""
    if isinstance(mbrs, torch.Tensor):
        mbrs = mbrs.detach().cpu().numpy()
    arr = np.asarray(mbrs, np.float64)
    if arr.size % 4 != 0:
        raise ValueError(
            f"{what} must be (n, 4) [xlo, ylo, xhi, yhi]; got shape {arr.shape}"
        )
    arr = arr.reshape(-1, 4)
    if not np.isfinite(arr).all():
        bad = int(np.nonzero(~np.isfinite(arr).all(axis=1))[0][0])
        raise ValueError(
            f"{what}[{bad}] has a non-finite coordinate "
            f"({arr[bad].tolist()}); NaN/±inf MBRs are rejected"
        )
    inverted = (arr[:, 0] > arr[:, 2]) | (arr[:, 1] > arr[:, 3])
    if inverted.any():
        bad = int(np.nonzero(inverted)[0][0])
        raise ValueError(f"{what}[{bad}] is inverted (lo > hi): {arr[bad].tolist()}")
    return arr


def validate_queries(queries, *, what: str = "queries") -> np.ndarray:
    """:func:`validate_mbrs` for query rectangles, raising the typed
    :class:`InvalidQueryError`; returns (Q, 4) float32."""
    try:
        arr = validate_mbrs(queries, what=what)
    except ValueError as e:
        raise InvalidQueryError(str(e)) from None
    return np.ascontiguousarray(arr, np.float32)


@dataclasses.dataclass(frozen=True)
class RegionResult:
    """Result of a batched region (or point) search.

    hits:             (Q, id_space) bool object-overlap mask — columns are
                      GLOBAL object ids (build positions until live updates
                      begin; append-only afterwards).
    visits_per_level: (Q, L) int32 node accesses by tree level — the
                      paper's disk accesses broken down by depth.  Once
                      live updates begin, columns past ``base_levels`` are
                      the delta buffer's flat-scan accesses.
    base_levels:      levels of the frozen base build; None for an index
                      with no live-update state.
    """

    hits: torch.Tensor
    visits_per_level: torch.Tensor
    base_levels: Optional[int] = None

    @property
    def visits(self) -> torch.Tensor:
        """(Q,) total accesses per query."""
        return self.visits_per_level.sum(dim=1)

    @property
    def counts(self) -> torch.Tensor:
        """(Q,) number of objects found per query."""
        return self.hits.sum(dim=1)

    def ids(self, i: int) -> torch.Tensor:
        """Object ids found by query ``i`` (ascending)."""
        return torch.nonzero(self.hits[i]).flatten()

    @property
    def delta_visits(self) -> torch.Tensor:
        """(Q,) delta-buffer accesses per query (all zero when the index
        has no live-update state)."""
        if self.base_levels is None:
            return torch.zeros((self.visits_per_level.shape[0],), dtype=torch.int64,
                               device=self.visits_per_level.device)
        return self.visits_per_level[:, self.base_levels:].sum(dim=1, dtype=torch.int64)


@dataclasses.dataclass(frozen=True)
class KNNResult:
    """Result of a batched k-nearest-neighbour query (tensors on the
    backend's device).

    ids:    (Q, k) int32 object ids, nearest first.
    dists:  (Q, k) float32 Euclidean MBR min-distances, ascending.
    visits: (Q,) int64 node accesses spent answering each query (for the
            device path: summed over every expanding-radius round).
    """

    ids: torch.Tensor
    dists: torch.Tensor
    visits: torch.Tensor


@dataclasses.dataclass
class AccessStats:
    """The paper's disk-access accounting, accumulated over the lifetime
    of a :class:`SpatialIndex`, with the durability and degradation
    ledger of the JAX package's ``AccessStats``.

    ``launches`` counts the hand-written kernels' launches on the card
    (one per level per sweep chunk, K per join; 0 on the ``torch`` and
    ``host`` backends and rungs), not the TPU kernel's one launch per
    16-query block, so comparisons with the reference leave it out.
    Not here yet: the serving front end's ``shed_queries`` and
    ``queued_queries`` (they come with ``serve/``), and the byte and tile
    ledger ``bytes_streamed``, ``mask_bytes``, ``tiles_fetched`` and
    ``launch_reports`` (they come with ``obs/counters`` derived for the
    card).  ``tiles_skipped`` is the streaming sweep's own count, made on
    the device (ROADMAP C6).
    """

    queries: int = 0
    node_accesses: int = 0
    launches: int = 0        # kernel launches (0 for the host backend)
    knn_queries: int = 0
    knn_rounds: int = 0      # expanding-radius region rounds issued
    joins: int = 0           # tree-vs-tree join calls
    # live-update ledger
    inserts: int = 0
    deletes: int = 0
    flushes: int = 0         # merges (manual, policy, or overflow)
    delta_accesses: int = 0  # node_accesses spent on delta-buffer levels
    # durability / degradation ledger
    launch_failures: int = 0   # rung dispatch attempts that raised
    retries: int = 0           # same-rung retries after a failure
    degraded_batches: int = 0  # batches answered below the top rung
    shed_mutations: int = 0    # objects dropped by admission="shed"
    queued_mutations: int = 0  # objects parked by DurableIndex queueing
    rung_dispatches: dict = dataclasses.field(default_factory=dict)
    # (level, tile) pairs the streaming sweep (stream=True) skipped, as the
    # kernel counted them on the device
    tiles_skipped: int = 0

    def record(self, n_queries: int, accesses: int, launches: int) -> None:
        self.queries += int(n_queries)
        self.node_accesses += int(accesses)
        self.launches += int(launches)

    def absorb_health(self, health: Optional[dict]) -> None:
        """Fold one :meth:`SpatialServer.drain_health` delta into the
        ledger (no-op for backends without a degradation ladder)."""
        if not health:
            return
        self.retries += int(health.get("retries", 0))
        self.degraded_batches += int(health.get("degraded_batches", 0))
        self.launch_failures += sum(int(v) for v in health.get("rung_failures", {}).values())
        for rung, n in health.get("rung_dispatches", {}).items():
            if n:
                self.rung_dispatches[rung] = self.rung_dispatches.get(rung, 0) + int(n)

    def to_dict(self) -> dict:
        """Flat snapshot of every counter (``rung_dispatches`` stays a
        nested dict) — the form for metrics export and for windowed deltas
        via :meth:`diff`."""
        out = dataclasses.asdict(self)
        out["rung_dispatches"] = dict(self.rung_dispatches)
        return out

    def diff(self, prev) -> dict:
        """Counter deltas since ``prev`` (an :class:`AccessStats` or a
        previous :meth:`to_dict` snapshot).  Zero rung entries are
        dropped."""
        prev_d = prev.to_dict() if isinstance(prev, AccessStats) else dict(prev)
        out = {}
        for k, v in self.to_dict().items():
            if isinstance(v, dict):
                pv = prev_d.get(k) or {}
                d = {r: n - pv.get(r, 0) for r, n in v.items()}
                out[k] = {r: n for r, n in d.items() if n}
            else:
                out[k] = v - prev_d.get(k, 0)
        return out

    @property
    def degraded(self) -> bool:
        """True once any batch was answered below the top rung."""
        return self.degraded_batches > 0

    @property
    def accesses_per_query(self) -> float:
        return self.node_accesses / max(self.queries, 1)


def _reject_opts(structure: str, **opts) -> None:
    """A build option the chosen structure does not use fails loudly."""
    bad = [k for k, v in opts.items() if v is not None]
    if bad:
        raise TypeError(f"structure {structure!r} does not accept option(s) {bad}")


class BuildArtifacts:
    """One built structure plus its lazily lowered forms (the flat tree,
    the level schedule, and its quantized tile forms for
    ``precision="compact"`` and ``"compact8"``), computed once and shared
    by every backend over this build.  The schedules live on ``device``;
    the pointer trees and the flat tree live on the host."""

    def __init__(self, structure: str, mbrs, *, device=None, levels=None,
                 max_entries=None, build=None, order=None):
        if structure not in STRUCTURES:
            raise ValueError(f"unknown structure {structure!r}; expected one of {STRUCTURES}")
        if order not in (None, "none", "hilbert"):
            raise ValueError(f"unknown order {order!r}; expected 'hilbert' (or None)")
        self.structure = structure
        self.device = ops.resolve_device(device)
        self.mbrs = validate_mbrs(mbrs)
        self.n_objects = self.mbrs.shape[0]
        if self.n_objects == 0:
            raise ValueError("a spatial index needs at least one MBR")
        self.order = order
        # the user's options, so a merge or extend() can re-run the same build
        self.build_opts = dict(levels=levels, max_entries=max_entries, build=build,
                               order=order)
        self._pointer_tree = None
        self._pointer_pending = False  # restored: the tree is rebuilt on first use
        self._flat: Optional[FlatTree] = None
        self._schedule: Optional[LevelSchedule] = None
        self._quantized: Optional[QuantizedSchedule] = None
        self._quantized8: Optional[QuantizedSchedule] = None
        # Autotuned TileConfig winners keyed by kernels.autotune.shape_key,
        # shared by every backend over these artifacts.
        self.tuned: dict = {}
        if structure == "mqr":
            _reject_opts(structure, levels=levels, max_entries=max_entries, build=build)
            self._pointer_tree = mqrtree.build(self.mbrs)
        elif structure == "rtree":
            _reject_opts(structure, levels=levels, build=build)
            self._pointer_tree = rtree.build(
                self.mbrs,
                max_entries=rtree.DEFAULT_M if max_entries is None else max_entries,
            )
        else:
            _reject_opts(structure, max_entries=max_entries)
            if build not in (None, "host", "device"):
                raise ValueError(f"unknown build {build!r}; expected 'host' or 'device'")
            if levels is None:
                levels = bulk.default_levels(self.n_objects)
            obj = torch.from_numpy(self.mbrs.astype(np.float32)).to(self.device)
            if build == "device":
                # The bulk fixed point in one kernel call, straight to the
                # schedule arrays: no host pointer tree.
                self._schedule = ops.device_schedule(obj, levels=levels, device=self.device)
            else:
                self._schedule = pyramid_schedule(bulk.build_pyramid(obj, levels), obj)
            if order == "hilbert":
                self._schedule = ops.hilbert_permute(self._schedule)

    @classmethod
    def restore(cls, structure: str, mbrs, build_opts: Optional[dict],
                schedule: LevelSchedule, quantized: Optional[QuantizedSchedule] = None,
                ) -> "BuildArtifacts":
        """Rehydrate artifacts from a snapshot: the saved schedule (and the
        uint16 tile form, when it was saved) is installed as it is, on its
        own device — no build and no quantization runs, so a restore
        launches neither kernel #4 nor #5.  The host pointer tree of an
        mqr or R-tree (the ``host`` backend and pointer k-NN need it) is
        rebuilt from the object table on first use; the reference rebuilds
        it at once, with the same deterministic build."""
        if structure not in STRUCTURES:
            raise ValueError(f"unknown structure {structure!r}; expected one of {STRUCTURES}")
        self = cls.__new__(cls)
        self.structure = structure
        self.device = schedule.device
        self.mbrs = np.asarray(mbrs, np.float64).reshape(-1, 4)
        self.n_objects = self.mbrs.shape[0]
        self.build_opts = dict(levels=None, max_entries=None, build=None, order=None)
        self.build_opts.update(build_opts or {})
        # the saved schedule was captured after any slot ordering
        self.order = self.build_opts.get("order")
        self._pointer_tree = None
        self._pointer_pending = structure != "pyramid"
        self._flat = None
        self._schedule = schedule
        self._quantized = quantized
        self._quantized8 = None
        self.tuned = {}
        return self

    @property
    def pointer_tree(self):
        """The host pointer tree (mqr and rtree; None for the pyramid)."""
        if self._pointer_pending:
            self._pointer_pending = False
            if self.structure == "mqr":
                self._pointer_tree = mqrtree.build(self.mbrs)
            else:
                me = self.build_opts.get("max_entries")
                self._pointer_tree = rtree.build(
                    self.mbrs, max_entries=rtree.DEFAULT_M if me is None else me)
        return self._pointer_tree

    @property
    def flat(self) -> FlatTree:
        """The :class:`FlatTree` of the pointer tree (mqr and rtree only)."""
        if self._flat is None:
            if self.pointer_tree is None:
                raise ValueError("structure 'pyramid' has no pointer tree / FlatTree form")
            self._flat = flatten(self.pointer_tree)
        return self._flat

    @property
    def schedule(self) -> LevelSchedule:
        """The level schedule on :attr:`device` (tree schedules are lowered
        on the host first), in Hilbert slot order when ``order="hilbert"``."""
        if self._schedule is None:
            schedule = level_schedule(self.flat)
            if self.order == "hilbert":
                schedule = ops.hilbert_permute(schedule)
            self._schedule = schedule.to(self.device)
        return self._schedule

    @property
    def quantized(self) -> QuantizedSchedule:
        """Compact uint16 tile form of :attr:`schedule`, quantized once and
        shared by every ``precision="compact"`` backend."""
        if self._quantized is None:
            self._quantized = ops.quantize_schedule(self.schedule)
        return self._quantized

    @property
    def quantized8(self) -> QuantizedSchedule:
        """Hierarchical uint8-upper / uint16-lower tile form of
        :attr:`schedule`, for ``precision="compact8"`` backends."""
        if self._quantized8 is None:
            self._quantized8 = ops.quantize_schedule(self.schedule, upper8=True)
        return self._quantized8


class SpatialIndex:
    """Build/query surface over the ported structure × backend paths."""

    def __init__(self, artifacts: BuildArtifacts, spec: BackendSpec, **backend_opts):
        if artifacts.structure not in spec.structures:
            raise ValueError(
                f"backend {spec.name!r} does not serve structure "
                f"{artifacts.structure!r} (serves: {sorted(spec.structures)})"
            )
        self._artifacts = artifacts
        self.spec = spec
        self.stats = AccessStats()
        self._backend_opts = dict(backend_opts)
        self._backend = spec.factory(artifacts, **backend_opts)
        # Live-update state, created on the first insert/delete.  The log
        # lives in a shared one-slot cell so `with_backend` twins see each
        # other's mutations whichever mutates first.
        self._policy = None            # MergePolicy from build()
        self._updates_cell = {"log": None}
        self._live_engine = None
        self._backend_base_epoch = 0   # base epoch self._backend was built at
        self._admission = "merge"      # what to do with unbufferable batches
        self._fault_plan = None        # repro_torch.ft.FaultPlan, threaded everywhere

    @property
    def _updates(self):
        return self._updates_cell["log"]

    @_updates.setter
    def _updates(self, log):
        self._updates_cell["log"] = log

    # -- construction --------------------------------------------------
    @classmethod
    def build(cls, mbrs, *, structure: str = "mqr", backend: str = "cuda",
              device=None, backend_opts: Optional[dict] = None,
              **opts) -> "SpatialIndex":
        """Build a spatial index over ``mbrs`` (n, 4) on ``device`` (the CUDA
        card when None).

        structure: ``mqr`` (the paper's pointer tree) | ``rtree`` (Guttman
            baseline) | ``pyramid`` (bulk bottom-up fixed point).
        backend:   ``cuda`` (fused sweep; plain versions on the CPU) |
            ``torch`` (the plain sweep on the index's device) | ``host``
            (pointer search / numpy oracle) | ``serve`` (the batching
            server: LRU cache, dedupe, the cuda → torch → host ladder;
            options ``query_block``, ``cache_size``, ``block_w``,
            ``precision``, ``ladder``, ``max_retries``, ``backoff``).
        opts: build options (``levels`` and ``build="host"|"device"`` for
            the pyramid — ``"device"`` runs the build kernel and emits the
            schedule directly; ``max_entries`` for the rtree;
            ``order="hilbert"``) plus backend options (``block_w``,
            ``query_block``, ``autotune="auto"|"on"|"off"``,
            ``precision="float32"|"compact"|"compact8"``, ``stream=True``
            for the streaming sweep), routed by key; an option the backend
            does not take raises ``TypeError``.  Live-update options:
            ``capacity`` (delta-buffer slots) and ``merge`` (a
            :class:`repro_torch.update.MergePolicy` or kwargs dict)
            configure how :meth:`insert` / :meth:`delete` buffer and when
            they compact; ``admission`` says what happens to a batch the
            buffer cannot absorb: ``"merge"`` (fold it into a compaction;
            ``BufferFullError`` when the policy has ``auto=False``) or
            ``"shed"`` (drop it, counted in ``stats.shed_mutations``);
            ``fault_plan`` — a :class:`repro_torch.ft.FaultPlan` threaded
            through the update log and the serving ladder.
        backend_opts: an explicit dict of backend-only options; a key also
            given in ``opts`` raises ``TypeError``.
        """
        update_opts = {k: opts.pop(k) for k in list(opts) if k in _UPDATE_OPTS}
        build_opts = {k: v for k, v in opts.items() if k in _BUILD_OPTS}
        routed = {k: v for k, v in opts.items() if k not in _BUILD_OPTS}
        for k, v in (backend_opts or {}).items():
            if k in opts or k in update_opts:
                raise TypeError(f"backend_opts duplicates option {k!r} also passed directly")
            if k in _BUILD_OPTS or k in _UPDATE_OPTS:
                kind = "build" if k in _BUILD_OPTS else "update"
                raise TypeError(f"backend_opts key {k!r} is a {kind} option; pass it directly")
            routed[k] = v
        artifacts = BuildArtifacts(structure, mbrs, device=device, **build_opts)
        idx = cls(artifacts, get_backend(backend), **routed)
        if "capacity" in update_opts or "merge" in update_opts:
            # validated eagerly so a bad option fails at build time
            idx._policy = as_policy(update_opts.get("merge"), update_opts.get("capacity"))
        admission = update_opts.get("admission")
        if admission is not None:
            if admission not in ADMISSION_MODES:
                raise ValueError(
                    f"unknown admission {admission!r}; expected one of {ADMISSION_MODES} "
                    f"(queueing lives in repro_torch.checkpoint.DurableIndex)")
            idx._admission = admission
        if update_opts.get("fault_plan") is not None:
            idx.bind_fault_plan(update_opts["fault_plan"])
        return idx

    def with_backend(self, backend: str, **backend_opts) -> "SpatialIndex":
        """A new index answering from the SAME build on another backend
        (build once, serve anywhere; lowerings are shared).  Live mutation
        state is shared too: mutations through either index are visible to
        both."""
        new = SpatialIndex(self.artifacts, get_backend(backend), **backend_opts)
        new._policy = self._policy
        new._admission = self._admission
        new._updates_cell = self._updates_cell
        if self._updates is not None:
            new._backend_base_epoch = self._updates.base_epoch
        if self._fault_plan is not None:
            new.bind_fault_plan(self._fault_plan)
        return new

    def extend(self, new_mbrs, *, flush: str = "auto") -> "SpatialIndex":
        """Batch insertion: a new index whose live set adds ``new_mbrs``.

        The batch lands in the NEW index's delta buffer and merges by
        policy, while this index stays untouched.  ``flush="always"``
        compacts at once (on a never-mutated index: a fresh build over the
        concatenated objects, with no live-update state).  Batches larger
        than the buffer capacity merge directly either way.
        """
        if flush not in ("auto", "always"):
            raise ValueError(f"unknown flush {flush!r}; expected 'auto' or 'always'")
        new_mbrs = np.asarray(new_mbrs, np.float64).reshape(-1, 4)
        if flush == "always" and self._updates is None:
            mbrs = np.concatenate([self.artifacts.mbrs, new_mbrs], axis=0)
            artifacts = BuildArtifacts(self.structure, mbrs, device=self.device,
                                       **self.artifacts.build_opts)
            clone = SpatialIndex(artifacts, self.spec, **self._backend_opts)
            clone._policy = self._policy
            return clone
        clone = self._snapshot()
        clone.insert(new_mbrs)
        if flush == "always":
            clone.flush()
        return clone

    def _snapshot(self) -> "SpatialIndex":
        """A new index over the same (current) base with an independent
        copy of any live-update state."""
        clone = SpatialIndex(self.artifacts, self.spec, **self._backend_opts)
        clone._policy = self._policy
        clone._admission = self._admission
        if self._updates is not None:
            clone._updates = self._updates.snapshot()
            clone._backend_base_epoch = clone._updates.base_epoch
        return clone

    # -- introspection -------------------------------------------------
    @property
    def artifacts(self) -> BuildArtifacts:
        """The CURRENT frozen base build (replaced at every merge)."""
        if self._updates is not None:
            return self._updates.base
        return self._artifacts

    @property
    def structure(self) -> str:
        return self.artifacts.structure

    @property
    def backend(self) -> str:
        return self.spec.name

    @property
    def device(self) -> torch.device:
        return self.artifacts.device

    @property
    def n_objects(self) -> int:
        """Number of LIVE objects (base survivors + buffered inserts)."""
        if self._updates is not None:
            return self._updates.n_live
        return self.artifacts.n_objects

    @property
    def id_space(self) -> int:
        """Width of ``RegionResult.hits``: the dense global-id space
        ``[0, id_space)``.  Equals ``n_objects`` until live updates begin;
        append-only afterwards (deleted ids never recycle)."""
        if self._updates is not None:
            return self._updates.id_capacity
        return self.artifacts.n_objects

    @property
    def schedule(self) -> LevelSchedule:
        return self.artifacts.schedule

    # -- durability / fault injection ----------------------------------
    def bind_fault_plan(self, plan) -> None:
        """Thread a :class:`repro_torch.ft.FaultPlan` (or ``None`` to
        detach) through every layer that honours injection hooks: the
        update log (mid-merge kills, slow merges) and the serving ladder
        (forced launch failures)."""
        self._fault_plan = plan
        if self._updates is not None:
            self._updates.fault_plan = plan
        if hasattr(self._backend, "bind_fault_plan"):
            self._backend.bind_fault_plan(plan)
        if self._live_engine is not None:
            self._live_engine.bind_fault_plan(plan)

    def _drain_health(self, source) -> None:
        drain = getattr(source, "drain_health", None)
        if drain is not None:
            self.stats.absorb_health(drain())

    def save(self, path) -> None:
        """Write a versioned snapshot of the full index state — object
        table, level schedule (and the uint16 tiles when they were made),
        delta buffer, tombstones, id space and merge policy — atomically
        (tmp + rename), in the JAX package's format.  Arrays are copied to
        the host; :meth:`load` restores the same hits and visits."""
        from repro_torch.checkpoint.spatial import save_index

        save_index(self, path)

    @classmethod
    def load(cls, path, *, backend: str = "cuda", device=None, **backend_opts
             ) -> "SpatialIndex":
        """Restore an index saved by :meth:`save` (by either package) onto
        ``backend`` and ``device`` (the card when None).  The saved
        schedule is installed as it is: no build or quantization runs."""
        from repro_torch.checkpoint.spatial import load_index

        return load_index(path, backend=backend, device=device, **backend_opts)

    def metrics(self, *, tenant: Optional[str] = None):
        """Snapshot :attr:`stats` into a
        :class:`repro_torch.obs.MetricsRegistry` (render with
        ``.to_prometheus()`` or ``.to_json()``); ``tenant`` adds a label to
        every sample."""
        from repro_torch.obs import metrics as _obs_metrics

        reg = _obs_metrics.MetricsRegistry()
        labels = {"tenant": tenant} if tenant else None
        _obs_metrics.stats_into(reg, self.stats, labels=labels)
        return reg

    # -- live updates --------------------------------------------------
    def _ensure_log(self) -> UpdateLog:
        if self._updates is None:
            structure = self._artifacts.structure
            device = self._artifacts.device
            build_opts = dict(self._artifacts.build_opts)
            self._updates = UpdateLog(
                self._artifacts,
                self._policy if self._policy is not None else MergePolicy(),
                rebuild=lambda mbrs: BuildArtifacts(structure, mbrs, device=device,
                                                    **build_opts),
            )
            self._backend_base_epoch = self._updates.base_epoch
        if self._fault_plan is not None:
            self._updates.fault_plan = self._fault_plan
        return self._updates

    def _live(self) -> LiveEngine:
        if self._live_engine is None or self._live_engine.log is not self._updates:
            self._live_engine = LiveEngine(self._updates, self.spec.name,
                                           self._backend_opts)
            if self._fault_plan is not None:
                self._live_engine.bind_fault_plan(self._fault_plan)
        return self._live_engine

    def _current_backend(self):
        """The pristine backend over the CURRENT base build, re-made lazily
        after a merge (possibly made through a ``with_backend`` twin)."""
        if (self._updates is not None
                and self._backend_base_epoch != self._updates.base_epoch):
            self._backend = self.spec.factory(self.artifacts, **self._backend_opts)
            self._backend_base_epoch = self._updates.base_epoch
        return self._backend

    def insert(self, new_mbrs) -> np.ndarray:
        """Insert objects ONLINE; returns their global ids.

        The batch lands in the delta buffer (O(1), no rebuild) and is
        visible to every query path at once; the merge policy, or a full
        buffer, folds it into a fresh base build later.  Batches larger
        than the buffer capacity merge directly (one bulk rebuild over the
        live set).
        """
        new_mbrs = validate_mbrs(new_mbrs, what="insert batch")
        n = new_mbrs.shape[0]
        if n == 0:  # no-op: leave pristine state and epochs untouched
            return np.zeros((0,), np.int64)
        with _obs_trace.span("index.insert", n=n):
            return self._insert(new_mbrs, n)

    def _insert(self, new_mbrs: np.ndarray, n: int) -> np.ndarray:
        log = self._ensure_log()
        if n > log.capacity:
            # Never bufferable: folds straight into one merge, regardless
            # of admission.
            gids = log.merge_insert(new_mbrs)
            self.stats.flushes += 1
        elif not log.can_buffer(n):
            if self._admission == "shed":
                self.stats.shed_mutations += n
                return np.zeros((0,), np.int64)
            if not log.policy.auto:
                raise BufferFullError(
                    f"delta buffer cannot absorb {n} insert(s) (fill {log.fill:.0%}) "
                    f"and the merge policy has auto=False; call flush() or enable "
                    f"auto merging")
            gids = log.merge_insert(new_mbrs)
            self.stats.flushes += 1
        else:
            gids = log.buffer_insert(new_mbrs)
            if log.policy.should_flush(fill=log.fill, tombstone_ratio=log.tombstone_ratio):
                log.flush()
                self.stats.flushes += 1
        self.stats.inserts += n
        return gids

    def delete(self, ids) -> None:
        """Delete live objects by global id (tombstones).

        Base objects stay physically in the frozen build, masked out of
        every hit set from this call on; buffered inserts free their delta
        slot.  Unknown or already-dead ids raise ``KeyError``.
        """
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:  # no-op: leave pristine state and epochs untouched
            return
        with _obs_trace.span("index.delete", n=ids.size):
            log = self._ensure_log()
            gids = log.delete(ids)
            self.stats.deletes += int(gids.shape[0])
            if log.n_live > 0 and log.policy.should_flush(
                    fill=log.fill, tombstone_ratio=log.tombstone_ratio):
                log.flush()
                self.stats.flushes += 1

    def flush(self) -> bool:
        """Merge buffer + tombstones into a fresh base build now.

        Hit sets are bit-identical before and after (global ids are
        preserved); returns True if a merge ran.
        """
        if self._updates is None:
            return False
        with _obs_trace.span("index.flush"):
            if self._updates.flush():
                self.stats.flushes += 1
                return True
        return False

    def live_metrics(self):
        """The paper's §5.2 structure metrics (overlap, overcoverage, …) of
        the CURRENT live object set, on the mqr insertion-rule oracle tree."""
        return compute_metrics(live_tree(self))

    # -- queries -------------------------------------------------------
    def _queries(self, queries, width: int) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            q = queries.to(device=self.device, dtype=torch.float32)
        else:
            q = torch.from_numpy(np.asarray(queries, np.float32)).to(self.device)
        return q.reshape(-1, width).contiguous()

    def _region_raw(self, q: torch.Tensor):
        """One region batch on the current state, without bookkeeping:
        ``(hits, visits, launches, base_levels, skipped)`` (``base_levels``
        None while pristine; ``skipped`` the streaming sweep's count or
        None)."""
        if self._updates is None:
            hits, visits, launches, skipped = self._backend.region(q)
            self._drain_health(self._backend)
            return hits, visits, launches, None, skipped
        live = self._live()
        hits, visits, launches = live.region(
            q, base_region=lambda qs: self._current_backend().region(qs)[:3])
        self._drain_health(live)
        return hits, visits, launches, self._updates.base.schedule.levels, None

    def _account(self, n_queries: int, visits, launches: int, base_levels, skipped) -> None:
        """Fold one region batch into :attr:`stats` (one device sync for
        the access count and its companion)."""
        total = visits.sum(dtype=torch.int64)
        if base_levels is not None:
            extra = visits[:, base_levels:].sum(dtype=torch.int64)
        else:
            extra = skipped if skipped is not None else torch.zeros_like(total)
        accesses, extra = torch.stack([total, extra]).tolist()
        self.stats.record(n_queries, accesses, launches)
        if base_levels is None:
            self.stats.tiles_skipped += extra
        else:
            self.stats.delta_accesses += extra

    def region(self, queries) -> RegionResult:
        """Batched region search over (Q, 4) query rectangles."""
        q = self._queries(queries, 4)
        with _obs_trace.span("index.region", backend=self.spec.name,
                             structure=self.structure, queries=q.shape[0]):
            hits, visits, launches, base_levels, skipped = self._region_raw(q)
        self._account(q.shape[0], visits, launches, base_levels, skipped)
        return RegionResult(hits=hits, visits_per_level=visits, base_levels=base_levels)

    def point(self, points) -> RegionResult:
        """Point queries (Q, 2) as degenerate rectangles."""
        p = self._queries(points, 2)
        return self.region(torch.cat([p, p], dim=1))

    def count(self, queries) -> torch.Tensor:
        """(Q,) number of objects overlapping each query rectangle."""
        return self.region(queries).counts

    def join(self, other: "SpatialIndex", predicate: str = "intersects"):
        """Batch spatial join against another index.

        Sweeps both indexes' level schedules against each other (this
        index's backend and precision pick the engine, and its device holds
        the result) and returns a :class:`repro_torch.index.join.JoinResult`
        whose pair set equals the brute-force nested-loop oracle over the
        two live object sets, including mid-buffer live state and
        tombstones on either side.  Only ``predicate="intersects"``
        (closed-boundary overlap, the paper's region semantics) is defined.
        ``stats.launches`` grows by one per swept level (ROADMAP C7).
        """
        from .join import join_impl

        with _obs_trace.span("index.join", backend=self.spec.name,
                             other_backend=other.spec.name, predicate=predicate):
            result, launches = join_impl(self, other, predicate)
        visits = result.pair_visits.tolist()
        self.stats.joins += 1
        self.stats.record(1, sum(visits), launches)
        self.stats.delta_accesses += sum(visits[result.base_levels:])
        return result

    def knn(self, points, k: int) -> KNNResult:
        """k nearest neighbours of each (Q, 2) point, by MBR min-distance.

        Host backend: exact branch-and-bound over the pointer tree (brute
        force for the pyramid, which has no pointer form, and for a live
        index).  Other backends: expanding-radius region rounds through
        the backend's sweep until ≥k survivors, one √2-margin
        confirming round, then a top-k distance epilogue on the device.
        Equal distances resolve by lowest object id on every engine.
        """
        if isinstance(points, torch.Tensor):
            points = points.detach().cpu().numpy()
        points = np.asarray(points, np.float64).reshape(-1, 2)
        if not 1 <= k <= self.n_objects:
            raise ValueError(f"k={k} outside [1, {self.n_objects}]")
        with _obs_trace.span("index.knn", backend=self.spec.name, k=k,
                             queries=points.shape[0]):
            return self._knn(points, k)

    def _knn(self, points: np.ndarray, k: int) -> KNNResult:
        nq = points.shape[0]
        live = self._updates
        if self.spec.name == "host":
            if live is not None:
                # Under mutation the base pointer tree is stale; answer
                # exactly from the live id-space table.
                ids, dists, visits = _knn.knn_brute_masked(live.mbr_table, live.alive,
                                                           points, k)
            elif self.artifacts.pointer_tree is not None:
                ids, dists, visits = _knn.knn_pointer(self.artifacts.pointer_tree, points, k)
            else:
                ids, dists, visits = _knn.knn_brute(self.artifacts.mbrs, points, k)
            self.stats.knn_queries += nq
            self.stats.record(nq, int(visits.sum()), 0)
            return KNNResult(ids=torch.from_numpy(ids), dists=torch.from_numpy(dists),
                             visits=torch.from_numpy(visits))

        def region_fn(qs):
            q = self._queries(qs, 4)
            hits, visits, launches, base_levels, skipped = self._region_raw(q)
            self._account(0, visits, launches, base_levels, skipped)
            return hits, visits

        # Live indexes rank candidates over the id-space MBR table (hits
        # already exclude tombstones, so stale rows never rank).
        obj_mbrs = live.mbr_table if live is not None else self.artifacts.mbrs
        ids, dists, visits, rounds = _knn.knn_expanding(region_fn, obj_mbrs, points, k,
                                                        device=self.device)
        self.stats.knn_queries += nq
        self.stats.knn_rounds += rounds
        self.stats.queries += nq
        return KNNResult(ids=ids, dists=dists, visits=visits)
