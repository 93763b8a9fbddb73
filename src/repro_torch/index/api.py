"""`SpatialIndex` — the façade over the port's build and query paths.

Counterpart of ``repro.index.api`` for the slices ported so far:

    idx = SpatialIndex.build(mbrs)   # the paper's mqr-tree, autotuned sweep
    res = idx.region(queries)        # RegionResult(hits, visits_per_level)
    res = idx.point(points)          # degenerate-rectangle queries
    cnt = idx.count(queries)         # hits per query

Structures: ``mqr`` (the default, the paper's pointer tree, built on the
host), ``rtree`` (Guttman baseline) and ``pyramid`` (bulk fixed point,
``build="device"`` on the card).  Everything runs on the CUDA card unless
``device="cpu"`` is passed (then each kernel's plain PyTorch version
runs); without a card and without that request, building raises.  Results
are torch tensors on the backend's device.  Options the port does not
have yet raise ``NotImplementedError`` naming ROADMAP.md.
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
from repro_torch.kernels import ops

from .registry import BackendSpec, get_backend

STRUCTURES = ("mqr", "rtree", "pyramid")

# Build-time options; everything else in **opts goes to the backend factory.
_BUILD_OPTS = ("levels", "max_entries", "build", "order")
# Live-update / durability options of the JAX façade, not ported yet.
_UPDATE_OPTS = ("capacity", "merge", "admission", "fault_plan")


def _roadmap(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet; see ROADMAP.md")


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

    hits:             (Q, n_objects) bool object-overlap mask.
    visits_per_level: (Q, L) int32 node accesses by tree level — the
                      paper's disk accesses broken down by depth.
    """

    hits: torch.Tensor
    visits_per_level: torch.Tensor

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


@dataclasses.dataclass
class AccessStats:
    """The paper's disk-access accounting, accumulated over the lifetime
    of a :class:`SpatialIndex`."""

    queries: int = 0
    node_accesses: int = 0
    launches: int = 0        # sweep launches (0 for the host backend)

    def record(self, n_queries: int, accesses: int, launches: int) -> None:
        self.queries += int(n_queries)
        self.node_accesses += int(accesses)
        self.launches += int(launches)


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
        self.pointer_tree = None
        self._flat: Optional[FlatTree] = None
        self._schedule: Optional[LevelSchedule] = None
        self._quantized: Optional[QuantizedSchedule] = None
        self._quantized8: Optional[QuantizedSchedule] = None
        # Autotuned TileConfig winners keyed by kernels.autotune.shape_key,
        # shared by every backend over these artifacts.
        self.tuned: dict = {}
        if structure == "mqr":
            _reject_opts(structure, levels=levels, max_entries=max_entries, build=build)
            self.pointer_tree = mqrtree.build(self.mbrs)
        elif structure == "rtree":
            _reject_opts(structure, levels=levels, build=build)
            self.pointer_tree = rtree.build(
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
        self.artifacts = artifacts
        self.spec = spec
        self.stats = AccessStats()
        self._backend = spec.factory(artifacts, **backend_opts)

    @classmethod
    def build(cls, mbrs, *, structure: str = "mqr", backend: str = "cuda",
              device=None, backend_opts: Optional[dict] = None,
              **opts) -> "SpatialIndex":
        """Build a spatial index over ``mbrs`` (n, 4) on ``device`` (the CUDA
        card when None).

        structure: ``mqr`` (the paper's pointer tree) | ``rtree`` (Guttman
            baseline) | ``pyramid`` (bulk bottom-up fixed point).
        backend:   ``cuda`` (fused sweep; plain versions on the CPU) |
            ``host`` (pointer search / numpy oracle).
        opts: build options (``levels`` and ``build="host"|"device"`` for
            the pyramid — ``"device"`` runs the build kernel and emits the
            schedule directly; ``max_entries`` for the rtree;
            ``order="hilbert"``) plus backend options (``block_w``,
            ``query_block``, ``autotune="auto"|"on"|"off"``,
            ``precision="float32"|"compact"|"compact8"``), routed by key; an
            option the backend does not take raises ``TypeError``.
        backend_opts: an explicit dict of backend-only options; a key also
            given in ``opts`` raises ``TypeError``.
        """
        for k in _UPDATE_OPTS:
            if k in opts:
                raise _roadmap(f"option {k!r} (live updates and durability)")
        build_opts = {k: v for k, v in opts.items() if k in _BUILD_OPTS}
        routed = {k: v for k, v in opts.items() if k not in _BUILD_OPTS}
        for k, v in (backend_opts or {}).items():
            if k in opts:
                raise TypeError(f"backend_opts duplicates option {k!r} also passed directly")
            if k in _BUILD_OPTS:
                raise TypeError(f"backend_opts key {k!r} is a build option; pass it directly")
            routed[k] = v
        artifacts = BuildArtifacts(structure, mbrs, device=device, **build_opts)
        return cls(artifacts, get_backend(backend), **routed)

    def with_backend(self, backend: str, **backend_opts) -> "SpatialIndex":
        """A new index answering from the SAME build artifacts on another
        backend (build once, serve anywhere; lowerings are shared)."""
        return SpatialIndex(self.artifacts, get_backend(backend), **backend_opts)

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
        return self.artifacts.n_objects

    @property
    def schedule(self) -> LevelSchedule:
        return self.artifacts.schedule

    def _queries(self, queries, width: int) -> torch.Tensor:
        if isinstance(queries, torch.Tensor):
            q = queries.to(device=self.device, dtype=torch.float32)
        else:
            q = torch.from_numpy(np.asarray(queries, np.float32)).to(self.device)
        return q.reshape(-1, width).contiguous()

    def region(self, queries) -> RegionResult:
        """Batched region search over (Q, 4) query rectangles."""
        q = self._queries(queries, 4)
        hits, visits, launches = self._backend.region(q)
        self.stats.record(q.shape[0], int(visits.sum()), launches)
        return RegionResult(hits=hits, visits_per_level=visits)

    def point(self, points) -> RegionResult:
        """Point queries (Q, 2) as degenerate rectangles."""
        p = self._queries(points, 2)
        return self.region(torch.cat([p, p], dim=1))

    def count(self, queries) -> torch.Tensor:
        """(Q,) number of objects overlapping each query rectangle."""
        return self.region(queries).counts

    # -- not ported yet (ROADMAP.md "Port to PyTorch/CUDA") ------------
    def insert(self, new_mbrs):
        raise _roadmap("SpatialIndex.insert (live updates)")

    def delete(self, ids):
        raise _roadmap("SpatialIndex.delete (live updates)")

    def flush(self):
        raise _roadmap("SpatialIndex.flush (live updates)")

    def extend(self, new_mbrs, **kwargs):
        raise _roadmap("SpatialIndex.extend (live updates)")

    def join(self, other, predicate: str = "intersects"):
        raise _roadmap("SpatialIndex.join")

    def knn(self, points, k: int):
        raise _roadmap("SpatialIndex.knn")

    def save(self, path):
        raise _roadmap("SpatialIndex.save (checkpoints)")
