"""Declarative serving configuration: config dicts → a built tenant stack.

Counterpart of ``repro.serve.config``.  Plain dicts are typed into frozen
dataclass configs at the boundary — typos and illegal values fail THERE,
with the offending key named, never as a shape error three layers down —
and one ``build`` call assembles the runtime stack.

A :class:`ServerConfig` declares the whole front end::

    cfg = ServerConfig.from_dict({
        "query_block": 8,
        "classes": [
            {"name": "interactive", "deadline_ms": 50, "overload": "shed",
             "max_queue": 64},
            {"name": "batch", "deadline_ms": 2000, "overload": "queue"},
        ],
        "tenants": [
            {"name": "maps", "structure": "pyramid", "backend": "serve",
             "build": "device", "precision": "compact"},
            {"name": "fleet", "structure": "mqr", "backend": "serve",
             "capacity": 256, "durable_root": "/data/fleet"},
        ],
    })
    front = ServingFrontEnd.build(cfg, data={"maps": ..., "fleet": ...})

Each tenant maps to its own (structure, backend, precision, merge
policy) stack — its own :class:`repro_torch.index.SpatialIndex` (or, with
``durable_root``, a WAL-backed :class:`repro_torch.checkpoint.DurableIndex`
that recovers on restart), and therefore its own epoch-tagged result
cache: one tenant's mutations can never invalidate or leak into
another's answers.

Backend names are the port's (``cuda``, ``torch``, ``host``, ``serve``).
A config written for the JAX package, which names ``pallas`` or ``lax``
(as a tenant's backend or as rungs of a ``ladder`` option), is mapped
``pallas`` → ``cuda`` and ``lax`` → ``torch`` at the boundary, and its
JAX-only options (``interpret``) are dropped, by
:func:`repro_torch.checkpoint.durable.recorded_backend`, which does the
same for a snapshot's names (ROADMAP C20); so one config dict drives both
packages.  The device
is not a config field: ``ServingFrontEnd.build`` takes it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: admission vocabulary shared with DurableIndex (repro_torch.checkpoint.durable):
#: ``shed`` drops over-limit work, ``queue`` parks it best-effort.
OVERLOAD_MODES = ("shed", "queue")


def _typed(cls, d: dict):
    """Dict → dataclass with typo catching: unknown keys raise with the
    accepted field names listed (the factory-config contract)."""
    fields = {f.name for f in dataclasses.fields(cls)}
    bad = sorted(set(d) - fields)
    if bad:
        raise TypeError(
            f"{cls.__name__}: unknown key(s) {bad}; accepted: {sorted(fields)}"
        )
    return cls(**d)


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One admission class: a completion deadline plus the overload verb.

    deadline_ms: per-request SLO — also the continuous-batching bound (a
        pending batch launches when its oldest request's deadline slack
        runs out, see :mod:`repro_torch.serve.queue`).
    overload:    what happens to arrivals beyond ``max_queue`` pending in
        this class — ``"shed"`` rejects them (a typed
        :class:`~repro_torch.serve.frontend.OverloadShed` answer, counted in
        ``AccessStats.shed_queries``), ``"queue"`` parks them best-effort
        (deadline no longer drives their launch; counted in
        ``AccessStats.queued_queries``).
    max_queue:   pending-request admission limit for the class.
    """

    name: str
    deadline_ms: float
    overload: str = "shed"
    max_queue: int = 1024

    def __post_init__(self):
        if self.deadline_ms <= 0:
            raise ValueError(f"SLO class {self.name!r}: deadline_ms must be > 0")
        if self.overload not in OVERLOAD_MODES:
            raise ValueError(
                f"SLO class {self.name!r}: overload {self.overload!r} not in "
                f"{OVERLOAD_MODES}"
            )
        if self.max_queue < 1:
            raise ValueError(f"SLO class {self.name!r}: max_queue must be >= 1")

    @property
    def deadline_s(self) -> float:
        return self.deadline_ms / 1e3


DEFAULT_SLO_CLASSES: Tuple[SLOClass, ...] = (
    SLOClass("interactive", deadline_ms=50.0, overload="shed", max_queue=256),
    SLOClass("batch", deadline_ms=2000.0, overload="queue", max_queue=65536),
)


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's declarative index stack.

    The fields mirror ``SpatialIndex.build`` keyword-for-keyword —
    structure, backend, precision, device build, delta-buffer capacity,
    merge-policy kwargs, mutation admission — plus ``durable_root``:
    when set, the tenant is backed by a :class:`repro_torch.checkpoint.
    DurableIndex` at that path (WAL-first mutations; an existing
    generation is recovered instead of rebuilt, so a front-end restart
    resumes every durable tenant where it crashed).
    """

    name: str
    structure: str = "mqr"
    backend: str = "serve"
    precision: str = "float32"
    build: Optional[str] = None        # pyramid-only: "host" | "device"
    levels: Optional[int] = None       # pyramid-only
    max_entries: Optional[int] = None  # rtree-only
    capacity: Optional[int] = None     # delta-buffer slots
    merge: Optional[dict] = None       # MergePolicy kwargs
    admission: str = "merge"           # mutation admission
    durable_root: Optional[str] = None
    query_block: Optional[int] = None  # override the server-wide block
    backend_opts: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        from repro_torch.checkpoint.durable import recorded_backend
        from repro_torch.index.api import ADMISSION_MODES, STRUCTURES
        from repro_torch.index.registry import backend_names

        # a JAX package config's names and options, in the port's
        backend, opts = recorded_backend(
            {"backend": self.backend, "backend_opts": self.backend_opts})
        object.__setattr__(self, "backend", backend)
        object.__setattr__(self, "backend_opts", opts)
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.structure not in STRUCTURES:
            raise ValueError(
                f"tenant {self.name!r}: unknown structure {self.structure!r}; "
                f"expected one of {STRUCTURES}"
            )
        if self.backend not in backend_names():
            raise ValueError(
                f"tenant {self.name!r}: unknown backend {self.backend!r}; "
                f"registered: {backend_names()}"
            )
        if self.precision not in ("float32", "compact"):
            raise ValueError(
                f"tenant {self.name!r}: unknown precision {self.precision!r}"
            )
        if self.admission not in ADMISSION_MODES:
            raise ValueError(
                f"tenant {self.name!r}: unknown admission {self.admission!r}; "
                f"expected one of {ADMISSION_MODES}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "TenantConfig":
        return _typed(cls, d)

    def index_opts(self, server_query_block: int) -> dict:
        """The ``SpatialIndex.build`` keyword set this config declares."""
        opts = dict(self.backend_opts)
        opts["structure"] = self.structure
        opts["backend"] = self.backend
        if self.backend in ("cuda", "serve"):
            opts.setdefault("precision", self.precision)
        if self.backend == "serve":
            opts.setdefault(
                "query_block",
                self.query_block if self.query_block is not None
                else server_query_block,
            )
        for k in ("build", "levels", "max_entries", "capacity", "merge"):
            v = getattr(self, k)
            if v is not None:
                opts[k] = v
        if self.capacity is not None or self.merge is not None:
            opts.setdefault("admission", self.admission)
        return opts


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """The whole front end, declaratively.

    tenants:     the tenant stacks (at least one; names unique).
    classes:     SLO admission classes (names unique; the first is the
                 default class for requests that don't name one).
    query_block: coalesced-batch size — matched to the serving kernel's
                 query block so padded launches stay shape-stable.
    slack_margin_ms: safety margin subtracted from deadline slack when
                 deciding that a partial batch must launch NOW.
    """

    tenants: Tuple[TenantConfig, ...]
    classes: Tuple[SLOClass, ...] = DEFAULT_SLO_CLASSES
    query_block: int = 16
    slack_margin_ms: float = 1.0

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("ServerConfig needs at least one tenant")
        for field, items in (("tenant", self.tenants), ("class", self.classes)):
            names = [x.name for x in items]
            if len(set(names)) != len(names):
                raise ValueError(f"duplicate {field} names: {names}")
        if self.query_block < 1:
            raise ValueError("query_block must be >= 1")

    @classmethod
    def from_dict(cls, d: dict) -> "ServerConfig":
        d = dict(d)
        tenants = tuple(
            t if isinstance(t, TenantConfig) else TenantConfig.from_dict(t)
            for t in d.pop("tenants", ())
        )
        classes = d.pop("classes", None)
        if classes is None:
            classes = DEFAULT_SLO_CLASSES
        else:
            classes = tuple(
                c if isinstance(c, SLOClass) else _typed(SLOClass, c)
                for c in classes
            )
        return _typed(
            cls, dict(d, tenants=tenants, classes=classes)
        )

    def slo_class(self, name: Optional[str]) -> SLOClass:
        if name is None:
            return self.classes[0]
        for c in self.classes:
            if c.name == name:
                return c
        raise ValueError(
            f"unknown SLO class {name!r}; declared: "
            f"{[c.name for c in self.classes]}"
        )
