"""Backend registry for the :class:`SpatialIndex` façade.

Counterpart of ``repro.index.registry``: backends self-register with the
structures they serve; the façade looks them up by name at build time and
:func:`advertised_pairs` lists every (structure, backend) pair.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Tuple


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    name: str
    structures: frozenset
    factory: Callable       # (BuildArtifacts, **opts) -> adapter with .region()
    doc: str = ""


_REGISTRY: Dict[str, BackendSpec] = {}
_BUILTINS_LOADED = False


def register_backend(name: str, *, structures: Iterable[str], doc: str = ""):
    """Class/function decorator: declare a query backend.

    The factory is called as ``factory(artifacts, **backend_opts)`` and
    must return an adapter exposing ``region(queries) -> (hits (Q, n_obj)
    bool, visits (Q, L) int32, launches int)``.
    """

    def deco(factory):
        _REGISTRY[name] = BackendSpec(
            name=name, structures=frozenset(structures), factory=factory, doc=doc
        )
        return factory

    return deco


def get_backend(name: str) -> BackendSpec:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {backend_names()}"
        ) from None


def backend_names() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def advertised_pairs() -> List[Tuple[str, str]]:
    """Every (structure, backend) combination the registry serves."""
    _ensure_loaded()
    return sorted(
        (structure, spec.name)
        for spec in _REGISTRY.values()
        for structure in spec.structures
    )


def _ensure_loaded() -> None:
    # The built-in backends register on import of .backends; imported
    # lazily so registry.py stays import-cycle-free.
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        from . import backends  # noqa: F401

        _BUILTINS_LOADED = True
