"""Fault injection for the durability and serving paths (counterpart of
``repro.ft``'s ``failures`` module; ``elastic`` and ``straggler`` serve the
training loop, which is not ported yet)."""

from .failures import (  # noqa: F401
    KILL_SITES,
    FailureInjector,
    FaultPlan,
    InjectedFailure,
    KillPoint,
)

__all__ = ["KILL_SITES", "FailureInjector", "FaultPlan", "InjectedFailure", "KillPoint"]
