"""Fault injection and straggler monitoring (counterpart of ``repro.ft``):
``failures`` serves the durability, serving and training paths,
``straggler`` the training loop (``launch/train.py``).  ``elastic`` (mesh
re-planning) is ROADMAP A4b."""

from .failures import (  # noqa: F401
    KILL_SITES,
    FailureInjector,
    FaultPlan,
    InjectedFailure,
    KillPoint,
)
from .straggler import StragglerEvent, StragglerMonitor  # noqa: F401

__all__ = ["KILL_SITES", "FailureInjector", "FaultPlan", "InjectedFailure", "KillPoint",
           "StragglerEvent", "StragglerMonitor"]
