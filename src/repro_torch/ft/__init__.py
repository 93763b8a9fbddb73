"""Fault injection, straggler monitoring and elastic re-meshing
(counterpart of ``repro.ft``): ``failures`` serves the durability, serving
and training paths, ``straggler`` the training loop (``launch/train.py``),
``elastic`` the mesh plan after a loss of devices and its resharding plan."""

from .failures import (  # noqa: F401
    KILL_SITES,
    FailureInjector,
    FaultPlan,
    InjectedFailure,
    KillPoint,
)
from .elastic import MeshPlan, build_mesh, plan_mesh, reshard_plan  # noqa: F401
from .straggler import StragglerEvent, StragglerMonitor  # noqa: F401

__all__ = ["KILL_SITES", "FailureInjector", "FaultPlan", "InjectedFailure", "KillPoint",
           "MeshPlan", "StragglerEvent", "StragglerMonitor", "build_mesh", "plan_mesh",
           "reshard_plan"]
