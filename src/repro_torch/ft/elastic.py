"""Elastic re-meshing: rebuild the device mesh after node loss and compute
the resharding plan for a checkpointed state.

Counterpart of ``repro.ft.elastic``; :func:`plan_mesh` gives the
reference's plans.  The contract at 1000+ nodes: when hosts drop, the job
restarts from the latest checkpoint on the surviving device set.
Parameters were saved with *logical* axes (the PartitionSpec tree is a pure
function of the param tree via ``repro_torch.sharding.rules``), so
resharding = re-deriving specs on the new mesh; nothing about the
checkpoint format depends on the old topology.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels.ops import resolve_device
from repro_torch.sharding import rules


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_devices: int
    dropped: int


def plan_mesh(n_available: int, *, model_parallel: int = 16,
              multi_pod_threshold: int = 512) -> MeshPlan:
    """Largest well-formed mesh on the surviving devices.

    Keeps the model axis fixed (TP degree is a property of the model fit),
    shrinks the data axis, and drops remainder devices (they rejoin at the
    next re-mesh — the standard elastic-DP contract).
    """
    mp = model_parallel
    usable = (n_available // mp) * mp
    if usable == 0:
        raise ValueError(f"cannot keep model_parallel={mp} with {n_available} devices")
    data = usable // mp
    if usable >= multi_pod_threshold and data % 2 == 0:
        return MeshPlan((2, data // 2, mp), ("pod", "data", "model"),
                        usable, n_available - usable)
    return MeshPlan((data, mp), ("data", "model"), usable, n_available - usable)


def build_mesh(plan: MeshPlan, device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of the plan's shape and axis names over a running
    process group of exactly ``plan.n_devices`` ranks; ``device_type`` the
    card's unless ``"cpu"`` is asked for (without a card and without it,
    this raises)."""
    if device_type is None:
        device_type = resolve_device(None).type
    if not dist.is_initialized() or dist.get_world_size() != plan.n_devices:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"the plan needs a process group of {plan.n_devices} ranks, "
                           f"have {have}")
    return init_device_mesh(device_type, plan.shape, mesh_dim_names=plan.axis_names)


def reshard_plan(params_abs, old_mesh, new_mesh):
    """(old_spec, new_spec) pairs per leaf — the logical axes are identical,
    only the mesh changed, so this is exactly the redistribution plan."""
    return rules.map_with_path(
        lambda path, leaf: (rules.spec_for_param(path, leaf.shape, old_mesh),
                            rules.spec_for_param(path, leaf.shape, new_mesh)),
        params_abs)
