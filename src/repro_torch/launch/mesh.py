"""Meshes: the production shapes and a real 1x1 mesh on the card.

Counterpart of ``repro.launch.mesh``.  :func:`make_production_mesh` returns
the reference's shapes as :class:`MeshShape`s, axis names and sizes with no
devices: the sharding rules and the dry run need nothing more, and nothing
here touches device state.  :func:`make_host_mesh` builds a real
``DeviceMesh`` of one device on a world-size-1 process group;
:func:`fake_production_mesh` a real ``DeviceMesh`` of the production shape
on a fake process group, for the dry run of a sharded step on ``meta``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels.ops import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """An abstract mesh: axis names and their sizes, no devices."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def n_devices(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_card_mesh() -> MeshShape:
    """The 1x1 ``("data", "model")`` shape of one card (the dry run's
    ``--mesh card``)."""
    return MeshShape(("data", "model"), (1, 1))


def make_host_mesh(device=None) -> DeviceMesh:
    """Degenerate 1x1 ``("data", "model")`` mesh on the real local device:
    the card unless ``device="cpu"`` is asked for (without a card and
    without ``device=`` it raises).  Starts a world-size-1 process group on
    a ``HashStore`` when none is running: NCCL on the card, gloo only on
    the CPU.  The caller ends it with
    ``torch.distributed.destroy_process_group()``."""
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a host mesh needs a real device, not {dev}")
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError(f"a host mesh needs a world of 1 rank, got {dist.get_world_size()}")
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_production_mesh(*, multi_pod: bool = False):
    """The production mesh (16x16, or 2x16x16 multi-pod) as a real
    ``DeviceMesh`` of 256 or 512 ranks on a fake process group
    (``torch.testing._internal.distributed.fake_pg``: collectives move
    nothing), seen from rank 0: the dry run's sharded step runs on it with
    ``meta`` local shards.  Its device type is ``cuda``, the H100 mesh's,
    so DTensor picks the collectives NCCL runs (an all-to-all where gloo
    would all-gather); nothing touches a device.  Starts the group and
    destroys it on exit; raises if a process group is running."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = make_production_mesh(multi_pod=multi_pod)
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=shape.n_devices)
    try:
        yield init_device_mesh("cuda", shape.sizes, mesh_dim_names=shape.axis_names)
    finally:
        dist.destroy_process_group()
