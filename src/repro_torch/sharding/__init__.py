"""Sharding rules (counterpart of ``repro.sharding``)."""

from .rules import (  # noqa: F401
    PartitionSpec,
    batch_shardings,
    batch_spec,
    cache_shardings,
    cache_spec,
    data_axes,
    param_shardings,
    param_specs,
    placements,
    shard_shape,
)
