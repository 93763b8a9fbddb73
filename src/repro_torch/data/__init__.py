"""The synthetic LM data pipeline and the spatial shard router
(counterpart of ``repro.data``)."""

from .pipeline import DataConfig, SyntheticLM, make_batch_fn  # noqa: F401
from .spatial_router import route_shards  # noqa: F401
