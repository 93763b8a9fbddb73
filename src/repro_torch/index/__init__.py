"""The :class:`SpatialIndex` façade and its backend registry."""

from repro_torch.update import MergePolicy

from .api import (
    AccessStats,
    BuildArtifacts,
    InvalidQueryError,
    KNNResult,
    RegionResult,
    SpatialIndex,
    validate_mbrs,
    validate_queries,
)
from .join import JoinResult
from .registry import advertised_pairs, backend_names, get_backend, register_backend
