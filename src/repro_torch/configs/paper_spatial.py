"""The paper's own workload: spatial index construction + region search.

A copy of ``repro.configs.paper_spatial`` (data only).  Not an LM arch —
exposes dataset/query parameters for the paper benchmarks and the mqr-KV
defaults used by the LM integration.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SpatialConfig:
    dataset: str = "uniform_squares"
    n_objects: int = 1000
    n_trees: int = 5          # paper: 100 random orders; scaled for CPU
    n_queries: int = 20
    seed: int = 0
    rtree_max_entries: int = 5


def config() -> SpatialConfig:
    return SpatialConfig()
