"""Tree-quality metrics exactly as evaluated in the paper (Section 5.2).

A copy of ``repro.core.metrics`` over the port's own tree modules.

Works for both MQRTree and RTree through a small adapter layer: a *node view*
is ``(child_mbrs, child_is_node, depth)`` per node.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from . import mbr as M
from .mqrtree import MQRTree
from .rtree import RTree


@dataclasses.dataclass
class TreeMetrics:
    n_nodes: int
    height: int                 # worst-case root->node depth
    avg_path: float             # average depth over object references
    coverage: float             # sum of node-MBR areas
    overcoverage: float         # sum of per-node whitespace
    overlap: float              # sum of per-node pairwise entry intersection
    space_utilization: float    # mean fraction of locations/entries used

    def row(self) -> dict:
        return dataclasses.asdict(self)


def _node_views(tree) -> List[Tuple[np.ndarray, np.ndarray, int, int]]:
    """Return per-node (entry_mbrs, is_node_flags, depth, capacity)."""
    views = []
    if isinstance(tree, MQRTree):
        for node, depth in tree.iter_nodes():
            ms, flags = [], []
            for _, e in node.entries():
                ms.append(e.mbr)
                flags.append(e.is_node)
            if ms:
                views.append((np.stack(ms), np.array(flags), depth, 5))
    elif isinstance(tree, RTree):
        for node, depth in tree.iter_nodes():
            ms = [e.mbr for e in node.entries]
            flags = [not node.leaf] * len(ms)
            if ms:
                views.append((np.stack(ms), np.array(flags), depth, tree.M))
    else:  # pragma: no cover - defensive
        raise TypeError(type(tree))
    return views


def compute_metrics(tree) -> TreeMetrics:
    views = _node_views(tree)
    n_nodes = len(views)
    height = 0
    coverage = 0.0
    overcoverage = 0.0
    overlap = 0.0
    util = 0.0
    obj_depth_sum = 0.0
    obj_count = 0
    for ms, is_node, depth, cap in views:
        node_mbr = M.merge_many(ms)
        coverage += float(M.area(node_mbr))
        overcoverage += float(M.area(node_mbr)) - M.union_area(ms)
        overlap += M.pairwise_overlap_total(ms)
        util += ms.shape[0] / cap
        height = max(height, depth)
        n_objs_here = int((~is_node).sum())
        obj_depth_sum += depth * n_objs_here
        obj_count += n_objs_here
    return TreeMetrics(
        n_nodes=n_nodes,
        height=height,
        avg_path=obj_depth_sum / max(obj_count, 1),
        coverage=coverage,
        overcoverage=overcoverage,
        overlap=overlap,
        space_utilization=util / max(n_nodes, 1),
    )
