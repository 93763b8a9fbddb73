"""Spatial shard router: the faithful mqr-tree applied to the data plane.

Counterpart of ``repro.data.spatial_router``, over the port's
``repro_torch.core.mqrtree``; it runs on the host, as the reference's does.
Multi-host pipelines with spatial payloads (geo tiles, molecular frames,
image patches) want co-located data on the same host.  The router builds an
mqr-tree over shard MBRs and assigns hosts by subtree — spatially coherent
shards land together, and the paper's zero-overlap property means no shard
is fetched by two hosts.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core import mqrtree


def route_shards(shard_mbrs: np.ndarray, n_hosts: int) -> Dict[int, List[int]]:
    """Assign shards (by MBR) to hosts via mqr-tree subtree decomposition.

    Returns {host_id: [shard ids]} with contiguous spatial groups.
    """
    tree = mqrtree.build(shard_mbrs)
    order: List[int] = []

    def walk(node):
        for _, e in sorted(node.entries(), key=lambda t: t[0]):
            if e.is_node:
                walk(e.node)
            else:
                order.append(e.obj)

    walk(tree.root)
    assert len(order) == shard_mbrs.shape[0]
    per = int(np.ceil(len(order) / n_hosts))
    return {h: order[h * per : (h + 1) * per] for h in range(n_hosts)}
