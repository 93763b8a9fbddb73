"""Host oracle for the live-update subsystem: the paper's insertion rules.

Counterpart of ``repro.update.oracle``, over the port's own
``core/mqrtree.py``.  The acceptance contract (DESIGN.md §8) is that every
backend's hit sets over base ∪ delta − tombstones stay bit-identical to a
pointer mqr-tree maintained with the paper's own insertion strategy over
the live object set.  :func:`live_tree` builds that tree — objects inserted
in ascending global id, i.e. original insertion order — and is also what
``SpatialIndex.live_metrics`` evaluates the Section 5.2 structure metrics
on.
"""

from __future__ import annotations

from typing import List, Set

import numpy as np

from repro_torch.core import mqrtree


def live_tree(index_or_log) -> mqrtree.MQRTree:
    """The mqr insertion-rule tree over the CURRENT live object set.

    Accepts a ``SpatialIndex`` (pristine or live) or an ``UpdateLog``.
    Live logs cache the tree per mutation epoch — rebuilding only when
    the live set actually changed.
    """
    log = getattr(index_or_log, "_updates", index_or_log)
    if log is None:  # pristine index: the build inputs ARE the live set
        mbrs = np.asarray(index_or_log.artifacts.mbrs, np.float64)
        return mqrtree.build(mbrs)
    if log._oracle is not None and log._oracle[0] == log.epoch:
        return log._oracle[1]
    tree = mqrtree.MQRTree()
    for g in np.nonzero(log.alive)[0]:
        tree.insert(int(g), log.mbr_table[g])
    log._oracle = (log.epoch, tree)
    return tree


def region_sets(index_or_log, queries) -> List[Set[int]]:
    """Per-query sets of live global ids the oracle tree finds.  Queries go
    through the same float32 cast the façade applies, then the tree
    searches in float64 — the ``host`` backend's convention."""
    tree = live_tree(index_or_log)
    queries = np.asarray(queries, np.float32).reshape(-1, 4)
    return [
        set(tree.region_search(np.asarray(q, np.float64))[0]) for q in queries
    ]


def hits_mask(index_or_log, queries, width: int) -> np.ndarray:
    """Oracle hit sets as a (Q, width) bool mask in global-id space,
    directly comparable to ``RegionResult.hits``."""
    sets = region_sets(index_or_log, queries)
    out = np.zeros((len(sets), width), bool)
    for i, ids in enumerate(sets):
        out[i, sorted(ids)] = True
    return out
