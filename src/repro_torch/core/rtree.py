"""Guttman R-tree (1984) — the paper's benchmark baseline.

A copy of ``repro.core.rtree`` (host numpy, float64).

Quadratic split, ``M = 5`` entries per node (matching the mqr-tree's five
locations, and consistent with the node counts reported in the paper's
tables: ~196 nodes for 500 objects), ``m = 2``.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from . import mbr as M

DEFAULT_M = 5
DEFAULT_m = 2


class REntry:
    __slots__ = ("mbr", "child", "obj")

    def __init__(self, mbr: np.ndarray, child: "RNode" = None, obj: int = None):
        self.mbr = np.asarray(mbr, dtype=np.float64)
        self.child = child
        self.obj = obj


class RNode:
    __slots__ = ("entries", "leaf", "parent")

    def __init__(self, leaf: bool = True, parent: "RNode" = None):
        self.entries: List[REntry] = []
        self.leaf = leaf
        self.parent = parent

    def mbr(self) -> np.ndarray:
        return M.merge_many(np.stack([e.mbr for e in self.entries]))


class RTree:
    def __init__(self, max_entries: int = DEFAULT_M, min_entries: int = DEFAULT_m):
        self.M = max_entries
        self.m = min_entries
        self.root = RNode(leaf=True)

    # ------------------------------------------------------------------
    def insert(self, obj_id: int, obj_mbr: np.ndarray) -> None:
        entry = REntry(np.asarray(obj_mbr, np.float64), obj=obj_id)
        leaf = self._choose_leaf(self.root, entry)
        leaf.entries.append(entry)
        if len(leaf.entries) > self.M:
            self._split_and_adjust(leaf)
        else:
            self._adjust_upward(leaf)

    def _choose_leaf(self, node: RNode, entry: REntry) -> RNode:
        while not node.leaf:
            best: Optional[REntry] = None
            best_enl = np.inf
            best_area = np.inf
            for e in node.entries:
                a = M.area(e.mbr)
                enl = M.area(M.merge(e.mbr, entry.mbr)) - a
                if enl < best_enl or (enl == best_enl and a < best_area):
                    best, best_enl, best_area = e, enl, a
            node = best.child
        return node

    def _adjust_upward(self, node: RNode) -> None:
        while node.parent is not None:
            parent = node.parent
            for e in parent.entries:
                if e.child is node:
                    e.mbr = node.mbr()
                    break
            node = parent

    def _split_and_adjust(self, node: RNode) -> None:
        while True:
            a_entries, b_entries = self._quadratic_split(node.entries)
            node.entries = a_entries
            sibling = RNode(leaf=node.leaf, parent=node.parent)
            sibling.entries = b_entries
            for e in sibling.entries:
                if e.child is not None:
                    e.child.parent = sibling
            if node.parent is None:
                new_root = RNode(leaf=False)
                new_root.entries = [
                    REntry(node.mbr(), child=node),
                    REntry(sibling.mbr(), child=sibling),
                ]
                node.parent = new_root
                sibling.parent = new_root
                self.root = new_root
                return
            parent = node.parent
            for e in parent.entries:
                if e.child is node:
                    e.mbr = node.mbr()
                    break
            parent.entries.append(REntry(sibling.mbr(), child=sibling))
            if len(parent.entries) > self.M:
                node = parent
                continue
            self._adjust_upward(parent)
            return

    def _quadratic_split(
        self, entries: List[REntry]
    ) -> Tuple[List[REntry], List[REntry]]:
        # PickSeeds: the pair wasting the most area.
        n = len(entries)
        worst = -np.inf
        s1 = s2 = 0
        for i in range(n):
            for j in range(i + 1, n):
                waste = (
                    M.area(M.merge(entries[i].mbr, entries[j].mbr))
                    - M.area(entries[i].mbr)
                    - M.area(entries[j].mbr)
                )
                if waste > worst:
                    worst, s1, s2 = waste, i, j
        group_a = [entries[s1]]
        group_b = [entries[s2]]
        mbr_a = entries[s1].mbr.copy()
        mbr_b = entries[s2].mbr.copy()
        rest = [e for k, e in enumerate(entries) if k not in (s1, s2)]
        while rest:
            need_a = self.m - len(group_a)
            need_b = self.m - len(group_b)
            if need_a >= len(rest):
                group_a.extend(rest)
                for e in rest:
                    mbr_a = M.merge(mbr_a, e.mbr)
                break
            if need_b >= len(rest):
                group_b.extend(rest)
                for e in rest:
                    mbr_b = M.merge(mbr_b, e.mbr)
                break
            # PickNext: entry with max preference difference.
            best_k = 0
            best_diff = -np.inf
            for k, e in enumerate(rest):
                d1 = M.area(M.merge(mbr_a, e.mbr)) - M.area(mbr_a)
                d2 = M.area(M.merge(mbr_b, e.mbr)) - M.area(mbr_b)
                if abs(d1 - d2) > best_diff:
                    best_diff = abs(d1 - d2)
                    best_k = k
            e = rest.pop(best_k)
            d1 = M.area(M.merge(mbr_a, e.mbr)) - M.area(mbr_a)
            d2 = M.area(M.merge(mbr_b, e.mbr)) - M.area(mbr_b)
            if d1 < d2 or (
                d1 == d2
                and (
                    M.area(mbr_a) < M.area(mbr_b)
                    or (M.area(mbr_a) == M.area(mbr_b) and len(group_a) <= len(group_b))
                )
            ):
                group_a.append(e)
                mbr_a = M.merge(mbr_a, e.mbr)
            else:
                group_b.append(e)
                mbr_b = M.merge(mbr_b, e.mbr)
        return group_a, group_b

    # ------------------------------------------------------------------
    def region_search(self, query: np.ndarray) -> Tuple[List[int], int]:
        query = np.asarray(query, dtype=np.float64)
        found: List[int] = []
        visits = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            visits += 1
            for e in node.entries:
                if not M.overlaps(e.mbr, query):
                    continue
                if node.leaf:
                    found.append(e.obj)
                else:
                    stack.append(e.child)
        return found, visits

    # ------------------------------------------------------------------
    def iter_nodes(self) -> Iterator[Tuple[RNode, int]]:
        stack = [(self.root, 1)]
        while stack:
            node, depth = stack.pop()
            yield node, depth
            if not node.leaf:
                for e in node.entries:
                    stack.append((e.child, depth + 1))

    def validate(self) -> None:
        for node, _ in self.iter_nodes():
            if node is not self.root:
                assert self.m <= len(node.entries) <= self.M
            else:
                assert len(node.entries) <= self.M
            if not node.leaf:
                for e in node.entries:
                    assert np.allclose(e.mbr, e.child.mbr()), "stale parent MBR"


def build(mbrs: np.ndarray, max_entries: int = DEFAULT_M) -> RTree:
    t = RTree(max_entries=max_entries)
    for i, m in enumerate(np.asarray(mbrs, dtype=np.float64)):
        t.insert(i, m)
    return t
