"""Shared pointer-tree adapters (a copy of ``repro.index.trees``): one
structure dispatch for the host region search (``backends.HostBackend``),
so a new pointer node shape is wired up in exactly one place."""

from __future__ import annotations


def node_children(node):
    """(mbr, child, obj) triples of one node — mqr and R nodes unified."""
    if hasattr(node, "locs"):  # mqr Node
        return [(e.mbr, e.node if e.is_node else None, e.obj)
                for _, e in node.entries()]
    return [(e.mbr, e.child, e.obj) for e in node.entries]  # RNode


def node_mbr(node):
    """Node MBR — attribute on mqr nodes, method on R nodes."""
    return node.mbr if not callable(node.mbr) else node.mbr()


def tree_height(tree) -> int:
    height = 0
    for _, depth in tree.iter_nodes():
        height = max(height, depth)
    return height
