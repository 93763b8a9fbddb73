"""Faithful mqr-tree (Moreau & Osborn 2012) — pointer-level reproduction.

A copy of ``repro.core.mqrtree``, kept line for line so the port builds the
same tree node for node (float64 numpy on the host, same tie-breaking in
``quad_of_point``, same CENTER chains and ``_MAX_REINSERT_OPS``).

Implements Section 3 of the paper:

* 5-location two-dimensional nodes (``NE, NW, SW, SE, EQ``) — Fig. 1.
* The Fig. 2 orientation table.  With ``A`` the centroid being placed and
  ``B`` the node-MBR centroid:

      A == B                -> EQ
      Ax > Bx, Ay >= By     -> NE   (due E folds into NE)
      Ax > Bx, Ay <  By     -> SE
      Ax < Bx, Ay >  By     -> NW
      Ax < Bx, Ay <= By     -> SW   (due W folds into SW)
      Ax == Bx, Ay > By     -> NW   (due N folds into NW)
      Ax == Bx, Ay < By     -> SE   (due S folds into SE)

* NORMAL / CENTER node types (Section 3.2).  A CENTER node stores only
  objects whose centroid equals the node-MBR centroid, linearly; chains of
  CENTER nodes extend capacity (Section 3.4, Fig. 9).
* The insertion strategy of Figs. 5-9: merge the node MBR, queue the new
  object, find all objects (recursively, at any depth) whose location became
  invalid because the node centroid moved, remove them, and re-insert
  everything starting at the current node.

Deviation log (documented; see DESIGN.md §3.1 and tests):

1. The paper's Figs. 6-7 enumerate the shifted *regions* for each of the
   expansion/contraction cases on an integer grid (with ±1 boundary
   offsets).  Those regions are exactly the set
   ``{p : quad(p, old_centroid) != quad(p, new_centroid)}``.  We detect
   shifted objects with that predicate directly (branch-free, float-exact)
   instead of enumerating regions — identical result without the
   integer-grid assumption.
2. ``insert_queue``'s CENTER branch in Fig. 9 would file an object whose
   centroid differs from the node centroid into a CENTER node (possible
   when the merged MBR's centroid does not move).  We restore the CENTER
   invariant by demoting the node to NORMAL and re-queueing its objects,
   mirroring the Fig. 6 CENTER case.
3. After objects are pulled out of a subtree (``remove_and_q_objects``), the
   subtree MBRs contract; we additionally re-validate affected descendants
   so the node-validity invariant of Section 3.2 holds at *every* node —
   the paper's Section 4 properties implicitly require this.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, List, Optional, Tuple

import numpy as np

from . import mbr as M

# Location indices (Fig. 1).
NE, NW, SW, SE, EQ = 0, 1, 2, 3, 4
N_LOCS = 5
LOC_NAMES = ("NE", "NW", "SW", "SE", "EQ")

NORMAL = 0
CENTER = 1

_MAX_REINSERT_OPS = 1_000_000  # safety valve against pathological cycles


def find_insert_quad(a_mbr: np.ndarray, b_mbr: np.ndarray) -> int:
    """Fig. 2: orientation of centroid(a) with respect to centroid(b)."""
    ax, ay = M.centroid(a_mbr)
    bx, by = M.centroid(b_mbr)
    return quad_of_point(ax, ay, bx, by)


def quad_of_point(ax: float, ay: float, bx: float, by: float) -> int:
    if ax == bx and ay == by:
        return EQ
    if ax > bx:
        return NE if ay >= by else SE
    if ax < bx:
        return NW if ay > by else SW
    # ax == bx
    return NW if ay > by else SE


class Entry:
    """Content of one node location: an object or a subtree."""

    __slots__ = ("mbr", "node", "obj")

    def __init__(self, mbr: np.ndarray, node: "Node" = None, obj: int = None):
        self.mbr = np.asarray(mbr, dtype=np.float64)
        self.node = node
        self.obj = obj

    @property
    def is_node(self) -> bool:
        return self.node is not None


class Node:
    __slots__ = ("mbr", "locs", "ntype", "parent")

    def __init__(self, parent: "Node" = None):
        self.mbr: Optional[np.ndarray] = None
        self.locs: List[Optional[Entry]] = [None] * N_LOCS
        self.ntype = NORMAL
        self.parent = parent

    # -- small helpers -------------------------------------------------
    def entries(self) -> Iterator[Tuple[int, Entry]]:
        for i, e in enumerate(self.locs):
            if e is not None:
                yield i, e

    def num_children(self) -> int:
        return sum(1 for e in self.locs if e is not None)

    def is_empty(self) -> bool:
        return all(e is None for e in self.locs)

    def recompute_mbr(self) -> None:
        ms = [e.mbr for e in self.locs if e is not None]
        self.mbr = M.merge_many(np.stack(ms)) if ms else None


class MQRTree:
    """The mqr-tree.  Objects are referenced by integer ids."""

    def __init__(self):
        self.root = Node()
        self._ops = 0

    # ------------------------------------------------------------------
    # Insertion (Figs. 5-9)
    # ------------------------------------------------------------------
    def insert(self, obj_id: int, obj_mbr: np.ndarray) -> None:
        self._ops = 0
        self._insert(self.root, Entry(np.asarray(obj_mbr, np.float64), obj=obj_id))
        # Hoist: a root with a single subtree entry is a pure husk.
        while True:
            entries = list(self.root.entries())
            if len(entries) == 1 and entries[0][1].is_node:
                self.root = entries[0][1].node
                self.root.parent = None
            else:
                break

    @staticmethod
    def _normalize(e: Optional[Entry]) -> Optional[Entry]:
        """Collapse chains of single-entry interior nodes (``adjust_node``:
        the paper deletes nodes emptied by removal; a one-entry husk carries
        no information and breaks insertion-order independence)."""
        while e is not None and e.is_node and e.node.num_children() == 1:
            (_, inner), = list(e.node.entries())
            e = inner
        return e

    def _insert(self, n: Node, entry: Entry) -> None:
        """Fig. 5 ``insert``: entry is an object entry (never a subtree)."""
        self._ops += 1
        if self._ops > _MAX_REINSERT_OPS:
            raise RuntimeError("mqr-tree insertion did not converge")

        if n.num_children() == 0:
            n.mbr = entry.mbr.copy()
            n.locs[EQ] = entry
            n.ntype = NORMAL
            return

        orig_mbr = n.mbr.copy()
        n.mbr = M.merge(n.mbr, entry.mbr)

        queue: deque = deque()
        quad = find_insert_quad(entry.mbr, n.mbr)
        queue.append((quad, entry))

        self._find_shifted_objs(queue, n, orig_mbr)
        self._insert_queue(n, queue)

    # ------------------------------------------------------------------
    def _find_shifted_objs(self, queue: deque, n: Node, orig_mbr: np.ndarray) -> None:
        """Figs. 6-7: queue every object whose location became invalid.

        The paper enumerates the affected sub-regions per expansion /
        contraction case (Fig. 4).  All of those regions are contained in the
        union of the vertical band ``x in [old_cx, new_cx]`` and the
        horizontal band ``y in [old_cy, new_cy]``: a centroid's quadrant can
        only change if its x-relation or its y-relation to the node centroid
        changes.  We prune subtree descent with that band (equivalent to the
        paper's region list, robust for float coordinates).
        """
        quad_move = find_insert_quad(n.mbr, orig_mbr)
        if quad_move == EQ:
            # Centroid did not move; all existing placements remain valid.
            return

        ncx, ncy = M.centroid(n.mbr)
        ocx, ocy = M.centroid(orig_mbr)
        band = (
            min(ocx, ncx), max(ocx, ncx),  # x band
            min(ocy, ncy), max(ocy, ncy),  # y band
        )

        if n.ntype == CENTER:
            # Fig. 6 CENTER case: every stored object shares the *old*
            # centroid; they all move to the quadrant of old-centroid
            # relative to the new centroid.
            for obj_entry in self._drain_center_chain(n):
                q = quad_of_point(*M.centroid(obj_entry.mbr), ncx, ncy)
                queue.append((q, obj_entry))
            n.ntype = NORMAL
            return

        # NORMAL node: for each location, pull out (recursively) every object
        # whose quadrant w.r.t. the *new* centroid differs from its location.
        self._queue_invalid_members(queue, n, ncx, ncy, band)

    def _queue_invalid_members(
        self, queue: deque, n: Node, ncx: float, ncy: float, band
    ) -> None:
        """Enforce the object-level validity invariant at node ``n``: every
        object reachable from location ``li`` must have its centroid in
        quadrant ``li`` of ``n``'s centroid (paper Section 4, property 2 —
        what ``remove_and_q_objects`` maintains).  Violators are removed and
        queued.  ``band`` prunes subtree descent."""
        for li in range(N_LOCS):
            e = n.locs[li]
            if e is None:
                continue
            if not e.is_node:
                q = quad_of_point(*M.centroid(e.mbr), ncx, ncy)
                if q != li:
                    n.locs[li] = None
                    queue.append((q, e))
            else:
                self._collect_shifted_from_subtree(
                    queue, e.node, li, ncx, ncy, band
                )
                if e.node.is_empty():
                    n.locs[li] = None
                else:
                    e.node.recompute_mbr()
                    e.mbr = e.node.mbr
                    e = self._normalize(e)
                    n.locs[li] = e
                    # Entry-level rule (Section 3.2): the entry's own MBR
                    # centroid must also sit in the location's quadrant.
                    q = quad_of_point(*M.centroid(e.mbr), ncx, ncy)
                    if q != li:
                        n.locs[li] = None
                        if e.is_node:
                            for obj_entry in self._drain_subtree(e.node):
                                qq = quad_of_point(
                                    *M.centroid(obj_entry.mbr), ncx, ncy
                                )
                                queue.append((qq, obj_entry))
                        else:
                            queue.append((q, e))

    @staticmethod
    def _hits_band(mbr: np.ndarray, band) -> bool:
        x_lo, x_hi, y_lo, y_hi = band
        return (mbr[0] <= x_hi and mbr[2] >= x_lo) or (
            mbr[1] <= y_hi and mbr[3] >= y_lo
        )

    def _collect_shifted_from_subtree(
        self, queue: deque, sub: Node, li: int, ncx: float, ncy: float, band
    ) -> bool:
        """Fig. 8 ``remove_and_q_objects`` over a subtree: remove the objects
        whose centroid is no longer in quadrant ``li`` of the new parent
        centroid and queue them for re-insertion.  Returns True if anything
        was removed from within ``sub``."""
        if sub.mbr is not None and not self._hits_band(sub.mbr, band):
            return False
        removed = False
        for si in range(N_LOCS):
            e = sub.locs[si]
            if e is None:
                continue
            if e.is_node:
                if self._collect_shifted_from_subtree(
                    queue, e.node, li, ncx, ncy, band
                ):
                    removed = True
                    if e.node.is_empty():
                        sub.locs[si] = None
                    else:
                        e.node.recompute_mbr()
                        e.mbr = e.node.mbr
                        sub.locs[si] = self._normalize(e)
            else:
                q = quad_of_point(*M.centroid(e.mbr), ncx, ncy)
                if q != li:
                    sub.locs[si] = None
                    queue.append((q, e))
                    removed = True
        # ``adjust_node``: contraction moved this subtree node's centroid —
        # restore validity of its own members (deviation 3).
        if removed and not sub.is_empty():
            old_c = M.centroid(sub.mbr)
            sub.recompute_mbr()
            self._local_revalidate(sub, old_c)
        return removed

    def _local_revalidate(self, node: Node, old_centroid) -> None:
        """Restore the full (object-level) validity invariant of ``node``
        after its MBR moved from ``old_centroid``.  Same machinery as
        ``_find_shifted_objs`` but rooted at an interior node."""
        if node.ntype == CENTER or node.is_empty() or node.mbr is None:
            return
        ncx, ncy = M.centroid(node.mbr)
        ocx, ocy = old_centroid
        if ncx == ocx and ncy == ocy:
            return
        band = (min(ocx, ncx), max(ocx, ncx), min(ocy, ncy), max(ocy, ncy))
        local_q: deque = deque()
        self._queue_invalid_members(local_q, node, ncx, ncy, band)
        if local_q:
            self._insert_queue(node, local_q)

    def _drain_center_chain(self, n: Node) -> List[Entry]:
        """Remove and return all object entries of a CENTER node chain."""
        out: List[Entry] = []
        for i in range(N_LOCS):
            e = n.locs[i]
            n.locs[i] = None
            if e is None:
                continue
            if e.is_node:
                out.extend(self._drain_center_chain(e.node))
            else:
                out.append(e)
        return out

    def _drain_subtree(self, n: Node) -> List[Entry]:
        out: List[Entry] = []
        for i in range(N_LOCS):
            e = n.locs[i]
            n.locs[i] = None
            if e is None:
                continue
            if e.is_node:
                out.extend(self._drain_subtree(e.node))
            else:
                out.append(e)
        return out

    # ------------------------------------------------------------------
    def _insert_queue(self, n: Node, queue: deque) -> None:
        """Fig. 9: (re)insert queued entries into node ``n``."""
        while queue:
            self._ops += 1
            if self._ops > _MAX_REINSERT_OPS:
                raise RuntimeError("mqr-tree insertion did not converge")
            quad, entry = queue.popleft()

            if n.is_empty():
                n.ntype = NORMAL
                n.mbr = entry.mbr.copy()
                n.locs[EQ] = entry
                continue

            # Keep the node MBR consistent with everything being placed.
            orig = n.mbr.copy()
            n.mbr = M.merge(n.mbr, entry.mbr)
            if not np.array_equal(orig, n.mbr):
                # The centroid may have moved again: re-check validity of the
                # current occupants.
                self._find_shifted_objs(queue, n, orig)
            # The quad stored at enqueue time can be stale (later merges move
            # the centroid); always recompute against the current node MBR.
            quad = find_insert_quad(entry.mbr, n.mbr)

            if n.ntype == CENTER:
                if np.allclose(M.centroid(entry.mbr), M.centroid(n.mbr)):
                    self._center_insert(n, entry)
                else:
                    # Deviation 2: restore the CENTER invariant.
                    ncx, ncy = M.centroid(n.mbr)
                    for obj_entry in self._drain_center_chain(n):
                        q = quad_of_point(*M.centroid(obj_entry.mbr), ncx, ncy)
                        queue.append((q, obj_entry))
                    n.ntype = NORMAL
                    queue.append((find_insert_quad(entry.mbr, n.mbr), entry))
                continue

            occupant = n.locs[quad]
            if occupant is None:
                n.locs[quad] = entry
                continue

            if occupant.is_node:
                # Descend: Fig. 9 calls insert() on the subtree root.
                occupant.node.parent = n
                self._insert(occupant.node, entry)
                occupant.mbr = occupant.node.mbr
                # The subtree MBR grew; its centroid can drift out of the
                # quadrant (wide objects).  Restore node validity at object
                # granularity (as the paper's remove_and_q_objects does).
                ncx, ncy = M.centroid(n.mbr)
                q_now = quad_of_point(*M.centroid(occupant.mbr), ncx, ncy)
                if q_now != quad:
                    n.locs[quad] = None
                    for obj_entry in self._drain_subtree(occupant.node):
                        qq = quad_of_point(*M.centroid(obj_entry.mbr), ncx, ncy)
                        queue.append((qq, obj_entry))
                continue

            # Occupied by an object.
            if quad == EQ and n.num_children() == 1:
                # Convert this node into a CENTER node (same centroids).
                n.ntype = CENTER
                existing = n.locs[EQ]
                n.locs = [None] * N_LOCS
                n.locs[0] = existing
                queue.append((quad, entry))
                continue

            # Create a new child holding both objects (Fig. 9 tail).
            child = Node(parent=n)
            self._insert(child, occupant)
            self._insert(child, entry)
            n.locs[quad] = Entry(child.mbr.copy(), node=child)

    def _center_insert(self, n: Node, entry: Entry) -> None:
        """Place an object into a CENTER node chain (linear organization)."""
        node = n
        while True:
            node.mbr = M.merge(node.mbr, entry.mbr)
            for i in range(N_LOCS - 1):
                if node.locs[i] is None:
                    node.locs[i] = entry
                    return
            # All 4 object slots used: follow/create the chain link in the
            # last slot.
            link = node.locs[N_LOCS - 1]
            if link is None:
                nxt = Node(parent=node)
                nxt.ntype = CENTER
                nxt.mbr = entry.mbr.copy()
                nxt.locs[0] = entry
                node.locs[N_LOCS - 1] = Entry(nxt.mbr.copy(), node=nxt)
                return
            if not link.is_node:
                # Slot 4 holds an object (legacy layout): push it down.
                carried = link
                nxt = Node(parent=node)
                nxt.ntype = CENTER
                nxt.mbr = carried.mbr.copy()
                nxt.locs[0] = carried
                node.locs[N_LOCS - 1] = Entry(nxt.mbr.copy(), node=nxt)
                link = node.locs[N_LOCS - 1]
            node = link.node
            # keep the chain entry MBR fresh
            link.mbr = M.merge(link.mbr, entry.mbr)

    # ------------------------------------------------------------------
    # Region search (Section 3.6): overlap test against every location.
    # ------------------------------------------------------------------
    def region_search(self, query: np.ndarray) -> Tuple[List[int], int]:
        """Return (object ids overlapping query, node visits aka disk accesses)."""
        query = np.asarray(query, dtype=np.float64)
        found: List[int] = []
        visits = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node.mbr is None:
                continue
            visits += 1
            for _, e in node.entries():
                if not M.overlaps(e.mbr, query):
                    continue
                if e.is_node:
                    stack.append(e.node)
                else:
                    found.append(e.obj)
        return found, visits

    # ------------------------------------------------------------------
    # Introspection used by tests / metrics
    # ------------------------------------------------------------------
    def iter_nodes(self) -> Iterator[Tuple[Node, int]]:
        stack = [(self.root, 1)]
        while stack:
            node, depth = stack.pop()
            yield node, depth
            for _, e in node.entries():
                if e.is_node:
                    stack.append((e.node, depth + 1))

    def all_objects(self) -> List[Tuple[int, np.ndarray]]:
        out = []
        for node, _ in self.iter_nodes():
            for _, e in node.entries():
                if not e.is_node:
                    out.append((e.obj, e.mbr))
        return out

    def validate(self) -> None:
        """Assert the Section 3.2 validity rules at every node."""
        for node, _ in self.iter_nodes():
            if node.is_empty():
                assert node is self.root, "empty non-root node"
                continue
            ms = np.stack([e.mbr for _, e in node.entries()])
            enclosing = M.merge_many(ms)
            assert np.allclose(node.mbr, enclosing), (
                f"node MBR {node.mbr} != enclosing {enclosing}"
            )
            if node.ntype == CENTER:
                c = M.centroid(node.mbr)
                for _, e in node.entries():
                    if not e.is_node:
                        assert np.allclose(M.centroid(e.mbr), c), "CENTER invariant"
                continue
            ncx, ncy = M.centroid(node.mbr)
            for li, e in node.entries():
                q = quad_of_point(*M.centroid(e.mbr), ncx, ncy)
                assert q == li, (
                    f"entry at {LOC_NAMES[li]} belongs in {LOC_NAMES[q]} "
                    f"(centroid {M.centroid(e.mbr)}, node centroid {(ncx, ncy)})"
                )


def build(mbrs: np.ndarray) -> MQRTree:
    """Build an mqr-tree by inserting ``mbrs`` (shape (n, 4)) in order."""
    t = MQRTree()
    for i, m in enumerate(np.asarray(mbrs, dtype=np.float64)):
        t.insert(i, m)
    return t


# ---------------------------------------------------------------------------
# Additional queries (paper §5.5 / §6 directions)
# ---------------------------------------------------------------------------


def point_search(tree: MQRTree, point) -> Tuple[List[int], int]:
    """Exact point query.  For point data the paper's zero-overlap property
    (§4) implies at most ONE path is followed — §5.5: "it is possible that
    the mqr-tree can perform a one-path search at most".  Returns
    (object ids whose MBR contains the point, nodes visited)."""
    import numpy as _np

    p = _np.asarray(point, dtype=_np.float64)
    found: List[int] = []
    visits = 0
    stack = [tree.root]
    while stack:
        node = stack.pop()
        if node.mbr is None:
            continue
        visits += 1
        for _, e in node.entries():
            if not M.contains_point(e.mbr, p):
                continue
            if e.is_node:
                stack.append(e.node)
            else:
                found.append(e.obj)
    return found, visits


def knn_search(tree: MQRTree, point, k: int) -> Tuple[List[int], int]:
    """Best-first k-nearest-neighbour over MBR min-distance (the paper's
    §6 future direction, as realized by the DR-tree line of work).
    Returns (k object ids nearest to point, nodes visited)."""
    import heapq
    import numpy as _np

    p = _np.asarray(point, dtype=_np.float64)

    def mindist(mbr) -> float:
        dx = max(mbr[0] - p[0], 0.0, p[0] - mbr[2])
        dy = max(mbr[1] - p[1], 0.0, p[1] - mbr[3])
        return float(dx * dx + dy * dy)

    visits = 0
    heap = [(0.0, 0, True, tree.root)]
    tie = 1
    out: List[Tuple[float, int]] = []
    while heap and len(out) < k:
        d, _, is_node, item = heapq.heappop(heap)
        if is_node:
            node = item
            if node.mbr is None:
                continue
            visits += 1
            for _, e in node.entries():
                tie += 1
                if e.is_node:
                    heapq.heappush(heap, (mindist(e.mbr), tie, True, e.node))
                else:
                    heapq.heappush(heap, (mindist(e.mbr), tie, False, e.obj))
        else:
            out.append((d, item))
    return [o for _, o in out], visits
