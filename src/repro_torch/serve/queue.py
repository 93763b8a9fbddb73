"""Continuous batching: coalesce single arrivals into bounded batches.

Counterpart of ``repro.serve.queue``, host code only, with the
reference's behaviour.  Single region/point/knn/count requests arrive one
at a time; kernels want dense ``(query_block, 4)`` batches.  A :class:`BatchQueue` holds
one FIFO per coalescing group — ``(tenant, "region")`` for the three
rectangle-shaped kinds (a point is a degenerate rectangle, a count is a
region reduced at completion) and ``(tenant, "knn", k)`` per distinct
``k`` — and launches a group's head batch when EITHER bound trips:

* **size**: the group holds a full ``query_block`` of requests;
* **deadline**: the oldest non-parked request's slack runs out —
  ``now >= deadline - est_service - margin`` where ``est_service`` is an
  EWMA of the group's recent launch-to-complete times (on the card,
  completion waits for the batch's kernels: the front end synchronizes
  before it stamps it).  Waiting any longer would spend the request's
  remaining SLO budget on queueing.

Requests parked by ``overload="queue"`` admission never drive the
deadline bound (their SLO is already forfeit); they ride along in FIFO
order whenever the size bound or another request's deadline launches
their group, or when the front end drains.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import trace as _obs_trace

#: request kinds the front end coalesces
KINDS = ("region", "point", "count", "knn")

#: kinds that share the rectangle-batch coalescing group
RECT_KINDS = ("region", "point", "count")

# one counter for the module: seqs order the requests of a process
_SEQ = itertools.count()


@dataclasses.dataclass
class Request:
    """One in-flight request: payload + SLO + the latency timeline.

    The object doubles as the caller's ticket — :attr:`status` moves
    ``pending -> done`` (or is born ``rejected``/``shed``) and
    :attr:`result` holds the per-kind answer once completed.
    """

    tenant: str
    kind: str
    payload: np.ndarray          # (4,) rect for rect kinds; (2,) point for knn
    slo_class: str
    deadline: float              # absolute, on the front end's clock
    t_arrival: float
    k: Optional[int] = None      # knn only
    parked: bool = False         # admitted past max_queue (overload="queue")
    seq: int = dataclasses.field(default_factory=lambda: next(_SEQ))
    status: str = "pending"      # pending | done | shed | rejected
    result: Any = None
    t_launch: Optional[float] = None
    t_complete: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.status == "done"

    def timeline(self):
        from .telemetry import RequestTimeline

        return RequestTimeline(self.t_arrival, self.t_launch, self.t_complete)


GroupKey = Tuple  # ("rect", tenant) | ("knn", tenant, k)


def group_key(req: Request) -> GroupKey:
    if req.kind in RECT_KINDS:
        return ("rect", req.tenant)
    return ("knn", req.tenant, req.k)


class BatchQueue:
    """FIFO coalescing queues, one per group, with EWMA service estimates."""

    def __init__(self, query_block: int, *, slack_margin: float = 1e-3,
                 est_alpha: float = 0.25, est_init: float = 2e-3):
        self.query_block = int(query_block)
        self.slack_margin = float(slack_margin)
        self.est_alpha = float(est_alpha)
        self.est_init = float(est_init)
        self._queues: Dict[GroupKey, Deque[Request]] = {}
        self._est: Dict[GroupKey, float] = {}
        self.pending_by_class: Dict[str, int] = {}

    # -- admission-side bookkeeping ------------------------------------
    def pending(self, slo_class: Optional[str] = None) -> int:
        if slo_class is None:
            return sum(len(q) for q in self._queues.values())
        return self.pending_by_class.get(slo_class, 0)

    def add(self, req: Request) -> None:
        self._queues.setdefault(group_key(req), deque()).append(req)
        self.pending_by_class[req.slo_class] = (
            self.pending_by_class.get(req.slo_class, 0) + 1
        )

    # -- launch decisions ----------------------------------------------
    def est_service(self, key: GroupKey) -> float:
        return self._est.get(key, self.est_init)

    def observe_service(self, key: GroupKey, seconds: float) -> None:
        prev = self._est.get(key)
        a = self.est_alpha
        self._est[key] = (
            seconds if prev is None else (1 - a) * prev + a * seconds
        )

    def due_groups(self, now: float) -> List[Tuple[GroupKey, bool]]:
        """Groups that must launch at ``now``: ``(key, by_deadline)`` —
        full groups first (size bound), then any group whose oldest
        non-parked request has run out of deadline slack."""
        out = []
        for key, q in self._queues.items():
            if not q:
                continue
            if len(q) >= self.query_block:
                out.append((key, False))
                continue
            oldest = next((r for r in q if not r.parked), None)
            if oldest is None:
                continue
            slack = oldest.deadline - now - self.est_service(key)
            if slack <= self.slack_margin:
                _obs_trace.instant("queue.deadline_due",
                                   group=str(key), seq=oldest.seq,
                                   slack_ms=slack * 1e3)
                out.append((key, True))
        return out

    def pop_batch(self, key: GroupKey) -> List[Request]:
        """Dequeue up to ``query_block`` requests of one group, FIFO."""
        q = self._queues.get(key)
        batch: List[Request] = []
        while q and len(batch) < self.query_block:
            req = q.popleft()
            self.pending_by_class[req.slo_class] -= 1
            batch.append(req)
        return batch

    def drain_keys(self) -> List[GroupKey]:
        return [k for k, q in self._queues.items() if q]
