"""Streaming latency telemetry for the serving front end.

Counterpart of ``repro.serve.telemetry``.  Latency is tracked in
log-spaced histogram buckets (constant relative error, O(1) memory,
O(buckets) quantile reads), NOT by storing samples — the front end is
sized for open-loop load sweeps where millions of requests would
otherwise accumulate.  Each request carries three timestamps (enqueue →
launch → complete, the last after the batch's kernels finished); the
queue-wait and service split is derivable, and the headline numbers are
the tail quantiles: p50 / p99 / p99.9 completion latency versus offered
load.

Shed / queued / degradation counters fold into the same per-tenant
:class:`repro_torch.index.AccessStats` ledger every other layer reports
through (``shed_queries`` / ``queued_queries`` / ``degraded_batches``),
so one stats object describes a tenant end to end.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional


class LatencyHistogram:
    """Log-bucketed streaming latency histogram (seconds in, quantiles out).

    Buckets grow geometrically from ``lo`` to ``hi`` by ``growth`` (≈7%
    relative resolution by default); samples clamp into the edge buckets.
    Quantiles report the geometric midpoint of the covering bucket, so a
    quantile is never off by more than one growth factor.
    """

    def __init__(self, lo: float = 1e-5, hi: float = 120.0,
                 growth: float = 1.07):
        self.lo = float(lo)
        self.growth = float(growth)
        self._log_g = math.log(growth)
        self.n_buckets = int(math.ceil(math.log(hi / lo) / self._log_g)) + 1
        self.counts = [0] * self.n_buckets
        self.n = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, seconds: float) -> None:
        v = max(float(seconds), 0.0)
        self.n += 1
        self.total += v
        self.max = max(self.max, v)
        if v <= self.lo:
            idx = 0
        else:
            idx = min(
                int(math.log(v / self.lo) / self._log_g) + 1,
                self.n_buckets - 1,
            )
        self.counts[idx] += 1

    def quantile(self, q: float) -> float:
        """The ``q``-quantile in seconds (0 when empty).  ``q`` is
        clamped: ``q <= 0`` reads the lowest occupied bucket, ``q >= 1``
        returns the exact observed maximum (the midpoint estimate of the
        top bucket could otherwise exceed every recorded sample)."""
        if self.n == 0:
            return 0.0
        if q >= 1.0:
            return self.max
        rank = max(q, 0.0) * (self.n - 1)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen > rank:
                if i == 0:
                    return self.lo
                # geometric midpoint of bucket i: [lo*g^(i-1), lo*g^i)
                return self.lo * self.growth ** (i - 0.5)
        return self.max  # pragma: no cover — rank always covered above

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other``'s samples into this histogram (in place; used
        by the metrics registry to aggregate across tenants/classes).
        Bucket layouts must match — these are log-bucket counts, not
        samples, so incompatible layouts cannot be re-binned."""
        if (self.lo, self.growth, self.n_buckets) != (
                other.lo, other.growth, other.n_buckets):
            raise ValueError(
                "cannot merge histograms with different bucket layouts: "
                f"(lo={self.lo}, growth={self.growth}, "
                f"n_buckets={self.n_buckets}) vs (lo={other.lo}, "
                f"growth={other.growth}, n_buckets={other.n_buckets})"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.total += other.total
        self.max = max(self.max, other.max)
        return self

    def to_dict(self) -> Dict[str, object]:
        """JSON-friendly snapshot: layout + sparse non-zero buckets."""
        return {
            "lo": self.lo,
            "growth": self.growth,
            "n_buckets": self.n_buckets,
            "n": self.n,
            "total": self.total,
            "max": self.max,
            "counts": {i: c for i, c in enumerate(self.counts) if c},
        }

    @property
    def mean(self) -> float:
        return self.total / max(self.n, 1)

    def quantiles_ms(self) -> Dict[str, float]:
        return {
            "p50_ms": self.quantile(0.50) * 1e3,
            "p99_ms": self.quantile(0.99) * 1e3,
            "p999_ms": self.quantile(0.999) * 1e3,
        }


@dataclasses.dataclass
class ServeTelemetry:
    """Front-end counters + per-class latency histograms.

    One instance per :class:`~repro_torch.serve.frontend.ServingFrontEnd`;
    ``snapshot()`` is the flat dict the load generator turns into
    rows (:func:`repro_torch.serve.loadgen.write_bench_rows`).
    """

    submitted: int = 0
    completed: int = 0
    rejected: int = 0          # invalid geometry, refused at the boundary
    shed: int = 0              # admission control dropped (overload)
    queued_overload: int = 0   # admitted past max_queue, parked best-effort
    slo_violations: int = 0    # completed after the class deadline
    batches: int = 0           # coalesced batches launched
    batched_requests: int = 0  # requests inside those batches
    deadline_launches: int = 0 # batches launched by deadline slack, not size
    latency: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram
    )
    queue_wait: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram
    )
    by_class: Dict[str, LatencyHistogram] = dataclasses.field(
        default_factory=dict
    )
    by_tenant: Dict[str, LatencyHistogram] = dataclasses.field(
        default_factory=dict
    )

    def observe(self, req, cls_deadline_s: float) -> None:
        """Fold one completed request's timeline into the histograms."""
        self.completed += 1
        lat = req.t_complete - req.t_arrival
        self.latency.record(lat)
        self.queue_wait.record(req.t_launch - req.t_arrival)
        self.by_class.setdefault(req.slo_class, LatencyHistogram()).record(lat)
        self.by_tenant.setdefault(req.tenant, LatencyHistogram()).record(lat)
        if lat > cls_deadline_s:
            self.slo_violations += 1

    @property
    def avg_batch(self) -> float:
        return self.batched_requests / max(self.batches, 1)

    def snapshot(self) -> Dict[str, float]:
        out = {
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "shed": self.shed,
            "queued_overload": self.queued_overload,
            "slo_violations": self.slo_violations,
            "batches": self.batches,
            "deadline_launches": self.deadline_launches,
            "avg_batch": round(self.avg_batch, 2),
            "mean_ms": self.latency.mean * 1e3,
            "queue_wait_p99_ms": self.queue_wait.quantile(0.99) * 1e3,
        }
        out.update(self.latency.quantiles_ms())
        return out


@dataclasses.dataclass(frozen=True)
class RequestTimeline:
    """The three timestamps every served request carries (seconds on the
    front end's clock): scheduled arrival/enqueue, batch launch, and
    completion.  Exposed for tests and offline analysis."""

    t_arrival: float
    t_launch: Optional[float]
    t_complete: Optional[float]

    @property
    def queue_wait(self) -> Optional[float]:
        if self.t_launch is None:
            return None
        return self.t_launch - self.t_arrival

    @property
    def latency(self) -> Optional[float]:
        if self.t_complete is None:
            return None
        return self.t_complete - self.t_arrival
