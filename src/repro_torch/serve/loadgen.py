"""Open-loop load generation: latency-under-load for the front end.

Counterpart of ``repro.serve.loadgen``: arrival offsets and query rects
come from numpy generators seeded exactly as the reference's, so both
packages see the same load for the same seed.  Arrivals follow a
Poisson process at the OFFERED rate — the generator never waits for an
answer before sending the next request, and each request's latency is
measured from its *scheduled* arrival time, not from when the generator
got around to submitting it.  A closed-loop client (send, wait, send)
silently stops offering load exactly when the server slows down, hiding
the tail; the open-loop clock keeps the pressure honest (the classic
coordinated-omission trap).

:func:`run_sweep` drives one fresh front end per offered-QPS level and
returns one row per level — p50/p99/p99.9 completion latency, shed and
queued counts, achieved throughput — which :func:`write_bench_rows`
merges into a ``BENCH_<date>.json`` trajectory file in a directory the
caller names.  On the card every completion is stamped after the batch's
kernels finished (:mod:`repro_torch.serve.frontend`).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .frontend import ServingFrontEnd


def poisson_arrivals(qps: float, duration: float, *, seed: int = 0
                     ) -> np.ndarray:
    """Arrival offsets (seconds from start) of a Poisson process at
    ``qps`` over ``duration`` — exponential inter-arrival gaps."""
    if qps <= 0:
        return np.zeros((0,), np.float64)
    rng = np.random.default_rng(seed)
    # mean count + 4 sigma, then clip to the window
    n = int(qps * duration + 4 * np.sqrt(qps * duration)) + 8
    gaps = rng.exponential(1.0 / qps, size=n)
    t = np.cumsum(gaps)
    return t[t < duration]


def rect_workload(extent, n: int, *, seed: int = 0,
                  sel: float = 0.05) -> np.ndarray:
    """(n, 4) valid query rects covering ≈``sel`` of ``extent`` each."""
    lo = np.asarray(extent[:2], np.float64)
    hi = np.asarray(extent[2:], np.float64)
    span = np.maximum(hi - lo, 1e-6)
    rng = np.random.default_rng(seed)
    side = span * np.sqrt(sel)
    c = lo + rng.random((n, 2)) * (span - side)
    return np.concatenate([c, c + side], axis=1).astype(np.float32)


def data_extent(mbrs) -> np.ndarray:
    m = np.asarray(mbrs, np.float64)
    return np.concatenate([m[:, :2].min(axis=0), m[:, 2:].max(axis=0)])


def run_load(front: ServingFrontEnd, tenant: str, queries: np.ndarray,
             arrivals: np.ndarray, *, kind: str = "region",
             knn_k: int = 8, knn_every: int = 0,
             slo: Optional[str] = None) -> Dict[str, float]:
    """Drive one open-loop run; returns the telemetry snapshot plus
    offered/achieved QPS.

    ``knn_every=n`` turns every n-th request into a knn at the query
    rect's lower corner, exercising the second coalescing group under
    the same arrival process.

    One thread both offers and serves, so while a batch runs no request
    is submitted.  Where the reference pumps after every submit, this
    loop pumps only once it has caught up with the schedule: arrivals
    whose time has passed are all enqueued first, as a concurrent front
    end would see them, so admission control sheds past ``max_queue``.
    Pumping after each overdue arrival instead launches it alone (its
    deadline has passed), and under overload every batch shrinks to one
    request and no request is shed (ROADMAP C22).
    """
    clock = front.clock
    start = clock()
    n = len(arrivals)
    for i in range(n):
        target = start + float(arrivals[i])
        # pump while waiting out the gap — this IS the serving loop
        while True:
            now = clock()
            if now >= target:
                break
            if not front.pump():
                time.sleep(min(target - now, 1e-4))
        q = queries[i % len(queries)]
        if knn_every and (i % knn_every) == knn_every - 1:
            front.submit(tenant, "knn", q[:2], k=knn_k, slo=slo,
                         t_arrival=target)
        else:
            front.submit(tenant, kind, q, slo=slo, t_arrival=target)
        if i + 1 == n or clock() < start + float(arrivals[i + 1]):
            front.pump()  # caught up with the schedule: launch what is due
    front.drain()
    elapsed = clock() - start
    row = front.telemetry.snapshot()
    row["qps_offered"] = n / max(arrivals[-1], 1e-9) if n else 0.0
    row["qps_achieved"] = row["completed"] / max(elapsed, 1e-9)
    row["duration_s"] = elapsed
    return row


def run_sweep(make_front: Callable[[], "tuple[ServingFrontEnd, str]"],
              qps_levels: Sequence[float], *, duration: float = 2.0,
              seed: int = 0, sel: float = 0.05, knn_every: int = 0,
              knn_k: int = 8) -> List[Dict[str, float]]:
    """One row per offered-QPS level, each on a FRESH front end (fresh
    telemetry, fresh queues) so levels can't contaminate each other.
    ``make_front`` returns ``(front, tenant_name)``; the front is warmed
    up before timing so first-call costs never land in the latency curve."""
    rows = []
    for li, qps in enumerate(qps_levels):
        front, tenant = make_front()
        front.warmup(knn_k=knn_k if knn_every else None)
        extent = data_extent(front.tenants[tenant].spatial.artifacts.mbrs)
        arrivals = poisson_arrivals(qps, duration, seed=seed + li)
        queries = rect_workload(
            extent, max(len(arrivals), 1), seed=seed + 1000 + li, sel=sel
        )
        row = run_load(front, tenant, queries, arrivals,
                       knn_every=knn_every, knn_k=knn_k)
        row["qps_level"] = float(qps)
        rows.append(row)
    return rows


def write_bench_rows(rows: Sequence[Dict[str, float]], root: str,
                     *, name: str = "serving") -> str:
    """Merge sweep rows into ``BENCH_<UTC-date>.json`` at ``root``,
    preserving rows other benches already wrote today (the harness in
    benchmarks/run.py owns the file format: name / us_per_call /
    derived).  Each level gets its own row, ``<name>_qps<level>``, so
    the latency-vs-load curve stays legible in the trajectory file."""
    date = time.strftime("%Y-%m-%d", time.gmtime())
    path = os.path.join(root, f"BENCH_{date}.json")
    doc = {"date": date, "rows": []}
    if os.path.exists(path):
        with open(path) as f:
            doc = json.load(f)
    doc["rows"] = [r for r in doc["rows"]
                   if not str(r.get("name", "")).startswith(f"{name}_qps")]
    for row in rows:
        level = int(round(row.get("qps_level", row.get("qps_offered", 0))))
        doc["rows"].append({
            "name": f"{name}_qps{level}",
            "us_per_call": row.get("mean_ms", 0.0) * 1e3,
            "derived": dict(row),
        })
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=float)
        f.write("\n")
    return path
