"""The multi-tenant serving front end.

Counterpart of ``repro.serve.frontend``.  One :class:`ServingFrontEnd`
owns any number of tenant index stacks and turns single-query arrivals
into kernel-shaped launches:

* :meth:`submit` — the hardened boundary: geometry is validated per
  request (NaN/±inf/inverted rects raise the typed
  :class:`repro_torch.index.InvalidQueryError` BEFORE touching a batch),
  then admission control compares the request's SLO class queue depth
  against the class limit — over it, ``overload="shed"`` returns a
  ``shed`` ticket (the request never queues) and ``overload="queue"``
  parks the request best-effort;
* :meth:`pump` — continuous batching: launches every group whose size or
  deadline bound has tripped (:mod:`repro_torch.serve.queue`), one
  ``SpatialIndex`` call per coalesced batch;
* answers are BIT-IDENTICAL to calling the tenant's index directly: the
  front end only stacks, dispatches, and unstacks — caching, dedupe,
  padding, and the cuda → torch → host degradation ladder all live in the
  per-tenant serving stack underneath (the ``serve`` backend), which is
  also why a bound :class:`repro_torch.ft.FaultPlan` shows up as tail
  latency, never as errors.  The front end catches no kernel error: on
  the card only the ``serve`` backend's ladder degrades, and only on an
  injected failure (ROADMAP C18);
* every tenant has its own index, its own epoch-tagged result cache, and
  its own :class:`repro_torch.index.AccessStats` ledger — tenant A's
  mutations bump only A's epoch, so B's cached answers stay valid.

Where the port differs from the reference (ROADMAP C21):

* **Completion waits for the card.**  A tenant's ``region`` and ``knn``
  return CUDA tensors while the kernels may still run, so each batch
  waits for its results once — one ``.tolist()`` of the batch's counts
  when it holds a count request, else one stream synchronize — before
  its requests are stamped complete and before the service time feeds
  the queue's EWMA estimate.  Latency, the estimate and so the deadline
  bound are the card's, not the enqueue's.  No other host sync is made
  per request.
* **Answers stay on the tenant's device**: :class:`Answer` holds rows of
  the batch's hit and visit tensors, a k-NN answer ``(ids[i],
  dists[i])``, a count a Python int.  A row keeps its batch's hit tensor
  alive (16 MB for 16 queries at n = 1e6), so the front end keeps no
  completed request; the caller holds its tickets.
* ``build`` takes the ``device`` every tenant is built on (the card when
  None); it is not a config field, so config dicts stay shared with the
  reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.index.api import InvalidQueryError, SpatialIndex, validate_queries
from repro_torch.obs import trace as _obs_trace

from .config import ServerConfig, TenantConfig
from .queue import KINDS, BatchQueue, GroupKey, Request, group_key
from .telemetry import ServeTelemetry


class OverloadShed(Exception):
    """Raised by :meth:`Request-awaiting helpers <ServingFrontEnd.result>`
    when asked for the answer of a request that admission control shed."""


@dataclasses.dataclass(frozen=True)
class Answer:
    """Per-request region/point answer: one row of the batched result,
    on the tenant's device."""

    hits: torch.Tensor            # (id_space,) bool global-id overlap mask
    visits: torch.Tensor          # (L,) int32 per-level accesses

    @property
    def ids(self) -> torch.Tensor:
        return torch.nonzero(self.hits).flatten()


def _wait(t: torch.Tensor) -> None:
    """Block until the work queued before ``t``'s last kernel is done (a
    no-op on the CPU, where it already is)."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


class TenantRuntime:
    """One tenant's built stack: the config plus its live index.

    ``index`` is the queryable object — a :class:`SpatialIndex`, or a
    :class:`repro_torch.checkpoint.DurableIndex` when the tenant declared
    ``durable_root`` (mutations then go WAL-first and a front-end
    restart recovers the tenant's last durable state).
    """

    def __init__(self, config: TenantConfig, index):
        self.config = config
        self.index = index

    @property
    def spatial(self) -> SpatialIndex:
        """The underlying SpatialIndex (unwraps DurableIndex)."""
        return getattr(self.index, "index", self.index)

    @property
    def stats(self):
        return self.index.stats

    @property
    def epoch(self) -> int:
        """The tenant's mutation epoch (0 until the first mutation)."""
        log = self.spatial._updates
        return 0 if log is None else int(log.epoch)


class ServingFrontEnd:
    """Continuous batching + admission control over a tenant registry."""

    def __init__(self, config: ServerConfig,
                 runtimes: Dict[str, TenantRuntime], *,
                 clock: Optional[Callable[[], float]] = None):
        self.config = config
        self.tenants = dict(runtimes)
        self.clock = clock if clock is not None else time.monotonic
        self.queue = BatchQueue(
            config.query_block, slack_margin=config.slack_margin_ms / 1e3
        )
        self.telemetry = ServeTelemetry()

    # -- construction ---------------------------------------------------
    @classmethod
    def build(cls, config: Union[ServerConfig, dict], data: Dict[str, np.ndarray],
              *, device=None, clock=None, fault_plan=None) -> "ServingFrontEnd":
        """Declarative config → built front end (the factory idiom).

        ``data`` maps tenant name → (n, 4) MBRs; every declared tenant
        must be covered (durable tenants with an existing generation
        recover from disk instead and may omit their entry).  Every
        tenant is built (or recovered) on ``device``: the CUDA card when
        None; without a card that raises unless ``device="cpu"`` is asked
        for.
        """
        if not isinstance(config, ServerConfig):
            config = ServerConfig.from_dict(config)
        runtimes: Dict[str, TenantRuntime] = {}
        for tc in config.tenants:
            runtimes[tc.name] = TenantRuntime(
                tc, cls._build_tenant_index(tc, config, data, device)
            )
        front = cls(config, runtimes, clock=clock)
        if fault_plan is not None:
            front.bind_fault_plan(fault_plan)
        return front

    @staticmethod
    def _build_tenant_index(tc: TenantConfig, config: ServerConfig,
                            data: Dict[str, np.ndarray], device):
        opts = tc.index_opts(config.query_block)
        if tc.durable_root is not None:
            from repro_torch.checkpoint import DurableIndex

            structure = opts.pop("structure")
            backend = opts.pop("backend")
            opts.pop("admission", None)
            # the tenant's backend goes explicitly, as in the reference (a
            # recovery would otherwise reopen on the recorded one, C16)
            return DurableIndex.open(
                tc.durable_root, data.get(tc.name),
                structure=structure, backend=backend, device=device,
                admission=tc.admission, **opts,
            )
        if tc.name not in data:
            raise ValueError(
                f"tenant {tc.name!r} declared but no dataset provided "
                f"(have: {sorted(data)})"
            )
        return SpatialIndex.build(data[tc.name], device=device, **opts)

    # -- the hardened boundary -----------------------------------------
    def submit(self, tenant: str, kind: str, payload, *,
               k: Optional[int] = None, slo: Optional[str] = None,
               t_arrival: Optional[float] = None) -> Request:
        """Enqueue ONE query; returns its ticket (the mutable Request).

        ``t_arrival`` overrides the arrival timestamp — the open-loop
        load generator passes the SCHEDULED arrival so latency includes
        any submit-side lag (no coordinated omission).
        """
        if tenant not in self.tenants:
            raise ValueError(
                f"unknown tenant {tenant!r} (have: {sorted(self.tenants)})"
            )
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
        cls = self.config.slo_class(slo)
        now = self.clock()
        arrival = now if t_arrival is None else float(t_arrival)

        # geometry is validated BEFORE the request can touch a batch —
        # one poisoned rect must never invalidate its neighbours' answers
        if kind == "knn":
            payload = self._validate_point(payload, tenant)
            if k is None or k < 1:
                raise InvalidQueryError(f"knn needs k >= 1, got {k!r}")
            rt = self.tenants[tenant]
            if k > rt.index.n_objects:
                raise InvalidQueryError(
                    f"k={k} exceeds tenant {tenant!r} live objects "
                    f"({rt.index.n_objects})"
                )
        else:
            if kind == "point":
                payload = self._validate_point(payload, tenant)
                payload = np.concatenate([payload, payload])
            else:
                try:
                    payload = validate_queries(
                        payload, what=f"{tenant}/{kind} query"
                    ).reshape(4)
                except InvalidQueryError:
                    self.telemetry.rejected += 1
                    raise
        self.telemetry.submitted += 1

        req = Request(
            tenant=tenant, kind=kind, payload=payload, k=k,
            slo_class=cls.name, deadline=arrival + cls.deadline_s,
            t_arrival=arrival,
        )
        # admission control: per-class queue-depth limit
        if self.queue.pending(cls.name) >= cls.max_queue:
            if cls.overload == "shed":
                req.status = "shed"
                self.telemetry.shed += 1
                self.tenants[tenant].stats.shed_queries += 1
                # span-less counter event: overload is visible in the
                # trace export, not just in AccessStats
                _obs_trace.counter("serve.shed", shed=self.telemetry.shed)
                return req
            req.parked = True    # overload="queue": best-effort, no SLO
            self.telemetry.queued_overload += 1
            self.tenants[tenant].stats.queued_queries += 1
            _obs_trace.counter("serve.queued_overload",
                               queued=self.telemetry.queued_overload)
        _obs_trace.instant("serve.enqueue", tenant=tenant, kind=kind,
                           slo=cls.name, seq=req.seq)
        self.queue.add(req)
        return req

    def _validate_point(self, payload, tenant: str) -> np.ndarray:
        p = np.asarray(payload, np.float32).reshape(-1)
        if p.shape[0] != 2 or not np.isfinite(p).all():
            self.telemetry.rejected += 1
            raise InvalidQueryError(
                f"{tenant!r}: point must be 2 finite coordinates, got "
                f"{np.asarray(payload).tolist()!r}"
            )
        return p

    # -- continuous batching -------------------------------------------
    def pump(self, now: Optional[float] = None) -> int:
        """Launch every batch whose size or deadline bound has tripped;
        returns the number of batches launched."""
        launched = 0
        while True:
            t = self.clock() if now is None else now
            due = self.queue.due_groups(t)
            if not due:
                return launched
            for key, by_deadline in due:
                batch = self.queue.pop_batch(key)
                if batch:
                    self._launch(key, batch, by_deadline=by_deadline)
                    launched += 1

    def drain(self) -> int:
        """Flush everything still queued, bounds or not (shutdown /
        end-of-run path); returns the number of batches launched."""
        launched = self.pump()
        for key in self.queue.drain_keys():
            while True:
                batch = self.queue.pop_batch(key)
                if not batch:
                    break
                self._launch(key, batch, by_deadline=False)
                launched += 1
        return launched

    def _launch(self, key: GroupKey, batch, *, by_deadline: bool) -> None:
        t_launch = self.clock()
        for req in batch:
            req.t_launch = t_launch
        rt = self.tenants[batch[0].tenant]
        with _obs_trace.span("serve.launch", tenant=batch[0].tenant,
                             kind=key[0], batch=len(batch),
                             by_deadline=by_deadline):
            if key[0] == "rect":
                rects = np.stack([r.payload for r in batch])
                res = rt.index.region(rects)
                # the batch's one wait for the device, before any
                # completion stamp: its counts, or a synchronize
                counts = None
                if any(r.kind == "count" for r in batch):
                    counts = torch.count_nonzero(res.hits, dim=1).tolist()
                else:
                    _wait(res.hits)
                for i, req in enumerate(batch):
                    if req.kind == "count":
                        req.result = counts[i]
                    else:
                        req.result = Answer(
                            hits=res.hits[i], visits=res.visits_per_level[i]
                        )
                    self._complete(req)
            else:
                pts = np.stack([r.payload for r in batch])
                res = rt.index.knn(pts, k=key[2])
                _wait(res.dists)
                for i, req in enumerate(batch):
                    req.result = (res.ids[i], res.dists[i])
                    self._complete(req)
        done = self.clock()
        self.queue.observe_service(key, done - t_launch)
        self.telemetry.batches += 1
        self.telemetry.batched_requests += len(batch)
        if by_deadline:
            self.telemetry.deadline_launches += 1

    def _complete(self, req: Request) -> None:
        req.t_complete = self.clock()
        req.status = "done"
        self.telemetry.observe(
            req, self.config.slo_class(req.slo_class).deadline_s
        )

    def result(self, req: Request):
        """The answer for a ticket, pumping the queue until it lands.
        Raises :class:`OverloadShed` for shed requests — the typed
        signal that admission control, not an error, dropped the work."""
        if req.status == "shed":
            raise OverloadShed(
                f"request {req.seq} ({req.tenant}/{req.kind}, class "
                f"{req.slo_class!r}) was shed by admission control"
            )
        while req.status == "pending":
            if not self.pump():
                # nothing due yet: force the straggler's group out
                batch = self.queue.pop_batch(group_key(req))
                if batch:
                    self._launch(group_key(req), batch, by_deadline=True)
        return req.result

    # -- mutations (per-tenant epochs) ---------------------------------
    def insert(self, tenant: str, mbrs):
        """Insert into ONE tenant's live set; only that tenant's epoch
        (and therefore only its cached answers) is touched."""
        return self._tenant(tenant).index.insert(mbrs)

    def delete(self, tenant: str, ids):
        return self._tenant(tenant).index.delete(ids)

    def flush(self, tenant: str):
        return self._tenant(tenant).index.flush()

    def _tenant(self, tenant: str) -> TenantRuntime:
        try:
            return self.tenants[tenant]
        except KeyError:
            raise ValueError(
                f"unknown tenant {tenant!r} (have: {sorted(self.tenants)})"
            ) from None

    # -- health / introspection ----------------------------------------
    def bind_fault_plan(self, plan) -> None:
        """Thread one :class:`repro_torch.ft.FaultPlan` through every tenant's
        serving ladder — injected launch failures then surface as
        degraded (slower) batches, never as failed requests."""
        for rt in self.tenants.values():
            rt.index.bind_fault_plan(plan)

    def stats(self, tenant: str):
        """The tenant's :class:`repro_torch.index.AccessStats` ledger."""
        return self._tenant(tenant).stats

    def metrics(self):
        """One :class:`repro_torch.obs.MetricsRegistry` snapshot of the whole
        front end: serve telemetry (latency/queue-wait summaries, per
        SLO class and per tenant) plus every tenant's ``AccessStats``
        under a ``tenant`` label.  Render with
        ``.to_prometheus()`` or ``.to_json()``."""
        from repro_torch.obs import metrics as _obs_metrics

        reg = _obs_metrics.MetricsRegistry()
        _obs_metrics.telemetry_into(reg, self.telemetry)
        for name, rt in sorted(self.tenants.items()):
            _obs_metrics.stats_into(reg, rt.stats,
                                    labels={"tenant": name})
        return reg

    def warmup(self, *, knn_k: Optional[int] = None) -> None:
        """Run every tenant's batched query path once at the serving
        shape (one full-block region batch, plus one knn batch when
        ``knn_k`` is given) so the first timed request doesn't pay the
        first call's costs (allocations, the autotuner).  Touches caches
        and stats like any query."""
        qb = self.config.query_block
        rect = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
        for rt in self.tenants.values():
            _wait(rt.index.region(np.tile(rect, (qb, 1))).hits)
            if knn_k is not None and knn_k <= rt.index.n_objects:
                _wait(rt.index.knn(np.zeros((qb, 2), np.float32), k=knn_k).dists)

    def pending(self) -> int:
        return self.queue.pending()
