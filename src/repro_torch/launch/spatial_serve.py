"""Batched spatial query serving over the fused region sweep.

Counterpart of ``repro.launch.spatial_serve``: the low-level batch engine.
The documented serving entry point is the front end,
:mod:`repro_torch.serve` (continuous batching, SLO admission, tenants),
which reaches this engine through the ``serve`` backend.  A
:class:`SpatialServer` holds one level schedule on its device (the CUDA
card unless the caller passes ``device="cpu"``) and answers streams of
query rectangles with

* an LRU result cache — repeated regions are answered without touching
  the device; entries are tagged with the mutation epoch, so an entry
  cached under an older epoch is never served (:meth:`rebind`);
* query batching — cache misses are deduplicated, padded with
  never-overlapping ``NEVER_MBR`` queries up to a multiple of
  ``query_block``, and swept as ONE batch;
* a degradation ladder ``cuda → torch → host`` (:data:`LADDER`): each rung
  answers with the same sweep semantics, so degradation changes latency,
  never answers.

    PYTHONPATH=src python -m repro_torch.launch.spatial_serve --n 2000 --queries 256

Where the port differs from the reference:

* **One sweep per batch.**  The reference ``vmap``s its kernel over
  16-query blocks and counts one launch a block.  Here the padded miss
  batch goes through the port's sweep in one call (kernel #1, or #3 for a
  pristine compact8 server), and ``ServeStats.kernel_launches`` counts as
  the ``cuda`` backend does: the number of levels per batch on the
  ``cuda`` rung (on the CPU too, where the plain version runs), 0 on
  ``torch`` and ``host`` (ROADMAP C3).
* **Results stay where the port's backends keep them**: hits and visits
  are tensors on the server's device, and so are the LRU's rows, kept in
  two preallocated tensors of slots (one (capacity, n) bool, one
  (capacity, L) int32).  A batch's misses go in with one ``index_copy_``
  each; an evicted row's slot is reused.  The capacity grows by doubling
  up to ``cache_size`` rows, so :attr:`SpatialServer.cache_bytes` is at
  most ``cache_size × (n + 4 L)``.
* **The kernels are built when a server is made on a CUDA device**
  (``ops.load_kernels``), outside the ladder: a failing ``nvcc`` build or
  load raises from the constructor and is never counted as a rung failure.

What each rung absorbs.  The ladder is walked by
:func:`repro_torch.kernels.fallback.run_ladder`.  On a CUDA device the
only rung failure is an injected :class:`repro_torch.ft.InjectedFailure`
(a :class:`repro_torch.ft.FaultPlan`'s): the ``torch`` rung (the kernels'
plain versions on the same device) and the ``host`` rung (numpy on host
copies of the arrays, made lazily at its first dispatch and dropped at
:meth:`rebind`, its answer uploaded) then answer bit for bit as ``cuda``
would.  A real kernel error on the card is not answered around: the
server raises ``RuntimeError`` chained to it, counted as no failure.  A
sticky CUDA error (an illegal address) would leave every later CUDA call
of the process failing anyway, the host rung's copies and its upload
included, so recovery is a new process (``DurableIndex.recover``) and
eager host copies would change nothing.  On the CPU every ``Exception``
is a rung failure, as in the reference.  A simulated kill (``KillPoint``,
a ``BaseException``) passes through the ladder untouched.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from collections import OrderedDict
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.flat import NEVER_MBR, LevelSchedule
from repro_torch.kernels import fallback, ops

LADDER = ("cuda", "torch", "host")


@dataclasses.dataclass
class ServeStats:
    queries_served: int = 0
    cache_hits: int = 0           # answered from the LRU of a previous call
    dedup_hits: int = 0           # duplicates within one batch, computed once
    batches_dispatched: int = 0
    kernel_launches: int = 0      # card launches of the hand-written kernels
    node_accesses: int = 0        # sum of per-level visit counts ("disk accesses")
    retries: int = 0              # failed launches retried on the same rung
    degraded_batches: int = 0     # batches answered below the top rung
    rung_dispatches: dict = dataclasses.field(
        default_factory=lambda: {r: 0 for r in LADDER}
    )
    rung_failures: dict = dataclasses.field(
        default_factory=lambda: {r: 0 for r in LADDER}
    )

    @property
    def cache_hit_rate(self) -> float:
        return self.cache_hits / max(self.queries_served, 1)


class SpatialServer:
    """Serve batched region searches from one level schedule.

    Args:
      schedule: the tree/pyramid :class:`LevelSchedule`.
      device: where the server runs (the CUDA card when None; without a
        card, ``device="cpu"`` must be asked for); the schedule and the
        quantized form are moved there, a ``live`` bundle must be there.
      query_block: misses are padded up to a multiple of this.
      cache_size: LRU capacity in distinct query rectangles (0 disables).
      block_w: the sweep kernel's tile width.
      precision: ``"float32"``, ``"compact"`` (uint16 tiles, exact
        confirming pass) or ``"compact8"`` (uint8 upper levels, pristine
        servers only) — hit sets are identical, visits are each sweep's own.
      quantized: optionally the pre-built ``QuantizedSchedule`` for the
        compact precisions (quantized here when omitted).
      live: optionally the live-update bundle
        (:class:`repro_torch.update.AugmentedArrays`): the server then
        sweeps base levels + delta-buffer flat levels + tombstone mask, and
        :meth:`rebind` swaps in a new mutation epoch's arrays.
      ladder: the rungs walked when a dispatch fails, drawn from
        :data:`LADDER` in that order.
      max_retries: failed dispatches retried per rung (with exponential
        backoff) before falling to the next rung.
      backoff: base retry sleep in seconds; attempt ``k`` waits
        ``backoff * 2**k``, capped at ``backoff_cap``.
      fault_plan: optional :class:`repro_torch.ft.FaultPlan`; its
        :meth:`~repro_torch.ft.FaultPlan.launch` hook fires before every
        rung dispatch.
    """

    def __init__(
        self,
        schedule: LevelSchedule,
        *,
        device=None,
        query_block: int = 16,
        cache_size: int = 4096,
        block_w: int = 128,
        precision: str = "float32",
        quantized=None,
        live=None,
        ladder: Tuple[str, ...] = LADDER,
        max_retries: int = 2,
        backoff: float = 0.05,
        backoff_cap: float = 1.0,
        fault_plan=None,
    ):
        if precision not in ("float32", "compact", "compact8"):
            raise ValueError(f"unknown precision {precision!r}")
        ladder = tuple(ladder)
        bad = [r for r in ladder if r not in LADDER]
        if not ladder or bad:
            raise ValueError(f"ladder rungs must be drawn from {LADDER}, got {ladder!r}")
        if int(query_block) < 1:
            raise ValueError(f"query_block must be >= 1, got {query_block}")
        self.device = ops.resolve_device(device)
        schedule = schedule.to(self.device)
        if quantized is not None:
            quantized = quantized.to(self.device)
        if live is not None and any(a.device != self.device for a in live.arrays):
            raise ValueError(f"the live bundle's arrays must be on {self.device}")
        self.schedule = schedule
        # Built here, outside the ladder: a build error is not a rung failure.
        ops.load_kernels(self.device)
        self.precision = precision
        self.query_block = int(query_block)
        self.cache_size = int(cache_size)
        self.block_w = int(block_w)
        self.ladder = ladder
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.fault_plan = fault_plan
        self._rung_floor = 0   # sticky: index of the lowest healthy rung
        self.stats = ServeStats()
        self._health_mark = (0, 0, {r: 0 for r in LADDER}, {r: 0 for r in LADDER})
        self.epoch = 0
        # LRU: query bytes -> (epoch tag, slot); the rows live in slots of
        # two preallocated tensors on the device, grown geometrically up to
        # ``cache_size`` rows and reused on eviction.
        self._cache: "OrderedDict[bytes, Tuple[int, int]]" = OrderedDict()
        self._rows_hits: torch.Tensor | None = None     # (capacity, n) bool
        self._rows_visits: torch.Tensor | None = None   # (capacity, L) int32
        self._free_slots: list = []
        self._n_out = schedule.n_objects
        self._levels_out = schedule.levels
        if live is not None:
            if live.precision != precision:
                raise ValueError(
                    f"live bundle is {live.precision!r}, server asked for {precision!r}")
            self._n_out = live.n_objects
            self._levels_out = live.levels
            self._inputs = live
        elif precision == "compact8":
            # Live mutation normalizes compact8 -> compact upstream, so this
            # branch is base-only.
            qs = quantized if quantized is not None else ops.quantize_schedule(
                schedule, upper8=True)
            if not qs.hierarchical and schedule.levels > 1:
                raise ValueError(
                    "precision='compact8' needs a hierarchical quantized schedule "
                    "(quantize_schedule(..., upper8=True))")
            self._inputs = qs
        elif precision == "compact":
            self._inputs = quantized if quantized is not None else ops.quantize_schedule(
                schedule)
        else:
            self._inputs = schedule
        key = (precision, live is not None)
        self._search = fallback.SEARCHES[key]
        self._search_torch, self._search_host = fallback.FALLBACKS[key]
        self._host_inputs = None   # host copies, made on the first host dispatch

    # ------------------------------------------------------------------
    def rebind(self, arrays, *, epoch: int) -> None:
        """Swap the live arrays for a new mutation epoch (live servers
        only).

        The replacement must be shape- and dtype-identical — delta contents
        and the alive mask change per mutation, the shapes do not; a merge
        changes shapes and needs a fresh server.  The epoch tag advances so
        LRU entries cached under older epochs stop matching (and are evicted
        on touch) instead of being served stale.
        """
        if not hasattr(self._inputs, "arrays"):
            raise ValueError("rebind needs a live server (made with live=...)")
        arrays = tuple(arrays)
        old = self._inputs.arrays
        if len(arrays) != len(old) or any(
                a.shape != b.shape or a.dtype != b.dtype or a.device != b.device
                for a, b in zip(arrays, old)):
            raise ValueError(
                "rebind requires shape/dtype-identical arrays on the server's device; "
                "a merge (base rebuild) needs a new SpatialServer")
        self._inputs = dataclasses.replace(self._inputs, arrays=arrays)
        self._host_inputs = None
        self.epoch = int(epoch)

    def bind_fault_plan(self, plan) -> None:
        """Attach (or detach, with ``None``) a fault-injection plan."""
        self.fault_plan = plan

    def reset_health(self) -> None:
        """Forget sticky degradation: the next batch starts back at the
        top rung (call after the underlying fault is known fixed)."""
        self._rung_floor = 0

    @property
    def current_rung(self) -> str:
        return self.ladder[min(self._rung_floor, len(self.ladder) - 1)]

    @property
    def cache_bytes(self) -> int:
        """Bytes the LRU's row storage takes on the server's device (its
        capacity, at most ``cache_size`` rows of ``n + 4 L`` bytes)."""
        return sum(t.numel() * t.element_size()
                   for t in (self._rows_hits, self._rows_visits) if t is not None)

    def drain_health(self) -> dict:
        """Health-ladder counter deltas since the previous drain (retries,
        degraded batches, per-rung dispatches/failures) — the façade folds
        these into ``AccessStats`` per query call."""
        s = self.stats
        m_ret, m_deg, m_disp, m_fail = self._health_mark
        out = {
            "retries": s.retries - m_ret,
            "degraded_batches": s.degraded_batches - m_deg,
            "rung_dispatches": {r: s.rung_dispatches.get(r, 0) - m_disp.get(r, 0)
                                for r in LADDER},
            "rung_failures": {r: s.rung_failures.get(r, 0) - m_fail.get(r, 0)
                              for r in LADDER},
            "rung": self.current_rung,
        }
        self._health_mark = (s.retries, s.degraded_batches, dict(s.rung_dispatches),
                             dict(s.rung_failures))
        return out

    # ------------------------------------------------------------------
    def search(self, queries) -> Tuple[torch.Tensor, torch.Tensor]:
        """Answer (Q, 4) query rectangles.

        Returns ``(hits (Q, n) bool, visits (Q, L) int32)`` on the server's
        device, exactly as the sweep would per query — the cache and
        batching are result-transparent.  NaN/±inf/inverted rectangles
        raise the typed :class:`repro_torch.index.InvalidQueryError` before
        any of them can be cached or join a padded batch.
        """
        from repro_torch.index.api import validate_queries

        queries = validate_queries(queries, what="served queries")
        nq = queries.shape[0]
        if nq == 0:
            return (torch.zeros((0, max(self._n_out, 1)), dtype=torch.bool, device=self.device),
                    torch.zeros((0, self._levels_out), dtype=torch.int32, device=self.device))
        self.stats.queries_served += nq

        keys = [queries[i].tobytes() for i in range(nq)]
        # key -> (True, cache slot) or (False, row of this call's miss batch)
        source: dict = {}
        miss_rows: list = []
        for i, k in enumerate(keys):
            if k in source:  # duplicate within this batch: computed once
                self.stats.dedup_hits += 1
                continue
            entry = self._cache.get(k)
            if entry is not None and entry[0] == self.epoch:
                self._cache.move_to_end(k)
                self.stats.cache_hits += 1
                source[k] = (True, entry[1])
                continue
            if entry is not None:  # cached under an older mutation epoch: stale
                del self._cache[k]
                self._free_slots.append(entry[1])
            source[k] = (False, len(miss_rows))
            miss_rows.append(queries[i])

        block = self._dispatch(np.stack(miss_rows)) if miss_rows else None
        if block is not None and len(miss_rows) == nq:
            out = block  # every query a distinct miss, in order
        else:
            out = self._gather(keys, source, block)
        if block is not None:
            self._put([k for k, (cached, _) in source.items() if not cached], block)
        return out

    def _gather(self, keys, source, block):
        """The call's answer from cache slots and miss-batch rows, gathered
        before :meth:`_put` may reuse a slot."""
        like_h, like_v = block if block is not None else (self._rows_hits, self._rows_visits)
        hits = like_h.new_empty((len(keys), like_h.shape[1]))
        visits = like_v.new_empty((len(keys), like_v.shape[1]))
        picks = {True: ([], []), False: ([], [])}
        for pos, k in enumerate(keys):
            cached, row = source[k]
            picks[cached][0].append(pos)
            picks[cached][1].append(row)
        for cached, (pos, rows) in picks.items():
            if not pos:
                continue
            src_h, src_v = (self._rows_hits, self._rows_visits) if cached else block
            pos = torch.tensor(pos, dtype=torch.int64, device=self.device)
            rows = torch.tensor(rows, dtype=torch.int64, device=self.device)
            hits.index_copy_(0, pos, src_h.index_select(0, rows))
            visits.index_copy_(0, pos, src_v.index_select(0, rows))
        return hits, visits

    # ------------------------------------------------------------------
    def _dispatch(self, miss: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        qb = self.query_block
        n = miss.shape[0]
        pad = (-n) % qb
        if pad:
            # pad with never-overlapping null queries (results discarded)
            miss = np.concatenate([miss, np.broadcast_to(NEVER_MBR, (pad, 4))], axis=0)
        q = torch.from_numpy(np.ascontiguousarray(miss, np.float32)).to(self.device)
        hits, visits, launches = self._run_ladder(q)
        hits, visits = hits[:n], visits[:n]
        self.stats.batches_dispatched += 1
        self.stats.kernel_launches += launches
        self.stats.node_accesses += int(visits.sum(dtype=torch.int64))
        return hits, visits

    def _run_ladder(self, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Dispatch one padded batch down the health ladder
        (:func:`repro_torch.kernels.fallback.run_ladder`).

        Starts at the sticky rung floor (a rung that exhausted its retry
        budget earlier stays skipped until :meth:`reset_health`), retries
        each rung ``max_retries`` times with bounded exponential backoff,
        then degrades to the next rung.
        """
        start = min(self._rung_floor, len(self.ladder) - 1)
        try:
            out, ri = fallback.run_ladder(
                self.ladder, lambda rung: self._dispatch_rung(rung, q),
                ledger=self.stats, device=self.device, fault_plan=self.fault_plan,
                start=start, max_retries=self.max_retries, backoff=self.backoff,
                backoff_cap=self.backoff_cap, who="SpatialServer", queries=q.shape[0])
        except fallback.LadderExhausted:
            self._rung_floor = len(self.ladder) - 1
            raise
        # sticky floor: later batches skip the rungs that failed over
        self._rung_floor = max(self._rung_floor, ri)
        return out

    def _dispatch_rung(self, rung: str, q: torch.Tensor):
        """One attempt on one rung; returns ``(hits, visits, launches)`` on
        the server's device."""
        if rung == "cuda":
            hits, visits = self._search(q, self._inputs, block_w=self.block_w)
            return hits, visits, self._levels_out
        if rung == "torch":
            hits, visits = self._search_torch(q, self._inputs, block_w=self.block_w)
            return hits, visits, 0
        # host: numpy on host copies, no device launch
        if self._host_inputs is None:
            self._host_inputs = fallback.to_host(self._inputs)
        hits, visits = self._search_host(q.cpu().numpy(), self._host_inputs,
                                         block_w=self.block_w)
        return (torch.from_numpy(hits).to(self.device),
                torch.from_numpy(visits).to(self.device), 0)

    def _put(self, keys, block) -> None:
        """Cache this call's misses (``keys``, in the order of ``block``'s
        rows) with one copy into their slots.  Only the last
        ``cache_size`` can stay, as if each were put in turn."""
        if self.cache_size <= 0:  # caching disabled
            return
        first = max(len(keys) - self.cache_size, 0)
        keys = keys[first:]
        cap = 0 if self._rows_hits is None else self._rows_hits.shape[0]
        short = len(keys) - len(self._free_slots)
        if short > 0 and cap < self.cache_size:
            self._grow(block, min(self.cache_size, max(2 * cap, cap + short)))
        slots = []
        for k in keys:
            if self._free_slots:
                slot = self._free_slots.pop()
            else:  # full: evict the least recently used row, reuse its slot
                _, (_, slot) = self._cache.popitem(last=False)
            self._cache[k] = (self.epoch, slot)
            slots.append(slot)
        slots = torch.tensor(slots, dtype=torch.int64, device=self.device)
        self._rows_hits.index_copy_(0, slots, block[0][first:])
        self._rows_visits.index_copy_(0, slots, block[1][first:])

    def _grow(self, block, capacity: int) -> None:
        """Reallocate the row storage at ``capacity`` rows, keeping the
        rows held so far; the new slots join the free list."""
        old_h, old_v = self._rows_hits, self._rows_visits
        cap = 0 if old_h is None else old_h.shape[0]
        self._rows_hits = block[0].new_empty((capacity, block[0].shape[1]))
        self._rows_visits = block[1].new_empty((capacity, block[1].shape[1]))
        if cap:
            self._rows_hits[:cap] = old_h
            self._rows_visits[:cap] = old_v
        self._free_slots.extend(range(capacity - 1, cap - 1, -1))


# ---------------------------------------------------------------------------


def main(argv=None):
    from repro_torch.core import datasets, flat, mqrtree

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--repeat-frac", type=float, default=0.5,
                    help="fraction of queries drawn from a small hot set")
    ap.add_argument("--query-block", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the kernels' plain versions (default: the card)")
    args = ap.parse_args(argv)

    dev = ops.resolve_device(args.device)
    data = datasets.uniform_squares(args.n, seed=0)
    tree = mqrtree.build(data)
    sched = flat.level_schedule(flat.flatten(tree))
    server = SpatialServer(sched, device=dev, query_block=args.query_block)

    rng = np.random.default_rng(0)
    cold = datasets.region_queries(data, args.queries, seed=1)
    hot = datasets.region_queries(data, 8, seed=2)
    mask = rng.random(args.queries) < args.repeat_frac
    stream = np.where(mask[:, None], hot[rng.integers(0, 8, args.queries)], cold)

    t0 = time.time()
    chunks = [server.search(stream[i: i + args.query_block])
              for i in range(0, args.queries, args.query_block)]
    hits = torch.cat([h for h, _ in chunks])
    found = float(hits.sum(dim=1, dtype=torch.int64).double().mean())  # waits for the device
    dt = time.time() - t0
    s = server.stats
    print(
        f"[spatial-serve] {args.queries} queries in {dt:.3f}s "
        f"({args.queries / dt:.0f} q/s) on {dev} | cache hit rate "
        f"{s.cache_hit_rate:.0%} | {s.kernel_launches} kernel launches | "
        f"{s.node_accesses} node accesses | avg {found:.1f} objects/query | "
        f"rungs {s.rung_dispatches}"
    )


if __name__ == "__main__":
    main()
