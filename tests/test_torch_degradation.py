"""Port parity: the serving ladder ``cuda → torch → host`` changes latency,
never answers — and answers as the JAX package's ``pallas → lax → host``.

The 13 cases of tests/test_degradation.py run on the port's
``SpatialServer`` and ``serve`` backend, with the rung names mapped
(``pallas`` → ``cuda``, ``lax`` → ``torch``).  Every rung's hits and
visits must equal the JAX server's, and the ladder's ledger must count
exactly what the ``FaultPlan`` injected.  Beyond them: the ``LADDER``
constant, a ``KillPoint`` passing through the ladder, the ``serve`` join
ladder, each precision on each forced rung, and ``AccessStats.to_dict``
and ``diff`` equal to the reference's on the fields both have.

Sizes are the reference's (``uniform_squares(240, seed=21)``,
``query_block=4``).  ``launches`` is left out of every comparison: the
port counts card launches per batch (ROADMAP C3).

Tolerance: exact — boolean masks and integer counts.
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

from repro.core import datasets
from repro.core import flat as jflat
from repro.core import mqrtree as jmqrtree
from repro.ft import FaultPlan as JaxPlan
from repro.index import SpatialIndex as JaxIndex
from repro.launch import spatial_serve as jserve
from repro_torch import SpatialIndex
from repro_torch.core import flat, mqrtree
from repro_torch.ft import FaultPlan, InjectedFailure, KillPoint
from repro_torch.kernels import fallback
from repro_torch.launch.spatial_serve import LADDER, SpatialServer
from repro_torch.obs import trace as ptrace
from repro_torch.update import oracle

RUNG = {"pallas": "cuda", "lax": "torch", "host": "host"}


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _data():
    return datasets.uniform_squares(240, seed=21)


def _queries():
    return datasets.region_queries(_data(), 10, seed=22)


@functools.lru_cache(maxsize=None)
def _schedule():
    return flat.level_schedule(flat.flatten(mqrtree.build(_data())))


@functools.lru_cache(maxsize=None)
def _jax_answer(precision):
    """The healthy JAX server's (hits, visits) for the module's queries."""
    sched = jflat.level_schedule(jflat.flatten(jmqrtree.build(_data())))
    server = jserve.SpatialServer(sched, query_block=4, cache_size=0, backoff=0.0,
                                  precision=precision)
    return tuple(np.asarray(a) for a in server.search(_queries()))


def _server(plan=None, **kw):
    kw.setdefault("query_block", 4)
    kw.setdefault("cache_size", 0)
    kw.setdefault("backoff", 0.0)
    server = SpatialServer(_schedule(), device="cpu", fault_plan=plan, **kw)
    return server, _queries()


def _quiet(fn, *a):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*a)


def _equal_reference(hits, visits, precision="float32"):
    ref_hits, ref_visits = _jax_answer(precision)
    assert np.array_equal(_np(hits), ref_hits)
    assert np.array_equal(_np(visits), ref_visits)


class TestLadder:
    def test_healthy_server_stays_on_cuda(self):
        server, queries = _server()
        hits, visits = server.search(queries)
        _equal_reference(hits, visits)
        h = server.drain_health()
        assert h["rung"] == "cuda"
        assert h["rung_dispatches"]["cuda"] > 0
        assert h["degraded_batches"] == 0 and h["retries"] == 0

    def test_retry_recovers_without_degrading(self):
        plan = FaultPlan(fail_launches=1, fail_rungs=("cuda",))
        server, queries = _server(plan)
        hits, visits = server.search(queries)
        _equal_reference(hits, visits)
        h = server.drain_health()
        assert h["retries"] == 1 and h["degraded_batches"] == 0
        assert h["rung_failures"] == {"cuda": 1, "torch": 0, "host": 0}
        assert server.current_rung == "cuda"
        assert plan.launch_failures == 1

    def test_all_cuda_failures_fall_to_torch_with_parity(self):
        plan = FaultPlan(fail_launches=10**9, fail_rungs=("cuda",))
        server, queries = _server(plan)
        hits, visits = _quiet(server.search, queries)
        _equal_reference(hits, visits)
        h = server.drain_health()
        assert h["rung"] == "torch"
        assert h["degraded_batches"] == 1
        assert h["rung_failures"]["cuda"] == server.max_retries + 1 == plan.launch_failures
        assert h["rung_dispatches"] == {"cuda": 0, "torch": 1, "host": 0}

    def test_cuda_and_torch_failures_fall_to_host(self):
        plan = FaultPlan(fail_launches=10**9, fail_rungs=("cuda", "torch"))
        server, queries = _server(plan)
        before = server.stats.kernel_launches
        hits, visits = _quiet(server.search, queries)
        _equal_reference(hits, visits)
        assert server.current_rung == "host"
        assert server.stats.kernel_launches == before  # host launches nothing
        h = server.drain_health()
        assert h["rung_dispatches"]["host"] == 1
        assert h["rung_failures"] == {"cuda": 3, "torch": 3, "host": 0}
        assert plan.launch_failures == 6

    def test_floor_is_sticky_then_resettable(self):
        plan = FaultPlan(fail_launches=3, fail_rungs=("cuda",))
        server, queries = _server(plan)  # max_retries=2 -> 3 tries burn all
        _quiet(server.search, queries)
        assert server.current_rung == "torch"
        server.search(queries[:2])  # sticky: cuda is not probed again
        assert plan.launch_failures == 3
        assert server.current_rung == "torch"
        server.reset_health()
        assert server.current_rung == "cuda"
        server.search(queries[:2])  # healthy again (countdown exhausted)
        assert server.drain_health()["rung"] == "cuda"

    def test_degradation_warns(self):
        plan = FaultPlan(fail_launches=10**9, fail_rungs=("cuda",))
        server, queries = _server(plan)
        with pytest.warns(RuntimeWarning, match="degrading"):
            server.search(queries)

    def test_exhausted_ladder_raises(self):
        plan = FaultPlan(fail_launches=10**9, fail_rungs=("cuda",))
        server, queries = _server(plan, ladder=("cuda",))
        with pytest.raises(RuntimeError, match="every ladder rung"):
            server.search(queries)

    def test_compact_precision_ladder_parity(self):
        plan = FaultPlan(fail_launches=10**9, fail_rungs=("cuda", "torch"))
        server, queries = _server(plan, precision="compact")
        hits, visits = _quiet(server.search, queries)
        _equal_reference(hits, visits, "compact")
        assert server.current_rung == "host"

    def test_bad_ladder_rejected(self):
        with pytest.raises(ValueError, match="ladder"):
            _server(ladder=("cuda", "gpu"))
        with pytest.raises(ValueError, match="ladder"):
            _server(ladder=())
        with pytest.raises(ValueError, match="ladder"):
            _server(ladder=("pallas",))  # the reference's names are not the port's


class TestFacadeDegradation:
    """A serve-backend SpatialIndex keeps answering correctly when every
    kernel launch fails, and AccessStats says so, as the JAX index's."""

    def _pair(self, plan, *, mutate=False, port=True):
        data = datasets.uniform_squares(200, seed=31)
        queries = datasets.region_queries(data, 8, seed=32)
        kw = dict(query_block=4, cache_size=0, backoff=0.0)
        if port:
            idx = SpatialIndex.build(data, backend="serve", fault_plan=plan, capacity=16,
                                     device="cpu", **kw)
        else:
            idx = JaxIndex.build(data, backend="serve", fault_plan=plan, capacity=16, **kw)
        if mutate:
            idx.insert(datasets.uniform_squares(5, seed=33))
            idx.delete([3, 17, 201])
        return idx, queries

    def _both(self, rungs, *, mutate=False):
        out = []
        for port, cls in ((True, FaultPlan), (False, JaxPlan)):
            names = rungs if port else tuple(k for k, v in RUNG.items() if v in rungs)
            plan = cls(fail_launches=10**9, fail_rungs=names) if rungs else None
            idx, queries = self._pair(plan, mutate=mutate, port=port)
            res = _quiet(idx.region, queries)
            out.append((idx, queries, res))
        return out

    def _same_ledger(self, port_idx, jax_idx):
        p, j = port_idx.stats, jax_idx.stats
        for f in ("queries", "node_accesses", "launch_failures", "retries",
                  "degraded_batches", "delta_accesses", "inserts", "deletes", "flushes"):
            assert getattr(p, f) == getattr(j, f), f
        assert p.rung_dispatches == {RUNG[k]: v for k, v in j.rung_dispatches.items()}

    def test_pristine_serve_degrades_and_reports(self):
        (pi, queries, pr), (ji, _, jr) = self._both(("cuda",))
        assert np.array_equal(_np(pr.hits), oracle.hits_mask(pi, queries, pi.id_space))
        assert np.array_equal(_np(pr.hits), jr.hits)
        assert np.array_equal(_np(pr.visits_per_level), jr.visits_per_level)
        stats = pi.stats
        assert stats.degraded and stats.degraded_batches > 0
        assert stats.launch_failures > 0
        assert stats.rung_dispatches.get("torch", 0) > 0
        assert stats.rung_dispatches.get("cuda", 0) == 0
        self._same_ledger(pi, ji)

    def test_live_serve_degrades_and_reports(self):
        (pi, queries, pr), (ji, _, jr) = self._both(("cuda", "torch"), mutate=True)
        twin = pi.with_backend("host")
        assert torch.equal(pr.hits, twin.region(queries).hits)
        assert np.array_equal(_np(pr.hits), oracle.hits_mask(pi, queries, pi.id_space))
        assert np.array_equal(_np(pr.hits), jr.hits)
        assert np.array_equal(_np(pr.visits_per_level), jr.visits_per_level)
        assert pi.stats.degraded
        assert pi.stats.rung_dispatches.get("host", 0) > 0
        self._same_ledger(pi, ji)

    def test_healthy_serve_reports_no_degradation(self):
        (pi, queries, pr), (ji, _, jr) = self._both(())
        assert not pi.stats.degraded
        assert pi.stats.rung_dispatches.get("cuda", 0) > 0
        assert np.array_equal(_np(pr.hits), jr.hits)
        self._same_ledger(pi, ji)


def test_ladder_constant_order():
    assert LADDER == ("cuda", "torch", "host")
    assert tuple(RUNG[r] for r in jserve.LADDER) == LADDER


@pytest.mark.parametrize("rungs", [(), ("cuda",), ("cuda", "torch")])
@pytest.mark.parametrize("precision", ["float32", "compact", "compact8"])
def test_every_rung_equals_the_reference_at_every_precision(precision, rungs):
    plan = FaultPlan(fail_launches=10**9, fail_rungs=rungs) if rungs else None
    server, queries = _server(plan, precision=precision)
    hits, visits = _quiet(server.search, queries)
    _equal_reference(hits, visits, precision)
    answered = LADDER[len(rungs)]
    assert server.stats.rung_dispatches[answered] == 1


def test_kill_point_passes_through_the_ladder():
    """A simulated kill is not a rung failure: nothing is retried or
    degraded, and the kill reaches the caller."""

    class Killer(FaultPlan):
        def launch(self, rung):
            raise KillPoint("killed mid-dispatch")

    server, queries = _server(Killer())
    with pytest.raises(KillPoint):
        server.search(queries)
    s = server.stats
    assert s.retries == 0 and s.degraded_batches == 0
    assert s.rung_failures == {r: 0 for r in LADDER}


def test_cache_dedupe_and_epochs():
    """Cache hits and in-batch duplicates return the computed rows; the
    cache is bounded by ``cache_size`` and counts its bytes."""
    server, queries = _server(cache_size=6)
    batch = np.concatenate([queries, queries[:3]])
    hits, visits = server.search(batch)
    ref_hits, ref_visits = _jax_answer("float32")
    assert np.array_equal(_np(hits), np.concatenate([ref_hits, ref_hits[:3]]))
    assert np.array_equal(_np(visits), np.concatenate([ref_visits, ref_visits[:3]]))
    assert server.stats.dedup_hits == 3 and len(server._cache) == 6
    row = hits.shape[1] + 4 * visits.shape[1]
    assert server.cache_bytes == 6 * row
    again, _ = server.search(queries[4:])
    assert server.stats.cache_hits == 6
    assert np.array_equal(_np(again), ref_hits[4:])


def test_cache_slots_reused_under_eviction():
    """A cache far smaller than the stream: every answer equals the
    cache-less server's, slots are reused, the storage stays at
    ``cache_size`` rows, and stale rows of an older epoch are not served."""
    rng = np.random.default_rng(5)
    pool = datasets.region_queries(_data(), 12, seed=23)
    plain, _ = _server()
    server, _ = _server(cache_size=5)
    for _ in range(12):
        batch = pool[rng.integers(0, len(pool), int(rng.integers(1, 9)))]
        hits, visits = server.search(batch)
        ref_hits, ref_visits = plain.search(batch)
        assert torch.equal(hits, ref_hits) and torch.equal(visits, ref_visits)
        assert len(server._cache) <= 5
    assert server.stats.cache_hits > 0
    row = hits.shape[1] + 4 * visits.shape[1]
    assert server.cache_bytes == 5 * row
    slots = sorted(slot for _, slot in server._cache.values())
    assert len(set(slots)) == len(slots) and set(slots) | set(server._free_slots) == set(range(5))


def test_join_ladder_warns_and_traces():
    """A degraded serve join warns and leaves the same trace events as the
    region server: a failure per failed rung, a degrade per step down."""
    a, b = datasets.uniform_squares(60, seed=43), datasets.uniform_squares(50, seed=44)
    right = SpatialIndex.build(b, device="cpu")
    plan = FaultPlan(fail_launches=10**9, fail_rungs=("cuda", "torch"))
    left = SpatialIndex.build(a, backend="serve", fault_plan=plan, device="cpu")
    old = ptrace.get_tracer()
    tracer = ptrace.set_tracer(ptrace.Tracer())
    tracer.enabled = True
    try:
        with pytest.warns(RuntimeWarning) as caught:
            left.join(right)
        names = [e["name"] for e in tracer.events()]
    finally:
        ptrace.set_tracer(old)
    assert [str(w.message).rsplit(" ", 1)[-1] for w in caught] == ["'torch'", "'host'"]
    assert names.count("serve.rung_failure") == 2 and names.count("serve.degrade") == 2
    assert left.stats.launch_failures == 2 and left.stats.rung_dispatches == {"host": 1}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_only_injected_failures_degrade_on_the_card(device):
    """On a CUDA device a real error raises, chained and uncounted; an
    injected failure degrades there as anywhere.  On the CPU every error
    is a rung failure, as in the reference.  (No launch happens: the
    attempt is a stub, so the CUDA case runs without a card.)"""

    def attempt(rung):
        if rung == "cuda":
            raise ValueError("bad launch")
        return rung

    ledger = fallback.LadderLedger()
    if device == "cuda":
        with pytest.raises(RuntimeError, match="not absorbed") as info:
            fallback.run_ladder(LADDER, attempt, ledger=ledger, device=device)
        assert isinstance(info.value.__cause__, ValueError)
        assert ledger.rung_failures == {} and ledger.rung_dispatches == {}
    else:
        with pytest.warns(RuntimeWarning, match="degrading"):
            out, ri = fallback.run_ladder(LADDER, attempt, ledger=ledger, device=device)
        assert (out, ri) == ("torch", 1) and ledger.rung_failures == {"cuda": 1}

    def injected(rung):
        if rung == "cuda":
            raise InjectedFailure("scripted")
        return rung

    ledger = fallback.LadderLedger()
    with pytest.warns(RuntimeWarning, match="degrading"):
        out, ri = fallback.run_ladder(LADDER, injected, ledger=ledger, device=device,
                                      max_retries=1)
    assert (out, ri) == ("torch", 1)
    assert ledger.rung_failures == {"cuda": 2} and ledger.retries == 1
    assert ledger.degraded_batches == 1 and ledger.rung_dispatches == {"torch": 1}


def test_serve_join_ladder():
    """The serve join ladder: pairs equal healthy and degraded, the
    ledger counts as the reference's."""
    a, b = datasets.uniform_squares(120, seed=41), datasets.uniform_squares(90, seed=42)
    ref = JaxIndex.build(a, backend="host").join(JaxIndex.build(b, backend="host"))
    right = SpatialIndex.build(b, structure="rtree", device="cpu")
    for rungs, answered in (((), "cuda"), (("cuda",), "torch"), (("cuda", "torch"), "host")):
        plan = FaultPlan(fail_launches=10**9, fail_rungs=rungs) if rungs else None
        left = SpatialIndex.build(a, backend="serve", fault_plan=plan, device="cpu")
        res = left.join(right)
        assert np.array_equal(_np(res.pairs), ref.pairs)
        assert left.stats.rung_dispatches == {answered: 1}
        assert left.stats.launch_failures == len(rungs)
        assert left.stats.degraded_batches == (1 if rungs else 0)
        jplan = JaxPlan(fail_launches=10**9,
                        fail_rungs=tuple(k for k, v in RUNG.items() if v in rungs))
        jleft = JaxIndex.build(a, backend="serve", fault_plan=jplan if rungs else None)
        jleft.join(JaxIndex.build(b, structure="rtree", backend="host"))
        assert left.stats.launch_failures == jleft.stats.launch_failures
        assert left.stats.rung_dispatches == {
            RUNG[k]: v for k, v in jleft.stats.rung_dispatches.items()}


def test_access_stats_dict_and_diff_equal_the_reference():
    from repro.index.api import AccessStats as JaxStats
    from repro_torch.index import AccessStats

    port_only = {"tiles_skipped"}
    shared = {f.name for f in dataclasses.fields(AccessStats)} - port_only
    assert shared <= {f.name for f in dataclasses.fields(JaxStats)}
    p, j = AccessStats(), JaxStats()
    for s in (p, j):
        s.record(8, 40, 0)
        s.absorb_health({"retries": 2, "degraded_batches": 1,
                         "rung_failures": {"a": 3, "b": 0},
                         "rung_dispatches": {"a": 0, "b": 1}})
    before_p, before_j = p.to_dict(), j.to_dict()
    for s in (p, j):
        s.record(8, 12, 0)
        s.absorb_health({"rung_dispatches": {"b": 2}})
        s.shed_mutations += 5
    pd, jd = p.to_dict(), j.to_dict()
    assert {k: pd[k] for k in shared} == {k: jd[k] for k in shared}
    dp, dj = p.diff(before_p), j.diff(before_j)
    assert {k: dp[k] for k in shared} == {k: dj[k] for k in shared}
    assert dp["rung_dispatches"] == {"b": 2} and p.diff(p)["queries"] == 0
    assert p.degraded and p.accesses_per_query == j.accesses_per_query
