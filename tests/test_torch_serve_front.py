"""Port parity: the serving front end (``repro_torch.serve``) against the
JAX package's (``repro.serve``).

One config dict and one request script go through both front ends, each
on a ``FakeClock`` so batching decisions are deterministic.  Both must
give the same launches (tenant, kind, batch size, ``by_deadline``, from
the ``serve.launch`` trace spans), the same pump results, the same shed,
parked and rejected tickets, the same telemetry (counters and histogram
buckets), the same ``AccessStats`` but ``launches`` (ROADMAP C3), and the
same answers: hits, visits and counts bit for bit, k-NN ids equal and
distances within one float32 ulp (ROADMAP C8).  The same holds after a
mid-run ``FaultPlan`` (``fail_rungs=("cuda",)`` against the reference's
``("pallas",)``), for per-tenant epoch isolation, and for a durable tenant
written by the JAX front end and recovered by the port's.  The open-loop
generator's arrivals and query rects are bit-equal for several seeds, and
``LatencyHistogram`` reads the same quantiles from the same samples.

Sizes are the reference's (``mbr_dataset("serve_front",
"exponential_squares", 220)``).  The port runs with ``device="cpu"`` (the
kernels' plain versions); the reference's ``serve`` backend runs its
Pallas kernel in interpret mode, as its own tests do.

Tolerance: exact, but k-NN distances (one float32 ulp, C8).
"""
import contextlib
import pathlib
import re
import warnings

import numpy as np
import pytest
import torch

from conftest import f32_exact, mbr_dataset

import repro.serve as jserve
from repro.ft import FaultPlan as JaxPlan
from repro.obs import trace as jtrace
from repro.serve import loadgen as jloadgen
from repro.serve.telemetry import LatencyHistogram as JaxHistogram
import repro_torch.serve as pserve
from repro_torch.ft import FaultPlan
from repro_torch.index import InvalidQueryError
from repro_torch.obs import trace as ptrace
from repro_torch.serve import (
    OverloadShed,
    ServerConfig,
    ServingFrontEnd,
    TenantConfig,
)
from repro_torch.serve import loadgen
from repro_torch.serve.telemetry import LatencyHistogram

N = 220
RUNG = {"pallas": "cuda", "lax": "torch", "host": "host"}
CLASSES = [
    {"name": "interactive", "deadline_ms": 50.0, "overload": "shed", "max_queue": 6},
    {"name": "batch", "deadline_ms": 2000.0, "overload": "queue", "max_queue": 3},
]


class FakeClock:
    """Deterministic front-end clock: time moves only when told to."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _data() -> np.ndarray:
    return f32_exact(mbr_dataset("serve_front", "exponential_squares", N))


def _cfg(tenants, *, query_block=4, classes=CLASSES) -> dict:
    return {"tenants": tenants, "classes": classes, "query_block": query_block}


def _serve(**extra) -> dict:
    return {"backoff": 0.0, **extra}


@contextlib.contextmanager
def _tracers():
    """Fresh enabled tracers in both packages; the old ones restored."""
    old = jtrace.get_tracer(), ptrace.get_tracer()
    jt, pt = jtrace.set_tracer(jtrace.Tracer()), ptrace.set_tracer(ptrace.Tracer())
    jt.enabled = pt.enabled = True
    try:
        yield jt, pt
    finally:
        jtrace.set_tracer(old[0])
        ptrace.set_tracer(old[1])


def _launches(tracer):
    spans = sorted((e for e in tracer.events()
                    if e["ph"] == "X" and e["name"] == "serve.launch"),
                   key=lambda e: e["ts"])
    return [(e["args"]["tenant"], e["args"]["kind"], e["args"]["batch"],
             e["args"]["by_deadline"]) for e in spans]


def _fronts(cfg, data, **build):
    """The same config built by both packages, each on its own clock."""
    jf = jserve.ServingFrontEnd.build(cfg, data, clock=FakeClock(), **build.get("jax", {}))
    pf = ServingFrontEnd.build(cfg, data, device="cpu", clock=FakeClock(),
                               **build.get("port", {}))
    return jf, pf


def _script(data, n, *, seed, tenants=("t",), bursts=True, knn=True):
    """A mixed request script: ``("submit", tenant, kind, payload, k,
    slo)``, ``("bad", tenant, kind, payload)``, ``("advance", dt)``,
    ``("pump",)``, ending in ``("drain",)``."""
    rng = np.random.default_rng(seed)
    rects = loadgen.rect_workload(loadgen.data_extent(data), n, seed=seed, sel=0.2)
    ops = []
    for i, rect in enumerate(rects):
        tenant = tenants[i % len(tenants)]
        kind = ("region", "count", "point", "knn" if knn else "region")[i % 4]
        payload = rect[:2] if kind in ("point", "knn") else rect
        k = (3, 5)[i % 2] if kind == "knn" else None
        slo = "batch" if i % 5 == 4 else None
        ops.append(("submit", tenant, kind, payload, k, slo))
        if i % 7 == 6:
            ops.append(("bad", tenant, "region", np.array([3.0, 0, 1, 1])))
        if bursts and i % 9 == 8:  # a burst without pumping: sheds and parks
            for j in range(8):
                ops.append(("submit", tenant, "region", rects[(i + j) % n], None,
                            "batch" if j % 2 else None))
        if i % 3 == 2:
            ops.append(("advance", float(rng.uniform(0.0, 0.06))))
        ops.append(("pump",))
    ops.append(("drain",))
    return ops


def _run(front, ops):
    """Apply ``ops``; returns ``(tickets, pumps)``."""
    tickets, pumps = [], []
    for op in ops:
        if op[0] == "submit":
            _, tenant, kind, payload, k, slo = op
            tickets.append(front.submit(tenant, kind, payload, k=k, slo=slo))
        elif op[0] == "bad":
            with pytest.raises(ValueError):
                front.submit(*op[1:])
        elif op[0] == "advance":
            front.clock.advance(op[1])
        elif op[0] == "pump":
            pumps.append(front.pump())
        else:
            pumps.append(front.drain())
    return tickets, pumps


def _same_answer(j, p, req):
    """One ticket's answer in both packages."""
    if req.kind == "count":
        assert isinstance(p, int) and p == j
    elif req.kind == "knn":
        assert np.array_equal(p[0].numpy(), j[0])
        ulps = np.abs(p[1].numpy().view(np.int32) - np.asarray(j[1]).view(np.int32))
        assert ulps.max() <= 1
    else:
        assert np.array_equal(p.hits.numpy(), j.hits)
        assert np.array_equal(p.visits.numpy(), j.visits)
        assert np.array_equal(p.ids.numpy(), j.ids)


def _same_tickets(jt, pt):
    assert len(jt) == len(pt)
    for j, p in zip(jt, pt):  # by order: seqs come from two counters
        assert (p.tenant, p.kind, p.slo_class, p.status, p.parked) == (
            j.tenant, j.kind, j.slo_class, j.status, j.parked)
        assert (p.t_arrival, p.deadline, p.t_launch, p.t_complete) == (
            j.t_arrival, j.deadline, j.t_launch, j.t_complete)
        if j.status == "shed":
            assert p.result is None
            continue
        _same_answer(j.result, p.result, p)


def _same_stats(js, ps):
    jd, pd = js.to_dict(), ps.to_dict()
    assert set(jd) == set(pd)
    jd["rung_dispatches"] = {RUNG[k]: v for k, v in jd["rung_dispatches"].items()}
    for d in (jd, pd):
        d.pop("launches")
    assert pd == jd


def _same_telemetry(jtel, ptel):
    assert ptel.snapshot() == jtel.snapshot()
    assert ptel.latency.to_dict() == jtel.latency.to_dict()
    assert ptel.queue_wait.to_dict() == jtel.queue_wait.to_dict()
    for attr in ("by_class", "by_tenant"):
        jh, ph = getattr(jtel, attr), getattr(ptel, attr)
        assert sorted(ph) == sorted(jh)
        for name in jh:
            assert ph[name].to_dict() == jh[name].to_dict()


def _families(reg):
    return [line.split()[2] for line in reg.to_prometheus().splitlines()
            if line.startswith("# HELP")]


# ---------------------------------------------------------------------------
# the whole front end against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["host", "serve"])
def test_front_end_matches_the_reference(backend):
    data = _data()
    opts = _serve() if backend == "serve" else {}
    cfg = _cfg([{"name": "t", "backend": backend, "backend_opts": opts}])
    ops = _script(data, 30, seed=11)
    with _tracers() as (jtr, ptr):
        jf, pf = _fronts(cfg, {"t": data})
        jt, jp = _run(jf, ops)
        pt, pp = _run(pf, ops)
        assert _launches(ptr) == _launches(jtr)
    assert len(_launches(ptr)) > 5
    assert pp == jp
    _same_tickets(jt, pt)
    assert {t.status for t in pt} == {"done", "shed"}
    assert any(t.parked for t in pt)
    assert pf.telemetry.rejected == jf.telemetry.rejected > 0
    assert pf.telemetry.deadline_launches == jf.telemetry.deadline_launches > 0
    _same_telemetry(jf.telemetry, pf.telemetry)
    _same_stats(jf.stats("t"), pf.stats("t"))
    assert pf.stats("t").shed_queries > 0 and pf.stats("t").queued_queries > 0
    assert _families(pf.metrics()) == _families(jf.metrics())
    shed = next(t for t in pt if t.status == "shed")
    with pytest.raises(OverloadShed, match="shed by admission control"):
        pf.result(shed)


@pytest.mark.parametrize("backend", ["host", "serve"])
def test_every_served_answer_equals_the_tenants_own_index(backend):
    data = _data()
    opts = _serve() if backend == "serve" else {}
    pf = ServingFrontEnd.build(_cfg([{"name": "t", "backend": backend, "backend_opts": opts}]),
                               {"t": data}, device="cpu", clock=FakeClock())
    tickets, _ = _run(pf, _script(data, 24, seed=12, bursts=False))
    idx = pf.tenants["t"].index
    for req in tickets:
        got = pf.result(req)
        if req.kind == "knn":
            want = idx.knn(np.asarray(req.payload, np.float32)[None], k=req.k)
            assert torch.equal(got[0], want.ids[0]) and torch.equal(got[1], want.dists[0])
            continue
        want = idx.region(req.payload[None])
        if req.kind == "count":
            assert got == int(want.hits[0].sum())
        else:
            assert torch.equal(got.hits, want.hits[0])
            assert torch.equal(got.visits, want.visits_per_level[0])


def test_parity_survives_mid_run_forced_degradation():
    data = _data()
    opts = _serve(max_retries=0)
    cfg = _cfg([{"name": "t", "backend": "serve", "backend_opts": opts}])
    jf, pf = _fronts(cfg, {"t": data})
    jf.warmup()
    pf.warmup()
    jplan = JaxPlan(fail_launches=10 ** 9, fail_from_launch=3, fail_rungs=("pallas",))
    plan = FaultPlan(fail_launches=10 ** 9, fail_from_launch=3, fail_rungs=("cuda",))
    jf.bind_fault_plan(jplan)
    pf.bind_fault_plan(plan)
    ops = _script(data, 20, seed=13, bursts=False, knn=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt, _ = _run(jf, ops)
        pt, _ = _run(pf, ops)
    assert all(t.done for t in pt)
    _same_tickets(jt, pt)
    assert plan.launch_failures == jplan.launch_failures > 0
    stats = pf.stats("t")
    assert stats.degraded_batches > 0
    assert stats.rung_dispatches.get("cuda", 0) > 0 and stats.rung_dispatches.get("torch", 0) > 0
    _same_stats(jf.stats("t"), stats)


def test_tenant_mutation_bumps_only_its_own_epoch_and_cache():
    data = _data()
    cfg = _cfg([{"name": "a", "backend": "serve", "capacity": 32, "backend_opts": _serve()},
                {"name": "b", "backend": "serve", "backend_opts": _serve()}], query_block=2)
    jf, pf = _fronts(cfg, {"a": data, "b": data})
    rect = [0.0, 0.0, 0.6, 0.6]

    def ask(front, tenant):
        r = front.submit(tenant, "region", rect)
        front.drain()
        return front.result(r)

    first = {f: (ask(f, "a"), ask(f, "b")) for f in (jf, pf)}
    server = pf.tenants["b"].spatial._backend.server
    hits_before = server.stats.cache_hits
    new = np.array([[0.1, 0.1, 0.2, 0.2]], np.float32)
    gids = {f: f.insert("a", new) for f in (jf, pf)}
    for f in (jf, pf):
        f.flush("a")
    assert np.array_equal(gids[pf], gids[jf])
    assert pf.tenants["a"].epoch == jf.tenants["a"].epoch > 0
    assert pf.tenants["b"].epoch == jf.tenants["b"].epoch == 0
    second = {f: (ask(f, "a"), ask(f, "b")) for f in (jf, pf)}
    assert bool(second[pf][0].hits[int(gids[pf][0])])
    for j, p in zip(first[jf] + second[jf], first[pf] + second[pf]):
        assert np.array_equal(p.hits.numpy(), j.hits)
        assert np.array_equal(p.visits.numpy(), j.visits)
    # B's answer is unchanged, from its still-valid epoch-tagged cache
    assert torch.equal(second[pf][1].hits, first[pf][1].hits)
    assert server.stats.cache_hits == hits_before + 1
    _same_stats(jf.stats("a"), pf.stats("a"))
    _same_stats(jf.stats("b"), pf.stats("b"))


def test_durable_tenant_written_by_the_reference_recovers_in_the_port(tmp_path):
    data = _data()
    root = str(tmp_path / "tenant_a")
    cfg = _cfg([{"name": "a", "backend": "serve", "durable_root": root, "capacity": 32,
                 "backend_opts": _serve()}])
    rect = [0.25, 0.25, 0.45, 0.45]
    jf = jserve.ServingFrontEnd.build(cfg, {"a": data}, clock=FakeClock())
    res = jf.insert("a", np.array([[0.3, 0.3, 0.4, 0.4]], np.float32))
    assert res.applied
    req = jf.submit("a", "region", rect)
    jf.drain()
    want = jf.result(req)
    jf.tenants["a"].index.close()
    # restart in the other package: same config, no dataset — recovery
    pf = ServingFrontEnd.build(cfg, {}, device="cpu", clock=FakeClock())
    idx = pf.tenants["a"].index
    assert idx.recovered_ops == 1 and idx.index.backend == "serve"
    req = pf.submit("a", "region", rect)
    pf.drain()
    got = pf.result(req)
    assert bool(got.hits[int(res.ids[0])])
    assert np.array_equal(got.hits.numpy(), want.hits)
    assert np.array_equal(got.visits.numpy(), want.visits)
    idx.close()


# ---------------------------------------------------------------------------
# the config boundary and the entry point
# ---------------------------------------------------------------------------


def test_config_maps_the_reference_names_and_catches_typos():
    tc = TenantConfig.from_dict({"name": "a", "backend": "pallas",
                                 "backend_opts": {"interpret": True,
                                                  "ladder": ("pallas", "lax", "host")}})
    assert tc.backend == "cuda"
    assert tc.backend_opts == {"ladder": ("cuda", "torch", "host")}
    assert tc.index_opts(16) == {"ladder": ("cuda", "torch", "host"), "structure": "mqr",
                                 "backend": "cuda", "precision": "float32"}
    assert TenantConfig(name="b", backend="lax").index_opts(16) == {
        "structure": "mqr", "backend": "torch"}
    opts = TenantConfig(name="c", capacity=8).index_opts(4)
    assert opts == jserve.TenantConfig(name="c", capacity=8).index_opts(4)
    with pytest.raises(TypeError, match="bakend.*accepted"):
        TenantConfig.from_dict({"name": "a", "bakend": "serve"})
    with pytest.raises(ValueError, match="backend"):
        TenantConfig(name="a", backend="gpu")
    with pytest.raises(ValueError, match="at least one tenant"):
        ServerConfig.from_dict({"tenants": []})


def test_build_without_a_card_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg([{"name": "t", "backend": "host"}])
    with pytest.raises(RuntimeError):
        ServingFrontEnd.build(cfg, {"t": _data()})


def test_boundary_rejects_bad_geometry_before_a_batch():
    pf = ServingFrontEnd.build(_cfg([{"name": "a", "backend": "host"}]), {"a": _data()},
                               device="cpu", clock=FakeClock())
    good = pf.submit("a", "region", [0, 0, 5, 5])
    for bad in ([np.nan, 0, 1, 1], [0, 0, np.inf, 1], [3, 0, 1, 1]):
        with pytest.raises(InvalidQueryError):
            pf.submit("a", "region", bad)
    with pytest.raises(InvalidQueryError, match="exceeds"):
        pf.submit("a", "knn", [0.5, 0.5], k=N + 1)
    assert pf.queue.pending() == 1 and pf.telemetry.rejected == 3
    assert pf.result(good).hits.dtype == torch.bool


# ---------------------------------------------------------------------------
# open-loop generator and telemetry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_arrivals_and_workload_are_bit_equal(seed):
    for qps, duration in ((200.0, 1.0), (4000.0, 0.5), (0.0, 1.0)):
        a = loadgen.poisson_arrivals(qps, duration, seed=seed)
        b = jloadgen.poisson_arrivals(qps, duration, seed=seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    data = _data()
    ext = loadgen.data_extent(data)
    assert np.array_equal(ext, jloadgen.data_extent(data))
    a = loadgen.rect_workload(ext, 64, seed=seed, sel=0.05)
    b = jloadgen.rect_workload(ext, 64, seed=seed, sel=0.05)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_latency_histogram_equals_the_reference():
    samples = np.random.default_rng(5).lognormal(-5.0, 1.0, size=4000)
    h, j = LatencyHistogram(), JaxHistogram()
    assert h.quantile(0.5) == j.quantile(0.5) == 0.0
    for s in samples:
        h.record(s)
        j.record(s)
    for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert h.quantile(q) == j.quantile(q)
    assert h.to_dict() == j.to_dict() and h.quantiles_ms() == j.quantiles_ms()
    assert h.merge(h).to_dict() == j.merge(j).to_dict()


def test_run_sweep_rows_have_the_reference_keys(tmp_path):
    data = _data()
    cfg = _cfg([{"name": "t", "backend": "host"}])

    def make(pkg, **kw):
        return lambda: (pkg.ServingFrontEnd.build(cfg, {"t": data}, **kw), "t")

    rows = loadgen.run_sweep(make(pserve, device="cpu"), [400.0], duration=0.05, seed=1)
    jrows = jloadgen.run_sweep(make(jserve), [400.0], duration=0.05, seed=1)
    assert sorted(rows[0]) == sorted(jrows[0])
    assert rows[0]["completed"] + rows[0]["shed"] == jrows[0]["completed"] + jrows[0]["shed"]
    path = loadgen.write_bench_rows(rows, str(tmp_path))
    assert pathlib.Path(path).parent == tmp_path
    assert list(tmp_path.iterdir()) == [pathlib.Path(path)]


class ServiceClock:
    """A clock that moves 10 µs a read and ``service`` a served batch, so
    an overloaded open-loop run is deterministic."""

    def __init__(self, service: float):
        self.t, self.service = 0.0, service

    def __call__(self) -> float:
        self.t += 1e-5
        return self.t


class Served:
    """A tenant index whose every batch costs its clock ``service``."""

    def __init__(self, index, clock):
        self.index, self.clock = index, clock

    def __getattr__(self, name):
        return getattr(self.index, name)

    def region(self, queries):
        self.clock.t += self.clock.service
        return self.index.region(queries)


def test_overloaded_run_sheds_instead_of_shrinking_its_batches():
    """ROADMAP C22: at 4x the capacity (16 queries a 4 ms batch), the
    reference's load loop launches each overdue arrival alone and sheds
    nothing; the port's enqueues the overdue arrivals first, so full
    batches go out and admission sheds the excess."""
    data = _data()
    cfg = _cfg([{"name": "t", "backend": "host"}], query_block=16,
               classes=[{"name": "interactive", "deadline_ms": 50.0, "overload": "shed",
                         "max_queue": 64}])
    arrivals = loadgen.poisson_arrivals(16_000.0, 0.1, seed=2)
    queries = loadgen.rect_workload(loadgen.data_extent(data), len(arrivals), seed=3)
    rows = {}
    for pkg, gen, kw in ((jserve, jloadgen, {}), (pserve, loadgen, {"device": "cpu"})):
        clock = ServiceClock(4e-3)
        front = pkg.ServingFrontEnd.build(cfg, {"t": data}, clock=clock, **kw)
        front.tenants["t"].index = Served(front.tenants["t"].index, clock)
        rows[pkg] = gen.run_load(front, "t", queries, arrivals)
    ref, port = rows[jserve], rows[pserve]
    assert ref["submitted"] == port["submitted"] == len(arrivals)
    assert ref["shed"] == 0 and ref["avg_batch"] < 1.5
    assert port["shed"] > len(arrivals) // 2 and port["avg_batch"] > 12
    assert port["completed"] + port["shed"] == len(arrivals)
    assert port["p99_ms"] < ref["p99_ms"]


# ---------------------------------------------------------------------------
# layering
# ---------------------------------------------------------------------------


def test_front_end_uses_only_the_engines_public_surface():
    root = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    pats = [
        re.compile(r"from\s+repro_torch\.launch\.spatial_serve\s+import\s+[^\n]*\b_\w+"),
        re.compile(r"\bspatial_serve\._\w+"),
    ]
    offenders = [f"{f}: {m.group(0)}" for f in sorted((root / "serve").rglob("*.py"))
                 for pat in pats for m in pat.finditer(f.read_text())]
    assert not offenders, "\n".join(offenders)
    imports = re.compile(r"^\s*(from|import)\s+(jax|repro)\b", re.M)
    for f in sorted(root.rglob("*.py")):
        assert not imports.search(f.read_text()), f


def test_serving_layers_document_each_other():
    from repro_torch.launch import spatial_serve as engine

    assert "repro_torch.serve" in (engine.__doc__ or "")
    assert "front end" in (engine.__doc__ or "").lower()
    assert "repro_torch.launch.spatial_serve" in (pserve.__doc__ or "")
    assert "front end" in (pserve.__doc__ or "").lower()
