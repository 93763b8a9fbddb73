"""Port parity: the observability layer of ``repro_torch`` == the JAX
package's.

* The tracer keeps the reference's contract: the disabled path returns
  one shared null span, spans nest by containment and close under
  exceptions and simulated kills, the ring buffer bounds and counts
  drops, and the Chrome trace export has the reference's schema.
* For one op script — region, k-NN, inserts, deletes, a flush, a join, a
  degraded ``serve`` batch, durable commits and a checkpoint — the
  sequence of span names and their nesting equals the reference's, with
  the backend and rung names mapped (``pallas`` → ``cuda``, ``lax`` →
  ``torch``).
* ``MetricsRegistry`` renders the same Prometheus text and JSON as the
  reference's for the same samples, and ``SpatialIndex.metrics`` the same
  lines for the counters both packages keep.

Tolerance: exact — names, nesting, text.
"""
import json
import warnings

import pytest

from repro.checkpoint import DurableIndex as JaxDurable
from repro.core import datasets
from repro.ft import FaultPlan as JaxPlan
from repro.index import SpatialIndex as JaxIndex
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch import SpatialIndex
from repro_torch.checkpoint import DurableIndex
from repro_torch.ft import FaultPlan, KillPoint
from repro_torch.obs import metrics as pmetrics
from repro_torch.obs import trace as ptrace

NAMES = {"pallas": "cuda", "lax": "torch"}


def _map(name: str) -> str:
    for old, new in NAMES.items():
        name = name.replace(old, new)
    return name


@pytest.fixture
def tracer():
    """A fresh, enabled port tracer; the previous one is restored."""
    old = ptrace.get_tracer()
    t = ptrace.set_tracer(ptrace.Tracer())
    t.enabled = True
    yield t
    ptrace.set_tracer(old)


def _nesting(events):
    """(name, parent name) of every span in start order, parent by
    containment on the same thread; instants as (name, "instant")."""
    spans = sorted((e for e in events if e["ph"] == "X"), key=lambda e: (e["ts"], -e["dur"]))
    out, stack = [], []
    for e in spans:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
            stack.pop()
        parent = stack[-1]["name"] if stack else None
        out.append((_map(e["name"]), _map(parent) if parent else None,
                    _map(str(e["args"].get("rung", "")))))
        stack.append(e)
    instants = [(_map(e["name"]), "instant", _map(str(e["args"].get("rung", ""))))
                for e in events if e["ph"] == "i"]
    return out, instants


# ---------------------------------------------------------------------------
# the tracer's contract
# ---------------------------------------------------------------------------


class TestTracer:
    def test_disabled_tracing_returns_shared_null_span(self):
        old = ptrace.get_tracer()
        t = ptrace.set_tracer(ptrace.Tracer())
        try:
            assert ptrace.span("x") is ptrace.NULL_SPAN
            assert t.span("x") is ptrace.NULL_SPAN
            with ptrace.span("x", a=1) as s:
                s.annotate(b=2)
                s.event("e")
            assert t.events() == []
        finally:
            ptrace.set_tracer(old)

    def test_spans_nest_close_and_record_errors(self, tracer):
        with ptrace.span("outer"):
            with ptrace.span("inner"):
                pass
        with pytest.raises(ValueError):
            with ptrace.span("boom", n=3):
                raise ValueError("x")
        with pytest.raises(KillPoint):
            with ptrace.span("killed"):
                raise KillPoint("dead")
        ev = {e["name"]: e for e in tracer.events()}
        assert ev["boom"]["args"] == {"n": 3, "error": "ValueError"}
        assert ev["killed"]["args"]["error"] == "KillPoint"
        assert _nesting(tracer.events())[0][:2] == [("outer", None, ""), ("inner", "outer", "")]

    def test_ring_buffer_bounds_and_counts_drops(self):
        t = ptrace.Tracer(capacity=4)
        t.enabled = True
        for i in range(10):
            t.instant(f"e{i}")
        assert [e["name"] for e in t.events()] == ["e6", "e7", "e8", "e9"]
        assert t.dropped == 6
        t.clear()
        assert t.events() == [] and t.dropped == 0

    def test_annotate_instant_counter_and_export(self, tracer, tmp_path):
        with ptrace.span("s") as s:
            s.annotate(rows=5)
            s.event("inside", k=1)
        ptrace.counter("depth", queued=3)
        doc = json.loads(open(tracer.export_chrome_trace(tmp_path / "t.json")).read())
        kinds = {e["name"]: e for e in doc["traceEvents"]}
        assert kinds["s"]["args"] == {"rows": 5}
        assert kinds["inside"]["ph"] == "i" and kinds["inside"]["s"] == "t"
        assert kinds["depth"]["ph"] == "C" and kinds["depth"]["args"] == {"queued": 3.0}
        assert doc["metadata"] == {"recorder": "repro_torch.obs.trace", "dropped_events": 0}
        assert doc["displayTimeUnit"] == "ms"

    def test_enable_disable(self):
        old = ptrace.get_tracer()
        try:
            t = ptrace.enable(capacity=8)
            assert t is ptrace.get_tracer() and t.enabled
            ptrace.disable()
            assert not t.enabled
        finally:
            ptrace.set_tracer(old)


# ---------------------------------------------------------------------------
# the same op script, the same spans
# ---------------------------------------------------------------------------


def _script(pkg, root):
    """One op script through either package's public surface."""
    port = pkg == "port"
    Index, Plan, Durable = ((SpatialIndex, FaultPlan, DurableIndex) if port
                            else (JaxIndex, JaxPlan, JaxDurable))
    dev = {"device": "cpu"} if port else {}
    fast = "cuda" if port else "pallas"
    data = datasets.uniform_squares(150, seed=61)
    queries = datasets.region_queries(data, 6, seed=62)
    idx = Index.build(data, structure="pyramid", build="device", backend=fast,
                      capacity=16, autotune="off", **dev)
    idx.region(queries)
    idx.knn(queries[:3, :2], 3)
    idx.insert(datasets.uniform_squares(4, seed=63))
    idx.delete([1, 2])
    idx.region(queries)
    idx.flush()
    other = Index.build(data[:40], backend="host", **dev)
    idx.join(other)
    other.region(queries)
    plan = Plan(fail_launches=10**9, fail_rungs=(fast,))
    served = Index.build(data, backend="serve", fault_plan=plan, query_block=4,
                         cache_size=0, backoff=0.0, **dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        served.region(queries)
    d = Durable.create(data[:60], root, backend="host", sync=False, capacity=6, **dev)
    d.insert(datasets.uniform_squares(8, seed=64))  # oversized: a merge
    d.insert(datasets.uniform_squares(2, seed=65))
    d.delete([0])
    d.flush()
    d.checkpoint()
    d.close()


def test_op_script_spans_and_nesting_equal_the_reference(tracer, tmp_path):
    _script("port", tmp_path / "port")
    port = _nesting(tracer.events())
    old = jtrace.get_tracer()
    jt = jtrace.set_tracer(jtrace.Tracer())
    jt.enabled = True
    try:
        _script("jax", tmp_path / "jax")
        ref = _nesting(jt.events())
    finally:
        jtrace.set_tracer(old)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    names = {n for n, _, _ in port[0]}
    assert {"index.region", "backend.cuda", "index.knn", "index.insert", "index.delete",
            "index.flush", "update.merge", "index.join", "backend.host", "backend.serve",
            "serve.rung", "durable.commit", "wal.append", "checkpoint.save",
            "durable.checkpoint"} <= names
    assert ("serve.degrade", "instant", "") in port[1]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


class _Stats:
    def __init__(self, d):
        self._d = d

    def to_dict(self):
        return dict(self._d, rung_dispatches=dict(self._d["rung_dispatches"]))


def test_registry_renders_the_reference_text_and_json():
    def fill(mod):
        reg = mod.MetricsRegistry()
        reg.counter("ops total", 3, labels={"tenant": 'a"b\\c\nd'}, help="ops")
        reg.gauge("depth", 2.5)
        reg.gauge("1st", -0.0)
        stats = _Stats({"queries": 8, "node_accesses": 40, "retries": 1,
                        "rung_dispatches": {"cuda": 2, "host": 1}})
        mod.stats_into(reg, stats, labels={"tenant": "t0"})
        mod.stats_into(reg, stats, prefix="other")
        return reg

    p, j = fill(pmetrics), fill(jmetrics)
    assert p.to_prometheus() == j.to_prometheus()
    assert p.to_json() == j.to_json()
    assert 'repro_ops_total{tenant="a\\"b\\\\c\\nd"} 3' in p.to_prometheus()
    with pytest.raises(ValueError, match="registered as"):
        p.gauge("ops total", 1)


def test_index_metrics_equal_the_reference_on_shared_counters():
    data = datasets.uniform_squares(150, seed=71)
    queries = datasets.region_queries(data, 6, seed=72)
    p = SpatialIndex.build(data, backend="host", capacity=8, device="cpu")
    j = JaxIndex.build(data, backend="host", capacity=8)
    for idx in (p, j):
        idx.region(queries)
        idx.insert(datasets.uniform_squares(3, seed=73))
        idx.delete([4])
        idx.region(queries)
    def families(idx):
        out = {}
        for line in idx.metrics(tenant="t0").to_prometheus().splitlines():
            if line.startswith("# HELP"):
                fam = line.split()[2]
            out.setdefault(fam, []).append(line)
        return out

    pf, jf = families(p), families(j)
    # every family of the reference's, in its order (the port now keeps the
    # front-end and byte-ledger counters too)
    assert list(pf) == list(jf)
    for fam in jf:
        assert pf[fam] == jf[fam], fam
    assert 'repro_index_queries{tenant="t0"} 12' in pf["repro_index_queries"]
    doc = p.metrics().to_json()
    assert doc["namespace"] == "repro"
    assert "repro_index_queries" in {m["name"] for m in doc["metrics"]}
