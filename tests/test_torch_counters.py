"""The per-launch byte ledger (``repro_torch.obs.counters``).

* The reference's ledger math (``survivor_recurrence``,
  ``tile_bytes_per_query``, ``stream_fetch_bytes``,
  ``quantize_queries_grid``) and ``merge_reports``, copied into the port,
  must equal ``repro.obs.counters`` on the same numpy inputs.
* The report functions are derived again for the card (ROADMAP C19): each
  report the port's sweeps emit must equal its documented byte formula,
  recomputed here from the schedule's shapes and ``n_real``, on the
  pyramid, the mqr-tree and the R-tree at float32, compact, compact8 and
  ``stream=True``.
* ``AccessStats.tiles_skipped`` is the streaming kernel's own count and
  must not change when the side channel is armed; an autotune probe
  leaves nothing on the side channel.
* ``launch/loadgen.py`` runs to its end at ``REPRO_BENCH_TINY=1`` on the
  CPU, writing only into a temporary directory.

Tolerance: exact (integer byte counts).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.obs import counters as jcounters
from repro_torch import SpatialIndex
from repro_torch.core import datasets
from repro_torch.kernels.pyramid_scan import parent_windows
from repro_torch.obs import counters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def armed():
    counters.collect_launch_reports(True)
    yield
    counters.collect_launch_reports(False)


def _grid(rng, levels, width, cells=200):
    lo = rng.integers(0, cells, (levels, 2, width))
    hi = lo + rng.integers(0, 40, (levels, 2, width))
    mbr = np.concatenate([lo, hi], axis=1)
    parent = np.stack([rng.integers(0, max(1, width // 3), width) for _ in range(levels)])
    parent[0] = 0
    return mbr, parent


def _queries(rng, nq, cells=200):
    lo = rng.integers(0, cells, (nq, 2))
    return np.concatenate([lo, lo + rng.integers(0, 60, (nq, 2))], axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_math_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    levels, width, nq = 4, 300, 7
    mbr, parent = _grid(rng, levels, width)
    qq, qq8 = _queries(rng, nq), _queries(rng, nq, cells=60)
    for root in (True, False):
        mine = list(counters.survivor_recurrence(mbr, parent, lambda l: qq,
                                                 root_unconditional=root))
        ref = list(jcounters.survivor_recurrence(mbr, parent, lambda l: qq,
                                                 root_unconditional=root))
        assert len(mine) == len(ref) == levels
        for a, b in zip(mine, ref):
            assert a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
        n_real = rng.integers(1, width, levels)
        kw = dict(split=2, root_unconditional=root, qq8=qq8)
        assert counters.tile_bytes_per_query(mbr, parent, n_real, qq, **kw) == \
            jcounters.tile_bytes_per_query(mbr, parent, n_real, qq, **kw)
        win_off, win_w = parent_windows(parent, n_real, block_w=64)
        kw = dict(block_w=64, slot_bytes=10, root_unconditional=root)
        assert counters.stream_fetch_bytes(mbr, parent, qq, win_off, win_w, **kw) == \
            jcounters.stream_fetch_bytes(mbr, parent, qq, win_off, win_w, **kw)
    fq = rng.uniform(-5.0, 900.0, (nq, 4)).astype(np.float32)
    origin = np.array([0.0, 0.0, 0.0, 0.0], np.float32)
    inv = np.full(4, 0.37, np.float32)
    a = counters.quantize_queries_grid(fq, origin, inv, 255)
    b = jcounters.quantize_queries_grid(fq, origin, inv, 255)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 5])
def test_merge_reports_equals_the_reference(seed):
    def reports(mod):
        out = []
        for i in range(4):
            r = np.random.default_rng(seed * 10 + i)
            surv = tuple(int(x) for x in r.integers(0, 50, 3)) if i != 1 else None
            out.append(mod.LaunchReport(
                "compact", bool(i % 2), int(r.integers(1, 16)), 128,
                float(r.integers(0, 1 << 20)), mask_bytes=float(r.integers(0, 999)),
                tiles_fetched=int(r.integers(0, 9)), tiles_total=9,
                survivors_per_level=surv))
        return out

    mine, ref = counters.merge_reports(reports(counters)), jcounters.merge_reports(
        reports(jcounters))
    assert mine.to_dict() == ref.to_dict()
    assert counters.merge_reports([None]) is None


# ---------------------------------------------------------------------------
# the card's formulas, recomputed from the schedule
# ---------------------------------------------------------------------------


def _expected(kind, sched, qs, nq, block_w, tiles_of_level, parent_bytes, n_real=None):
    """The resident formula of ``resident_sweep_report``'s docstring."""
    levels, width = sched.levels, sched.width
    first = int(sched.root_unconditional)
    if n_real is None:
        read = real = [width] * levels
    else:
        real = [min(width, n) for n in n_real]
        read = [min(width, -(-n // block_w) * block_w) for n in real]
    streamed = sum(read[l] * tiles_of_level(l) for l in range(first, levels))
    streamed += sum(read[l] * parent_bytes for l in range(1, levels))
    return dict(
        bytes_streamed=float(streamed),
        mask_bytes=float(levels * nq * width + sum(nq * real[l] for l in range(1, levels))),
        tiles_fetched=sum(-(-read[l] // block_w) for l in range(first, levels)),
        tiles_total=levels * -(-width // block_w),
        queries=nq, stream=False,
    )


def _index(structure, n=700, **opts):
    data = datasets.uniform_squares(n, seed=3)
    return SpatialIndex.build(data, structure=structure, backend="cuda", device="cpu",
                              autotune="off", **opts), data


def _check(report, want):
    got = {k: getattr(report, k) for k in want}
    assert got == want


@pytest.mark.parametrize("structure", ["pyramid", "mqr", "rtree"])
@pytest.mark.parametrize("precision", ["float32", "compact", "compact8"])
def test_resident_reports_equal_their_formula(armed, structure, precision):
    idx, data = _index(structure, precision=precision, block_w=64)
    qs = datasets.region_queries(data, 5, seed=4)
    res = idx.region(qs)
    rep = res.launch_report
    assert counters.drain() == []          # the façade took it off the channel
    sched = idx.schedule
    if precision == "float32":
        want = _expected(precision, sched, qs, 5, 64, lambda l: 16, 4)
    elif precision == "compact":
        q = idx.artifacts.quantized
        want = _expected(precision, sched, qs, 5, 64, lambda l: 8, q.parent_q.element_size())
    else:
        q = idx.artifacts.quantized8
        assert q.split > 0
        want = _expected(precision, sched, qs, 5, 64, lambda l: 4 if l < q.split else 8,
                         q.parent_q.element_size(), n_real=sched.n_real.tolist())
    _check(rep, want)
    assert (rep.kind, rep.backend, rep.block_w, rep.launches) == (precision, "cuda", 64, 1)
    assert rep.survivors_per_level == tuple(res.visits_per_level.sum(dim=0).tolist())
    assert idx.stats.bytes_streamed == rep.bytes_streamed
    assert idx.stats.mask_bytes == rep.mask_bytes
    assert idx.stats.tiles_fetched == rep.tiles_fetched and idx.stats.launch_reports == 1


@pytest.mark.parametrize("structure", ["pyramid", "mqr"])
@pytest.mark.parametrize("precision", ["float32", "compact"])
def test_stream_reports_equal_their_formula(armed, structure, precision):
    idx, data = _index(structure, precision=precision, block_w=64, stream=True)
    qs = datasets.region_queries(data, 6, seed=5)
    rep = idx.region(qs).launch_report
    sched = idx.schedule
    parent = sched.parent if precision == "float32" else idx.artifacts.quantized.parent_q
    lanes = 16 if precision == "float32" else 8
    win_off, _ = parent_windows(parent, sched.n_real, block_w=64)
    level0 = int((win_off[0] >= 0).sum())
    skipped = idx.stats.tiles_skipped           # this one call's kernel count
    assert skipped > 0
    total = sched.levels * -(-sched.width // 64)
    root = sched.root_unconditional
    fetched = total - skipped - (level0 if root else 0)
    gated = fetched - (0 if root else level0)
    _check(rep, dict(
        bytes_streamed=float(64 * (fetched * lanes + gated * parent.element_size())),
        mask_bytes=float((2 * sched.levels - 1) * 6 * sched.width),
        tiles_fetched=fetched, tiles_total=total, stream=True, queries=6))


def test_chunked_batch_merges_into_one_report(armed):
    idx, data = _index("pyramid", block_w=64, query_block=4)
    qs = datasets.region_queries(data, 10, seed=6)
    rep = idx.region(qs).launch_report
    one = counters.scan_report_float32(idx.schedule, torch.zeros((1, 4)), block_w=64,
                                       stream=False)
    assert (rep.launches, rep.queries, rep.query_block) == (3, 10, 4)
    assert rep.bytes_streamed == 3 * one.bytes_streamed
    assert rep.tiles_fetched == 3 * one.tiles_fetched


def test_host_twin_and_knn_rounds_report(armed):
    data = datasets.uniform_squares(400, seed=7)
    idx = SpatialIndex.build(data, structure="pyramid", backend="host", device="cpu")
    rep = idx.region(datasets.region_queries(data, 3, seed=8)).launch_report
    s = idx.schedule
    assert rep.kind == "host-twin" and rep.backend == "host"
    assert rep.bytes_streamed == s.mbr_cm.numel() * 4 + s.parent.numel() * 4
    assert rep.tiles_fetched == rep.tiles_total == s.levels
    # k-NN folds every radius round's report into one (ROADMAP C23), on
    # the cuda backend and through the serve backend's cuda rung
    points = np.array([[100.0, 100.0], [500.0, 700.0]])
    for backend in ("cuda", "serve"):
        dev, _ = _index("pyramid", n=400, block_w=64)
        if backend == "serve":
            dev = dev.with_backend("serve", block_w=64)
        one = counters.scan_report_float32(dev.schedule, points, block_w=64, stream=False)
        dev.knn(points, 4)
        rounds = dev.stats.knn_rounds
        assert rounds >= 2 and dev.stats.launch_reports == 1
        assert dev.stats.bytes_streamed == rounds * one.bytes_streamed
        assert counters.drain() == []


@pytest.mark.parametrize("structure", ["pyramid", "mqr"])
def test_tiles_skipped_counts_once_armed_or_not(structure):
    data = datasets.uniform_squares(900, seed=9)
    qs = datasets.region_queries(data, 6, seed=10)
    got = []
    for on in (False, True):
        counters.collect_launch_reports(on)
        try:
            idx = SpatialIndex.build(data, structure=structure, backend="cuda", device="cpu",
                                     autotune="off", block_w=64, stream=True)
            idx.region(qs)
            idx.region(qs[:2])
            got.append(idx.stats.tiles_skipped)
            if on:
                assert idx.stats.launch_reports == 2
        finally:
            counters.collect_launch_reports(False)
    assert got[0] == got[1] > 0


def test_autotune_probes_leave_nothing_on_the_side_channel(armed, monkeypatch):
    emitted = []
    emit = counters.emit
    monkeypatch.setattr(counters, "emit", lambda r: (emitted.append(r), emit(r)))
    data = datasets.uniform_squares(1200, seed=11)
    idx = SpatialIndex.build(data, structure="pyramid", backend="cuda", device="cpu",
                             autotune="on")
    qs = datasets.region_queries(data, 40, seed=12)
    rep = idx.region(qs).launch_report
    assert len(emitted) > 2  # the fused candidates' probes reported
    assert counters.drain() == []
    # the winner's report is the batch's alone (the per-level plan reports
    # nothing, so then no probe's report may surface either)
    assert idx.stats.launch_reports == (0 if rep is None else 1)
    if rep is not None:
        assert rep.queries == 40 and rep.block_w == idx._backend.config.block_w


def test_disarmed_side_channel_reports_nothing():
    assert not counters.collecting()
    idx, data = _index("pyramid")
    res = idx.region(datasets.region_queries(data, 3, seed=13))
    assert res.launch_report is None and idx.stats.launch_reports == 0
    assert idx.stats.bytes_streamed == 0.0 and counters.drain() == []


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_loadgen_cli_runs_tiny_on_the_cpu(tmp_path):
    metrics, trace = tmp_path / "m.prom", tmp_path / "trace.json"
    env = dict(os.environ, REPRO_BENCH_TINY="1",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.loadgen", "--device", "cpu",
         "--qps", "50,200", "--metrics-out", str(metrics), "--trace-out", str(trace)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("qps_offered,qps_achieved") and len(lines) == 3
    assert "repro_serve_completed" in metrics.read_text()
    doc = json.loads((tmp_path / "m.prom.json").read_text())
    assert doc["namespace"] == "repro"
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert "serve.launch" in names
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.prom", "m.prom.json",
                                                          "trace.json"]
