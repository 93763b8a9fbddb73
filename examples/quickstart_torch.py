"""Quickstart of the PyTorch/CUDA port: one `SpatialIndex` façade over every
tree × backend path, on the card.

The counterpart of ``examples/quickstart.py``'s twelve steps on the
port's backends (``host``, ``torch``, ``cuda``, ``serve``), with every
parity assert of the reference.  Everything runs on the CUDA card unless
``--device cpu`` is given (then each kernel's plain PyTorch version
runs); without a card and without it, the first build raises.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import SpatialIndex  # noqa: E402
from repro_torch.core import datasets, metrics, mqrtree, rtree  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def same(a, b) -> bool:
    """Tensors equal in value, wherever each lives (the host backend
    answers on the CPU, the others on the index's device)."""
    return torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu())


def wait(dev) -> None:
    """A host clock around card work must wait for the card."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(device=None, *, trace_out="trace.json"):
    dev = ops.resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host CPU"
    print(f"device: {dev} ({name})")

    # 1. The paper's structure on 1000 uniform 10x10 squares
    data = datasets.uniform_squares(1000, seed=0)
    mq = mqrtree.build(data)
    rt = rtree.build(data)
    m, r = metrics.compute_metrics(mq), metrics.compute_metrics(rt)
    print("index     nodes  height  coverage      overcov      overlap")
    for label, x in (("mqr-tree", m), ("r-tree", r)):
        print(f"{label:9s} {x.n_nodes:5d}  {x.height:2d}({x.avg_path:4.1f}) "
              f"{x.coverage:12.0f} {x.overcoverage:12.0f} {x.overlap:12.0f}")
    print(f"\nmqr overlap is {100 * (1 - m.overlap / r.overlap):.0f}% lower; "
          "on point data it is exactly ZERO (paper section 4).")

    # 2. One façade, every build/query path: the host pointer oracle, the
    # plain PyTorch sweep, the hand-written CUDA kernel and the server.
    qs = datasets.region_queries(data, 20, seed=1)
    host = SpatialIndex.build(data, structure="mqr", backend="host", device=dev)
    rhost = SpatialIndex.build(data, structure="rtree", backend="host", device=dev)
    ref = host.region(qs)
    vr = int(rhost.region(qs).visits.sum())
    print(f"\nregion search over 20 queries: mqr {int(ref.visits.sum())} node "
          f"visits (host oracle); r-tree {vr}")

    for backend in ("torch", "cuda", "serve"):
        idx = host.with_backend(backend)  # same build artifacts, new engine
        res = idx.region(qs)
        assert same(res.hits, ref.hits)
        assert same(res.visits_per_level, ref.visits_per_level)
        print(f"backend={backend:6s} identical hits + per-level disk "
              f"accesses ({idx.stats.node_accesses} total, "
              f"{idx.stats.launches} launches)")

    # 3. k-NN: host branch-and-bound oracle vs the expanding-radius
    # schedule over the fused kernel.
    pts = np.random.default_rng(2).uniform(100, 900, (8, 2))
    kh = host.knn(pts, k=5)
    kd = host.with_backend("cuda").knn(pts, k=5)
    assert same(kh.ids, kd.ids)
    print(f"\nknn(k=5) over 8 points: host and fused-kernel paths agree; "
          f"nearest of point 0: objects {kh.ids[0].tolist()} "
          f"(host {int(kh.visits.sum())} vs device {int(kd.visits.sum())} "
          f"accesses)")

    # 4. The bulk pyramid structure through the same façade.
    pidx = SpatialIndex.build(data, structure="pyramid", backend="cuda", device=dev)
    print(f"pyramid backend=cuda: {int(pidx.count(qs).sum())} total hits over "
          f"{pidx.schedule.levels} levels, one launch a level per batch")

    # 5. Where the time goes: build-time / query-time split per backend.
    # The device bulk build replaces per-object host insertion with one
    # kernel call; precision="compact" sweeps uint16 MBR tiles at half the
    # bytes with identical hits.  Host clocks, each ending in a wait for
    # the card.
    print(f"\nbuild-time / query-time split (n=1000, 20 queries, {name}):")
    configs = [
        ("mqr", "host", {}),
        ("mqr", "cuda", {}),
        ("pyramid", "cuda", {"build": "device"}),
        ("pyramid", "cuda", {"build": "device", "precision": "compact"}),
    ]
    ref_hits = ref.hits
    for structure, backend, opts in configs:
        t0 = time.time()
        idx = SpatialIndex.build(data, structure=structure, backend=backend, device=dev,
                                 **opts)
        idx.region(qs)  # first call at the batch shape (autotuner) = build column
        wait(dev)
        t_build = time.time() - t0
        t0 = time.time()
        res = idx.region(qs)
        wait(dev)
        t_query = time.time() - t0
        if structure == "mqr":
            assert same(res.hits, ref_hits)
        tag = " ".join(f"{k}={v}" for k, v in opts.items()) or "-"
        print(f"  {structure:8s} {backend:7s} {tag:38s} "
              f"build {t_build:6.3f}s  query {t_query * 1e3:6.1f}ms")

    # 6. Batch insertion: extend() buffers the batch in the live-update
    # subsystem (flush="always" = an eager device re-build).
    didx = SpatialIndex.build(data, structure="pyramid", backend="cuda", build="device",
                              device=dev)
    t0 = time.time()
    grown = didx.extend(datasets.uniform_squares(500, seed=9))
    t_ext = time.time() - t0
    print(f"\nextend(+500 objects): {didx.n_objects} -> {grown.n_objects} "
          f"objects in {t_ext:.3f}s (buffered; no rebuild)")

    # 7. Live updates: insert/delete/flush online — the delta buffer rides
    # the same fused sweep, deletes are tombstones masked in the sweep's
    # epilogue, flush() compacts with ids preserved.
    live = SpatialIndex.build(data, structure="mqr", backend="cuda", capacity=256,
                              device=dev)
    gids = live.insert(datasets.uniform_squares(100, seed=10))
    live.delete(gids[:10])
    live.delete(np.arange(25))          # tombstone 25 base objects too
    res = live.region(qs)
    assert not bool(res.hits[:, :25].any())
    assert not bool(res.hits[:, torch.as_tensor(gids[:10], device=res.hits.device)].any())
    print(f"\nlive updates: +100 / -35 -> {live.n_objects} live objects, "
          f"{int(res.delta_visits.sum())} delta accesses over 20 queries "
          f"(buffer fill {live._updates.fill:.0%})")
    live.flush()
    post = live.region(qs)
    assert all(same(res.ids(i), post.ids(i)) for i in range(20))
    print(f"flush(): merged into a fresh base build — hit sets identical, "
          f"{live.stats.flushes} merge(s), zero overlap preserved on point "
          f"data (live_metrics)")

    # 8. Durability: save -> kill -> recover.  Every mutation goes to a
    # write-ahead log BEFORE it touches device state, so a kill at any
    # point (here: mid-workload, with a torn half-written record at the
    # WAL tail) recovers to the last durable op — identical hits on any
    # backend.
    from repro_torch.checkpoint import DurableIndex, live_ids
    from repro_torch.ft import FaultPlan, KillPoint

    root = tempfile.mkdtemp(prefix="mqr-durable-")
    try:
        plan = FaultPlan(kill_at_op=5, torn_write=True)  # die mid-append
        d = DurableIndex.create(data, root, backend="cuda", device=dev, capacity=64,
                                fault_plan=plan)
        try:
            for i in range(8):
                d.insert(datasets.uniform_squares(3, seed=20 + i))
        except KillPoint as e:
            print(f"\ndurability: simulated crash — {e}")
        d.close()
        rec = DurableIndex.recover(root, backend="cuda", device=dev)
        print(f"recover(): snapshot + {rec.recovered_ops} WAL ops replayed "
              f"(torn tail dropped: {rec.recovered_torn}) -> "
              f"{rec.n_objects} live objects")
        assert rec.ops_total == 5 and rec.n_objects == 1015
        twin = rec.index.with_backend("host")
        assert same(rec.region(qs).hits, twin.region(qs).hits)
        assert live_ids(rec).size == rec.n_objects
        rec.checkpoint()  # rotate: fresh snapshot generation + empty WAL
        rec.close()
        print("recovered index answers identically on cuda and host; "
              "checkpoint() rotated to a fresh generation")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # 9. Batch spatial join + the moving-object workload: both trees sweep
    # together, and the pair set equals the brute-force nested-loop
    # oracle — even while a churning delta buffer holds un-merged inserts
    # and tombstones.
    from repro_torch.launch.moving import MovingConfig, MovingWorkload

    w = MovingWorkload(
        MovingConfig(n_objects=64, moves_per_tick=8, query_every=5, seed=0),
        backend="cuda", capacity=96, device=dev,
    )
    t0 = time.time()
    last = w.run(15)   # 15 ticks: 120 deletes + 120 inserts, 3 query ticks
    wait(dev)
    dt = time.time() - t0
    a = w.query_index._updates.mbr_table.astype(np.float32)
    z = np.asarray(w.zones.artifacts.mbrs, np.float32)
    brute = ((a[:, None, 0] <= z[None, :, 2]) & (z[None, :, 0] <= a[:, None, 2])
             & (a[:, None, 1] <= z[None, :, 3]) & (z[None, :, 1] <= a[:, None, 3]))
    brute &= w.query_index._updates.alive[:, None]
    assert np.array_equal(last.join.pairs.cpu().numpy(), brute)
    print(f"\nmoving objects: 15 ticks in {dt:.2f}s "
          f"({w.query_index.stats.inserts} inserts, "
          f"{w.query_index.stats.deletes} deletes, "
          f"{w.query_index.stats.flushes} merges); final join: "
          f"{last.join.n_pairs} object×zone pairs from "
          f"{int(last.join.pair_visits.sum())} pair tests "
          f"(brute force: {brute.size}) — pair set identical to the "
          f"nested-loop oracle")

    # 10. Serving front end: single-request arrivals are coalesced into
    # deadline-bounded batches, admission-controlled per SLO class, one
    # tenant per declarative config — and every served answer equals the
    # tenant's index called directly.
    from repro_torch.serve import ServerConfig, ServingFrontEnd

    cfg = ServerConfig.from_dict({
        "query_block": 8,
        "classes": [
            {"name": "interactive", "deadline_ms": 50, "overload": "shed",
             "max_queue": 64},
        ],
        "tenants": [
            {"name": "maps", "structure": "mqr", "backend": "serve"},
            {"name": "fleet", "structure": "mqr", "backend": "host",
             "capacity": 64},
        ],
    })
    front = ServingFrontEnd.build(cfg, {"maps": data, "fleet": data}, device=dev)
    tickets = [
        front.submit("maps", "region", q) for q in qs[:6].astype(np.float32)
    ]
    tickets.append(front.submit("maps", "knn", [5.0, 5.0], k=3))
    front.drain()
    direct = front.tenants["maps"].index.region(qs[:6].astype(np.float32))
    for i, t in enumerate(tickets[:6]):
        assert same(front.result(t).hits, direct.hits[i])
    front.insert("fleet", data[:4] + 0.5)   # only fleet's epoch moves
    assert front.tenants["fleet"].epoch > 0 and front.tenants["maps"].epoch == 0
    snap = front.telemetry.snapshot()
    print(f"\nserving front end: {snap['completed']} served in "
          f"{snap['batches']} coalesced batches (avg {snap['avg_batch']}), "
          f"p99 {snap['p99_ms']:.2f} ms on {name}, shed {snap['shed']} — every "
          "answer identical to the direct index call")

    # 11. Hardware knobs: Hilbert leaf ordering at build time, the
    # streaming sweep, uint8 upper-level tiles, and the tiling autotuner —
    # four independent levers, zero answer movement.
    base = SpatialIndex.build(data, structure="mqr", backend="cuda", device=dev)
    ref = base.region(qs.astype(np.float32))
    tuned = SpatialIndex.build(
        data, structure="mqr", backend="cuda", order="hilbert", device=dev,
        backend_opts={"stream": True, "autotune": "off"},
    )
    res = tuned.region(qs.astype(np.float32))
    assert same(res.hits, ref.hits)
    assert same(res.visits_per_level, ref.visits_per_level)
    c8 = base.with_backend("cuda", precision="compact8").region(qs.astype(np.float32))
    assert same(c8.hits, ref.hits)
    print("\nhardware knobs: hilbert ordering + streamed sweep "
          "+ uint8 upper tiles all identical to the plain fused path "
          f"({int(ref.hits.sum())} hits; autotuner caches winners in "
          "BuildArtifacts.tuned)")

    # 12. Observability: trace spans + the per-launch byte ledger (the
    # bytes the card's sweep kernels read and write) + a metrics snapshot.
    # Tracing off costs one attribute check; the ledger is opt-in.
    from repro_torch.obs import counters, trace

    trace.enable()
    counters.collect_launch_reports(True)
    res = tuned.region(qs.astype(np.float32))
    rep = res.launch_report
    counters.collect_launch_reports(False)
    trace.get_tracer().export_chrome_trace(trace_out)
    trace.disable()
    prom = tuned.metrics(tenant="quickstart").to_prometheus()
    n_spans = sum(1 for e in trace.get_tracer().events() if e["ph"] == "X")
    print(f"\nobservability: {n_spans} spans -> {trace_out} (open in "
          f"Perfetto); launch ledger: {rep.bytes_streamed:.0f} B streamed "
          f"over {rep.tiles_fetched}/{rep.tiles_total} tiles "
          f"({rep.tiles_skipped} skipped) and {rep.mask_bytes:.0f} B of mask "
          f"traffic; metrics snapshot {len(prom.splitlines())} Prometheus "
          "lines, e.g.")
    for line in prom.splitlines():
        if line.startswith("repro_index_queries"):
            print(f"  {line}")
    return rep


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the kernels' plain versions (default: the card)")
    ap.add_argument("--trace-out", default="trace.json",
                    help="where step 12 writes its Chrome/Perfetto trace")
    args = ap.parse_args()
    main(args.device, trace_out=args.trace_out)
