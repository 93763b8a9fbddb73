#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main serving path on one CUDA card and check it.

    python3 chip_smoke.py [--n 1000000] [--queries 256] [--seed 0]

Phases:
  1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc;
  2. main path, with every launch counter set to 0 just before it:
     ``SpatialIndex.build(uniform_squares(n), structure="pyramid",
     build="device")`` on the card, then ``.region / .point / .count`` at
     ``precision="float32"`` and ``"compact"``; fails unless every kernel
     of the path launched;
  3. results: hits and visits equal the plain-PyTorch path on the same
     card (plain build, plain quantizer, plain sweep), compact hits equal
     float32 hits, hits cover a brute-force object-overlap mask (extra hits
     are printed), counts agree, and a small index on the card agrees with
     the numpy oracle on the CPU;
  4. each kernel against its plain version at the main path's shapes
     (exact equality: masks, integers and float32 min/max/compare do not
     round), timed with CUDA events (median of 7 after warm-up), beside the
     least time the card needs for the same bytes and operations;
  5. end-to-end times of build, region and point batches, peak device
     memory, and a torch.profiler trace of one region batch per precision
     (device time by kernel, and the device's idle share of the window).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
as the last line, ``{"ok": true, "device": {...}}``.  Exits nonzero, with no
result, when there is no CUDA device, when the port is missing, or when any
phase fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM3 bandwidth, and the CUDA-core 32-bit rate used for compares.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
REPEATS = 7


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def card_device() -> torch.device:
    return torch.device("cuda", 0)


def sync():
    torch.cuda.synchronize()


def time_ms(fn, repeats: int = REPEATS) -> float:
    """Median device time of ``fn()`` in ms (CUDA events), after warm-up."""
    fn()
    sync()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        sync()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, repeats: int = REPEATS) -> float:
    """Median host time of ``fn()`` ending in a synchronize, in ms."""
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float):
    """Least time for ``nbytes`` moved and ``ops`` done: the larger of the
    two, and which one it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over entries finite in both (0.0 when identical).
    Walks the leading dimension so a multi-GB mask never widens at once."""
    if a.shape != b.shape:
        return float("inf")
    if same(a, b):
        return 0.0
    worst = 0.0
    for x, y in zip(a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)):
        x64, y64 = x.to(torch.float64), y.to(torch.float64)
        both = torch.isfinite(x64) & torch.isfinite(y64)
        if both.any():
            worst = max(worst, float((x64 - y64).abs()[both].max()))
    return worst


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Exact equality of two tensors (uint16 compared through int32)."""
    if a.dtype == torch.uint16:
        a = a.to(torch.int32)
    if b.dtype == torch.uint16:
        b = b.to(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


class Checks:
    """Collects failed checks; a phase that raises counts as failed."""

    def __init__(self):
        self.failures: list[str] = []

    def expect(self, ok: bool, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failures.append(what)

    def phase(self, name: str, fn):
        print(f"== {name}", flush=True)
        try:
            return fn()
        except Exception:  # a failed phase is reported and fails the run
            traceback.print_exc()
            self.failures.append(f"phase {name} raised")
            return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="objects")
    ap.add_argument("--queries", type=int, default=256, help="queries per batch")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import SpatialIndex
        from repro_torch.core import datasets
        from repro_torch.core.flat import overlaps
        from repro_torch.kernels import _lib, ops
        from repro_torch.kernels.pyramid_scan import _quantize_queries
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})", file=sys.stderr)
        return 1

    dev = card_device()
    card = nvidia_smi_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    checks = Checks()

    t0 = time.perf_counter()
    checks.phase("build kernels", lambda: _lib.load())
    build_s = time.perf_counter() - t0
    print(f"  nvcc build + load: {build_s:.1f} s", flush=True)
    if checks.failures:
        print(f"FAILED: {checks.failures}", flush=True)
        return 1

    data = datasets.uniform_squares(args.n, seed=args.seed)
    queries = datasets.region_queries(data, args.queries, seed=args.seed).astype(np.float32)
    rng = np.random.default_rng(args.seed + 1)
    pick = data[rng.integers(0, args.n, size=args.queries)]
    points = np.stack([(pick[:, 0] + pick[:, 2]) * 0.5,
                       (pick[:, 1] + pick[:, 3]) * 0.5], axis=1).astype(np.float32)
    q_dev = torch.from_numpy(queries).to(dev)
    out = {}

    # -- 2. main path --------------------------------------------------
    def main_path():
        sync()
        _lib.counters.reset()
        t = time.perf_counter()
        idx = SpatialIndex.build(data, structure="pyramid", build="device")
        sync()
        out["build_ms"] = (time.perf_counter() - t) * 1e3
        for precision in ("float32", "compact"):
            t = time.perf_counter()
            ix = idx if precision == "float32" else idx.with_backend(
                "cuda", precision="compact")
            region = ix.region(queries)
            point = ix.point(points)
            count = ix.count(queries)
            sync()
            out[precision] = dict(index=ix, region=region, point=point, count=count,
                                  first_ms=(time.perf_counter() - t) * 1e3)
        sync()
        out["launches"] = _lib.counters.snapshot()
        out["index"] = idx
        print(f"  levels {idx.schedule.levels}  width {idx.schedule.width}  "
              f"build {out['build_ms']:.1f} ms  launches {out['launches']}", flush=True)
        for name in ("build_levels", "quantize_cm", "level_sweep_f32", "level_sweep_u16"):
            checks.expect(out["launches"].get(name, 0) > 0,
                          f"{name} launched on the main path ({out['launches'].get(name, 0)})")

    checks.phase("main path", main_path)
    if "index" not in out:
        print(f"FAILED: {checks.failures}", flush=True)
        return 1
    idx = out["index"]
    sched = idx.schedule
    qsched = idx.artifacts.quantized

    # -- 3. results ----------------------------------------------------
    def results():
        plain = ops.device_schedule(data, levels=sched.levels, engine="torch", device=dev)
        for f in ("mbr_cm", "parent", "n_real", "obj_mbr", "obj_level", "obj_slot", "obj_id"):
            checks.expect(same(getattr(sched, f), getattr(plain, f)),
                          f"device build == plain build: {f}")
        qplain = ops.quantize_schedule(plain, engine="torch")
        for f in ("mbr_q", "parent_q", "origin", "inv_cell", "confirm_mbr"):
            checks.expect(same(getattr(qsched, f), getattr(qplain, f)),
                          f"quantized schedule == plain: {f}")
        p_dev = torch.from_numpy(points).to(dev)
        point_q = torch.cat([p_dev, p_dev], dim=1)
        for precision, scan, s in (("float32", ops.pyramid_scan, plain),
                                   ("compact", ops.pyramid_scan_compact, qplain)):
            r = out[precision]
            for what, q, res in (("region", q_dev, r["region"]), ("point", point_q, r["point"])):
                hits, visits = scan(s, q, engine="torch")
                checks.expect(same(res.hits, hits), f"{precision} {what} hits == plain path")
                checks.expect(same(res.visits_per_level, visits),
                              f"{precision} {what} visits == plain path")
            checks.expect(same(r["count"], r["region"].hits.sum(dim=1)),
                          f"{precision} count == region hits per query")
        checks.expect(same(out["compact"]["region"].hits, out["float32"]["region"].hits),
                      "compact hits == float32 hits")
        obj = sched.obj_mbr
        brute = overlaps(obj[None, :, :], q_dev[:, None, :])           # (Q, n)
        hits = out["float32"]["region"].hits
        missing = int((brute & ~hits).sum())
        extra = int((hits & ~brute).sum())
        print(f"  brute-force overlaps {int(brute.sum())}, hits {int(hits.sum())}, "
              f"extra hits {extra}", flush=True)
        checks.expect(missing == 0, f"hits cover the brute-force overlap mask (missing {missing})")
        v32 = out["float32"]["region"].visits_per_level
        vc = out["compact"]["region"].visits_per_level
        print(f"  visits/query float32 {float(v32.sum()) / args.queries:.2f}  "
              f"compact {float(vc.sum()) / args.queries:.2f}", flush=True)
        # a small index on the card against the numpy oracle on the CPU
        small = data[:2000]
        sq = datasets.region_queries(small, 8, seed=args.seed)
        for precision in ("float32", "compact"):
            for build in ("device", "host"):
                on_card = SpatialIndex.build(small, build=build, precision=precision).region(sq)
                oracle = SpatialIndex.build(small, backend="host", device="cpu").region(sq)
                checks.expect(
                    same(on_card.hits.cpu(), oracle.hits)
                    and same(on_card.visits_per_level.cpu(), oracle.visits_per_level),
                    f"n=2000 {precision} build={build} on the card == numpy oracle")

    checks.phase("results", results)

    # -- 4. kernels against their plain versions -----------------------
    kernels = []

    def kernel_row(name, source, replaces, kernel_fn, plain_fn, nbytes, ops_count):
        got, want = kernel_fn(), plain_fn()
        sync()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        ok = len(got) == len(want) and all(same(a, b) for a, b in zip(got, want))
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        checks.expect(ok, f"{name} kernel == plain version on the card (max_abs_err {err})")
        del got, want
        ms = time_ms(kernel_fn)
        plain_ms = time_ms(plain_fn)
        b_ms, b_by = bound_ms(nbytes, ops_count)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=out["launches"].get(name, 0), max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ))
        print(f"  {name}: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
              f"by {b_by})", flush=True)

    def kernel_phase():
        L, _, W = sched.mbr_cm.shape
        nq = q_dev.shape[0]
        obj = sched.obj_mbr
        kernel_row(
            "build_levels", "src/repro_torch/kernels/csrc/build_levels.cu",
            "src/repro/kernels/build.py:215",
            lambda: ops.build_levels(obj, levels=L),
            lambda: ops.build_levels_torch(obj, levels=L),
            # read the MBRs; write group_of, mbr_cm, parent (24 B/slot) and n_real
            nbytes=obj.numel() * 4 + L * W * (4 + 16 + 4) + L * 4,
            # per level and object: centroids, quadrant, key, 4 min/max, count
            ops_count=L * W * 16,
        )
        kernel_row(
            "quantize_cm", "src/repro_torch/kernels/csrc/quantize.cu",
            "src/repro/kernels/quantize.py:133",
            lambda: ops.quantize_cm(sched.mbr_cm, qsched.origin, qsched.inv_cell),
            lambda: ops.quantize_cm_torch(sched.mbr_cm, qsched.origin, qsched.inv_cell),
            nbytes=sched.mbr_cm.numel() * (4 + 2) + 32,
            ops_count=sched.mbr_cm.numel() * 6,
        )
        kernel_row(
            "level_sweep_f32", "src/repro_torch/kernels/csrc/level_sweep.cu",
            "src/repro/kernels/pyramid_scan.py:498",
            lambda: ops.level_sweep(q_dev, sched.mbr_cm, sched.parent,
                                    root_unconditional=False),
            lambda: ops.level_sweep_torch(q_dev, sched.mbr_cm, sched.parent,
                                          root_unconditional=False),
            # read queries, float32 tiles and int32 parents; write the mask
            nbytes=nq * 16 + L * W * (16 + 4) + L * nq * W,
            ops_count=L * nq * W * 8,
        )
        qq = _quantize_queries(q_dev, qsched.origin, qsched.inv_cell, qsched.cells)
        pbytes = qsched.parent_q.element_size()
        kernel_row(
            "level_sweep_u16", "src/repro_torch/kernels/csrc/level_sweep.cu",
            "src/repro/kernels/pyramid_scan.py:498",
            lambda: ops.level_sweep(qq, qsched.mbr_q, qsched.parent_q,
                                    root_unconditional=False),
            lambda: ops.level_sweep_torch(qq, qsched.mbr_q, qsched.parent_q,
                                          root_unconditional=False),
            nbytes=nq * 16 + L * W * (8 + pbytes) + L * nq * W,
            ops_count=L * nq * W * 8,
        )

    checks.phase("kernels vs plain versions", kernel_phase)

    def timings():
        out["build_steady_ms"] = wall_ms(
            lambda: SpatialIndex.build(data, structure="pyramid", build="device"), 5)
        for precision in ("float32", "compact"):
            ix = out[precision]["index"]
            out[precision]["region_ms"] = wall_ms(lambda: ix.region(queries))
            out[precision]["point_ms"] = wall_ms(lambda: ix.point(points))
        torch.cuda.reset_peak_memory_stats()
        out["compact"]["index"].region(queries)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  build (first) {out['build_ms']:.1f} ms, build (steady, median of 5) "
              f"{out['build_steady_ms']:.1f} ms", flush=True)
        for precision in ("float32", "compact"):
            r = out[precision]
            print(f"  {precision}: region {r['region_ms']:.2f} ms, point "
                  f"{r['point_ms']:.2f} ms per {args.queries}-query batch "
                  f"(median of {REPEATS}); first region+point+count {r['first_ms']:.1f} ms",
                  flush=True)
        print(f"  peak device memory of one compact region batch: {out['peak_gib']:.2f} GiB",
              flush=True)

    checks.phase("end-to-end timings", timings)

    def profile():
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as trace

        for precision in ("float32", "compact"):
            ix = out[precision]["index"]
            ix.region(queries)
            sync()
            with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                ix.region(queries)
                sync()
                window_us = (time.perf_counter() - t) * 1e6
            rows = []
            for evt in prof.key_averages():
                if evt.device_type != DeviceType.CUDA:
                    continue  # host-side ops; their kernels are listed themselves
                dev_us = getattr(evt, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(evt, "self_cuda_time_total", 0)
                if dev_us > 0:
                    rows.append((dev_us, evt.count, evt.key))
            rows.sort(reverse=True)
            busy = sum(r[0] for r in rows)
            print(f"  {precision} region batch: host window {window_us / 1e3:.3f} ms, "
                  f"device busy {busy / 1e3:.3f} ms, idle share "
                  f"{max(0.0, 1 - busy / window_us):.3f}", flush=True)
            for dev_us, count, key in rows[:12]:
                print(f"    {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)

    checks.phase("profile: device time by kernel, one region batch", profile)

    summary = dict(
        n=args.n, queries=args.queries, seed=args.seed, card=card,
        levels=sched.levels, width=sched.width, nvcc_build_s=build_s,
        build_ms=out.get("build_ms"), build_steady_ms=out.get("build_steady_ms"),
        region_ms={p: out[p].get("region_ms") for p in ("float32", "compact")},
        point_ms={p: out[p].get("point_ms") for p in ("float32", "compact")},
        peak_gib=out.get("peak_gib"),
    )
    print("summary " + json.dumps(summary), flush=True)
    if checks.failures:
        print(f"FAILED: {checks.failures}", flush=True)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
