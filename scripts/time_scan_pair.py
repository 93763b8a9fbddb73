#!/usr/bin/env python3
"""Time kernels #7 (``mbr_scan``) and #3 (``level_sweep_hier``) of one source
tree on a CUDA card, so that two trees can be compared in one run.

    python scripts/time_scan_pair.py [--src src] [--label new] [--tree-n 50000]
                                     [--cache build/scan_pair_inputs.pt] [--wide-level 0]

Run it once per tree (each in its own process, since each tree has its own
``repro_torch``), in turns on one card: parent, change, change, parent.
The mqr-tree is built on the host (pure Python, about a minute at 50,000
objects), so the first process saves its compact8 inputs to ``--cache`` and
the others load them.

* #7: ``mbr_scan_cm`` on the widest level of a device-built pyramid over
  ``uniform_squares(1e6)`` (W 1e6, read in place), at Q 256 with the
  default ``block_n`` (as ``chip_smoke.py``'s kernel row) and at the
  autotuner's probe shape, Q 16, with every ``block_n`` it tries.
* #3 on the mqr-tree over ``uniform_squares(tree_n)`` (uint16 parents, the
  root visited unconditionally) at Q 256 and Q 16, and on the pyramid
  (uint8 upper levels, int32 parents) at Q 256; with the schedule's
  ``n_real`` where the wrapper takes it, and without.
* #1 (``level_sweep``, uint16 tiles and parents) on the same mqr-tree at
  Q 256 and Q 16: the kernel whose body #3 shares, as a control.

``--wide-level 0`` times a copy of ``--src`` (under ``build/``) whose #3
sweeps every shape as one launch a level, with the same skip of padding
tiles, instead of in the persistent grid: the alternative the fork in
``level_sweep.cu`` was measured against.

Each row: the mask against the plain version, the device time of one call
(the profiler's, mean of 7 calls after a warm-up; ``timed_by`` says
``events`` where every trace lost activities and CUDA events, which hold
host time too, stand in), its kernels in launch
order with their device time and the gap before each (µs, medians over 7
calls), one fill (``zero_()``) of the same mask bytes, and the byte bound
at 3.35 TB/s.
Prints one JSON line, ``{"label": ..., "rows": [...]}``.  Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import shutil
import statistics
import sys
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
REPEATS = 7
PROBE_BLOCKS = (64, 128, 256, 512)


def launches(fn, repeats: int = REPEATS) -> dict:
    """Device activity of ``repeats`` calls of ``fn()`` after a warm-up, from
    one trace (traced again while it lost activities, as
    ``chip_smoke.device_ms`` does): the launches a call, and per launch
    position its short name, device µs and the gap µs since the previous
    activity ended (medians over the calls).  Where every trace lost
    activities, only the count is kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    fn()
    cs.sync()
    for _ in range(cs.TRACE_ATTEMPTS):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(repeats):
                    fn()
                cs.sync()
        evts = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        names = [cs.kernel_name(e.name) for e in evts]
        if cs.complete([names.count(n) for n in set(names)], repeats):
            break
    else:
        return dict(events=len(evts), kernels=[], us=[], gap_us=[])
    n = len(evts) // repeats
    calls = [evts[c * n:(c + 1) * n] for c in range(repeats)]
    med = lambda xs: round(statistics.median(xs), 2)  # noqa: E731
    return dict(
        events=len(evts),
        kernels=names[:n],
        us=[med([c[i].time_range.elapsed_us() for c in calls]) for i in range(n)],
        gap_us=[0.0] + [med([c[i].time_range.start - c[i - 1].time_range.end for c in calls])
                        for i in range(1, n)],
    )


def tree_inputs(cache: Path, tree_n: int):
    """The mqr-tree's compact8 sweep inputs on the CPU: built and saved on
    the first call, loaded after."""
    if cache.exists():
        return torch.load(cache)
    import numpy as np

    from repro_torch import SpatialIndex
    from repro_torch.core import datasets
    from repro_torch.kernels.pyramid_scan import _quantize_queries

    d = datasets.uniform_squares(tree_n, seed=0)
    q = torch.from_numpy(datasets.region_queries(d, 256, seed=0).astype(np.float32))
    tix = SpatialIndex.build(d, device="cpu")
    s, t8 = tix.schedule, tix.artifacts.quantized8
    inp = dict(
        q8=_quantize_queries(q, t8.origin, t8.inv_cell8, t8.cells8),
        q16=_quantize_queries(q, t8.origin, t8.inv_cell, t8.cells),
        mbr8=t8.mbr_q8, mbr16=t8.mbr_q[t8.split:].contiguous(), parent=t8.parent_q,
        mbr_q=t8.mbr_q,
        n_real=s.n_real, split=t8.split, root=s.root_unconditional)
    cache.parent.mkdir(parents=True, exist_ok=True)
    torch.save(inp, cache)
    return inp


def with_wide_level(src: Path, wide_level: int) -> Path:
    """A copy of the source tree ``src`` whose ``level_sweep.cu`` sets
    ``WIDE_LEVEL`` to ``wide_level``; returns the copy's src directory."""
    out = ROOT / "build" / f"scan_pair_wide_level_{wide_level}" / "src"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(src, out, ignore=shutil.ignore_patterns("__pycache__"))
    cu = out / "repro_torch" / "kernels" / "csrc" / "level_sweep.cu"
    text, n = re.subn(r"constexpr int WIDE_LEVEL = \d+;",
                      f"constexpr int WIDE_LEVEL = {wide_level};", cu.read_text())
    if n != 1:
        raise SystemExit(f"time_scan_pair: no WIDE_LEVEL in {cu}")
    cu.write_text(text)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="")
    ap.add_argument("--wide-level", type=int, default=None,
                    help="time a copy of --src with this WIDE_LEVEL (0: #3 one launch a level)")
    ap.add_argument("--n", type=int, default=1_000_000, help="pyramid objects")
    ap.add_argument("--tree-n", type=int, default=50_000, help="mqr-tree objects")
    ap.add_argument("--cache", default=str(ROOT / "build" / "scan_pair_inputs.pt"),
                    help="the mqr-tree's saved sweep inputs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_scan_pair: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    if args.wide_level is not None:
        src = with_wide_level(src, args.wide_level)
        args.src = str(src)
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from repro_torch import SpatialIndex
    from repro_torch.core import datasets
    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels.pyramid_scan import _quantize_queries

    dev = cs.card_device()
    _lib.load()
    takes_n_real = "n_real" in inspect.signature(ops.level_sweep_hier).parameters
    out = {"label": args.label, "src": args.src, "card": cs.nvidia_smi_line(),
           "takes_n_real": takes_n_real, "rows": []}

    def row(name, fn, plain_fn, nbytes):
        got, want = fn(), plain_fn()
        equal = cs.same(got, want)
        fill_ms = cs.device_ms(got.zero_)
        del got, want
        ms, timed_by = cs.device_timing(fn)
        s = launches(fn)
        bound = nbytes / cs.PEAK_BYTES_PER_S * 1e3
        r = dict(name=name, equal=equal, ms=ms, timed_by=timed_by, bound_ms=bound,
                 fill_ms=fill_ms, **s)
        out["rows"].append(r)
        print(f"  {name}: {ms:.4f} ms by {timed_by} ({bound / ms:.0%} of the {bound:.4f} ms "
              f"bound), "
              f"fill {fill_ms:.4f} ms, equal {equal}, {len(s['kernels'])} launches "
              f"{list(zip(s['kernels'], s['us'], s['gap_us']))} ({args.label})", flush=True)

    # #7 on the pyramid's widest level, read in place
    data = datasets.uniform_squares(args.n, seed=0)
    q = torch.from_numpy(datasets.region_queries(data, 256, seed=0).astype(np.float32)).to(dev)
    idx = SpatialIndex.build(data, structure="pyramid", build="device", **cs.FIXED)
    sched = idx.schedule
    L, _, W = sched.mbr_cm.shape
    level = sched.mbr_cm[L - 1]
    for nq, blocks in ((256, (None,)), (16, PROBE_BLOCKS)):
        qn = q[:nq].contiguous()
        for bn in blocks:
            kw = {} if bn is None else {"block_n": bn}
            row(f"#7 Q {nq} W {W}" + ("" if bn is None else f" block_n {bn}"),
                lambda: ops.mbr_scan_cm(level, qn, **kw),
                lambda: ops.mbr_scan_torch(level.T, qn),
                nq * 16 + W * 16 + nq * W)

    def hier_rows(label, inp, nqs, root):
        levels, width = inp["split"] + inp["mbr16"].shape[0], inp["mbr16"].shape[2]
        sp = inp["split"]
        pbytes = inp["parent"].element_size()
        for nq in nqs:
            args8 = (inp["q8"][:nq].contiguous(), inp["q16"][:nq].contiguous(),
                     inp["mbr8"], inp["mbr16"], inp["parent"])
            # queries read, tiles and parents of the tested levels read once,
            # the (L, Q, W) mask written once
            tested = levels - int(root)
            nbytes = (nq * 32 + tested * width * pbytes + (sp - int(root)) * width * 4
                      + (levels - sp) * width * 8 + levels * nq * width)
            variants = [("", {})]
            if takes_n_real:
                variants = [(" n_real", {"n_real": inp["n_real"]}), (" no n_real", {})]
            for tag, kw in variants:
                row(f"#3 {label} Q {nq}{tag}",
                    lambda: ops.level_sweep_hier(*args8, split=sp, root_unconditional=root,
                                                 **kw),
                    lambda: ops.level_sweep_hier_torch(*args8, split=sp,
                                                       root_unconditional=root),
                    nbytes)

    t = tree_inputs(Path(args.cache), args.tree_n)
    t = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in t.items()}
    hier_rows(f"mqr W {t['mbr16'].shape[2]}", t, (256, 16), t["root"])
    levels, width = t["mbr_q"].shape[0], t["mbr_q"].shape[2]
    for nq in (256, 16):
        qq = t["q16"][:nq].contiguous()
        row(f"#1 mqr W {width} Q {nq}",
            lambda: ops.level_sweep(qq, t["mbr_q"], t["parent"]),
            lambda: ops.level_sweep_torch(qq, t["mbr_q"], t["parent"]),
            nq * 16 + (levels - 1) * width * 10 + levels * nq * width)

    q8s = idx.artifacts.quantized8
    pyr = dict(q8=_quantize_queries(q, q8s.origin, q8s.inv_cell8, q8s.cells8),
               q16=_quantize_queries(q, q8s.origin, q8s.inv_cell, q8s.cells),
               mbr8=q8s.mbr_q8, mbr16=q8s.mbr_q[q8s.split:], parent=q8s.parent_q,
               n_real=sched.n_real, split=q8s.split)
    hier_rows(f"pyramid W {W}", pyr, (256,), False)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
