#!/usr/bin/env python3
"""Time kernel #5 (``quantize_cm``) of one source tree on a CUDA card, so
that two trees can be compared in one run.

    python scripts/time_quantize_pair.py [--src src] [--label new] [--n 1000000]
                                         [--tree-n 50000]
                                         [--cache build/quantize_pair_inputs.pt]

Run it once per tree (each in its own process, since each tree has its own
``repro_torch``), in turns on one card: parent, change, change, parent.
The mqr-tree and the R-tree are built on the host (pure Python, about a
minute at 50,000 objects; both at once, in worker processes), so the
first process saves their level schedules to ``--cache`` and the others
load them.

Rows, each on the pyramid of a device build over ``uniform_squares(n)``
(11 levels of 1e6 slots at the default n) or on a tree's schedule:

* the uint16 tiles without ``n_real``, and with the schedule's ``n_real``
  where the tree's ``quantize_cm`` takes it (its padding written unread):
  the pyramid, the mqr-tree (11, 4, 13,534) and the R-tree (9, 4, 14,237);
* the compact8 pass on the pyramid: the uint16 tiles of every level and
  the uint8 tiles of the upper L - 1; one launch where the tree's
  ``quantize_cm`` takes ``split``, else its launch and the plain uint8
  pass its ``quantize_schedule(upper8=True)`` ran;
* ``quantize_schedule`` whole on the pyramid, compact and compact8: every
  device activity of the call (the grid's reductions, the parent cast and
  the confirm gather too).

Each row: the outputs against the plain version, the device time (the
profiler's, mean of 7 calls after a warm-up; ``timed_by`` says ``events``
where every trace lost activities and CUDA events stand in), one call's
CUDA-event window (median of 7; it also holds the wrapper's host time),
one fill (``zero_()``) of the same output bytes, and two byte bounds at
3.35 TB/s: ``dense_bound_ms`` (every slot read once, every output byte
written once) and ``bound_ms`` (the real slots read, every output byte
written: what the kernel with ``n_real`` must move).  Prints the card's
name and power limit and one JSON line, ``{"label": ..., "rows": [...]}``.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
TREES = ("mqr", "rtree")


def tree_fields(cache: Path, tree_n: int) -> dict:
    """Each tree's level-schedule fields (CPU tensors and scalars): built
    in worker processes and saved on the first call, loaded after."""
    if cache.exists():
        return torch.load(cache)
    import numpy as np

    import chip_smoke as cs

    with ProcessPoolExecutor(max_workers=len(TREES),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {s: pool.submit(cs.second_tree_build, s, tree_n, 0) for s in TREES}
        fields = {s: {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                      for k, v in f.result()[1].items()}
                  for s, f in futures.items()}
    cache.parent.mkdir(parents=True, exist_ok=True)
    torch.save(fields, cache)
    return fields


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="")
    ap.add_argument("--n", type=int, default=1_000_000, help="pyramid objects")
    ap.add_argument("--tree-n", type=int, default=50_000, help="objects of each tree")
    ap.add_argument("--cache", default=str(ROOT / "build" / "quantize_pair_inputs.pt"),
                    help="the trees' saved level schedules")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_quantize_pair: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import SpatialIndex
    from repro_torch.core import datasets
    from repro_torch.core.flat import CELLS8, LevelSchedule
    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels import quantize as qmod

    dev = cs.card_device()
    card = cs.nvidia_smi_line()
    print(card, flush=True)
    _lib.load()
    takes_n_real = "n_real" in inspect.signature(ops.quantize_cm).parameters
    out = {"label": args.label, "src": args.src, "card": card,
           "takes_n_real": takes_n_real, "rows": []}

    def tensors(r):
        if isinstance(r, torch.Tensor):
            return (r,)
        if isinstance(r, tuple):
            return r
        return tuple(t for t in (r.mbr_q, r.mbr_q8) if t is not None)

    def row(name, fn, plain_fn, dense_bytes, nbytes):
        got, want = tensors(fn()), tensors(plain_fn())
        equal = len(got) == len(want) and all(map(cs.same, got, want))
        fill_ms = cs.device_ms(lambda: [o.view(torch.uint8).zero_() for o in got])
        del got, want
        ms, timed_by = cs.device_timing(fn)
        window_ms = cs.time_ms(fn)
        dense = dense_bytes / cs.PEAK_BYTES_PER_S * 1e3
        bound = nbytes / cs.PEAK_BYTES_PER_S * 1e3
        out["rows"].append(dict(name=name, equal=equal, ms=ms, timed_by=timed_by,
                                window_ms=window_ms, fill_ms=fill_ms,
                                dense_bound_ms=dense, bound_ms=bound))
        print(f"  {name}: {ms:.4f} ms by {timed_by}, window {window_ms:.4f} ms, fill "
              f"{fill_ms:.4f} ms; bounds {bound:.4f} ms ({bound / ms:.0%}), dense "
              f"{dense:.4f} ms ({dense / ms:.0%}); equal {equal} ({args.label})", flush=True)

    def plain(cm, origin, inv, split=None, inv8=None):
        """The plain uint16 tiles, and the uint8 ones of levels [0, split)."""
        if split is None:
            return qmod.quantize_cm_torch(cm, origin, inv)
        if takes_n_real:
            return qmod.quantize_cm_torch(cm, origin, inv, split=split, inv_cell8=inv8)
        return (qmod.quantize_cm_torch(cm, origin, inv),
                qmod.quantize_cm_torch(cm[:split], origin, inv8, cells=CELLS8,
                                       dtype=torch.uint8))

    def bounds(sched, split=0):
        """Bytes of the dense bound and of the n_real one (see above)."""
        levels, _, width = sched.mbr_cm.shape
        written = levels * 4 * width * 2 + split * 4 * width
        return (levels * 4 * width * 4 + written,
                int(sched.n_real.sum()) * 16 + written + levels * 4)

    def tile_rows(label, sched):
        cm, n_real = sched.mbr_cm, sched.n_real
        levels, _, width = cm.shape
        origin, inv = qmod.grid_params(sched)
        dense, real = bounds(sched)
        row(f"{label} (L {levels}, W {width}) uint16, no n_real",
            lambda: ops.quantize_cm(cm, origin, inv), lambda: plain(cm, origin, inv),
            dense, dense)
        if takes_n_real:
            row(f"{label} (L {levels}, W {width}) uint16, n_real",
                lambda: ops.quantize_cm(cm, origin, inv, n_real=n_real),
                lambda: plain(cm, origin, inv), dense, real)
        return origin, inv

    data = datasets.uniform_squares(args.n, seed=0)
    idx = SpatialIndex.build(data, structure="pyramid", build="device", **cs.FIXED)
    sched = idx.schedule
    origin, inv = tile_rows("pyramid", sched)
    cm, n_real = sched.mbr_cm, sched.n_real
    levels = cm.shape[0]
    split = levels - 1
    _, inv8 = qmod.grid_params(sched, cells=CELLS8)
    if takes_n_real:
        def compact8():
            return ops.quantize_cm(cm, origin, inv, n_real=n_real, split=split,
                                   inv_cell8=inv8)
    else:  # the kernel, then the plain uint8 pass of its quantize_schedule
        def compact8():
            return (ops.quantize_cm(cm, origin, inv),
                    qmod.quantize_cm_torch(cm[:split], origin, inv8, cells=CELLS8,
                                           dtype=torch.uint8))
    row(f"pyramid compact8 pass (uint16 L {levels} + uint8 L {split})", compact8,
        lambda: plain(cm, origin, inv, split, inv8), *bounds(sched, split))
    for label, kw, sp in (("compact", {}, 0), ("compact8", {"upper8": True}, split)):
        row(f"pyramid quantize_schedule {label} (whole call)",
            lambda: ops.quantize_schedule(sched, **kw),
            lambda: ops.quantize_schedule(sched, engine="torch", **kw), *bounds(sched, sp))

    for structure, fields in tree_fields(Path(args.cache), args.tree_n).items():
        tile_rows(structure, LevelSchedule(**fields).to(dev))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
