#!/usr/bin/env python3
"""Time kernels #4 (``build_levels``) and #6 (``pair_sweep``) of one source
tree on a CUDA card, so that two trees can be compared in one run.

    python scripts/time_build_pair.py [--src src] [--n 1000000] [--label new]

Run it once per tree (each in its own process, since each tree has its own
``repro_torch``), in turns on one card: parent, change, change, parent.

* #4: one ``build_levels`` call over ``uniform_squares(n)`` at the default
  depth, its device time by level and kernel (``chip_smoke.build_breakdown``)
  and in all (``chip_smoke.device_ms``), and its four arrays against
  ``build_levels_torch`` (float arrays by their bits).
* #6: the pair mask between device-built pyramids at the widths of the
  join path's trees (13,534 and 14,237) and of its wide side (50,000
  exponential squares), float32, uint16 (joint grid) and the symmetric
  self-join, and a 1e6 pyramid against 3 zones (the moving path's narrow
  side); device time against the plain version's mask, and one fill
  (``zero_()``) of the same bytes.

Prints one JSON line, ``{"label": ..., "build": ..., "pair": ...}``.  Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--n", type=int, default=1_000_000, help="objects of #4's build")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_build_pair: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import SpatialIndex
    from repro_torch.core import bulk, datasets
    from repro_torch.index.join import lower_join
    from repro_torch.kernels import _lib, ops

    dev = cs.card_device()
    card = cs.nvidia_smi_line()
    _lib.load()
    out = {"label": args.label, "src": args.src, "card": card}

    obj = torch.from_numpy(datasets.uniform_squares(args.n, seed=0).astype("float32")).to(dev)
    levels = bulk.default_levels(args.n)
    got = ops.build_levels(obj, levels=levels)
    want = ops.build_levels_torch(obj, levels=levels)
    rows, names = cs.build_breakdown(lambda: ops.build_levels(obj, levels=levels), levels)
    cs.print_breakdown(rows, names, f"#4 at n {args.n}, L {levels} ({args.label})")
    out["build"] = dict(
        n=args.n, levels=levels, equal=all(bits_equal(a, b) for a, b in zip(got, want)),
        ms=cs.device_ms(lambda: ops.build_levels(obj, levels=levels)),
        launches=sum(c for r in rows for _, c in r.values()),
        by_level=[{k: round(t, 2) for k, (t, _) in r.items()} for r in rows])
    del got, want

    def pyramid(d, **kw):
        return SpatialIndex.build(d, structure="pyramid", build="device", **kw)

    a = pyramid(datasets.uniform_squares(13_534, seed=1))
    b = pyramid(datasets.uniform_squares(14_237, seed=2))
    e = pyramid(datasets.exponential_squares(50_000, seed=2))
    big = pyramid(datasets.uniform_squares(args.n, seed=3))
    zones = pyramid(datasets.uniform_squares(3, seed=4))
    out["pair"] = {}
    for label, left, right in (
            ("f32 13,534 x 14,237", a, b),
            ("u16 13,534 x 14,237", a.with_backend("cuda", precision="compact"), b),
            ("sym 13,534", a, a),
            ("f32 50,000 x 13,534", e, a),
            (f"f32 {args.n} x 3", big, zones)):
        jargs, k, sym = lower_join(left, right)
        sweep = (jargs[0], jargs[1], jargs[5], jargs[6])
        mask = ops.pair_sweep(*sweep, symmetric=sym)
        equal = bits_equal(mask, ops.pair_sweep_torch(*sweep, symmetric=sym))
        ms = cs.device_ms(lambda: ops.pair_sweep(*sweep, symmetric=sym))
        fill_ms = cs.device_ms(mask.zero_)
        out["pair"][label] = dict(k=k, wa=sweep[0].shape[2], wb=sweep[2].shape[2],
                                  equal=equal, ms=ms, fill_ms=fill_ms)
        print(f"  #6 {label} (K {k}): {ms:.4f} ms, fill {fill_ms:.4f} ms, "
              f"equal {equal} ({args.label})", flush=True)
        del mask
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
