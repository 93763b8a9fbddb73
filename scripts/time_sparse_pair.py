#!/usr/bin/env python3
"""Time kernel #9 (``mqr_sparse_attention``) of one source tree on a CUDA
card, so that two trees can be compared in one run.

    python scripts/time_sparse_pair.py [--src src] [--label new] [--seed 0]

Run it once per tree (each in its own process, since each tree has its own
``repro_torch``), in turns on one card: parent, change, change, parent.

Rows, all at a 32,768-token context (256 blocks of 128 keys), pos 32,731,
64 ids a query row, random inputs from ``--seed`` (the same in every
tree):

* ``g1_bf16``, ``g1_f32``: 128 query rows, each with its own kv row (the
  kernel phase's rows of ``chip_smoke.py``: kv copied per head), head dim
  64, 64 distinct ids a row.
* ``g4_bf16``: llama3.2-1B's decode shape, 128 query rows over 32 kv rows
  read in place (group 4), head dim 64, each kv row's 4 heads picking 64 of
  the same 98 blocks (about 3,100 distinct (kv row, block) pairs, as the
  model's ids give).
* ``g2_d128``, ``g4_d128``, ``g8_d128``, ``g8_d256``: internvl2-2b,
  granite-8b, command-r-35b and gemma-2b at B 4 (a tree whose kernel does
  not take the shape prints its error).

Each row: device time (``chip_smoke.device_timing``), the bound (distinct
(kv row, block) pairs read once, k and v, over 3.35 TB/s) and the worst
error over ``chip_smoke.worst_over_limit``'s limit against the plain
version.  Prints one JSON line, ``{"label": ..., "rows": ...}``.  Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
S, BS, K, HEAD_DIM = 32768, 128, 64, 64
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 3e-2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_sparse_pair: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _lib, ops

    dev = cs.card_device()
    _lib.load()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    nb, pos = S // BS, S - 37

    def randn(*shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def perm(n, k):
        return torch.randperm(n, generator=gen, device=dev)[:k]

    def pooled_ids(kv_rows, group, pool):
        """Each kv row's ``group`` heads pick K blocks of the same ``pool``."""
        rows = []
        for _ in range(kv_rows):
            p = perm(nb, pool)
            rows += [p[perm(pool, K)] for _ in range(group)]
        return torch.stack(rows).to(torch.int32)

    def inputs(kv_rows, group, d, dt, pool):
        kb, vb = randn(kv_rows, nb, BS, d, dt=dt), randn(kv_rows, nb, BS, d, dt=dt)
        q = randn(kv_rows * group, d, dt=dt)
        ids = (pooled_ids(kv_rows, group, pool) if pool else
               torch.stack([perm(nb, K) for _ in range(kv_rows * group)]).to(torch.int32))
        return q, kb, vb, ids, group

    shapes = {
        "g1_bf16": (128, 1, HEAD_DIM, torch.bfloat16, 0),
        "g1_f32": (128, 1, HEAD_DIM, torch.float32, 0),
        "g4_bf16": (32, 4, HEAD_DIM, torch.bfloat16, 98),
        "g2_d128": (32, 2, 128, torch.bfloat16, 96),
        "g4_d128": (32, 4, 128, torch.bfloat16, 98),
        "g8_d128": (32, 8, 128, torch.bfloat16, 192),
        "g8_d256": (4, 8, 256, torch.bfloat16, 192),
    }
    out = {"label": args.label, "src": args.src, "card": cs.nvidia_smi_line(), "rows": {}}
    for name, shape in shapes.items():
        q, kb, vb, ids, group = inputs(*shape)
        bh, d = q.shape
        kv = torch.arange(bh, device=dev)[:, None] // group
        pairs = int(torch.unique(kv * nb + ids.long()).numel())
        es = q.element_size()
        bound = (pairs * 2 * BS * d * es + bh * (2 * d * es + K * 4)) / cs.PEAK_BYTES_PER_S * 1e3
        row = {"pairs": pairs, "bound_ms": bound}
        try:
            got = ops.mqr_sparse_attention(q, kb, vb, ids, pos, group=group)
            want = ops.mqr_sparse_attention_torch(q, kb, vb, ids, pos, group=group)
            row["worst_over_limit"] = cs.worst_over_limit(got, want, *TOL[q.dtype])
            row["ms"], row["timed_by"] = cs.device_timing(
                lambda: ops.mqr_sparse_attention(q, kb, vb, ids, pos, group=group))
            row["share"] = bound / row["ms"]
        except (ValueError, RuntimeError) as e:
            row["error"] = str(e)
        out["rows"][name] = row
        print(f"  {args.label} {name}: {row}", flush=True)
        del q, kb, vb, ids
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
