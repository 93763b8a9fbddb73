#!/usr/bin/env python3
"""Hold kernel #9 at ``group=1`` of one source tree to another's bit for
bit, and run ``chip_smoke.py``'s LLM serving phase alone, on a CUDA card.

    python scripts/llm_phase_probe.py --src build/parent/src --label parent
    python scripts/llm_phase_probe.py --src src --label new --compare parent --llm

Each process builds its tree's kernels, runs #9 (``ops.mqr_sparse_attention``,
no ``group`` argument) on 12 fixed seeded inputs (float32 and bfloat16; rows
of 128, 6 and 3; ids inside and outside [0, nb); two causal limits) and
saves the outputs to ``chiprun_out/g1_<label>.pt``; ``--compare`` loads
another label's file and prints whether every output is bit-identical.
``--llm`` then runs ``chip_smoke.llm_phase`` at its defaults (llama3.2-1B at
full width, 32,768-token caches, prefill 4,096) and prints its checks,
launch counts and numbers.  Needs one CUDA card.
"""
import argparse
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def group1_outputs(ops, dev) -> dict:
    """#9 at group 1 on fixed seeded inputs, keyed by dtype, rows and pos."""
    import torch

    outs = {}
    for dt in (torch.bfloat16, torch.float32):
        for bh, nb, bs, d, k in ((128, 256, 128, 64, 64), (6, 9, 128, 128, 5),
                                 (3, 4, 32, 16, 7)):
            g = torch.Generator(device=dev).manual_seed(bh + nb + d)
            q = torch.randn((bh, d), generator=g, device=dev).to(dt)
            kb = torch.randn((bh, nb, bs, d), generator=g, device=dev).to(dt)
            vb = torch.randn((bh, nb, bs, d), generator=g, device=dev).to(dt)
            ids = torch.randint(-2, nb + 2, (bh, k), generator=g, device=dev,
                                dtype=torch.int32)
            for pos in (nb * bs - 37, nb * bs // 2):
                outs[f"{dt}-{bh}-{pos}"] = ops.mqr_sparse_attention(q, kb, vb, ids, pos).cpu()
    return outs


def bits(t):
    import torch

    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default="src", help="the source tree's src directory")
    ap.add_argument("--label", default="new")
    ap.add_argument("--compare", default=None, help="a label saved by an earlier run")
    ap.add_argument("--llm", action="store_true", help="also run the LLM serving phase")
    args = ap.parse_args(argv)
    sys.path.insert(0, str((ROOT / args.src).resolve()))
    import torch

    from repro_torch.kernels import _lib, ops

    t = time.perf_counter()
    _lib.load()
    print(f"[{args.label}] build + load {time.perf_counter() - t:.1f} s from {_lib.CSRC}",
          flush=True)
    dev = torch.device("cuda", 0)
    outs = group1_outputs(ops, dev)
    torch.cuda.synchronize()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    torch.save(outs, out_dir / f"g1_{args.label}.pt")
    print(f"[{args.label}] saved {len(outs)} #9 outputs", flush=True)
    ok = True
    if args.compare:
        other = torch.load(out_dir / f"g1_{args.compare}.pt")
        ok = all(torch.equal(bits(outs[k]), bits(other[k])) for k in outs)
        print(f"[{args.label}] #9 group=1 bit-identical to {args.compare}: {ok}", flush=True)
    if args.llm:
        sys.path.insert(0, str(ROOT))
        import chip_smoke as cs

        card = cs.nvidia_smi_line()
        print(card, flush=True)
        checks = cs.Checks()
        paths = {}
        phase_args = types.SimpleNamespace(seed=0, kv_len=32768, prefill=4096)
        res = checks.phase("LLM serving (llama3.2-1B, full width)",
                           lambda: cs.llm_phase(phase_args, checks, dev, card, paths))
        print("paths", paths, flush=True)
        print({k: v for k, v in (res or {}).items() if isinstance(v, (int, float))}, flush=True)
        print("FAILURES", checks.failures, flush=True)
        ok &= not checks.failures
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
