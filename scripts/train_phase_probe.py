#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s training phase and the checks of the backward
kernels of #8 and #10 alone on a CUDA card.

    python scripts/train_phase_probe.py [--seed 0] [--ptxas] [--no-train]

Builds the port's kernels (``--ptxas`` also prints nvcc's register and
shared-memory report for ``csrc/flash_attention_bwd.cu`` and
``csrc/rmsnorm_bwd.cu``), runs ``chip_smoke.train_phase`` (llama3.2-1B at
full width: ten train steps, a checkpoint and resume, an EF-int8 step, a
float32 step against the CPU) unless ``--no-train``, then
``chip_smoke.grad_kernel_checks`` (the two backward kernels against
autograd of their plain versions, timed beside their bounds and the
PyTorch library calls' backward).  Prints every check, number and launch
count; exits 1 if a check failed.  Needs one CUDA card with 80 GB.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--no-train", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import _lib

    if not torch.cuda.is_available():
        print("train_phase_probe: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.nvidia_smi_line()
    print(card, flush=True)
    if args.ptxas:
        for src in ("flash_attention_bwd.cu", "rmsnorm_bwd.cu", "flash_attention.cu"):
            out = subprocess.run(
                [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_lib.CSRC), "-c",
                 str(_lib.CSRC / src), "-o", "/dev/null"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log = ROOT / "build" / f"ptxas_{src}.txt"
            log.parent.mkdir(exist_ok=True)
            log.write_text(out.stdout)
            keep = [ln for ln in out.stdout.splitlines()
                    if "error" in ln or "Compiling entry" in ln or "Used" in ln
                    or "spill" in ln]
            print(f"== {src} (rc {out.returncode}; the whole log in {log})\n"
                  + "\n".join(keep), flush=True)
    t = time.perf_counter()
    _lib.load()
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    checks, paths, res = chip_smoke.Checks(), {}, {}
    dev = chip_smoke.card_device()
    t = time.perf_counter()
    if not args.no_train:
        checks.phase("training (llama3.2-1B, full width)", lambda: res.update(
            chip_smoke.train_phase(args, checks, dev, card, paths)))
    print(f"training phase {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    rows = checks.phase("backward kernels vs autograd of the plain versions",
                        lambda: chip_smoke.grad_kernel_checks(
                            checks, dev, args.seed, chip_smoke.train_launches(paths)))
    print(f"backward kernel phase {time.perf_counter() - t:.1f} s", flush=True)
    print("train " + json.dumps(res), flush=True)
    print("paths " + json.dumps(paths), flush=True)
    print(json.dumps({"kernels": rows or []}), flush=True)
    print(f"FAILURES {checks.failures}", flush=True)
    return 1 if checks.failures else 0


if __name__ == "__main__":
    sys.exit(main())
