#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s "LLM families" phase alone on a CUDA card.

    python scripts/families_phase_probe.py [--seed 0] [--prefill 4096] [--kv-len 32768]

Builds the port's kernels, then runs ``chip_smoke.families_phase`` (the
configs of ``chip_smoke.FAMILIES`` at full width) and prints its checks,
numbers and the launch counts of each run.  Exits 1 if a check failed.
Needs one CUDA card with 80 GB.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill", type=int, default=4096)
    ap.add_argument("--kv-len", type=int, default=32_768)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import _lib

    if not torch.cuda.is_available():
        print("families_phase_probe: no CUDA device", file=sys.stderr)
        return 1
    t = time.perf_counter()
    _lib.load()
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    card = chip_smoke.nvidia_smi_line()
    print(card, flush=True)
    checks, paths = chip_smoke.Checks(), {}
    checks.phase("LLM families", lambda: chip_smoke.families_phase(
        args, checks, torch.device("cuda", 0), card, paths))
    print("paths " + json.dumps(paths), flush=True)
    print(f"FAILURES {checks.failures}", flush=True)
    return 1 if checks.failures else 0


if __name__ == "__main__":
    sys.exit(main())
