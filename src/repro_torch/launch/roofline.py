"""Roofline analysis over the dry-run JSONs (DESIGN.md §4.2), for the H100.

Counterpart of ``repro.launch.roofline``: the same maths and columns, with
the card's constants in place of the TPU's.  Hardware model: NVIDIA H100
SXM (the card ``chip_smoke.py`` reports: H100 80GB HBM3 at 700 W), from
NVIDIA's H100 SXM figures — 989 TFLOP/s dense bf16, 3.35 TB/s of HBM3,
450 GB/s a direction over NVLink 4.

Per (arch x shape x mesh) cell:
  compute term    = FLOPs_global / (chips * peak)       [seconds/step]
  memory term     = bytes_global / (chips * HBM_bw)
  collective term = wire_bytes_per_device / link_bw
(the records hold per-device numbers; global = x chips.  ``--mesh card``
 records have no collectives; the production meshes' records hold the
 collectives the sharded step issued, counted by ``launch.op_cost``.)

Also reports MODEL_FLOPS / counted FLOPs (useful-compute fraction: catches
remat recompute and masked-attention waste) and the bound term.  Records of
cells that do not run sharded yet (``cost`` null: the mqr-KV sparse decode;
ROADMAP A4d) print in a separate "fits per device" table of argument bytes.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List

PEAK_FLOPS = 989e12     # bf16 dense / card (NVIDIA H100 SXM)
HBM_BW = 3.35e12        # bytes/s / card (HBM3, NVIDIA H100 SXM)
LINK_BW = 450e9         # bytes/s / direction (NVLink 4, NVIDIA H100 SXM)
CARD_BYTES = 80e9       # device memory of the H100 80GB


def load_cells(dry_dir: str, tag: str = "") -> List[Dict]:
    out = []
    for p in sorted(pathlib.Path(dry_dir).glob("*.json")):
        rec = json.loads(p.read_text())
        if (rec.get("tag") or "") != tag:
            continue
        out.append(rec)
    return out


def analyze(rec: Dict) -> Dict:
    chips = rec["n_devices"]
    flops_dev = rec["cost"]["flops_per_device"]
    bytes_dev = rec["cost"]["bytes_accessed_per_device"]
    wire_dev = rec["collectives"]["total_wire_bytes"]
    t_compute = flops_dev * chips / (chips * PEAK_FLOPS)
    t_memory = bytes_dev * chips / (chips * HBM_BW)
    t_coll = wire_dev / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bound = max(terms, key=terms.get)
    model_flops = rec.get("model_flops", 0)
    hlo_global = flops_dev * chips
    useful = model_flops / hlo_global if hlo_global > 0 else float("nan")
    # roofline fraction: useful model flops per chip-second at the bound
    step_time = max(terms.values())
    mfu = model_flops / (chips * PEAK_FLOPS * step_time) if step_time > 0 else 0.0
    return {
        **rec,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bound": bound,
        "useful_flops_ratio": useful,
        "roofline_mfu": mfu,
        "peak_gib": rec["memory"]["peak_bytes_per_device"] / 2**30,
    }


def table(cells: List[Dict]) -> str:
    rows = [
        "| arch | shape | mesh | compute s | memory s | collective s | bound "
        "| useful/counted | roofline-MFU | peak GiB/dev |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c.get("cost") is None:
            continue
        a = analyze(c)
        rows.append(
            f"| {a['arch']} | {a['shape']} | {a['mesh']} "
            f"| {a['t_compute_s']:.3e} | {a['t_memory_s']:.3e} "
            f"| {a['t_collective_s']:.3e} | **{a['bound']}** "
            f"| {a['useful_flops_ratio']:.2f} | {a['roofline_mfu']:.3f} "
            f"| {a['peak_gib']:.2f} |"
        )
    return "\n".join(rows)


def fits_table(cells: List[Dict]) -> str:
    """Records without a step cost (the production meshes): per-device
    argument bytes and whether they fit one card's 80 GB."""
    rows = [
        "| arch | shape | mesh | devices | params GiB/dev | moments GiB/dev | batch GiB/dev "
        "| caches GiB/dev | arguments GiB/dev | fit 80 GB |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c.get("cost") is not None:
            continue
        m = c["memory"]

        def gib(key):
            return f"{m[key] / 2**30:.3f}" if key in m else "-"

        fits = "yes" if m["argument_bytes_per_device"] <= CARD_BYTES else "no"
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | {c['n_devices']} "
            f"| {gib('params_bytes_per_device')} | {gib('moments_bytes_per_device')} "
            f"| {gib('batch_bytes_per_device')} | {gib('cache_bytes_per_device')} "
            f"| {gib('argument_bytes_per_device')} | {fits} |"
        )
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Roofline of the dry-run records (H100)")
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args(argv)
    cells = load_cells(args.dir, args.tag)
    if args.csv:
        print("arch,shape,mesh,t_compute,t_memory,t_collective,bound,"
              "useful_ratio,roofline_mfu,peak_gib")
        for c in cells:
            if c.get("cost") is None:
                continue
            a = analyze(c)
            print(
                f"{a['arch']},{a['shape']},{a['mesh']},{a['t_compute_s']:.4e},"
                f"{a['t_memory_s']:.4e},{a['t_collective_s']:.4e},{a['bound']},"
                f"{a['useful_flops_ratio']:.3f},{a['roofline_mfu']:.4f},"
                f"{a['peak_gib']:.2f}"
            )
    else:
        print(table(cells))
        if any(c.get("cost") is None for c in cells):
            print("\nfits per device (cells whose step does not run sharded yet):\n")
            print(fits_table(cells))


if __name__ == "__main__":
    main()
