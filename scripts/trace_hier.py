#!/usr/bin/env python3
"""Trace kernel #3 (``level_sweep_hier``) item by item on a CUDA card.

    python scripts/trace_hier.py [--cache build/scan_pair_inputs.pt] [--queries 256,16]
                                 [--pyramid] [--label NAME]

Copies ``src/repro_torch/kernels/csrc`` to ``build/trace_hier/csrc``, adds
the timestamps of ``PATCHES`` to the copy of ``level_sweep.cu`` (each
after an anchor of the source, which must be found once), builds the copy
into its own directory, then runs one call of the persistent sweep on the
mqr-tree inputs that ``scripts/time_scan_pair.py`` saves (run that first),
at each query count, and with ``--pyramid`` on a device-built pyramid of
100,000 uniform squares at Q 256 (narrow enough for the persistent grid).
Every item records, on the card's global timer, when its block took it,
when its tile was staged, when its parents' flags were all set and when
it was stored (and when thread 0 ended its own windows).  Prints, per
level: the spread of those times (µs from the first claim), the timeline
of the item that finished last (the level's critical item) and its SM,
and the median, 90th percentile and largest of an item's sweep time
(stored minus ready).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SLOTS = 8  # int64 words an item: 4 times, the SM, thread 0's sweep end, 2 spare

# (anchor, text put after it) in level_sweep.cu: item i records at
# g_hier_trace[8 i + k] the global timer when its block took it (0), staged
# its tile (1), found its parents stored (2) and stored it (3), its SM (4)
# and when thread 0 ended its own windows (5).
PATCHES = (
    ("constexpr int WIDE_WINDOW = 8;  // windows wider than this many tiles use the scan\n",
     "__device__ unsigned long long* g_hier_trace = nullptr;\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "  return t;\n"
     "}\n"),
    ("  const unsigned int* parents_done;\n", "  unsigned long long* trace;\n"),
    ("  __syncthreads();  // sq, stile, spar and sbox are filled\n",
     "  if (a.trace != nullptr && threadIdx.x == 0) a.trace[1] = gtime();\n"),
    ("    __syncthreads();  // the parents' items are stored: `prev` may be read\n  }\n",
     "  if (a.trace != nullptr && threadIdx.x == 0) a.trace[2] = gtime();\n"),
    ("      put(row, tw - s, window(tw - s, box_r, qi, q));\n  }\n",
     "  if (HIER && a.trace != nullptr && threadIdx.x == 0) a.trace[5] = gtime();\n"),
    ("    a.parents_done = l > 0 ? done + (size_t)(l - 1) * h.per_level : nullptr;\n",
     "    a.trace = g_hier_trace != nullptr ? g_hier_trace + 8 * item : nullptr;\n"
     "    if (a.trace != nullptr && threadIdx.x == 0) {\n"
     "      a.trace[0] = gtime();\n"
     "      unsigned int sm;\n"
     '      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));\n'
     "      a.trace[4] = sm;\n"
     "    }\n"),
    ("    __syncthreads();  // every store of the item is made\n",
     "    if (a.trace != nullptr && threadIdx.x == 0) a.trace[3] = gtime();\n"),
    ('extern "C" {\n',
     "int repro_hier_set_trace(void* buf) {\n"
     "  return (int)cudaMemcpyToSymbol(g_hier_trace, &buf, sizeof(buf));\n"
     "}\n"),
)


def traced_sources() -> Path:
    """A copy of the kernel sources with the timestamps of PATCHES in
    ``level_sweep.cu``; returns its directory."""
    src = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    out = ROOT / "build" / "trace_hier" / "csrc"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(src, out)
    path = out / "level_sweep.cu"
    text = path.read_text()
    for anchor, add in PATCHES:
        if text.count(anchor) != 1:
            raise SystemExit(f"trace_hier: anchor not found once in level_sweep.cu: {anchor!r}")
        text = text.replace(anchor, anchor + add)
    path.write_text(text)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cache", default=str(ROOT / "build" / "scan_pair_inputs.pt"))
    ap.add_argument("--queries", default="256,16")
    ap.add_argument("--pyramid", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_hier: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from repro_torch.kernels import _lib

    _lib.CSRC = traced_sources()  # the library is keyed by its sources
    import chip_smoke as cs
    from repro_torch import SpatialIndex
    from repro_torch.core import datasets
    from repro_torch.kernels import ops
    from repro_torch.kernels.pyramid_scan import _quantize_queries

    lib = _lib.load()
    set_trace = lib.repro_hier_set_trace
    set_trace.restype, set_trace.argtypes = ctypes.c_int, [ctypes.c_void_p]
    dev = cs.card_device()
    print(cs.nvidia_smi_line(), flush=True)

    def trace(name, call, levels):
        buf = torch.zeros(SLOTS * 1_000_000, dtype=torch.int64, device=dev)
        call()
        cs.sync()
        _lib.check(set_trace(buf.data_ptr()), "repro_hier_set_trace")
        call()
        cs.sync()
        _lib.check(set_trace(None), "repro_hier_set_trace")
        t = buf.view(-1, SLOTS).cpu().numpy().astype(np.float64)
        n = int((t[:, 0] > 0).sum())
        per = n // levels
        t = t[:n]
        g = (t[:, :4] - t[:, 0].min()) / 1e3
        own = (t[:, 5] - t[:, 0].min()) / 1e3
        print(f"{name} {args.label}: {n} items, {per} a level, "
              f"{g[:, 3].max():.1f} µs from the first claim to the last store", flush=True)
        print("   l | claim min max | ready min max | stored min max | critical item: "
              "claim staged ready thread-0-swept stored SM | sweep µs med p90 max", flush=True)
        for l in range(levels):
            x = g[l * per:(l + 1) * per]
            sweep = x[:, 3] - x[:, 2]
            i = int(np.argmax(x[:, 3]))
            print(f"  {l:2d} | {x[:, 0].min():6.1f} {x[:, 0].max():6.1f} | {x[:, 2].min():6.1f} "
                  f"{x[:, 2].max():6.1f} | {x[:, 3].min():6.1f} {x[:, 3].max():6.1f} | "
                  f"{x[i, 0]:6.1f} {x[i, 1]:6.1f} {x[i, 2]:6.1f} {own[l * per + i]:6.1f} "
                  f"{x[i, 3]:6.1f} "
                  f"{int(t[l * per + i, 4]):3d} | {np.median(sweep):5.2f} "
                  f"{np.percentile(sweep, 90):5.2f} {sweep.max():5.2f}", flush=True)

    inp = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
           for k, v in torch.load(args.cache).items()}
    levels = inp["split"] + inp["mbr16"].shape[0]
    for nq in (int(v) for v in args.queries.split(",")):
        hier = (inp["q8"][:nq].contiguous(), inp["q16"][:nq].contiguous(), inp["mbr8"],
                inp["mbr16"], inp["parent"])
        trace(f"mqr-tree W {inp['mbr16'].shape[2]} Q {nq}",
              lambda: ops.level_sweep_hier(*hier, split=inp["split"], n_real=inp["n_real"],
                                           root_unconditional=inp["root"]), levels)
    if args.pyramid:
        data = datasets.uniform_squares(100_000, seed=0)
        q = torch.from_numpy(datasets.region_queries(data, 256, seed=0).astype(np.float32))
        idx = SpatialIndex.build(data, structure="pyramid", build="device", **cs.FIXED)
        q8 = idx.artifacts.quantized8
        q = q.to(dev)
        hier = (_quantize_queries(q, q8.origin, q8.inv_cell8, q8.cells8),
                _quantize_queries(q, q8.origin, q8.inv_cell, q8.cells),
                q8.mbr_q8, q8.mbr_q[q8.split:], q8.parent_q)
        trace(f"pyramid W {idx.schedule.width} Q 256",
              lambda: ops.level_sweep_hier(*hier, split=q8.split, root_unconditional=False,
                                           n_real=idx.schedule.n_real), idx.schedule.levels)
    return 0


if __name__ == "__main__":
    sys.exit(main())
