"""Open-loop load-sweep CLI for the spatial serving front end.

Counterpart of ``repro.launch.loadgen``.  THE serving entry point is
:mod:`repro_torch.serve` (``ServingFrontEnd``); this CLI builds a demo
tenant registry on the card (``--device cpu`` runs the kernels' plain
versions instead; without a card and without it, building raises),
sweeps offered QPS through :mod:`repro_torch.serve.loadgen`, prints the
latency-vs-load curve, and (``--write-bench``) merges the rows into
``BENCH_<date>.json`` at the repo root:

  PYTHONPATH=src python -m repro_torch.launch.loadgen \
      --qps 50,150,400 --duration 2 --n 4096 --backend serve

``--backend`` takes the port's names (``serve``, ``cuda``, ``torch``,
``host``).  ``REPRO_BENCH_TINY=1`` shrinks everything to smoke-test
sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.obs import counters as obs_counters
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import ServerConfig, ServingFrontEnd
from repro_torch.serve.loadgen import run_sweep, write_bench_rows

TINY = os.environ.get("REPRO_BENCH_TINY") == "1"


def demo_dataset(n: int, *, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = rng.random((n, 2)).astype(np.float32) * 100.0
    wh = (rng.random((n, 2)).astype(np.float32) * 0.5 + 0.05)
    return np.concatenate([c, c + wh], axis=1)


def build_sweep(args, last_front=None):
    """``make_front`` factory for :func:`run_sweep`.

    ``last_front`` is an optional one-element list: run_sweep builds a
    FRESH front per QPS level, so the cell captures whichever front ran
    last — the one ``--metrics-out`` snapshots after the sweep.
    """
    data = {"demo": demo_dataset(args.n)}
    cfg = ServerConfig.from_dict({
        "tenants": [{
            "name": "demo",
            "structure": args.structure,
            "backend": args.backend,
        }],
        "query_block": args.query_block,
        "classes": [
            {"name": "interactive", "deadline_ms": args.deadline_ms,
             "overload": "shed", "max_queue": args.max_queue},
        ],
    })

    def make_front():
        front = ServingFrontEnd.build(cfg, data, device=args.device)
        if last_front is not None:
            last_front[0] = front
        return front, "demo"

    return make_front


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--qps", default="25,100,400" if TINY else "50,200,800")
    p.add_argument("--duration", type=float, default=0.4 if TINY else 2.0)
    p.add_argument("--n", type=int, default=256 if TINY else 8192)
    p.add_argument("--structure", default="mqr")
    p.add_argument("--backend", default="serve")
    p.add_argument("--query-block", type=int, default=8 if TINY else 16)
    p.add_argument("--deadline-ms", type=float, default=50.0)
    p.add_argument("--max-queue", type=int, default=64 if TINY else 1024)
    p.add_argument("--knn-every", type=int, default=0,
                   help="every n-th request becomes a knn query")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="'cpu' for the kernels' plain versions (default: the card)")
    p.add_argument("--write-bench", action="store_true",
                   help="merge rows into BENCH_<date>.json at the repo root")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="record spans and export a Chrome/Perfetto "
                        "trace.json of the sweep")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write the last front's Prometheus metrics "
                        "snapshot (PATH and PATH + '.json')")
    args = p.parse_args(argv)
    args.device = ops.resolve_device(args.device)  # no card: raises, never the CPU
    name = torch.cuda.get_device_name(args.device) if args.device.type == "cuda" else "host"
    print(f"# device {args.device} ({name})", file=sys.stderr)

    if args.trace_out:
        obs_trace.enable()
        obs_counters.collect_launch_reports(True)

    levels = [float(x) for x in args.qps.split(",")]
    last_front = [None]
    rows = run_sweep(build_sweep(args, last_front), levels,
                     duration=args.duration, seed=args.seed,
                     knn_every=args.knn_every)

    print("qps_offered,qps_achieved,p50_ms,p99_ms,p999_ms,shed,"
          "slo_violations,avg_batch")
    for row in rows:
        print(f"{row['qps_offered']:.1f},{row['qps_achieved']:.1f},"
              f"{row['p50_ms']:.3f},{row['p99_ms']:.3f},"
              f"{row['p999_ms']:.3f},{row['shed']},"
              f"{row['slo_violations']},{row['avg_batch']}")

    if args.trace_out:
        obs_trace.get_tracer().export_chrome_trace(args.trace_out)
        obs_counters.collect_launch_reports(False)
        obs_trace.disable()
        print(f"# wrote {args.trace_out}", file=sys.stderr)
    if args.metrics_out and last_front[0] is not None:
        reg = last_front[0].metrics()
        with open(args.metrics_out, "w") as f:
            f.write(reg.to_prometheus())
        reg.write_json(args.metrics_out + ".json")
        print(f"# wrote {args.metrics_out} (+.json)", file=sys.stderr)

    if args.write_bench:
        root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)
            )))
        )
        path = write_bench_rows(rows, root)
        print(f"# wrote {path}", file=sys.stderr)
    else:
        print(json.dumps(rows, indent=1, default=float), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
