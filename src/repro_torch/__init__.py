"""repro_torch — the PyTorch/CUDA port of the mqr-tree spatial index.

The JAX package ``repro`` is the reference; this package mirrors its
layout and names for the slices ported so far (the pyramid build, the
paper's mqr-tree and the R-tree, the compact quantizers, the fused region
sweeps including the streaming one, live updates, the tree-vs-tree join,
k-NN, the moving-object workload, the mqr-KV block selection with the
attention and norm kernels, the durability and serving layer:
snapshots, the mutation WAL, ``DurableIndex``, ``FaultPlan``, the serving
ladder, trace spans, metrics and the per-launch byte ledger, and the
serving front end ``repro_torch.serve`` with its open-loop load
generator), with hand-written CUDA kernels for the card.  It imports
neither ``jax`` nor ``repro``.
"""

from .index.api import SpatialIndex

__all__ = ["SpatialIndex"]
