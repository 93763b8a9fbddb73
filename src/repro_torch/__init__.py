"""repro_torch — the PyTorch/CUDA port of the mqr-tree spatial index.

The JAX package ``repro`` is the reference; this package mirrors its
layout and names for the slice ported so far (the pyramid build, the
compact quantizer and the fused region sweep), with hand-written CUDA
kernels for the card.  It imports neither ``jax`` nor ``repro``.
"""

from .index.api import SpatialIndex

__all__ = ["SpatialIndex"]
