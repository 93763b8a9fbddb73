"""Error-feedback int8 gradient compression (counterpart of
``repro.optim.compress``).

Each gradient is quantized to int8 with a per-tensor scale after adding
the error-feedback buffer; the residual is carried to the next step.  The
returned gradients are the dequantized values (what a data-parallel
all-reduce of int8 would sum).  ``torch.round`` and ``jnp.round`` both round
half to even, so the int8 values equal the reference's.  A ``None``
gradient (a parameter the loss never reads) is taken as float32 zeros and
comes back in float32 (``launch.steps.make_train_step`` hands it zeros of
its parameter's dtype instead, as ``jax.grad`` gives the reference).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.modules import tree_leaves, tree_map


def ef_int8_state(params) -> Any:
    """float32 zeros shaped as ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def ef_int8_compress(grads, ef_state):
    """-> (dequantized int8 gradients in each gradient's dtype, the new
    error-feedback state)."""
    out_g, out_e = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(ef_state)):
        gf = e.clone() if g is None else g.to(torch.float32) + e
        q, scale = _quant(gf)
        deq = q.to(torch.float32) * scale
        out_g.append(deq if g is None else deq.to(g.dtype))
        out_e.append(gf - deq)
    it_g, it_e = iter(out_g), iter(out_e)
    return (tree_map(lambda _: next(it_g), ef_state), tree_map(lambda _: next(it_e), ef_state))
