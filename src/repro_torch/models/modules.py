"""Parameter initialisers and the small shared pieces of the models.

Counterpart of ``repro.models.modules``.  Parameters are nested dicts of
tensors, laid out as the reference's pytrees.  Initialisers follow the
reference's rule (a normal truncated at ±2σ, fan-in scaled) but draw from a
``torch.Generator``, so they do not give the reference's bits; tests carry
the reference's parameters across with ``repro_torch.convert``.

:func:`rmsnorm` is where the models meet kernel #10: on a CUDA tensor the
model calls the hand-written kernel (``ops.rmsnorm``, and in training its
backward kernel through ``ops.RMSNorm``), where the reference computes its
own jnp under ``jax.grad``.  Its plain version, which a CPU tensor takes, is the
same function as the reference's ``rmsnorm`` (float32 math, output in x's
dtype); ``tests/test_torch_models.py`` holds the two together.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def device_of(generator) -> torch.device:
    """The device an initialiser's ``generator`` draws on.  Initialisers
    take a ``torch.Generator``, or the ``meta`` device to lay out shapes and
    dtypes without drawing or allocating (``transformer.param_shapes``)."""
    return generator.device if isinstance(generator, torch.Generator) else generator


# A tensor of more elements than this is drawn in slices along its leading
# axis, so its float32 draw never lives whole (one DeepSeek-V3 expert tensor
# is 3.8e9 elements: 15 GB in float32).  Every tensor of llama3.2-1B lies
# below it, so their bits are those of one whole draw (ROADMAP C27).
SLICE_ELEMENTS = 1 << 28


def _draw(shape, std: float, dtype, generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def trunc_normal(shape, std: float, dtype, generator) -> torch.Tensor:
    """A normal truncated at ±2 drawn in float32, scaled by ``std`` and cast
    to ``dtype``, on the generator's device (``meta`` lays out the shape
    only).  Above :data:`SLICE_ELEMENTS` the draw goes slice by slice along
    the leading axis, each slice the same rule."""
    if not isinstance(generator, torch.Generator):
        return torch.empty(shape, dtype=dtype, device=generator)
    shape = tuple(shape)
    n = math.prod(shape)
    if n <= SLICE_ELEMENTS or shape[0] == 1:
        return _draw(shape, std, dtype, generator)
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    rows = max(1, SLICE_ELEMENTS // (n // shape[0]))
    for i in range(0, shape[0], rows):
        out[i:i + rows] = _draw((min(rows, shape[0] - i), *shape[1:]), std, dtype, generator)
    return out


def dense_init(generator, in_dim: int, out_shape, dtype=torch.bfloat16,
               scale: float = 1.0) -> torch.Tensor:
    """Weight of shape (in_dim, *out_shape), fan-in scaled truncated normal,
    on the generator's device."""
    return trunc_normal((in_dim, *out_shape), scale / math.sqrt(in_dim), dtype, generator)


def embed_init(generator, vocab: int, dim: int, dtype=torch.bfloat16) -> torch.Tensor:
    # 1/sqrt(dim) keeps tied-head logits O(1); the gemma family multiplies
    # its input embeddings by sqrt(dim), as in the reference.
    return trunc_normal((vocab, dim), dim ** -0.5, dtype, generator)


def rmsnorm_init(dim: int, device=None, dtype=torch.float32) -> torch.Tensor:
    # Norm scales stay float32: tiny and precision-critical.
    return torch.ones((dim,), dtype=dtype, device=device)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale in float32, in x's dtype: kernel
    #10 on the card, its plain version on the CPU (the reference's math);
    under autograd its backward is #10's backward kernel (``ops.RMSNorm``)."""
    return ops.RMSNorm.apply(x.contiguous(), scale, eps)


def act_fn(kind: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[kind]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exponent)


def apply_rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh) or (..., S, Dh); positions: (..., S) (a tensor)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == ang.dim() + 1:  # (..., S, H, Dh): broadcast over heads
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference's sharding constraint; on one device a no-op.  The
    rules exist (``repro_torch.sharding``); running the models sharded on
    DTensor over a production ``DeviceMesh`` is the next slice (ROADMAP
    A4d)."""
    return x


def tree_cast(tree, dtype):
    """Cast every floating tensor of a nested dict / list to ``dtype``."""
    if isinstance(tree, dict):
        return {k: tree_cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_cast(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def tree_map(fn, tree):
    """``fn`` over every leaf of a nested dict / list, keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def count_params(tree) -> int:
    return sum(int(t.numel()) for t in tree_leaves(tree))
