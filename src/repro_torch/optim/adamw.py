"""AdamW with global-norm clipping and a warmup-cosine schedule.

Counterpart of ``repro.optim.adamw``, step for step in float32: the same
clip, schedule, bias corrections and decoupled weight decay, moments kept
in ``moments_dtype``.  Parameters, gradients and moments are the port's
trees (nested dicts and lists of tensors, ``params["blocks"]`` a list).

Two differences of form, none of value:

- :func:`apply_updates` updates the parameters and the moments in place,
  under ``torch.no_grad()`` (the counterpart of the reference's
  ``donate_argnums``), and returns them.
- A gradient leaf may be ``None``: a parameter the loss never reads
  (DeepSeek-V3's ``mtp`` blocks, which the reference creates and never
  applies).  It is updated as a zero gradient, which is what ``jax.grad``
  gives the reference for such a leaf: its moments decay and weight decay
  still shrinks it (ROADMAP C31).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.modules import DTYPES, tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moments_dtype: str = "float32"


def init_state(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments shaped as ``params`` on their devices (the ``meta``
    device lays out shapes only)."""
    dt = DTYPES[cfg.moments_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    leaves = tree_leaves(params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaves[0].device if leaves else None),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio`` x lr
    at ``total_steps``; float32, as the reference's."""
    f = torch.float32
    step = step.to(f)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2) in float32; ``None`` leaves
    count as zeros."""
    leaves = [x for x in tree_leaves(tree) if x is not None]
    total = sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / max(norm, 1e-12)) in
    float32, cast back to its dtype -> (clipped grads, norm)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    clipped = tree_map(
        lambda g: None if g is None else (g.to(torch.float32) * scale).to(g.dtype), grads)
    return clipped, gnorm


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step, in place.  Returns (params, state, metrics) with
    metrics ``{"grad_norm", "lr"}`` (0-d float32 tensors)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v)):
        if g is not None:
            gf = g.to(torch.float32)
        elif isinstance(p, DTensor):  # on p's mesh, as p
            gf = torch.zeros_like(p, dtype=torch.float32)
        else:
            gf = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        m_new = b1 * m.to(torch.float32) + (1 - b1) * gf
        v_new = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    state = AdamWState(step=step, m=state.m, v=state.v)
    return params, state, {"grad_norm": gnorm, "lr": lr}
