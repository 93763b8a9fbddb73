"""Step functions shared by ``launch/train.py`` and ``launch/serve.py``.

Counterpart of ``repro.launch.steps``: :func:`make_train_step` (loss,
gradients, optional EF-int8 compression, one AdamW step),
:func:`make_serve_step` (one greedy decode step), :func:`make_prefill_step`,
and the allocation-free :func:`abstract_params` / :func:`abstract_opt_state`
(tensors on the ``meta`` device).  PyTorch runs eagerly, so where the
reference returns a function to ``jax.jit`` (with the parameters and the
optimizer state donated), these return plain functions that update the
parameters and the state in place.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.optim.compress import ef_int8_compress


def _grads_tree(params, grads):
    """The gradient list of ``tree_leaves(params)`` laid out as ``params``."""
    it = iter(grads)
    return tree_map(lambda _: next(it), params)


def make_train_step(cfg: T.ModelConfig, opt_cfg: adamw.AdamWConfig,
                    grad_compress: bool = False):
    """(params, opt_state, batch[, ef_state]) -> (params, opt_state[,
    ef_state], metrics), metrics ``{"grad_norm", "lr", "loss",
    "expert_load_max"}`` (0-d tensors, nothing read on the host).  The
    parameters (leaf tensors) and the state are updated in place; the
    gradients come from ``torch.autograd.grad``, ``None`` for a parameter
    the loss never reads (DeepSeek's ``mtp``), which AdamW updates as a
    zero gradient (ROADMAP C31)."""

    def train_step(params, opt_state, batch, ef_state=None):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, aux = T.loss_and_aux(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        loss = loss.detach()
        if grad_compress:
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            grads, ef_state = ef_int8_compress(_grads_tree(params, grads), ef_state)
        else:
            grads = _grads_tree(params, grads)
        params, opt_state, metrics = adamw.apply_updates(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, loss=loss, expert_load_max=torch.max(aux["expert_load"]))
        if grad_compress:
            return params, opt_state, ef_state, metrics
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: T.ModelConfig):
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch)

    return prefill_step


def make_serve_step(cfg: T.ModelConfig, mqr_sparse: bool = False):
    """One decode step: (params, tokens, caches, pos) -> (the greedy next
    token (B, 1) int32 — (B, 1, K) for audio — and the caches, written in
    place).  The vocab padding ids (``ModelConfig.padded_vocab``) are masked
    to -inf before the argmax; ties take the first index, as ``jnp.argmax``
    does.  Nothing is read on the host."""

    def serve_step(params, tokens, caches, pos):
        logits, caches = T.decode_step(params, cfg, tokens, caches, pos, mqr_sparse=mqr_sparse)
        vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(vocab_ids < cfg.vocab_size, logits, -torch.inf)
        return torch.argmax(logits, dim=-1).to(torch.int32), caches

    return serve_step


def abstract_params(cfg: T.ModelConfig):
    """The parameter tree of ``T.init_params`` as tensors on the ``meta``
    device: shapes and dtypes, no allocation (``T.param_shapes`` gives the
    same as (shape, dtype) pairs)."""
    return T._init_params(torch.device("meta"), cfg)


def abstract_opt_state(params_abs, opt_cfg: adamw.AdamWConfig) -> adamw.AdamWState:
    """``adamw.init_state`` of ``params_abs`` on the ``meta`` device."""
    return adamw.init_state(params_abs, opt_cfg)
