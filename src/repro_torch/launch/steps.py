"""Step functions of the LLM serving path.

Counterpart of ``repro.launch.steps``: :func:`make_serve_step` (one greedy
decode step) and :func:`make_prefill_step`.  PyTorch runs eagerly, so
where the reference returns a function to ``jax.jit``, these return plain
functions.  ``make_train_step``, ``abstract_params`` and
``abstract_opt_state`` wait for training (ROADMAP A4).
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T


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
