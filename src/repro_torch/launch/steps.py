"""Step functions shared by ``launch/train.py`` and ``launch/serve.py``.

Counterpart of ``repro.launch.steps``: :func:`make_train_step` (loss,
gradients, optional EF-int8 compression, one AdamW step),
:func:`make_serve_step` (one greedy decode step), :func:`make_prefill_step`,
and the allocation-free :func:`abstract_params` / :func:`abstract_opt_state`
(tensors on the ``meta`` device).  PyTorch runs eagerly, so where the
reference returns a function to ``jax.jit`` (with the parameters and the
optimizer state donated), these return plain functions that update the
parameters and the state in place.

The same steps run sharded: :func:`place` is the counterpart of the
reference's ``in_shardings``, putting parameters, optimizer state, batch,
tokens and caches on a ``DeviceMesh`` as DTensors with the placements of
``sharding.rules`` (``param_shardings``, ``batch_shardings``,
``cache_shardings``), and the step functions take them as they are.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models import transformer as T
from repro_torch.models.modules import on_mesh, shard, tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.optim.compress import ef_int8_compress
from repro_torch.sharding import rules


def _grads_tree(params, grads):
    """The gradient list of ``tree_leaves(params)`` laid out as ``params``."""
    it = iter(grads)
    return tree_map(lambda _: next(it), params)


def _place_one(t: torch.Tensor, mesh, placements) -> DTensor:
    placements = tuple(placements)
    if t.device.type == "meta":
        # the dry run: a meta local shard of the rules' shard shape
        spec = rules.PartitionSpec(*[
            tuple(n for n, p in zip(mesh.mesh_dim_names, placements) if p.is_shard(i)) or None
            for i in range(t.dim())])
        local = torch.empty(rules.shard_shape(spec, t.shape, mesh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    if math.prod(mesh.shape) == 1:
        # the mesh holds the whole tensor on its one device: wrap it, no copy
        return DTensor.from_local(t, mesh, placements, run_check=False)
    return distribute_tensor(t, mesh, placements)


def place(tree, shardings, mesh):
    """Every tensor of ``tree`` (nested dicts / lists, as ``params``; an
    ``AdamWState``'s ``m`` and ``v`` likewise) as a DTensor on ``mesh``
    with its placements from ``shardings``, a tree of the same nesting
    (``rules.param_shardings`` / ``batch_shardings`` / ``cache_shardings``
    of the same tree and mesh): the counterpart of the reference's
    ``in_shardings``.  Each rank passes the whole tensor, as each made it
    from the seed: ``distribute_tensor`` keeps its shard; on a mesh of one
    device ``DTensor.from_local`` wraps the tensor itself, no copy; a
    ``meta`` tensor (the dry run) becomes a ``meta`` local shard of the
    rules' shard shape."""
    pl = dict(rules.leaves_with_path(shardings))
    return rules.map_with_path(lambda path, t: _place_one(t, mesh, pl[path]), tree)


def place_opt_state(state: adamw.AdamWState, params, mesh) -> adamw.AdamWState:
    """An ``AdamWState`` on ``mesh``: moments as their parameters
    (``rules.param_shardings``), the step replicated."""
    sh = rules.param_shardings(params, mesh)
    rep = rules.placements(rules.PartitionSpec(), mesh)
    return adamw.AdamWState(step=_place_one(state.step, mesh, rep),
                            m=place(state.m, sh, mesh), v=place(state.v, sh, mesh))


def make_train_step(cfg: T.ModelConfig, opt_cfg: adamw.AdamWConfig,
                    grad_compress: bool = False):
    """(params, opt_state, batch[, ef_state]) -> (params, opt_state[,
    ef_state], metrics), metrics ``{"grad_norm", "lr", "loss",
    "expert_load_max"}`` (0-d tensors, replicated DTensors on a mesh;
    nothing read on the host).  The
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
        # on a mesh each gradient comes to its parameter's placements (a
        # reduce-scatter where it is ``Partial``), so AdamW updates each
        # rank's shards in place
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if isinstance(g, DTensor) and g.placements != p.placements else g
                 for p, g in zip(leaves, grads)]
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
        # on a mesh the vocab is gathered first: DTensor's own argmax over a
        # sharded vocab fails where a rank holds one row (torch 2.13)
        logits = shard(logits, ("pod", "data"), *([None] * (logits.dim() - 1)))
        vocab_ids = on_mesh(torch.arange(logits.shape[-1], device=logits.device), logits)
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
