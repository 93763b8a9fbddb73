"""Mixture-of-Experts FFN: token-choice top-k routing with capacity-based
dispatch.

Counterpart of ``repro.models.moe``: the granite-moe flavour (softmax
top-k) and the DeepSeek-V3 flavour (sigmoid scores, an aux-loss-free bias
used for selection only, renormalised gates, shared experts beside the
routed ones).  Both of the reference's dispatches:

- ``moe_dispatch="einsum"`` (the default): GShard's one-hot ``disp`` /
  ``comb`` products.  ``disp`` is built in x's dtype and ``comb`` in
  float32, then cast to x's dtype, where the reference rounds them.  Each
  token takes distinct experts, so a (token, expert) pair holds at most one
  choice; both tensors are therefore written by a scatter of the kept
  choices instead of the reference's (S, k, E, C) comparison, with the
  same values.
- ``"scatter"``: the kept choices are added into an (E·C + 1, D) buffer,
  whose last row takes the dropped ones, then gathered back.  Every row but
  that sink receives exactly one token, so the result does not depend on
  the order of the adds (on the card too).

Routing follows the reference's exactly: the capacity is
``max(1, int(s * k / e * capacity_factor))`` (the floor, as its code takes
it), a choice's place in its expert's queue counts the choices before it in
token-major, then choice, order, and the top k take the lower expert index
first on ties (``jax.lax.top_k``'s order; ``torch.topk`` promises none, so
a stable descending sort is used, ROADMAP C26).  Plain torch on every
device, as the reference computes it outside any kernel.

On a mesh (DTensors, ``launch.steps.place``) the experts lie over
``model`` as ``sharding.rules`` places w_in, w_gate (E, D, F) and w_out
(E, F, D); routing, dispatch and the expert products run on each rank's
batch rows and experts in ``local_map`` (ROADMAP C41), xe and ye are
constrained as the reference constrains them, and the combine is summed
over the expert ranks.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import _lib
from repro_torch.sharding import rules

from .modules import act_fn, dense_init, device_of, on_mesh, param_dtype, shard, trunc_normal


def init_moe(generator, cfg, d_model: int) -> Dict:
    """Router (D, E) float32 with its zero bias; experts laid out (E, D, F)
    and (E, F, D), as the reference's after its transpose; ``shared`` when
    the config has shared experts."""
    dt = param_dtype(cfg)
    e, f = cfg.n_experts, cfg.moe_d_ff
    params = {
        "router": dense_init(generator, d_model, (e,), torch.float32),
        "router_bias": torch.zeros((e,), dtype=torch.float32, device=device_of(generator)),
        "w_in": expert_init(generator, e, d_model, f, dt),
        "w_gate": expert_init(generator, e, d_model, f, dt),
        "w_out": expert_init(generator, e, f, d_model, dt),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        params["shared"] = {
            "w_in": dense_init(generator, d_model, (fs,), dt),
            "w_gate": dense_init(generator, d_model, (fs,), dt),
            "w_out": dense_init(generator, fs, (d_model,), dt),
        }
    return params


def expert_init(generator, e: int, in_dim: int, out_dim: int, dtype) -> torch.Tensor:
    """(E, in_dim, out_dim) expert weights, each fan-in scaled over in_dim
    (the reference draws (in_dim, E, out_dim) and transposes; the rule is
    the same, drawn in the layout it is kept in)."""
    return trunc_normal((e, in_dim, out_dim), in_dim ** -0.5, dtype, generator)


def capacity_of(cfg, s: int, capacity_factor: float) -> int:
    """Slots per expert for s tokens a row: the floor, as the reference's
    code takes it (its docstring says ceil)."""
    return max(1, int(s * cfg.experts_per_tok / cfg.n_experts * capacity_factor))


def route(params, cfg, x: torch.Tensor):
    """Router scores -> (top_idx (B, S, k) int64, gate (B, S, k) float32):
    the k highest selection scores, the lower expert first on ties, and the
    gates from the unbiased scores (renormalised for ``sigmoid``)."""
    logits = x.to(torch.float32) @ params["router"]
    if cfg.router_kind == "sigmoid":
        scores = torch.sigmoid(logits)
        sel_scores = scores + params["router_bias"]
    else:
        scores = torch.softmax(logits, dim=-1)
        sel_scores = scores
    order = torch.sort(sel_scores, dim=-1, descending=True, stable=True).indices
    top_idx = order[..., :cfg.experts_per_tok]
    gate = torch.gather(scores, -1, top_idx)
    if cfg.router_kind == "sigmoid":
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return top_idx, gate


def queue_slots(top_idx: torch.Tensor, n_experts: int, capacity: int):
    """Each choice's place in its expert's queue, counted in token-major,
    then choice, order over a batch row -> (slot (B, S, k) clipped to the
    capacity, keep (B, S, k) bool)."""
    b, s, k = top_idx.shape
    onehot = torch.nn.functional.one_hot(top_idx.reshape(b, s * k), n_experts)
    before = (torch.cumsum(onehot, dim=1) - onehot)  # earlier choices of that expert
    pos = torch.gather(before, -1, top_idx.reshape(b, s * k, 1)).reshape(b, s, k)
    return pos.clamp(max=capacity - 1), pos < capacity


def _expert_ffn(xe, w_in, w_gate, w_out, *, act: str) -> torch.Tensor:
    """xe (B, E, C, D) through each expert's gated FFN -> (B, E, C, D)."""
    fn = act_fn(act)
    hidden = fn(torch.einsum("becd,edf->becf", xe, w_gate)) * torch.einsum(
        "becd,edf->becf", xe, w_in)
    return torch.einsum("becf,efd->becd", hidden, w_out)


def _experts(params, cfg, xe: torch.Tensor) -> torch.Tensor:
    """:func:`_expert_ffn` of the layer's experts.  On a mesh each rank runs
    its batch rows through its experts (``local_map``; xe as ``shard``
    leaves it, experts over ``model``): the weights, whose D the rules
    shard over the data axes, are gathered there (FSDP), and their
    gradients are ``Partial`` over the data ranks that split the batch.
    DTensor's own plan for these einsums shards a batch the data axes do
    not divide unevenly, then cannot flatten it (ROADMAP C41)."""
    ws = (params["w_in"], params["w_gate"], params["w_out"])
    fn = functools.partial(_expert_ffn, act=cfg.act)
    if not isinstance(xe, DTensor):
        return fn(xe, *ws)
    xp = tuple(xe.placements)
    wp = tuple(Shard(0) if p.is_shard(1) else Replicate() for p in xp)
    wg = tuple(Shard(0) if p.is_shard(1) else Partial() if p.is_shard(0) else Replicate()
               for p in xp)
    return _lib.on_local_shards(fn, (xe, *ws), (xp, wp, wp, wp), xp, (xp, wg, wg, wg))


def _dispatch(x, router, router_bias, *, cfg, capacity: int, e0: int = 0, el: int = None):
    """Routing and dispatch of the batch rows x (B, S, D) to experts e0 ..
    e0 + E_l - 1 (all of them by default) -> (xe (B, E_l, C, D), the
    combine's operands, the (E,) float32 count of the tokens each expert
    took).  The combine's operands are ``comb`` (B, S, E_l·C) in x's dtype
    for ``"einsum"``; for ``"scatter"``, each choice's row of all E·C slots
    (B, S·k) (E·C for a dropped one) and its weight gate · keep (B, S, k)
    float32, 0 for a choice of another expert.  The routing is per batch
    row and over all experts: on a mesh each rank runs it on its batch
    shard for the experts it holds (:func:`_dispatch_sharded`)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_tok
    el = e if el is None else el
    top_idx, gate = route({"router": router, "router_bias": router_bias}, cfg, x)
    slot, keep = queue_slots(top_idx, e, capacity)
    # a kept choice's row of the (E·C) slots; the dropped ones go to a sink
    dest = torch.where(keep, top_idx * capacity + slot, e * capacity)  # (B, S, k)
    # ... and of the E_l·C slots here, the sink for another expert's
    mine = (dest >= e0 * capacity) & (dest < (e0 + el) * capacity)
    here = torch.where(mine, dest - e0 * capacity, el * capacity)
    if cfg.moe_dispatch == "scatter":
        xe = torch.zeros((b, el * capacity + 1, d), dtype=x.dtype, device=x.device)
        rows = here.reshape(b, s * k)
        xe.scatter_add_(1, rows[..., None].expand(b, s * k, d), x.repeat_interleave(k, dim=1))
        xe = xe[:, :el * capacity]
        combine = (dest.reshape(b, s * k), gate * mine)
    else:
        flat = here.reshape(b * s, k)
        disp = torch.zeros((b * s, el * capacity + 1), dtype=x.dtype, device=x.device)
        disp.scatter_(1, flat, 1.0)
        comb = torch.zeros((b * s, el * capacity + 1), dtype=torch.float32, device=x.device)
        comb.scatter_(1, flat, gate.reshape(b * s, k))
        disp = disp[:, :el * capacity].reshape(b, s, el * capacity)
        comb = comb[:, :el * capacity].reshape(b, s, el * capacity).to(x.dtype)
        xe = disp.transpose(1, 2) @ x  # all-to-all under EP
        combine = (comb,)
    # Router statistics for the aux-free bias update: a token counts for an
    # expert when one of its kept choices went there.
    routed = torch.zeros((b, s, e), dtype=torch.float32, device=x.device)
    routed.scatter_(2, top_idx, keep.to(torch.float32))
    return (xe.reshape(b, el, capacity, d), *combine, routed.sum(dim=(0, 1)))


def _dispatch_sharded(params, cfg, x, capacity: int):
    """:func:`_dispatch` of a DTensor x, one ``local_map``: x's batch over
    the data axes and whole on the ``model`` ranks, the router and its
    bias replicated, so DTensor never sees the sort, one-hot, cumsum and
    scatters (ROADMAP C41).  Each rank routes its batch rows over all
    experts and dispatches to the experts it holds (xe leaves with the
    placements ``shard`` gives it: batch over the data axes, experts over
    ``model``; ``comb`` with its E·C columns over ``model``); the scatter
    combine's weights are ``Partial`` over the expert ranks (0 for another
    rank's experts), the expert counts ``Partial`` over the data ranks
    (whole-number sums).  x's and the router's gradients are ``Partial``
    over the expert ranks (each has its experts' share), the router's over
    the data ranks too."""
    mesh = x.device_mesh
    b, _, d = x.shape
    xp = rules.placements(rules.clean_spec((("pod", "data"), None, None), x.shape, mesh), mesh)
    ep = rules.placements(rules.clean_spec((("pod", "data"), "model", None, None),
                                           (b, cfg.n_experts, capacity, d), mesh), mesh)
    split = math.prod(mesh.size(i) for i, p in enumerate(ep) if p.is_shard(1))
    fn = functools.partial(_dispatch, cfg=cfg, capacity=capacity,
                           e0=rules.shard_start(mesh, ep, 1, cfg.n_experts),
                           el=cfg.n_experts // split)
    rep = (Replicate(),) * mesh.ndim
    over_e = tuple(Partial() if q.is_shard(1) else p for p, q in zip(xp, ep))
    grad_r = tuple(Partial() if p.is_shard(0) or q.is_shard(1) else Replicate()
                   for p, q in zip(xp, ep))
    load = tuple(Partial() if p.is_shard(0) else Replicate() for p in xp)
    if cfg.moe_dispatch == "scatter":
        outs = (ep, xp, over_e, load)
    else:
        outs = (ep, tuple(Shard(2) if p.is_shard(1) else p for p in ep), load)
    return _lib.on_local_shards(fn, (x, params["router"], params["router_bias"]),
                                (xp, rep, rep), outs, (over_e, grad_r, grad_r), n_out=len(outs))


def _gather_combine(ye, rows, weight, e0: int = 0) -> torch.Tensor:
    """The scatter dispatch's combine: each choice's expert output, read
    from the slot rows of ye (B, E_l, C, D) (experts from ``e0`` on: a
    rank's expert shard, or all of them) by its row of the E·C slots, 0
    where the row lies elsewhere or is the sink; weighted by gate · keep
    (B, S, k) and summed over the k choices -> (B, S, D)."""
    b, el, c, d = ye.shape
    s, k = weight.shape[1:]
    local = rows - e0 * c
    inside = (local >= 0) & (local < el * c)
    y_tc = torch.gather(ye.reshape(b, el * c, d), 1,
                        local.clamp(0, el * c - 1)[..., None].expand(b, s * k, d))
    y_tc = torch.where(inside[..., None], y_tc, 0).reshape(b, s, k, d)
    return torch.einsum("bsk,bskd->bsd", weight.to(y_tc.dtype), y_tc)


def _gather_combine_sharded(ye, rows, weight) -> torch.Tensor:
    """:func:`_gather_combine` on each rank's expert shard of ye
    (``local_map``), with the weights as the dispatch leaves them,
    ``Partial`` over the mesh dims that shard the experts: y is
    ``Partial`` there (a token's k outputs lie on the ranks of its
    experts), as is the weights' gradient; ye's gradient rows are whole on
    their rank."""
    mesh, yp = ye.device_mesh, tuple(ye.placements)
    bp = tuple(p if p.is_shard(0) else Replicate() for p in yp)
    ep = tuple(Partial() if p.is_shard(1) else q for p, q in zip(yp, bp))
    fn = functools.partial(_gather_combine, e0=rules.shard_start(mesh, yp, 1, ye.shape[1]))
    return _lib.on_local_shards(fn, (ye, rows, weight), (yp, bp, ep), ep, (yp, bp, ep))


def moe_ffn(params, cfg, x: torch.Tensor, capacity_factor: float = None):
    """x (B, S, D) -> (y (B, S, D), {"expert_load": (E,) float32, the
    fraction of tokens routed to each expert, dropped choices excluded}).

    On a mesh (x and the parameters DTensors) routing and dispatch run on
    each rank's batch rows (:func:`_dispatch_sharded`), the expert products
    as DTensor operators with the experts over ``model`` (``rules``: w_in,
    w_gate (E, D, F) and w_out (E, F, D) shard E over ``model``, their D
    over the data axes), and xe and ye are constrained as the reference's;
    the load is the mean over the whole (B, S): the ranks' counts summed,
    then times the reciprocal of the global count."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    b, s, d = x.shape
    e = cfg.n_experts
    capacity = capacity_of(cfg, s, capacity_factor)
    if isinstance(x, DTensor):
        xe, *combine, load = _dispatch_sharded(params, cfg, x, capacity)
    else:
        xe, *combine, load = _dispatch(x, params["router"], params["router_bias"], cfg=cfg,
                                       capacity=capacity)
    xe = shard(xe, ("pod", "data"), "model", None, None)
    ye = shard(_experts(params, cfg, xe), ("pod", "data"), "model", None, None)
    if cfg.moe_dispatch == "scatter":
        gather = _gather_combine_sharded if isinstance(ye, DTensor) else _gather_combine
        y = gather(ye, *combine)
    else:
        y = combine[0] @ ye.reshape(b, e * capacity, d)

    if cfg.n_shared_experts:
        sp = params["shared"]
        act = act_fn(cfg.act)
        y = y + (act(x @ sp["w_gate"]) * (x @ sp["w_in"])) @ sp["w_out"]

    if isinstance(load, DTensor):  # the ranks' whole-number counts, summed exactly
        load = load.redistribute(load.device_mesh, (Replicate(),) * load.device_mesh.ndim)
    # the mean as XLA takes it: the sum times the float32 reciprocal of the count
    inv = on_mesh(torch.tensor(1.0 / (b * s), dtype=torch.float32, device=x.device), load)
    return y, {"expert_load": load * inv}
