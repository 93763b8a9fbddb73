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
"""

from __future__ import annotations

from typing import Dict

import torch

from .modules import act_fn, dense_init, device_of, param_dtype, shard, trunc_normal


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


def _experts(params, cfg, xe: torch.Tensor) -> torch.Tensor:
    """xe (B, E, C, D) through each expert's gated FFN -> (B, E, C, D)."""
    act = act_fn(cfg.act)
    hidden = act(torch.einsum("becd,edf->becf", xe, params["w_gate"])) * torch.einsum(
        "becd,edf->becf", xe, params["w_in"])
    return torch.einsum("becf,efd->becd", hidden, params["w_out"])


def moe_ffn(params, cfg, x: torch.Tensor, capacity_factor: float = None):
    """x (B, S, D) -> (y (B, S, D), {"expert_load": (E,) float32, the
    fraction of tokens routed to each expert, dropped choices excluded})."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_tok
    capacity = capacity_of(cfg, s, capacity_factor)
    top_idx, gate = route(params, cfg, x)
    slot, keep = queue_slots(top_idx, e, capacity)
    # a kept choice's row of the (E·C) slots; the dropped ones go to a sink
    dest = torch.where(keep, top_idx * capacity + slot, e * capacity)  # (B, S, k)

    if cfg.moe_dispatch == "scatter":
        xe = torch.zeros((b, e * capacity + 1, d), dtype=x.dtype, device=x.device)
        rows = dest.reshape(b, s * k)
        xe.scatter_add_(1, rows[..., None].expand(b, s * k, d),
                        x.repeat_interleave(k, dim=1))
        xe = shard(xe[:, :e * capacity].reshape(b, e, capacity, d),
                   ("pod", "data"), "model", None, None)
        ye = _experts(params, cfg, xe).reshape(b, e * capacity, d)
        ye = torch.cat([ye, torch.zeros((b, 1, d), dtype=ye.dtype, device=ye.device)], dim=1)
        y_tc = torch.gather(ye, 1, rows[..., None].expand(b, s * k, d)).reshape(b, s, k, d)
        y = torch.einsum("bsk,bskd->bsd", (gate * keep).to(y_tc.dtype), y_tc)
    else:
        flat = dest.reshape(b * s, k)
        disp = torch.zeros((b * s, e * capacity + 1), dtype=x.dtype, device=x.device)
        disp.scatter_(1, flat, 1.0)
        comb = torch.zeros((b * s, e * capacity + 1), dtype=torch.float32, device=x.device)
        comb.scatter_(1, flat, gate.reshape(b * s, k))
        disp = disp[:, :e * capacity].reshape(b, s, e * capacity)
        comb = comb[:, :e * capacity].reshape(b, s, e * capacity).to(x.dtype)
        xe = (disp.transpose(1, 2) @ x).reshape(b, e, capacity, d)  # all-to-all under EP
        xe = shard(xe, ("pod", "data"), "model", None, None)
        ye = _experts(params, cfg, xe).reshape(b, e * capacity, d)
        y = comb @ ye

    if cfg.n_shared_experts:
        sp = params["shared"]
        act = act_fn(cfg.act)
        y = y + (act(x @ sp["w_gate"]) * (x @ sp["w_in"])) @ sp["w_out"]

    # Router statistics for the aux-free bias update: a token counts for an
    # expert when one of its kept choices went there.
    routed = torch.zeros((b, s, e), dtype=torch.float32, device=x.device)
    routed.scatter_(2, top_idx, keep.to(torch.float32))
    # the mean as XLA takes it: the sum times the float32 reciprocal of the count
    inv = torch.tensor(1.0 / (b * s), dtype=torch.float32, device=x.device)
    return y, {"expert_load": routed.sum(dim=(0, 1)) * inv}
