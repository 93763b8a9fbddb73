"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Counterpart of ``repro.models.rglru``.  The real-gated linear recurrent
unit:

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

wrapped, as RecurrentGemma's recurrent block, in a linear in-projection, a
short causal conv, a GeLU (tanh form) gate branch and an out-projection.
Prefill runs the recurrence as a log-depth scan over the sequence
(Hillis–Steele doubling with the reference's combine; the reference uses
``jax.lax.associative_scan``, whose summation order differs); decode is an
O(1) update written into the cache in place.  Plain torch on every device,
as the reference computes it outside any kernel.  On a mesh (DTensors) the
width W lies over ``model``; the conv, the scan and the decode's update of
its window and state run on the width shards in ``local_map`` (ROADMAP
C44).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import _lib
from repro_torch.sharding import rules

from .mamba2 import _causal_conv, _window_conv
from .modules import dense_init, device_of, param_dtype, shard

_C = 8.0


def init_rglru(generator, cfg, d_model: int) -> Dict:
    dt = param_dtype(cfg)
    dev = device_of(generator)
    w = cfg.lru_width
    return {
        "in_x": dense_init(generator, d_model, (w,), dt),
        "in_gate": dense_init(generator, d_model, (w,), dt),
        "conv_w": dense_init(generator, cfg.conv_kernel, (w,), dt) * 0.1,
        "conv_b": torch.zeros((w,), dtype=dt, device=dev),
        "w_a": dense_init(generator, w, (w,), dt),
        "b_a": torch.zeros((w,), dtype=torch.float32, device=dev),
        "w_i": dense_init(generator, w, (w,), dt),
        "b_i": torch.zeros((w,), dtype=torch.float32, device=dev),
        # the reference's log(expm1(linspace(0.9, 0.999))) * 0 + 0.5
        "lam": torch.full((w,), 0.5, dtype=torch.float32, device=dev),
        "out": dense_init(generator, w, (d_model,), dt),
    }


def _gates(params, u):
    """a (the decay) and the gated input b, both float32 (B, S, W)."""
    r = torch.sigmoid((u @ params["w_a"]).to(torch.float32) + params["b_a"])
    i = torch.sigmoid((u @ params["w_i"]).to(torch.float32) + params["b_i"])
    log_a = -_C * F.softplus(params["lam"]) * r  # <= 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i * u.to(torch.float32)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, in log2(S)
    doubling steps of the combine (a_l a_r, a_r b_l + b_r): no loop over
    tokens."""
    s = a.shape[1]
    d = 1
    while d < s:
        a_l, b_l = a[:, :-d], b[:, :-d]
        a_r, b_r = a[:, d:], b[:, d:]
        b = torch.cat([b[:, :d], a_r * b_l + b_r], dim=1)
        a = torch.cat([a[:, :d], a_l * a_r], dim=1)
        d *= 2
    return b


def _width_layout(t: torch.Tensor) -> tuple:
    """Placements of a (B, ·, W) activation on its mesh: batch over the
    data axes, the width over ``model`` where each divides."""
    return rules.placements(rules.clean_spec((("pod", "data"), None, "model"), t.shape,
                                             t.device_mesh), t.device_mesh)


def _width_sharded(t: torch.Tensor) -> torch.Tensor:
    """A (B, ·, W) activation brought to :func:`_width_layout`."""
    return shard(t, ("pod", "data"), None, "model")


def _conv_w_layout(xp: tuple, grad: bool = False) -> tuple:
    """Placements of conv_w (K, W) and conv_b (W,) beside an input of
    placements ``xp``: their W with the input's; for the gradient
    (``grad``), ``Partial`` over the ranks that split the batch."""
    def one(dim):
        return tuple(Shard(dim) if p.is_shard(2) else Partial() if grad and p.is_shard(0)
                     else Replicate() for p in xp)
    return one(1), one(0)


def scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`linear_scan`; DTensors on their batch and width shards (the
    recurrence is elementwise in W), in one ``local_map``: DTensor's own
    rules for the rounds of slices and ``cat`` differ between torch
    releases (ROADMAP C40, C44)."""
    if not isinstance(a, DTensor):
        return linear_scan(a, b)
    pl = _width_layout(a)
    return _lib.on_local_shards(linear_scan, (a, b), (pl, pl), pl, (pl, pl))


def channel_conv(u, conv_w, conv_b):
    """The causal conv of u (B, S, W); DTensors on their width shards
    (``local_map``: exact for each channel)."""
    if not isinstance(u, DTensor):
        return _causal_conv(u, conv_w, conv_b)
    up = _width_layout(u)
    wp, bp = _conv_w_layout(up)
    wg, bg = _conv_w_layout(up, grad=True)
    return _lib.on_local_shards(_causal_conv, (u, conv_w, conv_b), (up, wp, bp), up,
                                (up, wg, bg))


def rglru_train(params, cfg, x, positions=None):
    """x (B, S, D) -> (B, S, D).  On a mesh the width W lies over
    ``model`` (``in_x``, ``in_gate`` and the columns of ``w_a`` / ``w_i``),
    u is gathered for ``u @ w_a`` by DTensor, and the conv and the scan run
    on the width shards."""
    u = _width_sharded(x @ params["in_x"])
    gate = _width_sharded(F.gelu(x @ params["in_gate"], approximate="tanh"))
    u = channel_conv(u, params["conv_w"], params["conv_b"])
    a, b = _gates(params, u)
    h = scan(a, b)
    return (h.to(x.dtype) * gate) @ params["out"]


def init_rglru_cache(cfg, batch: int, dtype, device) -> Dict:
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.lru_width), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32, device=device),
    }


def _window_step(u, conv, conv_w, conv_b):
    """The decode conv of u (B, 1, W_l) over the window ``conv`` (B, K-1,
    W_l), which is written in place -> (B, 1, W_l)."""
    window = torch.cat([conv, u], dim=1)
    out = _window_conv(window, conv_w, conv_b)
    conv.copy_(window[:, 1:])
    return out


def _h_step(a, b, h_cache, gate):
    """h = a h + b on the state ``h_cache`` (B, W_l), written in place ->
    the gated h (B, 1, W_l) in the gate's dtype."""
    h = a[:, 0] * h_cache + b[:, 0]
    h_cache.copy_(h)
    return h[:, None, :].to(gate.dtype) * gate


def rglru_decode(params, cfg, x, cache, pos=None):
    """Single-token update. x (B, 1, D).  Writes the cache in place and
    returns (out (B, 1, D), cache).  On a mesh the conv window (B, K-1, W)
    and the state h (B, W) keep W over ``model`` (``rules.cache_spec``)
    and are written on their local shards."""
    u = _width_sharded(x @ params["in_x"])  # (B, 1, W)
    gate = _width_sharded(F.gelu(x @ params["in_gate"], approximate="tanh"))
    ws = (params["conv_w"], params["conv_b"])
    if not isinstance(u, DTensor):
        a, b = _gates(params, _window_step(u, cache["conv"], *ws))
        return _h_step(a, b, cache["h"], gate) @ params["out"], cache
    up, cp, hp = _width_layout(u), tuple(cache["conv"].placements), tuple(cache["h"].placements)
    wp, bp = _conv_w_layout(up)
    pls = (up, cp, wp, bp)
    u = _lib.on_local_shards(_window_step, (u, cache["conv"], *ws), pls, up, pls)
    a, b = _gates(params, u)
    pls = (up, up, hp, up)
    y = _lib.on_local_shards(_h_step, (a, b, cache["h"], gate), pls, up, pls)
    return y @ params["out"], cache
