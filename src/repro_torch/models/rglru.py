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
as the reference computes it outside any kernel.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .mamba2 import _causal_conv, _window_conv
from .modules import dense_init, device_of, param_dtype

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


def rglru_train(params, cfg, x, positions=None):
    """x (B, S, D) -> (B, S, D)."""
    u = x @ params["in_x"]
    gate = F.gelu(x @ params["in_gate"], approximate="tanh")
    u = _causal_conv(u, params["conv_w"], params["conv_b"])
    a, b = _gates(params, u)
    h = linear_scan(a, b)
    return (h.to(x.dtype) * gate) @ params["out"]


def init_rglru_cache(cfg, batch: int, dtype, device) -> Dict:
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.lru_width), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32, device=device),
    }


def rglru_decode(params, cfg, x, cache, pos=None):
    """Single-token update. x (B, 1, D).  Writes the cache in place and
    returns (out (B, 1, D), cache)."""
    u = x @ params["in_x"]  # (B, 1, W)
    gate = F.gelu(x @ params["in_gate"], approximate="tanh")
    window = torch.cat([cache["conv"], u], dim=1)
    u = _window_conv(window, params["conv_w"], params["conv_b"])
    a, b = _gates(params, u)
    h = a[:, 0] * cache["h"] + b[:, 0]
    out = (h[:, None, :].to(x.dtype) * gate) @ params["out"]
    cache["conv"].copy_(window[:, 1:])
    cache["h"].copy_(h)
    return out, cache
