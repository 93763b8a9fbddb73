"""Mamba-2 (SSD, state-space duality — arXiv:2405.21060) mixer.

Counterpart of ``repro.models.mamba2``.  Prefill runs the chunked SSD
algorithm: quadratic attention-like work inside a chunk, a linear state
recurrence across chunks, carrying one chunk's quadratic term at a time.
Decode is an O(1) recurrent update of a (B, K−1, conv_dim) window and a
float32 (B, H, N, P) state, written into the cache in place (the reference
returns a new cache).  Plain torch on every device, as the reference
computes it outside any kernel; the gated norm runs kernel #10 on the card
(``rmsnorm``, at width ``d_inner``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .modules import dense_init, device_of, param_dtype, rmsnorm, rmsnorm_init, shard


def init_mamba2(generator, cfg, d_model: int) -> Dict:
    dt = param_dtype(cfg)
    dev = device_of(generator)
    d_inner = cfg.ssm_expand * d_model
    nheads = d_inner // cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    conv_dim = d_inner + 2 * g * n
    return {
        # fused input projection: [z, x, B, C, dt]
        "in_proj": dense_init(generator, d_model, (2 * d_inner + 2 * g * n + nheads,), dt),
        "conv_w": dense_init(generator, cfg.conv_kernel, (conv_dim,), dt) * 0.1,
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, dtype=torch.float32, device=dev)),
        "D": torch.ones((nheads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d_inner, dev),
        "out_proj": dense_init(generator, d_inner, (d_model,), dt),
    }


def _split_proj(cfg, d_model, zxbcdt):
    d_inner = cfg.ssm_expand * d_model
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    nheads = d_inner // cfg.ssm_headdim
    z, xbc, dt = zxbcdt.split([d_inner, d_inner + 2 * g * n, nheads], dim=-1)
    return z, xbc, dt, d_inner, g, n, nheads


def _causal_conv(x, w, b):
    """Depthwise causal conv1d.  x (B, S, C); w (K, C).  The taps are
    summed in the reference's order, each product in x's dtype."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return out + b


def _window_conv(window, w, b):
    """The conv over a decode window (B, K, C) -> (B, 1, C): the reference's
    einsum, products exact and summed in float32, rounded once."""
    out = (window.to(torch.float32) * w.to(torch.float32)).sum(dim=1).to(window.dtype)
    return (out + b)[:, None, :]


def _heads(t, b, s, g, hg, n):
    """Group tensors (B, S, G·N) -> (B, S, H, N), each group repeated for its
    hg heads."""
    return t.reshape(b, s, g, 1, n).expand(b, s, g, hg, n).reshape(b, s, g * hg, n)


def mamba2_train(params, cfg, x, positions=None, chunk: int = 256):
    """x (B, S, D) -> (B, S, D) via chunked SSD."""
    b, s, d_model = x.shape
    z, xbc, dt, d_inner, g, n, nheads = _split_proj(cfg, d_model, x @ params["in_proj"])
    xbc = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    xs, bs_, cs = xbc.split([d_inner, g * n, g * n], dim=-1)
    p, h = cfg.ssm_headdim, nheads
    hg = h // g  # heads per group
    xs = shard(xs.reshape(b, s, h, p), ("pod", "data"), None, "model", None)
    b_h = _heads(bs_, b, s, g, hg, n)
    c_h = _heads(cs, b, s, g, hg, n)

    dt_f = F.softplus(dt.to(torch.float32) + params["dt_bias"])  # (B, S, H)
    a = -torch.exp(params["A_log"])  # (H,) negative
    da = dt_f * a  # (B, S, H) log-decay a step

    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"S = {s} is not a multiple of the chunk {chunk}")
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    hstate = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    # One chunk's quadratic term is live at a time (the SSD schedule).
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, bc, cc, dac, dtc = xs[:, sl], b_h[:, sl], c_h[:, sl], da[:, sl], dt_f[:, sl]
        cum = torch.cumsum(dac, dim=1)  # (B, Q, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B, Qi, Qj, H)
        # Mask in log space BEFORE exp: exp of positive garbage above the
        # diagonal would overflow.
        seg = torch.where(causal[None, :, :, None], seg, -torch.inf)
        decay = torch.exp(seg).permute(0, 3, 1, 2)  # (B, H, Qi, Qj)
        # Intra-chunk (quadratic) term.
        cb = torch.einsum("bihn,bjhn->bhij", cc, bc)
        scores = cb * decay
        xf = xc.to(torch.float32)
        y_intra = torch.einsum("bhij,bjhp->bihp", scores.to(torch.float32),
                               dtc[..., None] * xf)
        # Inter-chunk term from the entering state.
        dfs = torch.exp(cum)
        y_inter = torch.einsum("bihn,bhnp->bihp", cc.to(torch.float32) * dfs[..., None], hstate)
        # State update to the chunk's end.
        dte = torch.exp(cum[:, -1:, :] - cum)  # (B, Q, H)
        bx = torch.einsum("bjhn,bjhp->bhnp", bc.to(torch.float32) * (dte * dtc)[..., None], xf)
        hstate = hstate * torch.exp(cum[:, -1, :])[:, :, None, None] + bx
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)
    y = y + xs * params["D"].to(x.dtype)[:, None]
    y = y.reshape(b, s, d_inner)
    y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ params["out_proj"]


def init_mamba2_cache(cfg, batch: int, d_model: int, dtype, device) -> Dict:
    d_inner = cfg.ssm_expand * d_model
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    nheads = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * g * n
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nheads, n, cfg.ssm_headdim), dtype=torch.float32,
                           device=device),
    }


def mamba2_decode(params, cfg, x, cache, pos=None):
    """Single-token recurrent update. x (B, 1, D).  Writes the cache in
    place and returns (out (B, 1, D), cache)."""
    b, _, d_model = x.shape
    z, xbc, dt, d_inner, g, n, nheads = _split_proj(cfg, d_model, x @ params["in_proj"])
    window = torch.cat([cache["conv"], xbc], dim=1)  # (B, K, conv_dim)
    xbc = F.silu(_window_conv(window, params["conv_w"], params["conv_b"]))
    xs, bs_, cs = xbc.split([d_inner, g * n, g * n], dim=-1)
    p, h = cfg.ssm_headdim, nheads
    xs = xs.reshape(b, h, p)
    b_h = _heads(bs_, b, 1, g, h // g, n)[:, 0]  # (B, H, N)
    c_h = _heads(cs, b, 1, g, h // g, n)[:, 0]

    dt_f = F.softplus(dt[:, 0].to(torch.float32) + params["dt_bias"])  # (B, H)
    da = torch.exp(dt_f * -torch.exp(params["A_log"]))  # (B, H)
    ssm = cache["ssm"] * da[:, :, None, None] + (
        b_h.to(torch.float32) * dt_f[..., None])[..., None] * xs.to(torch.float32)[:, :, None, :]
    y = (c_h.to(torch.float32)[:, :, None, :] @ ssm)[:, :, 0].to(x.dtype)  # (B, H, P)
    y = y + xs * params["D"].to(x.dtype)[None, :, None]
    y = y.reshape(b, 1, d_inner)
    y = rmsnorm(params["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ params["out_proj"]
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(ssm)
    return out, cache
