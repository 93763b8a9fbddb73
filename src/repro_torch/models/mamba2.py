"""Mamba-2 (SSD, state-space duality — arXiv:2405.21060) mixer.

Counterpart of ``repro.models.mamba2``.  Prefill runs the chunked SSD
algorithm: quadratic attention-like work inside a chunk, a linear state
recurrence across chunks, carrying one chunk's quadratic term at a time.
Decode is an O(1) recurrent update of a (B, K−1, conv_dim) window and a
float32 (B, H, N, P) state, written into the cache in place (the reference
returns a new cache).  Plain torch on every device, as the reference
computes it outside any kernel; the gated norm runs kernel #10 on the card
(``rmsnorm``, at width ``d_inner``).

On a mesh (DTensors) the heads lie over ``model`` (ROADMAP C43): the fused
projection, whose X the rules shard over ``model`` with the edges of z,
x, B, C and dt inside the shards, is gathered whole along X, and each rank
runs its heads (their conv channels, B and C whole, the SSD, the skip and
the gate) in one ``local_map``.  Decode keeps the conv window on its
channel shards and the state on its head shards, each written in place.
The gated norm's input (B, S, d_inner) is gathered for #10, which takes
whole rows.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import _lib
from repro_torch.sharding import rules

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


def _head_params(a_log, d_skip, dt_bias, h0: int, hl: int, nheads: int):
    """A_log, D and dt_bias (H,) of heads h0 .. h0+hl-1 (all of them
    without a mesh)."""
    if hl == nheads:
        return a_log, d_skip, dt_bias
    return (t[h0:h0 + hl] for t in (a_log, d_skip, dt_bias))


def _mixer_heads(zxbcdt, conv_w, conv_b, a_log, d_skip, dt_bias, *, cfg, d_model: int,
                 chunk: int, h0: int = 0, hl: int = 0):
    """The mixer from the fused projection zxbcdt (B, S, X), whole along X,
    to the gated y · silu(z) (B, S, hl·P) of heads h0 .. h0+hl-1 (all of
    them for hl 0): the causal conv of the channels those heads read
    (their own of x, B and C whole), the chunked SSD, the skip and the
    gate.  Each head and each channel alone, so a rank's heads take the
    unsharded values."""
    b, s, _ = zxbcdt.shape
    z, xbc, dt, d_inner, g, n, nheads = _split_proj(cfg, d_model, zxbcdt)
    p, hl = cfg.ssm_headdim, hl or nheads
    if hl != nheads:
        mine = slice(h0 * p, (h0 + hl) * p)
        xbc, conv_w, conv_b = (torch.cat([t[..., mine], t[..., d_inner:]], dim=-1)
                               for t in (xbc, conv_w, conv_b))
        z, dt = z[..., mine], dt[..., h0:h0 + hl]
    a_log, d_skip, dt_bias = _head_params(a_log, d_skip, dt_bias, h0, hl, nheads)
    xbc = F.silu(_causal_conv(xbc, conv_w, conv_b))
    xs, bs_, cs = xbc.split([hl * p, g * n, g * n], dim=-1)
    h = nheads
    hg = h // g  # heads per group
    xs = xs.reshape(b, s, hl, p)
    b_h = _heads(bs_, b, s, g, hg, n)
    c_h = _heads(cs, b, s, g, hg, n)
    if hl != nheads:
        b_h, c_h = b_h[:, :, h0:h0 + hl], c_h[:, :, h0:h0 + hl]

    dt_f = F.softplus(dt.to(torch.float32) + dt_bias)  # (B, S, Hl)
    a = -torch.exp(a_log)  # (Hl,) negative
    da = dt_f * a  # (B, S, Hl) log-decay a step

    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"S = {s} is not a multiple of the chunk {chunk}")
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xs.device))
    hstate = torch.zeros((b, hl, n, p), dtype=torch.float32, device=xs.device)
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
        ys.append((y_intra + y_inter).to(zxbcdt.dtype))
    y = torch.cat(ys, dim=1)
    y = y + xs * d_skip.to(zxbcdt.dtype)[:, None]
    return y.reshape(b, s, hl * p) * F.silu(z)


def _head_layout(t, nheads: int):
    """On a mesh, the placements of the mixer's per-head output (B, ·,
    H·P): batch over the data axes, heads over ``model`` where they
    divide; with the first head and the count of heads a rank holds."""
    mesh = t.device_mesh
    yp = rules.placements(rules.clean_spec((("pod", "data"), None, "model"),
                                           (t.shape[0], t.shape[1], nheads), mesh), mesh)
    split = math.prod(mesh.size(i) for i, p in enumerate(yp) if p.is_shard(2))
    return yp, rules.shard_start(mesh, yp, 2, nheads), nheads // split


def _mixer(params, cfg, zxbcdt, d_model: int, chunk: int):
    """:func:`_mixer_heads`.  On a mesh zxbcdt comes gathered whole along X
    (the edges of z, x, B, C and dt fall inside its shards) with the batch
    over the data axes, and one ``local_map`` runs each rank's heads
    (those of ``model``'s shard, ROADMAP C43): zxbcdt's gradient, and
    those of the conv and the (H,) parameters, taken whole, are
    ``Partial`` over the ranks that split the heads or the batch."""
    fn = functools.partial(_mixer_heads, cfg=cfg, d_model=d_model, chunk=chunk)
    ps = (params["conv_w"], params["conv_b"], params["A_log"], params["D"], params["dt_bias"])
    if not isinstance(zxbcdt, DTensor):
        return fn(zxbcdt, *ps)
    nheads = cfg.ssm_expand * d_model // cfg.ssm_headdim
    yp, h0, hl = _head_layout(zxbcdt, nheads)
    zp = tuple(p if p.is_shard(0) else Replicate() for p in yp)
    rep = (Replicate(),) * len(yp)
    zg = tuple(Partial() if y.is_shard(2) else z for y, z in zip(yp, zp))
    pg = tuple(Partial() if p.is_shard() else Replicate() for p in yp)
    return _lib.on_local_shards(functools.partial(fn, h0=h0, hl=hl), (zxbcdt, *ps),
                                (zp,) + (rep,) * 5, yp, (zg,) + (pg,) * 5)


def mamba2_train(params, cfg, x, positions=None, chunk: int = 256):
    """x (B, S, D) -> (B, S, D) via chunked SSD."""
    d_model = x.shape[-1]
    zxbcdt = shard(x @ params["in_proj"], ("pod", "data"), None, None)
    y = rmsnorm(params["norm"], _mixer(params, cfg, zxbcdt, d_model, chunk), cfg.norm_eps)
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


def _conv_step(zxbcdt, conv, conv_w, conv_b, *, cfg, d_model: int, c0: int = 0):
    """The decode conv of channels c0 .. c0+C_l-1 of xBC, those of the conv
    window ``conv`` (B, K-1, C_l), which is written in place: silu of the
    window's conv (B, 1, C_l)."""
    start = cfg.ssm_expand * d_model + c0
    window = torch.cat([conv, zxbcdt[..., start:start + conv.shape[2]]], dim=1)  # (B, K, C_l)
    out = F.silu(_window_conv(window, conv_w, conv_b))
    conv.copy_(window[:, 1:])
    return out


def _ssm_step(zxbcdt, xbc, ssm, a_log, d_skip, dt_bias, *, cfg, d_model: int, h0: int = 0):
    """The recurrent update of heads h0 .. h0+H_l-1, those of the state
    ``ssm`` (B, H_l, N, P), which is written in place, from the conv's
    output xbc (B, 1, conv_dim) whole: the gated y · silu(z) (B, 1,
    H_l·P)."""
    b = zxbcdt.shape[0]
    z, _, dt, d_inner, g, n, nheads = _split_proj(cfg, d_model, zxbcdt)
    xs, bs_, cs = xbc.split([d_inner, g * n, g * n], dim=-1)
    p, h, hl = cfg.ssm_headdim, nheads, ssm.shape[1]
    xs = xs.reshape(b, h, p)
    b_h = _heads(bs_, b, 1, g, h // g, n)[:, 0]  # (B, H, N)
    c_h = _heads(cs, b, 1, g, h // g, n)[:, 0]
    if hl != nheads:
        xs, b_h, c_h = xs[:, h0:h0 + hl], b_h[:, h0:h0 + hl], c_h[:, h0:h0 + hl]
        z, dt = z[..., h0 * p:(h0 + hl) * p], dt[..., h0:h0 + hl]
    a_log, d_skip, dt_bias = _head_params(a_log, d_skip, dt_bias, h0, hl, nheads)

    dt_f = F.softplus(dt[:, 0].to(torch.float32) + dt_bias)  # (B, H)
    da = torch.exp(dt_f * -torch.exp(a_log))  # (B, H)
    new = ssm * da[:, :, None, None] + (
        b_h.to(torch.float32) * dt_f[..., None])[..., None] * xs.to(torch.float32)[:, :, None, :]
    y = (c_h.to(torch.float32)[:, :, None, :] @ new)[:, :, 0].to(zxbcdt.dtype)  # (B, H, P)
    y = y + xs * d_skip.to(zxbcdt.dtype)[None, :, None]
    ssm.copy_(new)
    return y.reshape(b, 1, hl * p) * F.silu(z)


def mamba2_decode(params, cfg, x, cache, pos=None):
    """Single-token recurrent update. x (B, 1, D).  Writes the cache in
    place and returns (out (B, 1, D), cache).  On a mesh (ROADMAP C43)
    the projection is gathered whole along X, the conv runs on the conv
    window's channel shards (``rules.cache_spec``: channels over
    ``model``), its output is gathered, and the state's head shards take
    their heads (``local_map``, each rank writing its own shards)."""
    d_model = x.shape[-1]
    zxbcdt = shard(x @ params["in_proj"], ("pod", "data"), None, None)
    conv, ssm = cache["conv"], cache["ssm"]
    cfn = functools.partial(_conv_step, cfg=cfg, d_model=d_model)
    sfn = functools.partial(_ssm_step, cfg=cfg, d_model=d_model)
    ps = (params["A_log"], params["D"], params["dt_bias"])
    if not isinstance(conv, DTensor):
        xbc = cfn(zxbcdt, conv, params["conv_w"], params["conv_b"])
        y = sfn(zxbcdt, xbc, ssm, *ps)
    else:
        mesh, cp, sp = conv.device_mesh, tuple(conv.placements), tuple(ssm.placements)
        zp = tuple(p if p.is_shard(0) else Replicate() for p in cp)
        wp = tuple(Shard(1) if p.is_shard(2) else Replicate() for p in cp)
        bp = tuple(Shard(0) if p.is_shard(2) else Replicate() for p in cp)
        cfn = functools.partial(cfn, c0=rules.shard_start(mesh, cp, 2, conv.shape[2]))
        args, pls = (zxbcdt, conv, params["conv_w"], params["conv_b"]), (zp, cp, wp, bp)
        xbc = _lib.on_local_shards(cfn, args, pls, cp, pls)
        xbc = shard(xbc, ("pod", "data"), None, None)
        yp = tuple(Shard(2) if p.is_shard(1) else p for p in sp)
        sfn = functools.partial(sfn, h0=rules.shard_start(mesh, sp, 1, ssm.shape[1]))
        rep = (Replicate(),) * len(sp)
        args, pls = (zxbcdt, xbc, ssm, *ps), (zp, zp, sp, rep, rep, rep)
        y = _lib.on_local_shards(sfn, args, pls, yp, pls)
    y = rmsnorm(params["norm"], y, cfg.norm_eps)
    return y @ params["out_proj"], cache
