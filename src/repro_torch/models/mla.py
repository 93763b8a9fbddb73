"""Multi-head Latent Attention (DeepSeek-V2/V3).

Counterpart of ``repro.models.mla``.  Prefill projects to a compressed KV
latent ``c_kv`` (kv_lora_rank) plus a decoupled RoPE key ``k_rope`` shared
across heads, and expands per-head ``k_nope, v`` from the latent.  Decode
runs the *absorbed* form: queries are folded through the key up-projection
(``q_eff = q_nope · wk_b``), so attention reads the cached latent directly
and never materialises per-head K/V for the context; the mqr-KV 2-D score
axis lives on the latent (DESIGN.md §3.2).

The cache keeps the reference's layout, ``c_kv`` (B, S, rank) and
``k_rope`` (B, S, rope), and decode writes the new token into it in place
(the reference returns a new cache; ROADMAP C24 for the attention caches).
Prefill and decode are plain torch on every device, as the reference
computes them outside any Pallas kernel: kernel #8 takes no 192 / 128
split of the qk and v head dims, and #9 no two-part key (ROADMAP B).  The
norms ``q_norm`` and ``kv_norm`` run kernel #10 on the card (``rmsnorm``).
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import kvindex

from .attention import _at, _pos
from .modules import apply_rope, dense_init, device_of, param_dtype, rmsnorm, rmsnorm_init, shard

NEG_INF = -1e30


def init_mla(generator, cfg, d_model: int) -> Dict:
    dt = param_dtype(cfg)
    dev = device_of(generator)
    h = cfg.n_heads
    qk_nope, qk_rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": dense_init(generator, d_model, (cfg.q_lora_rank,), dt),
        "q_norm": rmsnorm_init(cfg.q_lora_rank, dev),
        "wq_b": dense_init(generator, cfg.q_lora_rank, (h, qk_nope + qk_rope), dt),
        "wkv_a": dense_init(generator, d_model, (cfg.kv_lora_rank + qk_rope,), dt),
        "kv_norm": rmsnorm_init(cfg.kv_lora_rank, dev),
        "wk_b": dense_init(generator, cfg.kv_lora_rank, (h, qk_nope), dt),
        "wv_b": dense_init(generator, cfg.kv_lora_rank, (h, dv), dt),
        "wo": dense_init(generator, h * dv, (d_model,), dt),
        # the mqr-KV probe direction on the latent (the 2-D score axis)
        "probe": dense_init(generator, cfg.kv_lora_rank, (1,), torch.float32)[:, 0],
    }


def _latent(params, cfg, x, positions):
    """The compressed path shared by prefill and decode: c_kv (B, S, rank)
    normed, k_rope (B, S, rope) rotated."""
    kv_a = x @ params["wkv_a"]
    c_kv, k_rope = kv_a.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c_kv = rmsnorm(params["kv_norm"], c_kv, cfg.norm_eps)
    return c_kv, apply_rope(k_rope, positions, cfg.rope_theta)


def _queries(params, cfg, x, positions):
    """q_nope (B, S, H, nope) and the rotated q_rope (B, S, H, rope)."""
    q_a = rmsnorm(params["q_norm"], x @ params["wq_a"], cfg.norm_eps)
    wq_b = params["wq_b"]
    q = (q_a @ wq_b.reshape(wq_b.shape[0], -1)).reshape(*q_a.shape[:-1], *wq_b.shape[1:])
    q_nope, q_rope = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _scale(cfg) -> torch.Tensor:
    """1 / sqrt(nope + rope) in float32, as the reference's jnp."""
    return 1.0 / torch.sqrt(torch.tensor(float(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim),
                                          dtype=torch.float32))


def _up(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Latent (B, S, rank) through an up-projection (rank, H, k) ->
    (B, H, S, k)."""
    b, s, r = c.shape
    h, k = w.shape[1:]
    return (c @ w.reshape(r, h * k)).reshape(b, s, h, k).transpose(1, 2)


def _out(cfg, out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out (B, S, H, dv) @ wo (H·dv, D) -> (B, S, D)."""
    return out.reshape(*out.shape[:2], -1) @ wo


def mla_train(params, cfg, x, positions, chunk: int = 1024):
    """Prefill (and the training forward): K/V expanded per head, then the
    reference's online softmax over chunks of ``chunk`` keys, qk dim
    nope + rope, v dim ``v_head_dim``.  x (B, S, D) -> (B, S, D)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    c_kv, k_rope = _latent(params, cfg, x, positions)
    q_nope, q_rope = _queries(params, cfg, x, positions)
    q_nope = shard(q_nope, ("pod", "data"), "model", None, None).transpose(1, 2)  # (B, H, S, k)
    q_rope = shard(q_rope, ("pod", "data"), "model", None, None).transpose(1, 2)
    k_nope = _up(c_kv, params["wk_b"])  # (B, H, S, nope)
    v = _up(c_kv, params["wv_b"])       # (B, H, S, dv)
    scale = _scale(cfg)
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"S = {s} is not a multiple of the chunk {chunk}")
    kp = positions.reshape(b, s // chunk, chunk)[0]  # positions are shared over the batch
    qp = positions[:, None, :, None]                 # (B, 1, S, 1)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=x.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=x.device)
    acc = torch.zeros((b, h, s, cfg.v_head_dim), dtype=torch.float32, device=x.device)
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = (q_nope @ k_nope[:, :, sl].transpose(-1, -2)
                  + q_rope @ k_rope[:, None, sl].transpose(-1, -2)).to(torch.float32) * scale
        logits = torch.where(qp >= kp[c], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        vc = v[:, :, sl]
        acc = acc * alpha[..., None] + (p.to(vc.dtype) @ vc).to(torch.float32)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(x.dtype)
    return _out(cfg, out.transpose(1, 2), params["wo"])


def init_mla_cache(cfg, batch: int, max_len: int, dtype, device) -> Dict:
    """The latent cache in the reference's layout: c_kv (B, max_len, rank)
    and k_rope (B, max_len, rope), zeros."""
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim), dtype=dtype,
                              device=device),
    }


def sparse_block_ids(params, cfg, q_eff, c_cache, pos) -> torch.Tensor:
    """mqr-KV selection over the latent cache: one index per batch row over
    c_kv (B, S, rank) with the layer's one probe, each head's region from
    its absorbed query q_eff (B, H, rank) -> ids (B, H, topk) int32.  The
    batched counterpart of the reference's per-row build and per-head
    select."""
    b, skv, rank = c_cache.shape
    topk = min(cfg.mqr_topk, skv // cfg.mqr_block)
    probe = params["probe"]
    index = kvindex.build_kv_index(c_cache, probe.expand(b, rank), cfg.mqr_block,
                                   cfg.mqr_levels)
    regions = kvindex.query_region(q_eff, probe.expand(b, 1, rank), _pos(pos, q_eff.device) + 1)
    return kvindex.select_blocks(index, regions, topk)


def _sparse_attend(cfg, q_eff, q_rope, c_cache, kr_cache, ids, pos, scale):
    """The reference's gather + softmax over the selected latent blocks,
    one batch row at a time (a row's gathered latent at full width is
    H · topk · block · rank, ~1.07 GB in bfloat16) -> (B, H, rank)."""
    b, skv, rank = c_cache.shape
    bs = cfg.mqr_block
    nb = skv // bs
    h, topk = ids.shape[1:]
    sel_pos = (ids.long()[..., None] * bs
               + torch.arange(bs, device=ids.device)).reshape(b, h, topk * bs)
    out = []
    for i in range(b):
        flat = ids[i].reshape(-1).long()
        cg = c_cache[i].view(nb, bs, rank)[flat].reshape(h, topk * bs, rank)
        krg = kr_cache[i].view(nb, bs, -1)[flat].reshape(h, topk * bs, -1)
        logits = ((q_eff[i, :, None, :] @ cg.transpose(-1, -2))
                  + (q_rope[i, :, None, :] @ krg.transpose(-1, -2)))[:, 0]
        logits = logits.to(torch.float32) * scale
        logits = torch.where(sel_pos[i] <= pos, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        out.append((p.to(cg.dtype)[:, None, :] @ cg)[:, 0])
        del cg, krg
    return torch.stack(out)


def mla_decode(params, cfg, x, cache, pos, mqr_sparse: bool = False):
    """Absorbed-latent single-token decode. x (B, 1, D); ``pos`` (a Python
    int or a 0-d integer tensor) is the new token's position.  Writes the
    latent cache in place and returns (out (B, 1, D), cache)."""
    b = x.shape[0]
    h = cfg.n_heads
    positions = _pos(pos, x.device).expand(b, 1)
    c_new, kr_new = _latent(params, cfg, x, positions)
    at = _at(pos, x.device)
    c_cache, kr_cache = cache["c_kv"], cache["k_rope"]
    c_cache.index_copy_(1, at, c_new.to(c_cache.dtype))
    kr_cache.index_copy_(1, at, kr_new.to(kr_cache.dtype))

    q_nope, q_rope = _queries(params, cfg, x, positions)
    # Absorb the key up-projection into the query: (B, H, rank)
    q_eff = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], params["wk_b"])
    q_rope = q_rope[:, 0]  # (B, H, rope)
    scale = _scale(cfg)
    if mqr_sparse:
        ids = sparse_block_ids(params, cfg, q_eff, c_cache, pos)
        attn_c = _sparse_attend(cfg, q_eff, q_rope, c_cache, kr_cache, ids, pos, scale)
    else:
        logits = (q_eff @ c_cache.transpose(1, 2)
                  + q_rope @ kr_cache.transpose(1, 2)).to(torch.float32) * scale  # (B, H, S)
        kv_pos = torch.arange(c_cache.shape[1], device=x.device)
        logits = torch.where(kv_pos <= pos, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        attn_c = p.to(c_cache.dtype) @ c_cache  # (B, H, rank)

    # Expand through the value up-projection, then the output projection.
    out = torch.einsum("bhr,rhk->bhk", attn_c, params["wv_b"])
    return _out(cfg, out.reshape(b, 1, h, cfg.v_head_dim), params["wo"]), cache
