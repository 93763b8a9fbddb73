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

On a mesh (DTensors) the heads lie over ``model`` (``wq_b``, ``wk_b``,
``wv_b`` and ``wo`` as ``sharding.rules`` places them); the online softmax
runs on each rank's batch and heads in ``local_map``, and the dense decode
over a sequence-sharded latent cache combines the ranks' shares as
flash-decoding does, in one ``local_map`` (ROADMAP C41).  The mqr-KV
sparse decode does not run sharded yet (A4d).
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core import kvindex
from repro_torch.kernels import _lib
from repro_torch.sharding import rules

from .attention import _at, _out_proj, _pos, _proj, _write_shard, combine_runs
from .modules import (
    apply_rope,
    dense_init,
    device_of,
    on_mesh,
    param_dtype,
    rmsnorm,
    rmsnorm_init,
    shard,
)

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
    q = _proj(q_a, params["wq_b"])
    q_nope, q_rope = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _scale(cfg) -> torch.Tensor:
    """1 / sqrt(nope + rope) in float32, as the reference's jnp."""
    return 1.0 / torch.sqrt(torch.tensor(float(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim),
                                          dtype=torch.float32))


def _online_softmax(q_nope, q_rope, k_nope, k_rope, v, positions, *, cfg, chunk: int):
    """The reference's online softmax over chunks of ``chunk`` keys: q_nope
    (B, S, H, nope), q_rope (B, S, H, rope), k_nope (B, S, H, nope), the
    shared k_rope (B, S, rope), v (B, S, H, dv), positions (B, S) -> out
    (B, S, H, dv) in v's dtype.  On a mesh each rank runs it on its batch
    and head shard (:func:`_attend`)."""
    b, s, h = q_nope.shape[:3]
    q_nope, q_rope, k_nope, v = (t.transpose(1, 2) for t in (q_nope, q_rope, k_nope, v))
    scale = _scale(cfg)
    if s % chunk:
        raise ValueError(f"S = {s} is not a multiple of the chunk {chunk}")
    kp = positions.reshape(b, s // chunk, chunk)[0]  # positions are shared over the batch
    qp = positions[:, None, :, None]                 # (B, 1, S, 1)
    m = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=v.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=v.device)
    acc = torch.zeros((b, h, s, cfg.v_head_dim), dtype=torch.float32, device=v.device)
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
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(v.dtype).transpose(1, 2)


def _attend(cfg, q_nope, q_rope, k_nope, k_rope, v, positions, chunk: int):
    """:func:`_online_softmax`; DTensors run on their local shards
    (``local_map``), as ``attention.causal_attention`` does: batch over the
    data axes, heads over ``model`` where they divide (a sequence-sharded
    q, as ``mla_train`` constrains it, is brought back to a head shard),
    the shared k_rope and the positions whole on the model ranks, k_rope's
    gradient summed over the ranks that share it (``Partial``)."""
    fn = functools.partial(_online_softmax, cfg=cfg, chunk=chunk)
    if not isinstance(q_nope, DTensor):
        return fn(q_nope, q_rope, k_nope, k_rope, v, positions)
    mesh = q_nope.device_mesh
    hp = rules.placements(rules.clean_spec((("pod", "data"), None, "model", None),
                                           q_nope.shape, mesh), mesh)
    bp = tuple(p if p.is_shard(0) else Replicate() for p in hp)
    kg = tuple(Partial() if p.is_shard(2) else p for p in hp)
    positions = on_mesh(positions, q_nope)
    return _lib.on_local_shards(fn, (q_nope, q_rope, k_nope, k_rope, v, positions),
                                (hp, hp, hp, bp, hp, bp), hp, (hp, hp, hp, kg, hp, bp))


def mla_train(params, cfg, x, positions, chunk: int = 1024):
    """Prefill (and the training forward): K/V expanded per head, then the
    reference's online softmax over chunks of ``chunk`` keys, qk dim
    nope + rope, v dim ``v_head_dim``.  x (B, S, D) -> (B, S, D)."""
    c_kv, k_rope = _latent(params, cfg, x, positions)
    q_nope, q_rope = _queries(params, cfg, x, positions)
    q_nope = shard(q_nope, ("pod", "data"), "model", None, None)
    q_rope = shard(q_rope, ("pod", "data"), "model", None, None)
    k_nope = _proj(c_kv, params["wk_b"])  # (B, S, H, nope)
    v = _proj(c_kv, params["wv_b"])       # (B, S, H, dv)
    out = _attend(cfg, q_nope, q_rope, k_nope, k_rope, v, positions, min(chunk, x.shape[1]))
    return _out_proj(out, params["wo"])


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


def _write(cache_t: torch.Tensor, at: torch.Tensor, new: torch.Tensor) -> None:
    """Write new (B, 1, ·) into a latent cache (B, S, ·) at slot ``at``; a
    DTensor cache on its local shard (``attention._write_shard``)."""
    new = new.to(cache_t.dtype)
    if isinstance(cache_t, DTensor):
        _write_shard(cache_t, at, new, dim=1)
    else:
        cache_t.index_copy_(1, at, new)


def _latent_softmax(q_eff, q_rope, c_cache, kr_cache, pos, *, scale, s0: int = 0):
    """The dense decode's softmax over one run of the latent cache, keys
    at positions s0 .. s0 + S_l - 1: q_eff (B, H, rank), q_rope (B, H,
    rope), c_cache (B, S_l, rank), kr_cache (B, S_l, rope) -> (m (1, B, H),
    l (1, B, H), o (1, B, H, rank)): the largest masked logit, the sum of
    exp(logit - m), and the run's softmax (in the cache's dtype) times its
    latent, each with a leading dim of one (the run's place in the
    sequence, :func:`_dense_latent_sharded`)."""
    logits = (q_eff @ c_cache.transpose(1, 2)
              + q_rope @ kr_cache.transpose(1, 2)).to(torch.float32) * scale  # (B, H, S_l)
    kv_pos = torch.arange(s0, s0 + c_cache.shape[1], device=c_cache.device)
    logits = torch.where(kv_pos <= pos, logits, NEG_INF)
    m = logits.amax(dim=-1)
    l = torch.exp(logits - m[..., None]).sum(dim=-1)
    o = torch.softmax(logits, dim=-1).to(c_cache.dtype) @ c_cache  # (B, H, rank)
    return m[None], l[None], o[None]


def _dense_latent_sharded(q_eff, q_rope, c_cache, kr_cache, pos, scale) -> torch.Tensor:
    """The dense decode on DTensor caches (``rules.cache_spec``: batch over
    the data axes, the sequence over ``model`` where it divides), as
    flash-decoding combines it: one ``local_map`` in which each rank takes
    the softmax over its run of keys (q with the cache's batch placements,
    its heads whole), giving its max m_r, its sum l_r and its o_r; then, the
    ranks' three gathered, w_r = exp(m_r - m) l_r with m the largest, and
    out = sum_r (w_r / sum w) o_r, in the cache's dtype.  Over one run (a
    sequence not split) the weight is exactly 1 and out is the plain
    decode's, bit for bit."""
    mesh, cp = c_cache.device_mesh, tuple(c_cache.placements)
    qp = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in cp)
    # outputs (runs, B, H[, rank]): the run over the ranks that split the
    # sequence, the batch as the cache's
    op = tuple(Shard(0) if p.is_shard(1) else Shard(1) if p.is_shard(0) else Replicate()
               for p in cp)
    fn = functools.partial(_latent_softmax, pos=pos, scale=scale,
                           s0=rules.shard_start(mesh, cp, 1, c_cache.shape[1]))
    args, pls = (q_eff, q_rope, c_cache, kr_cache), (qp, qp, cp, tuple(kr_cache.placements))
    m, l, o = _lib.on_local_shards(fn, args, pls, op, pls, n_out=3)
    whole = tuple(Shard(1) if p.is_shard(0) else Replicate() for p in cp)
    return combine_runs(m, l, o, whole, c_cache.dtype)


def mla_decode(params, cfg, x, cache, pos, mqr_sparse: bool = False):
    """Absorbed-latent single-token decode. x (B, 1, D); ``pos`` (a Python
    int or a 0-d integer tensor) is the new token's position.  Writes the
    latent cache in place and returns (out (B, 1, D), cache)."""
    if mqr_sparse and isinstance(cache["c_kv"], DTensor):
        raise NotImplementedError("the mqr-KV sparse decode does not run sharded yet "
                                  "(ROADMAP A4d)")
    b = x.shape[0]
    h = cfg.n_heads
    positions = _pos(pos, x.device).expand(b, 1)
    c_new, kr_new = _latent(params, cfg, x, positions)
    at = _at(pos, x.device)
    c_cache, kr_cache = cache["c_kv"], cache["k_rope"]
    _write(c_cache, at, c_new)
    _write(kr_cache, at, kr_new)

    q_nope, q_rope = _queries(params, cfg, x, positions)
    # Absorb the key up-projection into the query: (B, H, rank)
    q_eff = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], params["wk_b"])
    q_rope = q_rope[:, 0]  # (B, H, rope)
    scale = _scale(cfg)
    if mqr_sparse:
        ids = sparse_block_ids(params, cfg, q_eff, c_cache, pos)
        attn_c = _sparse_attend(cfg, q_eff, q_rope, c_cache, kr_cache, ids, pos, scale)
    elif isinstance(c_cache, DTensor):
        attn_c = _dense_latent_sharded(q_eff, q_rope, c_cache, kr_cache, pos, scale)
    else:
        attn_c = _latent_softmax(q_eff, q_rope, c_cache, kr_cache, pos, scale=scale)[2][0]

    # Expand through the value up-projection, then the output projection.
    out = torch.einsum("bhr,rhk->bhk", attn_c, params["wv_b"])
    return _out_proj(out.reshape(b, 1, h, cfg.v_head_dim), params["wo"]), cache
