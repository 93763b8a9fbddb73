"""Attention mixers: GQA/MQA full and sliding-window attention, the prefill
path, decode with a KV cache, and the mqr-KV sparse decode path (the
paper's technique; DESIGN.md §3).

Counterpart of ``repro.models.attention``.  Shapes at the functions'
edges are the reference's: hidden (B, S, D); q (B, S, H, Dh); k, v
(B, S, Hkv, Dh).  Three places differ on purpose:

- **The cache layout** (ROADMAP C24).  A cache holds k and v as
  (B, Hkv, S, Dh), not the reference's (B, S, Hkv, Dh), so one (batch, kv
  head) is a contiguous (nb, bs, Dh) run of blocks that kernel #9 reads in
  place, and decode writes the new token into the cache in place (the
  reference returns a new cache).  ``decode`` functions still return the
  cache dict, so callers read as the reference's.
- **Kernels.**  Causal attention without a window runs kernel #8
  (``ops.flash_attention``) over (B·H, S, Dh) with the kv heads broadcast
  to the query heads and S padded to a multiple of 128 (padding keys lie
  past every real query, so causality masks them and the result is
  exact); the mqr-KV sparse decode runs kernel #9
  (``ops.mqr_sparse_attention``) with ``group = H / Hkv`` over the blocks
  the batched index selected.  In training #8 runs through
  ``ops.FlashAttention``, whose backward is #8's backward kernel (D 64,
  128 and 256 on the card).  On a CPU tensor each takes its kernel's
  plain version.  Windowed attention, the banded local path and dense
  decode are plain torch on every device, as the reference computes them
  outside any kernel.  A head dim #8 is not built for (it takes 64, 128
  and 256) raises ``ValueError`` on the card; #9 takes any head dim up to
  256 that is a multiple of 16 bytes' worth of elements.
- **The logit scale.**  The reference divides logits by ``sqrt(Dh)``;
  kernels #8 and #9 multiply by ``1 / sqrt(Dh)``.  The two are the same
  float32 number only where sqrt(Dh) is a power of two (Dh 16, 64, 256);
  at Dh 128 they may differ by one rounding.

Every function assumes the positions of a sequence are 0 .. S-1, as every
caller (``transformer.embed_inputs``) gives them.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core import kvindex
from repro_torch.kernels import _lib, ops
from repro_torch.sharding import rules

from .modules import apply_rope, dense_init, grad_placed, on_mesh, param_dtype, shard

NEG_INF = -1e30
FLASH_TILE = 128  # kernel #8 takes S a multiple of this


def init_attention(generator, cfg, d_model: int) -> Dict:
    dh = cfg.head_dim_
    dt = param_dtype(cfg)
    return {
        "wq": dense_init(generator, d_model, (cfg.n_heads, dh), dt),
        "wk": dense_init(generator, d_model, (cfg.n_kv_heads, dh), dt),
        "wv": dense_init(generator, d_model, (cfg.n_kv_heads, dh), dt),
        "wo": dense_init(generator, cfg.n_heads * dh, (d_model,), dt),
        # mqr-KV probe direction per kv head (the 2-D score axis).
        "probe": dense_init(generator, dh, (cfg.n_kv_heads,), torch.float32).T.contiguous(),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ w (D, H, Dh) -> (B, S, H, Dh).  On a mesh the product
    (B, S, H·Dh) is first brought to batch over the data axes and heads over
    ``model`` where the heads divide (as ``rules.spec_for_param`` shards w),
    else replicated: a shard of H·Dh that splits a head cannot unflatten
    (nor can w's gradient: ``grad_placed``)."""
    y = x @ grad_placed(w.reshape(w.shape[0], -1))
    if isinstance(y, DTensor):
        y = shard(y, *rules.clean_spec((("pod", "data"), None, "model"),
                                       (*y.shape[:2], w.shape[1]), y.device_mesh))
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out (B, S, H, Dh) @ wo (H*Dh, D) -> (B, S, D)."""
    return grad_placed(out.reshape(*out.shape[:2], -1)) @ wo


def _project_qkv(params, cfg, x, positions):
    q = apply_rope(_proj(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_proj(x, params["wk"]), positions, cfg.rope_theta)
    v = _proj(x, params["wv"])
    return q, k, v


def _heads_first(t: torch.Tensor, group: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B*Hkv*group, S, Dh): each kv head repeated for the
    ``group`` query heads that read it (query head h reads kv head h // group)."""
    b, s, hkv, dh = t.shape
    t = t.permute(0, 2, 1, 3)[:, :, None].expand(b, hkv, group, s, dh)
    return t.reshape(b * hkv * group, s, dh)


def _kv_for_heads(t: torch.Tensor, dim: int, h0: int, hl: int, group: int, kv0: int):
    """The kv heads along ``dim`` of t (global heads from ``kv0`` on) that
    query heads h0 .. h0+hl-1 read (head h reads kv head h // group), and
    how many consecutive query heads read each: whole groups, the one kv
    head a rank's heads share (h0 a multiple of hl), else one selected a
    head.  Without a mesh (h0 = kv0 = 0, hl = H) t itself and ``group``."""
    first = h0 // group - kv0
    if h0 % group == 0 and hl % group == 0:
        n, rep = hl // group, group
    elif group % hl == 0:
        n, rep = 1, hl
    else:
        idx = torch.arange(h0, h0 + hl, device=t.device) // group - kv0
        return t.index_select(dim, idx), 1
    if (first, n) != (0, t.shape[dim]):
        t = t.narrow(dim, first, n)
    return t, rep


def _causal_local(q, k, v, h0: int = 0, kv0: int = 0, group: int = 1) -> torch.Tensor:
    """Kernel #8 over plain q (B, S, Hl, Dh), k, v (B, S, Hkv_l, Dh): query
    heads from global h0, kv heads from global kv0 (:func:`_kv_for_heads`)."""
    b, s, h, dh = q.shape
    pad = -s % FLASH_TILE
    qh = _heads_first(q, 1)
    kh, vh = (_heads_first(*_kv_for_heads(t, 2, h0, h, group, kv0)) for t in (k, v))
    if pad:
        qh, kh, vh = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (qh, kh, vh))
    # on the card a head dim the kernel is not built for raises, naming it;
    # under autograd the backward is #8's backward kernel, and the gradients
    # of the broadcast kv heads sum onto their kv head
    out = ops.FlashAttention.call(qh.contiguous(), kh.contiguous(), vh.contiguous())
    return out[:, :s].reshape(b, h, s, dh).permute(0, 2, 1, 3)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of q (B, S, H, Dh) over k, v (B, S, Hkv, Dh) at
    positions 0 .. S-1 -> (B, S, H, Dh), through kernel #8 (its plain
    version on the CPU).  S is padded to a multiple of 128 with zero rows;
    padded keys come after every real query, so they are masked.

    DTensors run on their local shards (``local_map``, at this (B, S, H,
    Dh) level, so no dim sharded on two mesh axes is ever reshaped): the
    batch over the data axes, the heads over ``model`` where they divide,
    the sequence whole (#8 takes q and k at positions 0 .. S-1, so a
    sequence-sharded q, as ``attention_train`` constrains it, is brought
    back to a head shard here; ROADMAP C38).  Each local query head reads
    its kv head by its global index (C39): with more query heads than
    ``model`` ranks but fewer kv heads (llama3.2-1B's 32 and 8 on 16) the kv
    heads are replicated and each rank picks the ones its heads read."""
    h = q.shape[2]
    group = h // k.shape[2]
    if not isinstance(q, DTensor):
        return _causal_local(q, k, v, 0, 0, group)
    mesh = q.device_mesh
    spec = (("pod", "data"), None, "model", None)
    qp = rules.placements(rules.clean_spec(spec, q.shape, mesh), mesh)
    kp = rules.placements(rules.clean_spec(spec, k.shape, mesh), mesh)
    h0 = rules.shard_start(mesh, qp, 2, h)
    kv0 = rules.shard_start(mesh, kp, 2, k.shape[2])
    # a kv head replicated where the query heads are sharded gets a partial
    # gradient on each rank: the ranks' gradients add up
    kg = tuple(Partial() if a.is_shard(2) and not b.is_shard(2) else b for a, b in zip(qp, kp))
    fn = functools.partial(_causal_local, h0=h0, kv0=kv0, group=group)
    return _lib.on_local_shards(fn, (q, k, v), (qp, kp, kp), qp, (qp, kg, kg))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    window: Optional[int] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Counterpart of the reference's ``flash_attention_jnp``: causal
    (optionally windowed) attention, q (B, S, H, Dh), k/v (B, Skv, Hkv, Dh).
    Without a window it is :func:`causal_attention` (kernel #8, positions
    0 .. S-1); with one, the reference's chunked online softmax in plain
    torch, never materialising (S, Skv)."""
    if window is None:
        return causal_attention(q, k, v)
    b, s, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))
    qs = q.reshape(b, s, hkv, g, dh)
    chunk = min(chunk, skv)
    if skv % chunk:
        raise ValueError(f"Skv = {skv} is not a multiple of chunk = {chunk}")
    kp = kv_positions.reshape(b, skv // chunk, chunk)[0]  # positions are shared
    qp = q_positions[:, :, None, None, None]
    m = torch.full((b, s, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, s, hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, s, hkv, g, dh), dtype=torch.float32, device=q.device)
    for c in range(skv // chunk):
        kc = k[:, c * chunk:(c + 1) * chunk]  # (B, chunk, Hkv, Dh)
        vc = v[:, c * chunk:(c + 1) * chunk]
        kpc = kp[c][None, None, None, None, :]
        logits = torch.einsum("bshgd,bchd->bshgc", qs, kc).to(torch.float32) * scale
        mask = (qp >= kpc) & (qp - kpc < window)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bshgc,bchd->bshgd", p.to(vc.dtype), vc).to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, s, h, dh).to(q.dtype)


def local_attention_banded(q, k, v, positions, window: int) -> torch.Tensor:
    """Exact sliding-window attention in O(S·2W): chunks of the window size,
    each attending to itself and the chunk before (plain torch, as the
    reference's jnp)."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    w = window
    if s % w:
        raise ValueError(f"S = {s} is not a multiple of the window {w}")
    nc = s // w
    scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))
    qc = q.reshape(b, nc, w, hkv, g, dh)
    kc = k.reshape(b, nc, w, hkv, dh)
    vc = v.reshape(b, nc, w, hkv, dh)
    pc = positions.reshape(b, nc, w)

    def prev(a):  # the previous chunk, zeros before the first
        return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], dim=1)

    k2 = torch.cat([prev(kc), kc], dim=2)  # (B, nc, 2w, Hkv, Dh)
    v2 = torch.cat([prev(vc), vc], dim=2)
    first = (torch.arange(nc, device=q.device) == 0)[None, :, None]
    p2 = torch.cat([torch.where(first, -1, pc - w), pc], dim=2)  # phantom chunk: -1
    logits = torch.einsum("bcqhgd,bckhd->bcqhgk", qc, k2).to(torch.float32) * scale
    qpos = pc[:, :, :, None, None, None]
    kpos = p2[:, :, None, None, None, :]
    mask = (qpos >= kpos) & (qpos - kpos < w) & (kpos >= 0)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bcqhgk,bckhd->bcqhgd", p.to(v2.dtype), v2)
    return out.reshape(b, s, h, dh)


def _mix(params, cfg, q, k, v, positions, window):
    if window is not None and cfg.local_attn_impl == "banded" and q.shape[1] % window == 0:
        out = local_attention_banded(q, k, v, positions, window)
    else:
        out = flash_attention(q, k, v, positions, positions, window=window,
                              chunk=cfg.attn_chunk)
    return _out_proj(out, params["wo"])


def attention_train(params, cfg, x, positions, window=None):
    """The full-sequence path (training and prefill). x: (B, S, D) -> (B, S, D)."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    q = shard(q, ("pod", "data"), "model", None, None)
    return _mix(params, cfg, q, k, v, positions, window)


def attention_prefill(params, cfg, x, positions, window=None):
    """Returns (out, cache contents k/v), k and v in the cache's layout
    (B, Hkv, S, Dh), for a later decode."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = _mix(params, cfg, q, k, v, positions, window)
    return out, {"k": k.transpose(1, 2).contiguous(), "v": v.transpose(1, 2).contiguous()}


def init_kv_cache(cfg, batch: int, max_len: int, dtype, device) -> Dict:
    """k, v (B, Hkv, max_len, Dh) zeros; with ``mqr_incremental`` (and
    max_len a multiple of the block) the incremental mqr-KV index of every
    (batch, kv head), as in the reference."""
    dh = cfg.head_dim_
    shape = (batch, cfg.n_kv_heads, max_len, dh)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.mqr_incremental and max_len % cfg.mqr_block == 0:
        nb = max_len // cfg.mqr_block
        idx0 = kvindex.init_incremental(nb, cfg.mqr_block, cfg.mqr_levels, device=device)

        def rows(a):
            return a.expand(batch, cfg.n_kv_heads, *a.shape)

        cache["idx_block"] = rows(idx0.block_mbr).contiguous()
        cache["idx_group"] = rows(idx0.group_mbr).contiguous()
        cache["idx_gof"] = rows(idx0.group_of)  # frozen membership: a view
    return cache


def init_local_cache(cfg, batch: int, dtype, device) -> Dict:
    """Ring buffer of the window's size for sliding-window layers."""
    shape = (batch, cfg.n_kv_heads, cfg.local_window, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((cfg.local_window,), -1, dtype=torch.int32, device=device),
    }


def _pos(pos, device) -> torch.Tensor:
    """``pos`` (a Python int or a 0-d integer tensor) as a 0-d int64 tensor
    on the device: a fill for an int, never a read on the host."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).reshape(())
    return torch.full((), int(pos), dtype=torch.int64, device=device)


def _at(pos, device) -> torch.Tensor:
    """``pos`` as a (1,) index for in-place writes."""
    return _pos(pos, device).reshape(1)


def _decode_qkv(params, cfg, x, pos):
    """q (B, 1, H, Dh) and the new k, v (B, 1, Hkv, Dh) at ``pos``."""
    positions = _pos(pos, x.device).expand(x.shape[0], 1)
    return _project_qkv(params, cfg, x, positions)


def _write(cache_t: torch.Tensor, at: torch.Tensor, new: torch.Tensor) -> None:
    """Write new (B, 1, Hkv, Dh) into cache (B, Hkv, S, Dh) at slot ``at``.
    A DTensor cache is written on its local shard (:func:`_write_shard`)."""
    new = new.transpose(1, 2).to(cache_t.dtype)
    if isinstance(cache_t, DTensor):
        _write_shard(cache_t, at, new)
    else:
        cache_t.index_copy_(2, at, new)


def _write_shard(cache_t, at: torch.Tensor, new) -> None:
    """The in-place write of :func:`_write` on each rank's shard of a
    DTensor cache (``rules.cache_spec``: batch over the data axes, kv heads
    or else the sequence over ``model``), gathering nothing: the new
    (B, Hkv, 1, Dh) is brought to the cache's batch and head placements (a
    local slice where it is replicated), and a sequence shard writes slot
    ``at`` only if the slot is its own (a select, no read on the host)."""
    mesh, pl = cache_t.device_mesh, cache_t.placements
    new = on_mesh(new, cache_t)
    want = tuple(Replicate() if p.is_shard(2) else p for p in pl)
    if tuple(new.placements) != want:
        new = new.redistribute(mesh, want)
    local, new = cache_t.to_local(), new.to_local()
    if not any(p.is_shard(2) for p in pl):
        local.index_copy_(2, at, new)
        return
    s0, n = rules.shard_start(mesh, pl, 2, cache_t.shape[2]), local.shape[2]
    slot = (at - s0).clamp(0, n - 1)
    mine = (at >= s0) & (at < s0 + n)
    local.index_copy_(2, slot, torch.where(mine, new, local.index_select(2, slot)))


def _decode_logits(qs, k_cache, mask, dh):
    """qs (B, Hkv, G, Dh) . the cache's keys (B, Hkv, S, Dh): a product in
    the cache's dtype, then float32 over sqrt(Dh), masked."""
    logits = (qs @ k_cache.mT).to(torch.float32)
    logits = logits / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))
    return torch.where(mask, logits, NEG_INF)


def _softmax_attend(qs, k_cache, v_cache, mask, dh):
    """The reference's decode attention: qs (B, Hkv, G, Dh) over the cache
    (B, Hkv, S, Dh); logits as a product in the cache's dtype, then float32
    over sqrt(Dh), masked, softmax, p in v's dtype -> (B, Hkv, G, Dh)."""
    logits = _decode_logits(qs, k_cache, mask, dh)
    p = torch.softmax(logits, dim=-1)
    return p.to(v_cache.dtype) @ v_cache


def local_attention_decode(params, cfg, x, cache, pos):
    """Single-token decode against the ring buffer. x: (B, 1, D); the cache
    is written in place and returned."""
    b = x.shape[0]
    dh, h, hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    w = cache["k"].shape[2]
    q, k_new, v_new = _decode_qkv(params, cfg, x, pos)
    slot = _at(pos, x.device) % w
    _write(cache["k"], slot, k_new)
    _write(cache["v"], slot, v_new)
    kv_pos = cache["pos"]
    kv_pos.index_copy_(0, slot, _at(pos, x.device).to(torch.int32))
    valid = (kv_pos >= 0) & (kv_pos <= pos) & (pos - kv_pos < w)
    qs = q.reshape(b, hkv, h // hkv, dh).to(cache["k"].dtype)
    out = _softmax_attend(qs, cache["k"], cache["v"], valid, dh).reshape(b, 1, h, dh)
    return _out_proj(out, params["wo"]), cache


def attention_decode(params, cfg, x, cache: Dict, pos, window=None, mqr_sparse: bool = False):
    """Single-token decode. x: (B, 1, D); ``pos`` (a Python int or a 0-d
    integer tensor) is the new token's position.  Writes the cache in place
    and returns (out (B, 1, D), cache)."""
    if mqr_sparse and isinstance(cache["k"], DTensor):
        raise NotImplementedError("the mqr-KV sparse decode does not run sharded yet "
                                  "(ROADMAP A4d)")
    q, k_new, v_new = _decode_qkv(params, cfg, x, pos)
    at = _at(pos, x.device)
    _write(cache["k"], at, k_new)
    _write(cache["v"], at, v_new)
    if mqr_sparse and "idx_block" in cache:
        out = _mqr_incremental_decode(params, cfg, q, k_new, cache, pos)
    elif mqr_sparse:
        out = _mqr_sparse_decode(params, cfg, q, cache["k"], cache["v"], pos)
    else:
        out = _dense_decode(cfg, q, cache["k"], cache["v"], pos, window)
    return _out_proj(out, params["wo"]), cache


def _dense_decode(cfg, q, k_cache, v_cache, pos, window):
    group = q.shape[2] // cfg.n_kv_heads
    kv_pos = on_mesh(torch.arange(k_cache.shape[2], device=q.device), k_cache)
    mask = kv_pos <= pos
    if window is not None:
        mask = mask & (kv_pos > pos - window)
    if isinstance(k_cache, DTensor):
        return _dense_decode_sharded(q, k_cache, v_cache, mask, group)
    return _decode_local(q, k_cache, v_cache, mask, group=group)


def _decode_operands(q, k, v, h0: int, kv0: int, group: int):
    """Local q (B, 1, Hl, Dh) as (B, n, g, Dh) in the cache's dtype, with the
    n kv heads (B, n, S_l, Dh) of k, v that its heads read
    (:func:`_kv_for_heads`), as ``_softmax_attend`` takes them."""
    (k, g), (v, _) = (_kv_for_heads(t, 1, h0, q.shape[2], group, kv0) for t in (k, v))
    return q.reshape(q.shape[0], k.shape[1], g, q.shape[3]).to(k.dtype), k, v


def _decode_local(q, k, v, mask, h0=0, kv0=0, group=1):
    """Dense decode attention (``_softmax_attend``) of plain tensors: the
    whole cache without a mesh (h0 = kv0 = 0), or one rank's shards with
    the cache's sequence whole."""
    qs, k, v = _decode_operands(q, k, v, h0, kv0, group)
    return _softmax_attend(qs, k, v, mask, q.shape[-1]).reshape(q.shape)


def _decode_max(q, k, v, mask, h0=0, kv0=0, group=1):
    """The largest masked logit of each query head over one rank's
    sequence shard (B, 1, Hl, 1)."""
    qs, k, _ = _decode_operands(q, k, v, h0, kv0, group)
    logits = _decode_logits(qs, k, mask, q.shape[-1])
    return logits.amax(dim=-1, keepdim=True).reshape(*q.shape[:3], 1)


def _decode_partial(q, k, v, mask, m, h0=0, kv0=0, group=1):
    """One rank's share of the softmax over its sequence shard, shifted by
    the global max ``m``: sum_j e_j v_j (B, 1, Hl, Dh) float32 with e_j
    rounded to v's dtype, as ``_softmax_attend`` rounds p, and sum_j e_j
    (B, 1, Hl, 1)."""
    qs, k, v = _decode_operands(q, k, v, h0, kv0, group)
    logits = _decode_logits(qs, k, mask, q.shape[-1])
    e = torch.exp(logits - m.reshape(*logits.shape[:3], 1))
    o = (e.to(v.dtype) @ v).to(torch.float32)
    return o.reshape(q.shape), e.sum(dim=-1).reshape(*q.shape[:3], 1)


def _dense_decode_sharded(q, k_cache, v_cache, mask, group: int):
    """Dense decode on DTensor caches, each rank on its own shards
    (``local_map``): q takes the cache's batch placements and its kv-head
    placements as query heads (each local query head reads its kv head by
    global index, C39).  Where ``rules.cache_spec`` shards the cache's
    sequence (kv heads that ``model`` does not divide), q is replicated
    over those ranks and the softmax is combined across them as
    flash-decoding does: the global max (a ``Partial("max")``), then each
    rank's shifted sums (``Partial("sum")``), out = sum e v / sum e."""
    mesh, kp = k_cache.device_mesh, tuple(k_cache.placements)
    h, hkv = q.shape[2], k_cache.shape[1]
    qp = tuple(Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(1) else Replicate()
               for p in kp)
    mp = tuple(Shard(0) if p.is_shard(2) else Replicate() for p in kp)
    at = dict(h0=rules.shard_start(mesh, qp, 2, h), kv0=rules.shard_start(mesh, kp, 1, hkv),
              group=group)
    mask = on_mesh(mask, k_cache)
    args, pls = (q, k_cache, v_cache, mask), (qp, kp, kp, mp)
    if not any(p.is_shard(2) for p in kp):
        return _lib.on_local_shards(functools.partial(_decode_local, **at), args, pls, qp, pls)
    m = _lib.on_local_shards(functools.partial(_decode_max, **at), args, pls,
                             tuple(Partial("max") if p.is_shard(2) else a
                                   for p, a in zip(kp, qp)), pls)
    m = m.redistribute(mesh, qp)
    o_pl = tuple(Partial() if p.is_shard(2) else a for p, a in zip(kp, qp))
    o = _lib.on_local_shards(functools.partial(_decode_partial, **at), args + (m,),
                             pls + (qp,), o_pl, pls + (qp,), n_out=2)
    return (o[0] / o[1]).to(v_cache.dtype)


def _probe_rows(params, b: int) -> torch.Tensor:
    """The probes (Hkv, Dh) broadcast over the batch: (B*Hkv, Dh)."""
    probe = params["probe"]
    return probe.expand(b, *probe.shape).reshape(-1, probe.shape[-1])


def _regions(q, probe_rows, hkv: int, pos) -> torch.Tensor:
    """Each query head's region (B*Hkv, G, 4), in its kv head's row."""
    b, _, h, dh = q.shape
    qs = q.reshape(b * hkv, h // hkv, dh)
    return kvindex.query_region(qs, probe_rows[:, None, :], _pos(pos, q.device) + 1)


def sparse_block_ids(params, cfg, q, k_cache, pos) -> torch.Tensor:
    """mqr-KV selection for one decode step, batched over (batch, kv head):
    one build of B·Hkv indexes over the key cache (B, Hkv, S, Dh), each
    query head's region searched in its kv head's index -> ids
    (B·H, topk) int32, query head h of batch b in row b·H + h.  The
    counterpart of the reference's ``vmap`` of build + select."""
    b, hkv, skv, dh = k_cache.shape
    topk = min(cfg.mqr_topk, skv // cfg.mqr_block)
    probe_rows = _probe_rows(params, b)
    index = kvindex.build_kv_index(k_cache.reshape(b * hkv, skv, dh), probe_rows,
                                   cfg.mqr_block, cfg.mqr_levels)
    ids = kvindex.select_blocks(index, _regions(q, probe_rows, hkv, pos), topk)
    return ids.reshape(b * cfg.n_heads, topk)


def _attend_blocks(cfg, q, k_cache, v_cache, ids, pos) -> torch.Tensor:
    """Kernel #9 over the selected blocks, reading the cache in place:
    query row b·H + h reads kv row (b·H + h) // G = b·Hkv + h // G."""
    b, _, h, dh = q.shape
    hkv, skv = k_cache.shape[1], k_cache.shape[2]
    nb, bs = skv // cfg.mqr_block, cfg.mqr_block
    qd = q.reshape(b * h, dh).to(k_cache.dtype)
    out = ops.mqr_sparse_attention(qd, k_cache.view(b * hkv, nb, bs, dh),
                                   v_cache.view(b * hkv, nb, bs, dh), ids, pos,
                                   group=h // hkv)
    return out.reshape(b, 1, h, dh)


def _mqr_sparse_decode(params, cfg, q, k_cache, v_cache, pos):
    """The paper's technique on the KV cache: region-search the mqr-KV index
    and attend only over the selected blocks (DESIGN.md §3)."""
    ids = sparse_block_ids(params, cfg, q, k_cache, pos)
    return _attend_blocks(cfg, q, k_cache, v_cache, ids, pos)


def _mqr_incremental_decode(params, cfg, q, k_new, cache, pos):
    """Sparse decode against the cache-resident incremental index, batched
    over (batch, kv head): the new key's (pos, score) point is merged into
    its block and ancestors, then each query head selects from its kv
    head's index (reading only the index) and kernel #9 attends."""
    b, _, h, dh = q.shape
    hkv = cfg.n_kv_heads
    nb = cache["k"].shape[2] // cfg.mqr_block
    topk = min(cfg.mqr_topk, nb)
    probe_rows = _probe_rows(params, b)
    s_new = kvindex.dot(k_new[:, 0].reshape(b * hkv, dh), probe_rows)  # (B*Hkv,)
    rows = (b * hkv,)
    idx = kvindex.IncKVIndex(cache["idx_block"].view(*rows, nb, 4),
                             cache["idx_group"].view(*rows, *cache["idx_group"].shape[2:]),
                             cache["idx_gof"].reshape(*rows, *cache["idx_gof"].shape[2:]))
    idx = kvindex.incremental_update(idx, pos, s_new, cfg.mqr_block)
    cache["idx_block"].copy_(idx.block_mbr.view_as(cache["idx_block"]))
    cache["idx_group"].copy_(idx.group_mbr.view_as(cache["idx_group"]))
    ids = kvindex.incremental_select(idx, _regions(q, probe_rows, hkv, pos), topk)
    return _attend_blocks(cfg, q, cache["k"], cache["v"], ids.reshape(b * h, topk), pos)
