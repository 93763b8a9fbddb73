"""Composable decoder-only LM: the serving path of the reference's models.

Counterpart of ``repro.models.transformer``.  A model is a stack of
*superblocks*; each applies the layer pattern ``cfg.block_pattern`` (mixer
+ FFN with pre-RMSNorm residuals).  Parameters are the reference's pytree as
nested dicts of tensors, except that ``params["blocks"]`` (and DeepSeek's
``params["blocks_dense"]``, the leading layers with a dense FFN) is a list
with one dict a superblock where the reference stacks them on a leading
axis for ``jax.lax.scan``, and ``params["mtp"]`` a list with one dict a
multi-token-prediction depth; here the superblocks run in a plain loop.
In training (a gradient wanted and ``cfg.remat``) each superblock and the
tail run under ``torch.utils.checkpoint`` (non-reentrant): ``remat_policy``
``"full"`` keeps only each superblock's input, ``"dots"`` also keeps the
outputs of its plain matrix products (``aten.mm``/``addmm``, the
reference's ``dots_with_no_batch_dims_saveable``) through
``create_selective_checkpoint_contexts``.  Caches likewise:
``caches["all"]`` (DeepSeek: ``"dense"`` and ``"moe"``) is a list of
per-superblock dicts, written in place by :func:`decode_step`; attention
caches are (B, Hkv, S, Dh) (C24), the others keep the reference's layout.

Every mixer (``attn``, ``local``, ``mla``, ``mamba2``, ``rglru``) and FFN
(``swiglu``, ``geglu``, ``mlp_gelu``, ``moe``, ``none``) of the ten
configs is ported, with both stub frontends (audio codebooks, vision
patches), and the training loss :func:`loss_and_aux`.  The MTP parameters
are created as the reference's, which never applies them (its
``loss_and_aux`` ignores ``params["mtp"]``): their gradients are ``None``
here and zeros under ``jax.grad``, and ``optim.apply_updates`` updates them
as zeros (ROADMAP C28, C31).

On the card every RMSNorm runs kernel #10, causal attention kernel #8 and
the mqr-KV sparse decode of the ``attn`` mixer kernel #9 (``attention``,
``modules``); in training #8 and #10 run their backward kernels; the MLA,
SSD, RG-LRU and MoE paths are plain torch, as the reference computes them
outside any kernel.  Every entry point takes
``device``: the card unless ``"cpu"`` is asked for.

The same functions run sharded when the parameters, the batch and the
caches are DTensors on a ``DeviceMesh`` (``launch.steps.place``; so far
the dense attention path, :func:`runs_sharded`, ROADMAP A4d):
``modules.shard`` at the reference's call sites, sequence parallelism of the residual when S %
2048 == 0 (gathered at each mixer's and FFN's input, C38), and on the
vocab shards the embedding lookup, the label's logit and the logsumexp
(:func:`embed_lookup`, :func:`label_logits`, :func:`log_sum_exp`; C40).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.kernels import _lib
from repro_torch.kernels.ops import resolve_device
from repro_torch.sharding import rules

from . import attention as attn
from . import mamba2 as m2
from . import mla as mla_mod
from . import moe as moe_mod
from . import rglru as rg
from .modules import (
    Params,
    act_fn,
    dense_init,
    device_of,
    embed_init,
    on_mesh,
    param_dtype,
    rmsnorm,
    rmsnorm_init,
    shard,
    tree_leaves,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    tail_pattern: Tuple[str, ...] = ()  # trailing layers when n_layers % pattern != 0
    ffn_kind: str = "swiglu"  # swiglu | geglu | mlp_gelu | moe | none
    act: str = "silu"
    # MoE
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    n_dense_layers: int = 0  # leading layers with dense FFN (DeepSeek)
    router_kind: str = "softmax"  # softmax | sigmoid
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "einsum"  # einsum (GShard baseline) | scatter (optimized)
    # MLA
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0  # multi-token-prediction heads (DeepSeek-V3)
    # Mamba-2
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    conv_kernel: int = 4
    ssd_chunk: int = 256
    # RG-LRU
    lru_width: int = 0
    local_window: int = 0
    local_attn_impl: str = "banded"  # banded | masked (perf baseline)
    # misc
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"  # full (nothing saveable) | dots (save matmuls)
    attn_chunk: int = 1024
    # frontends (stubs: precomputed embeddings/codebooks)
    frontend: str = "none"  # none | audio_codebooks | vision_patches
    n_codebooks: int = 0
    n_patches: int = 0
    # mqr-KV sparse attention (the paper's technique)
    mqr_block: int = 128
    mqr_topk: int = 64
    mqr_levels: int = 6
    mqr_incremental: bool = False  # index lives in the cache

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """LM-head vocab padded to 256 (pad ids are masked at serve time)."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def n_superblocks(self) -> int:
        body = self.n_layers - len(self.tail_pattern)
        if body % len(self.block_pattern):
            raise ValueError(f"{self.n_layers} layers do not divide into {self.block_pattern}")
        return body // len(self.block_pattern)

    def param_count(self) -> int:
        """Analytic total parameter count N (for 6·N·D roofline)."""
        d = self.d_model
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.frontend == "audio_codebooks":
            total += self.n_codebooks * self.vocab_size * d  # heads
        per_pattern = sum(self._mixer_params(kind) for kind in self.block_pattern)
        total += self.n_superblocks * per_pattern
        for kind in self.tail_pattern:
            total += self._mixer_params(kind)
        for li in range(self.n_layers):
            total += self._ffn_params(li)
        total += self.n_layers * 2 * d  # norms
        return total

    def _mixer_params(self, kind: str) -> int:
        d, dh = self.d_model, self.head_dim_
        if kind in ("attn", "local"):
            return d * dh * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * dh * d
        if kind == "mla":
            r, rk = self.q_lora_rank, self.kv_lora_rank
            qk = self.qk_nope_head_dim + self.qk_rope_head_dim
            return (
                d * r
                + r * self.n_heads * qk
                + d * (rk + self.qk_rope_head_dim)
                + rk * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        if kind == "mamba2":
            d_inner = self.ssm_expand * d
            gn = self.ssm_ngroups * self.ssm_state
            nheads = d_inner // self.ssm_headdim
            return d * (2 * d_inner + 2 * gn + nheads) + d_inner * d
        if kind == "rglru":
            w = self.lru_width
            return 2 * d * w + 2 * w * w + w * d
        raise ValueError(kind)

    def _ffn_params(self, layer_idx: int) -> int:
        d = self.d_model
        if self.ffn_kind == "none":
            return 0
        if self.ffn_kind == "moe" and layer_idx >= self.n_dense_layers:
            e, f = self.n_experts, self.moe_d_ff
            shared = 3 * d * self.moe_d_ff * self.n_shared_experts
            return e * 3 * d * f + d * e + shared
        f = self.d_ff
        if self.ffn_kind == "mlp_gelu":
            return 2 * d * f
        return 3 * d * f

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if self.ffn_kind != "moe":
            return self.param_count()
        total = self.param_count()
        e, k = self.n_experts, self.experts_per_tok
        inactive_layers = self.n_layers - self.n_dense_layers
        inactive = inactive_layers * (e - k) * 3 * self.d_model * self.moe_d_ff
        return total - inactive


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_mixer(generator, cfg, kind: str) -> Params:
    if kind in ("attn", "local"):
        return attn.init_attention(generator, cfg, cfg.d_model)
    if kind == "mla":
        return mla_mod.init_mla(generator, cfg, cfg.d_model)
    if kind == "mamba2":
        return m2.init_mamba2(generator, cfg, cfg.d_model)
    if kind == "rglru":
        return rg.init_rglru(generator, cfg, cfg.d_model)
    raise ValueError(kind)


def _init_ffn(generator, cfg, moe_layer: bool) -> Params:
    dt, d, f = param_dtype(cfg), cfg.d_model, cfg.d_ff
    if cfg.ffn_kind == "none":
        return {}
    if moe_layer:
        return moe_mod.init_moe(generator, cfg, d)
    if cfg.ffn_kind == "mlp_gelu":
        return {"w_in": dense_init(generator, d, (f,), dt),
                "w_out": dense_init(generator, f, (d,), dt)}
    return {"w_gate": dense_init(generator, d, (f,), dt),
            "w_in": dense_init(generator, d, (f,), dt),
            "w_out": dense_init(generator, f, (d,), dt)}


def _init_superblock(generator, cfg, moe_flags, pattern) -> Params:
    """One superblock of ``pattern``; moe_flags: whether each entry's FFN
    is MoE."""
    dev = device_of(generator)
    return {f"l{i}": {
        "mixer_norm": rmsnorm_init(cfg.d_model, dev),
        "mixer": _init_mixer(generator, cfg, kind),
        "ffn_norm": rmsnorm_init(cfg.d_model, dev),
        "ffn": _init_ffn(generator, cfg, moe_flags[i]),
    } for i, kind in enumerate(pattern)}


def init_params(seed: int, cfg: ModelConfig, device=None) -> Params:
    """Random parameters from ``seed`` on ``device`` (the card unless
    ``"cpu"``), laid out as the reference's (``blocks`` a list)."""
    dev = resolve_device(device)
    return _init_params(torch.Generator(device=dev).manual_seed(seed), cfg)


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree of :func:`init_params` with (shape, dtype) leaves,
    allocating nothing."""

    def leaves(tree):
        if isinstance(tree, dict):
            return {k: leaves(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [leaves(v) for v in tree]
        return tuple(tree.shape), tree.dtype

    return leaves(_init_params(torch.device("meta"), cfg))


def _split_stacks(cfg) -> bool:
    """DeepSeek's two homogeneous stacks: the leading ``n_dense_layers``
    with a dense FFN, then the MoE layers."""
    if cfg.ffn_kind == "moe" and cfg.n_dense_layers:
        if len(cfg.block_pattern) != 1:
            raise ValueError("n_dense_layers requires a single-entry pattern")
        return True
    return False


def _init_params(gen, cfg: ModelConfig) -> Params:
    dt, vpad, d = param_dtype(cfg), cfg.padded_vocab, cfg.d_model
    params: Params = {}
    if cfg.frontend == "audio_codebooks":
        params["embed"] = torch.stack([embed_init(gen, vpad, d, dt)
                                      for _ in range(cfg.n_codebooks)])
        params["lm_head"] = torch.stack([dense_init(gen, d, (vpad,), dt)
                                         for _ in range(cfg.n_codebooks)])
    else:
        params["embed"] = embed_init(gen, vpad, d, dt)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, d, (vpad,), dt)
    params["final_norm"] = rmsnorm_init(d, device_of(gen))
    moe = cfg.ffn_kind == "moe"
    pattern = cfg.block_pattern
    if _split_stacks(cfg):
        nd = cfg.n_dense_layers
        params["blocks_dense"] = [_init_superblock(gen, cfg, (False,), pattern)
                                  for _ in range(nd)]
        params["blocks"] = [_init_superblock(gen, cfg, (True,), pattern)
                            for _ in range(cfg.n_layers - nd)]
    else:
        flags = tuple(moe for _ in pattern)
        params["blocks"] = [_init_superblock(gen, cfg, flags, pattern)
                            for _ in range(cfg.n_superblocks)]
    if cfg.tail_pattern:
        tflags = tuple(moe for _ in cfg.tail_pattern)
        params["tail"] = _init_superblock(gen, cfg, tflags, cfg.tail_pattern)
    if cfg.mtp_depth:
        # DeepSeek-V3 MTP: one extra block and a projection a depth, created
        # as the reference's, which never applies them (C28)
        params["mtp"] = [{"proj": dense_init(gen, 2 * d, (d,), dt),
                          "block": _init_superblock(gen, cfg, (moe,), pattern)}
                         for _ in range(cfg.mtp_depth)]
    return params


def param_bytes(params: Params) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ffn_apply(p, cfg, x, moe_layer: bool):
    """-> (y, aux): aux the MoE layer's ``{"expert_load": (E,)}``, else None."""
    if cfg.ffn_kind == "none":
        return x * 0.0, None
    if moe_layer:
        _not_sharded(x, "the MoE FFN")
        return moe_mod.moe_ffn(p, cfg, x)
    act = act_fn(cfg.act)
    if cfg.ffn_kind == "mlp_gelu":
        return act(x @ p["w_in"]) @ p["w_out"], None
    h = act(x @ p["w_gate"]) * (x @ p["w_in"])
    h = shard(h, ("pod", "data"), None, "model")
    return h @ p["w_out"], None


def runs_sharded(cfg: ModelConfig) -> bool:
    """Whether the model's steps run on DTensors over a ``DeviceMesh``
    yet: the dense attention path, every mixer ``attn``, no MoE FFN and
    tokens in (no frontend).  The other mixers, the MoE FFN and the
    frontends raise ``NotImplementedError`` on DTensors (ROADMAP A4d), as
    the mqr-KV sparse decode does."""
    return (set(cfg.block_pattern + cfg.tail_pattern) <= {"attn"}
            and cfg.ffn_kind != "moe" and cfg.frontend == "none")


def _not_sharded(x, what: str) -> None:
    if isinstance(x, DTensor):
        raise NotImplementedError(f"{what} does not run sharded on a DeviceMesh yet "
                                  "(ROADMAP A4d)")


def _mixer_train(p, cfg, kind, x, positions):
    if kind == "attn":
        return attn.attention_train(p, cfg, x, positions)
    _not_sharded(x, f"the {kind} mixer")
    if kind == "local":
        return attn.attention_train(p, cfg, x, positions, window=cfg.local_window)
    if kind == "mla":
        return mla_mod.mla_train(p, cfg, x, positions, chunk=cfg.attn_chunk)
    if kind == "mamba2":
        return m2.mamba2_train(p, cfg, x, positions, chunk=cfg.ssd_chunk)
    if kind == "rglru":
        return rg.rglru_train(p, cfg, x, positions)
    raise ValueError(kind)


def _gather_seq(h):
    """A mixer's or an FFN's input with its sequence whole (batch over the
    data axes): where the residual is sequence-sharded (``_stack``), the
    gather of Megatron-style sequence parallelism, which XLA places for the
    reference.  Without it DTensor flattens (B, S) sharded on both into
    its matrix products, and its planner then takes minutes a step on the
    2x16x16 mesh (ROADMAP C38)."""
    return shard(h, ("pod", "data"), None, None)


def _superblock(block_params, cfg, x, positions, moe_flags, pattern):
    """-> (x, the summed expert load of its MoE layers, or None)."""
    aux_load = None
    for i, kind in enumerate(pattern):
        lp = block_params[f"l{i}"]
        h = _gather_seq(rmsnorm(lp["mixer_norm"], x, cfg.norm_eps))
        x = x + _mixer_train(lp["mixer"], cfg, kind, h, positions)
        h = _gather_seq(rmsnorm(lp["ffn_norm"], x, cfg.norm_eps))
        y, aux = _ffn_apply(lp["ffn"], cfg, h, moe_flags[i])
        x = x + y
        if aux is not None:
            load = aux["expert_load"]
            aux_load = load if aux_load is None else aux_load + load
    return x, aux_load


# the plain matrix products remat_policy="dots" keeps (no batch dims, as the
# reference's dots_with_no_batch_dims_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg, fn, *args):
    """``fn(*args)``, under activation checkpointing when a gradient is
    wanted and ``cfg.remat``: policy ``"dots"`` saves the plain matrix
    products, any other (``"full"``) nothing inside, as the reference's."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    if cfg.remat_policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                       _save_dots))
    return checkpoint(fn, *args, use_reentrant=False)


def _stack(blocks, cfg, x, positions, moe_flags):
    """Every superblock of a stack in turn -> (x, load (E,) float32 summed
    over the stack; (1,) zeros without MoE), as the reference's scan."""
    e = cfg.n_experts if cfg.ffn_kind == "moe" else 1
    load = torch.zeros((e,), dtype=torch.float32, device=x.device)
    for block_params in blocks:
        if x.shape[1] % 2048 == 0:
            # sequence parallelism, as the reference's scan body: the
            # residual (what remat keeps of a superblock) shards its
            # sequence over the model axis
            x = shard(x, ("pod", "data"), "model", None)
        x, aux_load = _remat(cfg, _superblock, block_params, cfg, x, positions, moe_flags,
                             cfg.block_pattern)
        if aux_load is not None:
            load = load + aux_load
    return x, load


def _lookup_local(embed, tokens, v0: int) -> torch.Tensor:
    """Rows of one rank's vocab shard (ids v0 .. v0 + V_local - 1) of the
    embedding table for ``tokens``; zeros for ids in another rank's shard."""
    local = tokens - v0
    inside = (local >= 0) & (local < embed.shape[0])
    return torch.where(inside[..., None], embed[local.clamp(0, embed.shape[0] - 1)], 0)


def embed_lookup(embed, tokens) -> torch.Tensor:
    """``embed[tokens]``.  On a mesh as a vocab-parallel embedding: the
    table's model dim gathered (FSDP), each rank looks its tokens up in its
    own vocab rows, and the result is ``Partial`` over the mesh dims that
    shard the vocab.  DTensor's own rule for the lookup's backward
    (``index_put``) fails on torch 2.11, and would gather the table."""
    if not isinstance(embed, DTensor):
        return embed[tokens]
    mesh, ep = embed.device_mesh, tuple(embed.placements)
    tokens = on_mesh(tokens, embed)
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in ep)
    tp = tuple(Replicate() if e.is_shard(0) or not t.is_shard(0) else t
               for e, t in zip(rows, tokens.placements))
    v0 = rules.shard_start(mesh, rows, 0, embed.shape[0])
    out = tuple(Partial() if e.is_shard(0) else t for e, t in zip(rows, tp))
    grad = tuple(e if e.is_shard(0) else Partial() if t.is_shard(0) else Replicate()
                 for e, t in zip(rows, tp))
    return _lib.on_local_shards(functools.partial(_lookup_local, v0=v0), (embed, tokens),
                                (rows, tp), out, (grad, tp))


def _scale_embeddings(cfg, x):
    """The gemma family scales its input embeddings by sqrt(d_model), taken
    in float32 and cast to the model's dtype, as the reference does."""
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32)).to(x.dtype)
    return x


def _embed_codebooks(emb, tokens):
    """Audio stub: sum over codebooks k of emb[k][tokens[..., k]]."""
    return sum(emb[k][tokens[..., k]] for k in range(emb.shape[0]))


def embed_inputs(params, cfg, batch: Dict[str, torch.Tensor]):
    """Returns (hidden (B, S, D), positions (B, S), loss_mask (B, S))."""
    dt = param_dtype(cfg)
    tokens = batch["tokens"].long()
    dev = tokens.device
    if cfg.frontend != "none":
        _not_sharded(params["embed"], f"the {cfg.frontend} frontend")
    if cfg.frontend == "audio_codebooks":
        x = _embed_codebooks(params["embed"], tokens).to(dt)  # tokens (B, S, K)
        b, s = tokens.shape[:2]
        positions = torch.arange(s, device=dev).expand(b, s)
        return x, positions, torch.ones((b, s), dtype=torch.bool, device=dev)
    if cfg.frontend == "vision_patches":
        vis = batch["vision_embeds"].to(dt)  # (B, P, D)
        x = torch.cat([vis, params["embed"][tokens].to(dt)], dim=1)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=dev).expand(b, s)
        mask = torch.cat([torch.zeros((b, vis.shape[1]), dtype=torch.bool, device=dev),
                          torch.ones(tokens.shape, dtype=torch.bool, device=dev)], dim=1)
        return x, positions, mask
    b, s = tokens.shape
    x = _scale_embeddings(cfg, embed_lookup(params["embed"], tokens).to(dt))
    positions = torch.arange(s, device=dev).expand(b, s)
    return x, positions, torch.ones((b, s), dtype=torch.bool, device=dev)


def forward_hidden(params, cfg, x, positions):
    """The hidden trunk shared by train and prefill: every superblock in a
    loop, the tail, the final norm.  Returns (hidden, load): the expert
    load (E,) summed over the MoE stack, as the reference's (the dense
    stack's and the tail's are dropped, as there; (1,) zeros without
    MoE)."""
    x = shard(x, ("pod", "data"), None, None)
    moe = cfg.ffn_kind == "moe"
    if _split_stacks(cfg):
        x, _ = _stack(params["blocks_dense"], cfg, x, positions, (False,))
        x, load = _stack(params["blocks"], cfg, x, positions, (True,))
    else:
        x, load = _stack(params["blocks"], cfg, x, positions,
                         tuple(moe for _ in cfg.block_pattern))
    if cfg.tail_pattern:
        tflags = tuple(moe for _ in cfg.tail_pattern)
        x, _ = _remat(cfg, _superblock, params["tail"], cfg, x, positions, tflags,
                      cfg.tail_pattern)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), load


def logits_fn(params, cfg, hidden):
    """Logits over the padded vocab, in the model's dtype (the pad ids are
    masked by the serve step, as in the reference)."""
    if cfg.frontend == "audio_codebooks":
        out = torch.einsum("bsd,kdv->bskv", hidden, params["lm_head"])
        return shard(out, ("pod", "data"), None, None, "model")
    out = hidden @ (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    # vocab over the model axis, batch over the data axes, as the reference
    return shard(out, ("pod", "data"), None, "model")


def _label_logits_local(logits, labels, v0: int) -> torch.Tensor:
    """Each label's logit from one rank's vocab shard (vocab ids v0 ..
    v0 + V_local - 1) of ``logits`` (..., V_local); 0 where the label lies
    in another rank's shard."""
    local = labels - v0
    inside = (local >= 0) & (local < logits.shape[-1])
    ll = torch.gather(logits, -1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    return torch.where(inside, ll, 0.0)


def label_logits(logits, labels) -> torch.Tensor:
    """``logits[..., labels]`` (labels >= 0).  Plain tensors take it with
    ``torch.gather``.  On a mesh each rank takes it from its own vocab
    shard, so the sharded logits are never gathered: the result is
    ``Partial`` (one rank's value, the others' 0) over the mesh dims that
    shard the vocab, then summed by whatever reads it (ROADMAP C40; the
    reference reduces a one-hot for the same reason)."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    mesh, last = logits.device_mesh, logits.dim() - 1
    lp = logits.placements
    v0 = rules.shard_start(mesh, lp, last, logits.shape[-1])
    lab = tuple(Replicate() if p.is_shard(last) or p.is_partial() else p for p in lp)
    logit_pl = tuple(Replicate() if p.is_partial() else p for p in lp)
    out = tuple(Partial() if p.is_shard(last) else p for p in logit_pl)
    labels = on_mesh(labels, logits)
    return _lib.on_local_shards(functools.partial(_label_logits_local, v0=v0),
                                (logits, labels), (logit_pl, lab), out, (logit_pl, lab))


def log_sum_exp(logits) -> torch.Tensor:
    """``torch.logsumexp`` over the vocab (the last dim).  On a mesh each
    rank takes it over its own vocab shard and the ranks' results, a
    (..., ranks) tensor, are combined by one more logsumexp, so the
    sharded logits are never gathered (C40); over one rank the combine is
    exact, value and gradient."""
    if not isinstance(logits, DTensor):
        return torch.logsumexp(logits, dim=-1)
    pl = tuple(Replicate() if p.is_partial() else p for p in logits.placements)
    part = _lib.on_local_shards(lambda t: torch.logsumexp(t, dim=-1, keepdim=True),
                                (logits,), (pl,), pl, (pl,))
    return torch.logsumexp(part, dim=-1)


def loss_and_aux(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Next-token cross-entropy (+ MoE load stats), as the reference's:
    ``batch["labels"]`` aligns with ``batch["tokens"]`` shifted by the
    caller (the data pipeline); a label below 0 is ignored.  The logsumexp
    runs over the padded vocab in float32 (the pad columns included, as in
    the reference); a vision model's patch positions get label -1; audio
    takes the mean over its codebooks.  Returns (loss, {"expert_load": (E,),
    "n_tokens": the count of valid positions}).  The label's logit is
    gathered where the reference reduces a one-hot: the same value (on a
    mesh, from each rank's vocab shard: :func:`label_logits`)."""
    x, positions, mask = embed_inputs(params, cfg, batch)
    hidden, load = forward_hidden(params, cfg, x, positions)
    logits = logits_fn(params, cfg, hidden).to(torch.float32)
    labels = batch["labels"].long()
    if cfg.frontend == "vision_patches":
        b, p = labels.shape[0], cfg.n_patches
        pad = torch.full((b, p), -1, dtype=labels.dtype, device=labels.device)
        labels = torch.cat([on_mesh(pad, labels), labels], dim=1)
    mask = on_mesh(mask, labels)
    logz = log_sum_exp(logits)
    ll = label_logits(logits, labels.clamp(min=0))
    if cfg.frontend == "audio_codebooks":
        # labels (B, S, K); logits (B, S, K, V)
        nll = (logz - ll).mean(dim=-1)  # mean over codebooks
        valid = mask & (labels >= 0).all(dim=-1)
    else:
        nll = logz - ll
        valid = mask & (labels >= 0)
    n_tokens = valid.sum()
    loss = torch.sum(nll * valid) / torch.clamp(n_tokens, min=1)
    return loss, {"expert_load": load, "n_tokens": n_tokens}


# ---------------------------------------------------------------------------
# Inference: prefill + decode
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Any:
    """Per-superblock caches: ``{"all": [{"l0": cache, ...}, ...]}``
    (DeepSeek: ``"dense"`` and ``"moe"``; and ``"tail"``) on ``device``
    (the card unless ``"cpu"``): attention (B, Hkv, max_len, Dh), local a
    ring buffer, MLA the latent (B, max_len, rank), Mamba-2 and RG-LRU
    their recurrent states."""
    dev = resolve_device(device)
    dt = param_dtype(cfg)

    def one(kind):
        if kind == "attn":
            return attn.init_kv_cache(cfg, batch, max_len, dt, dev)
        if kind == "local":
            return attn.init_local_cache(cfg, batch, dt, dev)
        if kind == "mla":
            return mla_mod.init_mla_cache(cfg, batch, max_len, dt, dev)
        if kind == "mamba2":
            return m2.init_mamba2_cache(cfg, batch, cfg.d_model, dt, dev)
        if kind == "rglru":
            return rg.init_rglru_cache(cfg, batch, dt, dev)
        raise ValueError(kind)

    def superblock(pattern):
        return {f"l{i}": one(kind) for i, kind in enumerate(pattern)}

    if _split_stacks(cfg):
        nd = cfg.n_dense_layers
        nm = cfg.n_layers - len(cfg.tail_pattern) - nd
        out = {"dense": [superblock(cfg.block_pattern) for _ in range(nd)],
               "moe": [superblock(cfg.block_pattern) for _ in range(nm)]}
    else:
        out = {"all": [superblock(cfg.block_pattern) for _ in range(cfg.n_superblocks)]}
    if cfg.tail_pattern:
        out["tail"] = superblock(cfg.tail_pattern)
    return out


def _mixer_decode(p, cfg, kind, x, cache, pos, mqr_sparse):
    if kind == "attn":
        return attn.attention_decode(p, cfg, x, cache, pos, mqr_sparse=mqr_sparse)
    _not_sharded(x, f"the {kind} mixer")
    if kind == "local":
        return attn.local_attention_decode(p, cfg, x, cache, pos)
    if kind == "mla":
        return mla_mod.mla_decode(p, cfg, x, cache, pos, mqr_sparse=mqr_sparse)
    if kind == "mamba2":
        return m2.mamba2_decode(p, cfg, x, cache, pos)
    if kind == "rglru":
        return rg.rglru_decode(p, cfg, x, cache, pos)
    raise ValueError(kind)


def _superblock_decode(block_params, cfg, x, caches, pos, moe_flags, mqr_sparse, pattern):
    for i, kind in enumerate(pattern):
        lp = block_params[f"l{i}"]
        h = rmsnorm(lp["mixer_norm"], x, cfg.norm_eps)
        y, _ = _mixer_decode(lp["mixer"], cfg, kind, h, caches[f"l{i}"], pos, mqr_sparse)
        x = x + y
        h = rmsnorm(lp["ffn_norm"], x, cfg.norm_eps)
        x = x + _ffn_apply(lp["ffn"], cfg, h, moe_flags[i])[0]
    return x


def decode_step(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, 1) integer (or (B, 1, K) for audio)
    caches,
    pos,  # a Python int or a 0-d integer tensor
    mqr_sparse: bool = False,
):
    """One decode step.  Returns (logits (B, 1, V...), caches); the caches
    are written in place (C24) and returned."""
    dt = param_dtype(cfg)
    tokens = tokens.long()
    if cfg.frontend == "audio_codebooks":
        _not_sharded(params["embed"], "the audio_codebooks frontend")
        x = _embed_codebooks(params["embed"], tokens).to(dt)
    else:
        x = _scale_embeddings(cfg, embed_lookup(params["embed"], tokens).to(dt))
    moe = cfg.ffn_kind == "moe"
    if _split_stacks(cfg):
        stacks = ((params["blocks_dense"], caches["dense"], (False,)),
                  (params["blocks"], caches["moe"], (True,)))
    else:
        stacks = ((params["blocks"], caches["all"], tuple(moe for _ in cfg.block_pattern)),)
    for blocks, stack_caches, flags in stacks:
        for block_params, cache in zip(blocks, stack_caches):
            x = _superblock_decode(block_params, cfg, x, cache, pos, flags, mqr_sparse,
                                   cfg.block_pattern)
    if cfg.tail_pattern:
        tflags = tuple(moe for _ in cfg.tail_pattern)
        x = _superblock_decode(params["tail"], cfg, x, caches["tail"], pos, tflags, mqr_sparse,
                               cfg.tail_pattern)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_fn(params, cfg, x), caches


def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Inference prefill: the full forward, returning the last token's
    logits (B, 1, V...).  Serving builds caches by streaming the prompt
    through :func:`decode_step` (``launch/serve.py``), as the reference."""
    x, positions, _ = embed_inputs(params, cfg, batch)
    hidden, _ = forward_hidden(params, cfg, x, positions)
    return logits_fn(params, cfg, hidden[:, -1:, :])
