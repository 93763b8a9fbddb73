"""Architecture registry: the assigned configs, their reduced smoke
variants and per-shape input specs (tensors on the ``meta`` device, no
allocation).

Counterpart of ``repro.configs.registry``; the architecture modules beside
it are copies of the reference's (data only).  :func:`input_specs` gives
the inputs of the dry run (``launch/dryrun.py``) where the reference gives
``ShapeDtypeStruct`` stand-ins.

Shapes (assignment):
  train_4k     seq_len=4096   global_batch=256   -> train_step
  prefill_32k  seq_len=32768  global_batch=32    -> prefill forward
  decode_32k   seq_len=32768  global_batch=128   -> serve_step (1 new token)
  long_500k    seq_len=524288 global_batch=1     -> serve_step, sub-quadratic
               (SSM/hybrid: native state decode; dense attention archs run
                the mqr-KV sparse path — the paper's technique; DESIGN.md §3.2)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

import torch

from repro_torch.models.transformer import ModelConfig, init_caches

ARCHS = (
    "mamba2_2p7b",
    "granite_moe_1b",
    "deepseek_v3_671b",
    "recurrentgemma_9b",
    "gemma_2b",
    "command_r_35b",
    "granite_8b",
    "llama32_1b",
    "musicgen_large",
    "internvl2_2b",
)

SHAPES: Dict[str, dict] = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke_config() if smoke else mod.config()


def scale_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Generic reduction: tiny widths/depths, same family/topology."""
    base = dict(
        n_layers=len(cfg.block_pattern) * 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_chunk=64,
        ssd_chunk=32,
        remat=False,
    )
    if cfg.ffn_kind == "moe":
        base.update(n_experts=4, experts_per_tok=2, moe_d_ff=32,
                    n_shared_experts=min(cfg.n_shared_experts, 1),
                    moe_capacity_factor=4.0)  # drop-free at smoke scale
        if cfg.n_dense_layers:
            base.update(n_layers=3, n_dense_layers=1)
    if cfg.ssm_state:
        base.update(ssm_state=16, ssm_headdim=16, d_model=64)
    if cfg.lru_width:
        base.update(lru_width=64, local_window=32)
    if cfg.use_mla:
        base.update(
            q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16,
        )
    if cfg.frontend == "vision_patches":
        base.update(n_patches=8)
    base.update(mqr_block=16, mqr_topk=4, mqr_levels=4)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)


def input_specs(cfg: ModelConfig, shape_name: str, global_batch=None, seq_len=None):
    """``meta`` tensors standing in for every model input of a shape cell,
    with the reference's shapes and dtypes; decode caches are
    ``init_caches(..., device="meta")`` in the port's layout (C24)."""
    sh = SHAPES[shape_name]
    b = global_batch or sh["global_batch"]
    s = seq_len or sh["seq_len"]
    kind = sh["kind"]

    def spec(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def tok_shape(seq):
        if cfg.frontend == "audio_codebooks":
            return (b, seq, cfg.n_codebooks)
        return (b, seq)

    if kind in ("train", "prefill"):
        seq = s - cfg.n_patches if cfg.frontend == "vision_patches" else s
        batch = {"tokens": spec(tok_shape(seq))}
        if kind == "train":
            batch["labels"] = spec(tok_shape(seq))
        if cfg.frontend == "vision_patches":
            batch["vision_embeds"] = spec((b, cfg.n_patches, cfg.d_model), torch.bfloat16)
        return {"batch": batch}

    # decode: one new token against caches of length s
    return {
        "tokens": spec(tok_shape(1)),
        "caches": init_caches(cfg, b, s, device="meta"),
        "pos": spec(()),
    }
