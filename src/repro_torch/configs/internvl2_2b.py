"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553
— InternViT + InternLM2; the ViT frontend is a STUB: input_specs provide
precomputed patch embeddings [arXiv:2404.16821]."""
from repro_torch.models.transformer import ModelConfig
from .registry import scale_for_smoke


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2_2b",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        ffn_kind="swiglu",
        vocab_size=92553,
        block_pattern=("attn",),
        frontend="vision_patches",
        n_patches=1024,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return scale_for_smoke(config())
