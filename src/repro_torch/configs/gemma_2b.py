"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000 —
GeGLU, head_dim=256 [arXiv:2403.08295]."""
from repro_torch.models.transformer import ModelConfig
from .registry import scale_for_smoke


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma_2b",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        ffn_kind="geglu",
        act="gelu",
        vocab_size=256000,
        block_pattern=("attn",),
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return scale_for_smoke(config())
