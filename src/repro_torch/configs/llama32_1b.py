"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.models.transformer import ModelConfig
from .registry import scale_for_smoke


def config() -> ModelConfig:
    return ModelConfig(
        name="llama32_1b",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        ffn_kind="swiglu",
        vocab_size=128256,
        block_pattern=("attn",),
        tie_embeddings=True,
        rope_theta=500000.0,
    )


def smoke_config() -> ModelConfig:
    return scale_for_smoke(config())
