"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) moe_d_ff=512
vocab=49155, 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.models.transformer import ModelConfig
from .registry import scale_for_smoke


def config() -> ModelConfig:
    return ModelConfig(
        name="granite_moe_1b",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        moe_d_ff=512,
        ffn_kind="moe",
        n_experts=32,
        experts_per_tok=8,
        router_kind="softmax",
        vocab_size=49155,
        block_pattern=("attn",),
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return scale_for_smoke(config())
