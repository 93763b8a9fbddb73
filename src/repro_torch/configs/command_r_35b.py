"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000 — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.models.transformer import ModelConfig
from .registry import scale_for_smoke


def config() -> ModelConfig:
    return ModelConfig(
        name="command_r_35b",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22528,
        ffn_kind="swiglu",
        vocab_size=256000,
        block_pattern=("attn",),
        tie_embeddings=True,
        rope_theta=75e5,
    )


def smoke_config() -> ModelConfig:
    return scale_for_smoke(config())
