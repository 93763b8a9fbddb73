"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152
— llama-arch, code [arXiv:2405.04324]."""
from repro_torch.models.transformer import ModelConfig
from .registry import scale_for_smoke


def config() -> ModelConfig:
    return ModelConfig(
        name="granite_8b",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        ffn_kind="swiglu",
        vocab_size=49152,
        block_pattern=("attn",),
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return scale_for_smoke(config())
