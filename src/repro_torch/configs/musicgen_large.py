"""musicgen-large [audio]: 48L d_model=2048 32H d_ff=8192 vocab=2048 —
decoder-only over EnCodec tokens (4 codebooks); the EnCodec frontend is a
STUB: inputs are codebook token ids [arXiv:2306.05284]."""
from repro_torch.models.transformer import ModelConfig
from .registry import scale_for_smoke


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen_large",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        ffn_kind="mlp_gelu",
        act="gelu",
        vocab_size=2048,
        block_pattern=("attn",),
        frontend="audio_codebooks",
        n_codebooks=4,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return scale_for_smoke(config(), n_codebooks=2)
