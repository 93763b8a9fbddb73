"""mamba2-2.7b [ssm]: 64L d_model=2560, attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.transformer import ModelConfig
from .registry import scale_for_smoke


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2_2p7b",
        n_layers=64,
        d_model=2560,
        n_heads=80,          # d_inner(5120) / headdim(64)
        n_kv_heads=80,
        head_dim=64,
        d_ff=0,
        ffn_kind="none",
        vocab_size=50280,
        block_pattern=("mamba2",),
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_ngroups=1,
        conv_kernel=4,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return scale_for_smoke(config())
