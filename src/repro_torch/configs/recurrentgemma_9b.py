"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attn 1:2 [arXiv:2402.19427]."""
from repro_torch.models.transformer import ModelConfig
from .registry import scale_for_smoke


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma_9b",
        n_layers=36,          # 38 in paper incl. in/out blocks; 36 pattern layers
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        ffn_kind="geglu",
        act="gelu",
        vocab_size=256000,
        block_pattern=("rglru", "rglru", "local"),
        lru_width=4096,
        local_window=2048,
        conv_kernel=4,
        tie_embeddings=True,
        rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return scale_for_smoke(config())
