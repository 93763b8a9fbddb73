"""deepseek-v3-671b [moe]: 61L d_model=7168 128H MLA, d_ff=2048(moe),
vocab=129280, 1 shared + 256 routed top-8, MTP [arXiv:2412.19437]."""
from repro_torch.models.transformer import ModelConfig
from .registry import scale_for_smoke


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek_v3_671b",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=18432,          # dense layers' FFN (first 3)
        moe_d_ff=2048,
        ffn_kind="moe",
        n_experts=256,
        experts_per_tok=8,
        n_shared_experts=1,
        n_dense_layers=3,
        router_kind="sigmoid",
        vocab_size=129280,
        block_pattern=("mla",),
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        mtp_depth=1,
        tie_embeddings=False,
        attn_chunk=2048,
    )


def smoke_config() -> ModelConfig:
    return scale_for_smoke(config())
