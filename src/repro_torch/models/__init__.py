from .transformer import ModelConfig, decode_step, init_caches, init_params, prefill  # noqa: F401
