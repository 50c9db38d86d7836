"""Qwen2-VL-7B backbone: M-RoPE over (temporal, height, width) position
streams, dynamic-resolution vision frontend STUBBED (input_specs() provides
patch embeddings + 3D positions) [arXiv:2409.12191]."""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab_size=152064,
        qkv_bias=True, rope_type="mrope", mrope_sections=(16, 24, 24),
        rope_theta=1e6, input_mode="embeddings",
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256,
        qkv_bias=True, rope_type="mrope", mrope_sections=(4, 2, 2),
        input_mode="embeddings", remat=False,
    )
