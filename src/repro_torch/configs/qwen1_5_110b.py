"""Qwen1.5-110B: GQA kv=8 with QKV bias [hf:Qwen/Qwen1.5-110B]."""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=49152, vocab_size=152064,
        qkv_bias=True, rope_theta=1e6,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, qkv_bias=True, remat=False,
    )
