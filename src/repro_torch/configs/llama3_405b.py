"""Llama-3.1 405B: GQA kv=8, 128k vocab, RoPE theta 5e5 [arXiv:2407.21783]."""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        d_ff=53248, vocab_size=128256,
        rope_theta=500000.0,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, rope_theta=500000.0, remat=False,
    )
