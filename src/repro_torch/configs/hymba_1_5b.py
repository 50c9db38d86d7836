"""Hymba-1.5B: parallel attention + Mamba heads per layer, SWA everywhere
except 3 full-attention layers (first/middle/last), ssm_state=16
[arXiv:2411.13676]. vocab 32001."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid",
        n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
        d_ff=5504, vocab_size=32001,
        default_layer="hymba", global_attn_layers=(0, 15, 31),
        window=1024, ssm=SSMConfig(d_state=16, d_conv=4, expand=2.0),
        tie_embeddings=True,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256,
        default_layer="hymba", global_attn_layers=(0, 3),
        window=16, ssm=SSMConfig(d_state=8, d_conv=4, expand=2.0),
        tie_embeddings=True, remat=False,
    )
