"""StarCoder2-3B: GQA kv=2, RoPE, LayerNorm, plain-GELU MLP, biases
[arXiv:2402.19173; hf bigcode/starcoder2-3b]."""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        d_ff=12288, vocab_size=49152,
        norm="layernorm", mlp_gated=False, mlp_act="gelu",
        qkv_bias=True, mlp_bias=True, tie_embeddings=True,
        rope_theta=1e6,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256,
        norm="layernorm", mlp_gated=False, mlp_act="gelu",
        qkv_bias=True, mlp_bias=True, tie_embeddings=True, remat=False,
    )
