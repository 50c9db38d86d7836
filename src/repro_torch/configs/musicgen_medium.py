"""MusicGen-medium backbone: decoder-only over EnCodec tokens
[arXiv:2306.05284]. Modality frontend is a STUB: input_specs() provides
precomputed frame embeddings; the head predicts the 2048-entry codebook.
Sinusoidal positions, LayerNorm, plain-GELU MLP (AudioCraft style)."""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
        d_ff=6144, vocab_size=2048,
        norm="layernorm", mlp_gated=False, mlp_act="gelu",
        rope_type="none", pos_embed="sinusoidal",
        input_mode="embeddings",
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=128,
        norm="layernorm", mlp_gated=False, mlp_act="gelu",
        rope_type="none", pos_embed="sinusoidal",
        input_mode="embeddings", remat=False,
    )
