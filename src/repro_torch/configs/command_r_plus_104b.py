"""Command R+ 104B: GQA kv=8, no linear biases, PARALLEL attn+FFN block,
LayerNorm, tied embeddings [hf:CohereForAI/c4ai-command-r-plus]."""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
        d_ff=33792, vocab_size=256000,
        norm="layernorm", parallel_block=True, tie_embeddings=True,
        rope_theta=75e6,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256,
        norm="layernorm", parallel_block=True, tie_embeddings=True,
        remat=False,
    )
