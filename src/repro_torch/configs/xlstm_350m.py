"""xLSTM-350M: sLSTM + mLSTM blocks, 7:1 ratio [arXiv:2405.04517].

24L d_model=1024 4H d_ff=0 (block-internal projections) vocab=50304.
Runs long_500k: O(1) recurrent decode state.
"""
from repro_torch.configs.base import ModelConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        default_layer="mlstm", slstm_every=8,
        rope_type="none", tie_embeddings=True,
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab_size=256,
        default_layer="mlstm", slstm_every=4,
        rope_type="none", tie_embeddings=True, remat=False,
    )
