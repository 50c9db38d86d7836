"""DeepSeekMoE-16B: fine-grained experts, 2 shared + 64 routed top-6,
first layer dense [arXiv:2401.06066]. Assigned d_ff=1408 is the per-expert
width; the first dense layer uses the published 10944."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=102400,
        moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff=1408,
                      first_dense_layers=1, dense_d_ff=10944, groups=16),
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=256,
        moe=MoEConfig(n_routed=8, n_shared=2, top_k=2, d_ff=96,
                      first_dense_layers=1, dense_d_ff=256, groups=1),
        remat=False,
    )
