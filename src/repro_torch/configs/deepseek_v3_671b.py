"""DeepSeek-V3 671B: MLA (q_lora 1536 / kv_lora 512 / rope 64),
1 shared + 256 routed top-8 fine-grained experts, first 3 layers dense
[arXiv:2412.19437]. Assigned d_ff=2048 is the per-expert width; dense
layers use the published 18432. MTP head available via train options."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig


def get_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=2048, vocab_size=129280,
        default_layer="mla",
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
        moe=MoEConfig(n_routed=256, n_shared=1, top_k=8, d_ff=2048,
                      first_dense_layers=3, dense_d_ff=18432, groups=16),
    )


def get_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab_size=256,
        default_layer="mla",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
        moe=MoEConfig(n_routed=8, n_shared=1, top_k=2, d_ff=64,
                      first_dense_layers=1, dense_d_ff=128, groups=1),
        remat=False,
    )
