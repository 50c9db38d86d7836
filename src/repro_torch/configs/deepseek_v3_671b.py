"""DeepSeek-V3 671B: MLA (q_lora 1536 / kv_lora 512 / rope 64),
1 shared + 256 routed top-8 fine-grained experts, first 3 layers dense
[arXiv:2412.19437]. Assigned d_ff=2048 is the per-expert width; dense
layers use the published 18432. MTP head available via train options.

`get_config()` / `get_smoke_config()` are the registered arch, the JAX
package's twin field for field: it routes with the JAX package's softmax
top-k and capacity dispatch (`models/moe.py`) and uses plain rope. The
published model (config.json's group-limited sigmoid router with its
choice bias, and YaRN) is `get_published_config()`, in the port-only
types `GroupRouterConfig` and `YarnMLAConfig`; it is not in `ARCHS`."""
from repro_torch.configs.base import (GroupRouterConfig, MLAConfig,
                                      ModelConfig, MoEConfig, YarnMLAConfig)


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


def get_published_config(layers: int = 61, experts_held: int | None = None,
                         first_expert: int = 0) -> ModelConfig:
    """The published model (config.json of deepseek-ai/DeepSeek-V3) at
    `layers` layers (the first 3 dense), its layers holding the routed
    experts [first_expert, first_expert + experts_held) of 256 (None:
    all). Every width is published."""
    return ModelConfig(
        name="deepseek-v3-671b-published", family="moe",
        n_layers=layers, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=2048, vocab_size=129280,
        default_layer="mla", rope_theta=10000.0,
        mla=YarnMLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                          qk_nope_dim=128, qk_rope_dim=64, v_dim=128,
                          rope_factor=40.0, original_max_positions=4096,
                          beta_fast=32.0, beta_slow=1.0, mscale=1.0,
                          mscale_all_dim=1.0),
        moe=GroupRouterConfig(n_routed=256, n_shared=1, top_k=8, d_ff=2048,
                              first_dense_layers=3, dense_d_ff=18432,
                              groups=1, n_group=8, topk_group=4,
                              norm_topk_prob=True,
                              routed_scaling_factor=2.5,
                              experts_held=experts_held or 0,
                              first_expert=first_expert),
        remat=False,
    )


def get_published_smoke_config(experts_held: int | None = None,
                               first_expert: int = 0,
                               layers: int = 3) -> ModelConfig:
    """The published router and YaRN at CPU-test widths: 16 routed experts
    in 4 groups, 2 groups kept, top 4; 1 dense layer and then MoE."""
    return ModelConfig(
        name="deepseek-v3-671b-published-smoke", family="moe",
        n_layers=layers, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab_size=256,
        default_layer="mla", rope_theta=10000.0,
        mla=YarnMLAConfig(q_lora_rank=32, kv_lora_rank=16,
                          qk_nope_dim=16, qk_rope_dim=8, v_dim=16,
                          rope_factor=40.0, original_max_positions=4096,
                          beta_fast=32.0, beta_slow=1.0, mscale=1.0,
                          mscale_all_dim=1.0),
        moe=GroupRouterConfig(n_routed=16, n_shared=1, top_k=4, d_ff=32,
                              first_dense_layers=1, dense_d_ff=128,
                              groups=1, n_group=4, topk_group=2,
                              norm_topk_prob=True,
                              routed_scaling_factor=2.5,
                              experts_held=experts_held or 0,
                              first_expert=first_expert),
        remat=False,
    )
