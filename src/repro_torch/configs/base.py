"""Model / training / shape configuration schema (a copy of
`repro.configs.base`: shapes only, no weights).

Every architecture file under repro_torch/configs/ exports
``get_config()`` (the exact published spec) and ``get_smoke_config()`` (a
reduced same-family config for CPU smoke tests). Shapes are the four assigned
input-shape cells; `kind` decides which step gets lowered in the dry-run.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_ff: int                      # per-expert FFN width
    capacity_factor: float = 1.25
    groups: int = 1                # dispatch groups (launcher sets >= dp shards)
    aux_weight: float = 0.01
    first_dense_layers: int = 0
    dense_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class GroupRouterConfig(MoEConfig):
    """Port-only: DeepSeek-V3's published router (its config.json's
    `topk_method: noaux_tc`), which no registered arch uses. Sigmoid
    scores; a per-expert bias added for choosing only; `n_group` groups
    ranked by the sum of their top-2 biased scores, `topk_group` kept; the
    top_k experts of those groups; the gate weights the chosen experts'
    raw scores, normalised (`norm_topk_prob`) and times
    `routed_scaling_factor`. Dropless: `capacity_factor` is unused. The
    layer holds the routed experts [first_expert, first_expert +
    experts_held) of `n_routed` (0: all) and computes their part alone,
    as one chip of an expert-parallel deployment does."""
    n_group: int = 8
    topk_group: int = 4
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.5
    experts_held: int = 0
    first_expert: int = 0

    @property
    def held(self) -> int:
        return self.experts_held or self.n_routed


@dataclasses.dataclass(frozen=True)
class YarnMLAConfig(MLAConfig):
    """Port-only: MLA with DeepSeek-V3's YaRN `rope_scaling` (no registered
    arch uses it): the rope dims' frequencies interpolated by `factor`
    between the correction dims of `beta_fast` and `beta_slow` rotations
    over `original_max_positions`, and the softmax scale times mscale**2,
    mscale = 0.1 mscale_all_dim ln(factor) + 1."""
    rope_factor: float = 40.0
    original_max_positions: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: float = 2.0
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # layer pattern: 'attn' | 'mla' | 'swa' | 'mlstm' | 'slstm' | 'hymba'
    default_layer: str = "attn"
    global_attn_layers: tuple = () # indices forced to full 'attn' (hymba)
    slstm_every: int = 0           # xlstm: every k-th layer is sLSTM
    window: int = 0                # sliding-window size for 'swa' layers
    # flavour flags
    qkv_bias: bool = False
    mlp_bias: bool = False
    mlp_gated: bool = True         # SwiGLU vs plain 2-matrix MLP
    mlp_act: str = "silu"
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    parallel_block: bool = False   # command-r style attn || mlp
    tie_embeddings: bool = False
    rope_type: str = "rope"        # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple = ()     # head_dim/2 split over (t, h, w)
    input_mode: str = "tokens"     # tokens | embeddings (audio/vlm stubs)
    pos_embed: str = "none"        # none | sinusoidal (additive)
    logit_softcap: float = 0.0
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # execution
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 1024         # blockwise attention kv-chunk (0 = never)
    scan_layers: bool = True
    # dry-run cost calibration: direct (type, is_moe, count) group override
    layer_groups_override: tuple = ()

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_types(self) -> tuple:
        out = []
        for i in range(self.n_layers):
            t = self.default_layer
            if self.slstm_every and (i + 1) % self.slstm_every == 0:
                t = "slstm"
            if i in self.global_attn_layers:
                # full-window variant of the default layer (hymba keeps its
                # parallel mamba branch; swa models fall back to full attn)
                t = "hymba_g" if self.default_layer == "hymba" else "attn"
            out.append(t)
        return tuple(out)

    def moe_layers(self) -> tuple:
        if self.moe is None:
            return tuple([False] * self.n_layers)
        k = self.moe.first_dense_layers
        return tuple([i >= k for i in range(self.n_layers)])

    def layer_groups(self) -> tuple:
        """Consecutive runs of identical (layer_type, is_moe) -> scan groups.
        Returns tuple of (layer_type, is_moe, count)."""
        if self.layer_groups_override:
            return tuple(tuple(g) for g in self.layer_groups_override)
        kinds = list(zip(self.layer_types(), self.moe_layers()))
        groups = []
        for t, m in kinds:
            if groups and groups[-1][0] == t and groups[-1][1] == m:
                groups[-1][2] += 1
            else:
                groups.append([t, m, 1])
        return tuple((t, m, c) for t, m, c in groups)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    microbatch: int = 0            # 0 -> global_batch (no accumulation)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    optimizer: str = "adamw"       # adamw | adafactor | adamw8bit
    state_dtype: str = "float32"   # moment dtype for adamw
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    grad_compression: str = "none" # none | int8
