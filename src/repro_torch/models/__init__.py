"""Models (port of `repro.models`): the few-shot feature-extraction
controllers and the decoder-only language model (layers, MoE,
transformer).

Every init takes other randomness than the reference's JAX PRNG `key`:
the LM's `dense_init`, `attn_init`, `mla_init`, `mlp_init`, `moe_init`,
`mlstm_init`, `slstm_init`, `mamba_init` and `transformer.init` a
`torch.Generator` (drawing on its device), `init_conv4` and
`init_resnet12` an integer seed (numpy normals). The draws differ, so
parity tests cross weights over from numpy
(`transformer.params_from_numpy`).
"""
