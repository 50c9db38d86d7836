"""The work of one decode step of a DeepSeek-V3-style model and of its
parts, counted from the configuration's numbers and the mix's shapes
alone, and the H100's dense bfloat16 peak: the yardstick of the LM
cells' `mfu` and roofline shares (bench/work.py keeps the search's).

Operations are the products' multiply-adds times 2 (elementwise work,
norms, softmax and rope left out); bytes are each weight read once (two
bytes a bfloat16 element, four a float32 one), the latent cache read
once and the tokens' activations in and out. For b tokens at position t
(t + 1 cached rows), D hidden, H heads, ranks q and r, rope p, nope n,
value v:

  mla    2 b (D q + q H (n + p) + D (r + p) + H n r + H (t + 1) (r + p)
         + H (t + 1) r + H r v + H v D); bytes: the weights, b (t + 1)
         (r + p) cache elements, b D in and out
  mlp    2 b 3 D F; bytes 3 D F weights
  moe    the router 2 b D E, the shared expert 2 b 3 D F and the routed
         pairs 2 pairs 3 D F, pairs the tokens' expected choices of the
         held experts (b k held / E); bytes: the held and shared experts'
         weights, the float32 router and bias
  logits 2 b D V; bytes D V weights and the (b, V) logits

A bound is the larger of bytes over HBM_BYTES_PER_S and operations over
BF16_OPS_PER_S; `bound_by` names which.
"""

from __future__ import annotations

from bench.work import HBM_BYTES_PER_S

#: NVIDIA's data sheet, H100 SXM, dense bfloat16 tensor-core peak
BF16_OPS_PER_S = 989.4e12


def _bound(ops: float, nbytes: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def mla(c: dict, b: int, t: int) -> dict:
    D, H = c["hidden_size"], c["num_attention_heads"]
    q, r = c["q_lora_rank"], c["kv_lora_rank"]
    n, p, v = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
    rows = t + 1
    weights = D * q + q * H * (n + p) + D * (r + p) + r * H * (n + v) \
        + H * v * D
    ops = 2 * b * (D * q + q * H * (n + p) + D * (r + p) + H * n * r
                   + H * rows * (r + p) + H * rows * r + H * r * v
                   + H * v * D)
    return _bound(ops, 2 * weights + 2 * b * rows * (r + p) + 2 * 2 * b * D)


def mlp(c: dict, b: int) -> dict:
    D, F = c["hidden_size"], c["intermediate_size"]
    return _bound(2 * b * 3 * D * F, 2 * 3 * D * F + 2 * 2 * b * D)


def held_pairs(c: dict, b: int) -> float:
    """The expected (token, held expert) pairs of b tokens."""
    return b * c["num_experts_per_tok"] * c["experts_held"] \
        / c["n_routed_experts"]


def moe(c: dict, b: int) -> dict:
    D, F, E = c["hidden_size"], c["moe_intermediate_size"], \
        c["n_routed_experts"]
    shared = c["n_shared_experts"]
    ops = 2 * b * D * E + 2 * 3 * D * F * (shared * b + held_pairs(c, b))
    nbytes = 2 * 3 * D * F * (c["experts_held"] + shared) + 4 * (D * E + E) \
        + 2 * 2 * b * D
    return _bound(ops, nbytes)


def logits(c: dict, b: int) -> dict:
    D, V = c["hidden_size"], c["vocab_size"]
    return _bound(2 * b * D * V, 2 * D * V + 2 * b * V)


def decode_step(c: dict, b: int, t: int) -> dict:
    """The whole step: every layer's attention and FFN, and the logits."""
    layers = c["num_hidden_layers"]
    dense = min(c["first_k_dense_replace"], layers)
    parts = [mla(c, b, t)] * layers + [mlp(c, b)] * dense \
        + [moe(c, b)] * (layers - dense) + [logits(c, b)]
    return _bound(sum(x["ops"] for x in parts),
                  sum(x["bytes"] for x in parts))
