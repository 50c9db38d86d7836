"""Plain reference of DeepSeek-V3's forward pass and of the kNN-LM head
over the MCAM datastore, written from the published description
(arXiv:2412.19437 Sec. 2.1; the model's config.json: MLA, YaRN
rope_scaling, the `noaux_tc` router) in plain PyTorch, float32.

It imports nothing of the program under test and no kernel. The head's
search is `bench/reference/mcam.py`'s `two_phase`. The benchmark hands it
the weights it draws from the seed at the configuration's shapes (never
the program's tree) and the inputs (and, to hold the program layer by
layer, the program's own input to each part); it computes in float32
with TF32 off, upcasting one layer's weights at a time.

Config: a dict of the model's config.json keys (`hidden_size`,
`num_attention_heads`, `q_lora_rank`, `kv_lora_rank`,
`qk_nope_head_dim`, `qk_rope_head_dim`, `v_head_dim`, `rope_theta`,
`rope_scaling`, `n_routed_experts`, `num_experts_per_tok`, `n_group`,
`topk_group`, `norm_topk_prob`, `routed_scaling_factor`,
`rms_norm_eps`, `first_k_dense_replace`) and the share held
(`experts_held`, `first_expert`).

Weights, by name (the program's tree is given the same tensors under
the same names):
  attention  wq_a (D, q_lora), q_norm (q_lora,), wq_b (q_lora, H, nope +
             rope), wkv_a (D, kv_lora + rope), kv_norm (kv_lora,), wkv_b
             (kv_lora, H, nope + v), wo_mla (H, v, D)
  dense FFN  w1, w3 (D, F), w2 (F, D)
  MoE        router (D, E), bias (E,) (`e_score_correction_bias`), we1,
             we3 (held, D, F), we2 (held, F, D): the experts
             first_expert + 0 .. held - 1, held = `experts_held`; shared
             {w1, w2, w3}
  layer      norm1 / norm2 {scale}; model: embed (V, D), final_norm
             {scale}, unembed (D, V)

Semantics:
  MLA        c_q = RMSNorm(x W_qa); q = c_q W_qb per head, split into
             nope and rope; [c_kv, k_pe] = x W_kva, c_kv = RMSNorm(c_kv);
             k_nope, v = c_kv W_kvb per head; q_pe and k_pe rotated at
             their positions (k_pe shared by the heads); scores (q_nope .
             k_nope + q_pe . k_pe) times the softmax scale, causal;
             output softmax . v, then W_o. Decode over a cache of
             (c_kv, k_pe) rows takes the absorbed form (DeepSeek-V2 Sec.
             2.1.2): q_nope W_uk^T scored against c_kv, the latent output
             through W_uv: the same sums, grouped otherwise.
  YaRN       rope frequencies 1 / theta^(2i/d) for i below the correction
             dim of beta_fast rotations over the original positions,
             divided by the factor above that of beta_slow, a linear ramp
             between (frequencies folded in float64, rounded to float32
             once); cos and sin times mscale(factor, mscale) /
             mscale(factor, mscale_all_dim); the softmax scale
             1 / sqrt(nope + rope) times mscale(factor, mscale_all_dim)^2,
             mscale(s, m) = 0.1 m ln s + 1.
  router     s = sigmoid(h W_r); choice = s + bias; 8 groups ranked by the
             sum of their two best choice scores, topk_group kept; the 8
             best choice scores among the kept groups' experts; gates the
             chosen experts' s, normalised to sum 1, times
             routed_scaling_factor. No token is dropped.
  MoE layer  the held experts' gated SwiGLU outputs for the tokens routed
             to them, plus the shared expert's for every token; the
             absent experts' part is left out.
  block      x + MLA(RMSNorm(x)); then + FFN(RMSNorm(.)); the first
             `first_k_dense_replace` layers' FFN dense, the rest MoE.
  head       logits = RMSNorm(x) W_unembed; the kNN mixture log((1 - lam)
             softmax(logits) + lam p_mem + 1e-20), p_mem the softmax of
             votes / 10 over the valid candidates of the MCAM search of
             x[:, :dim], each added into its label's entry.

Departures, each the program's too: rope rotates the two halves of the
rope dims as pairs (the port's layout) where the published code pairs
interleaved dims, a permutation of the rope weights' columns under random
weights; multi-token prediction is left out (Sec. 2.2: its modules can be
dropped at inference).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench.reference import mcam


def precise() -> None:
    """float32 products in float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    x = _f(x)
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * _f(scale)


# -- YaRN --------------------------------------------------------------------


def mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def rope_table(cfg: dict, device) -> tuple[torch.Tensor, float, float]:
    """(inverse frequencies (rope/2,) float32, cos/sin factor, softmax
    scale) of the configuration's rope_scaling."""
    d, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    scale = 1.0 / math.sqrt(cfg["qk_nope_head_dim"] + d)
    exps = np.arange(0, d, 2, dtype=np.float32).astype(np.float64) / d
    extra = 1.0 / np.power(base, exps)
    rs = cfg.get("rope_scaling")
    if not rs:
        return torch.from_numpy(extra.astype(np.float32)).to(device), 1.0, \
            scale
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def dim_of(rot):
        return d * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))
    low = max(math.floor(dim_of(rs["beta_fast"])), 0)
    high = min(math.ceil(dim_of(rs["beta_slow"])), d - 1)
    ramp = np.clip((np.arange(d // 2) - low) / max(high - low, 0.001), 0, 1)
    inv = extra / factor * ramp + extra * (1 - ramp)
    cs = mscale(factor, rs["mscale"]) / mscale(factor, rs["mscale_all_dim"])
    if rs.get("mscale_all_dim"):
        scale *= mscale(factor, rs["mscale_all_dim"]) ** 2
    return torch.from_numpy(inv.astype(np.float32)).to(device), cs, scale


def rope(x: torch.Tensor, pos: torch.Tensor, table) -> torch.Tensor:
    """x (..., S, [H,] d) rotated at positions pos (S,): the halves of the
    rope dims paired."""
    inv, cs, _ = table
    ang = pos.to(torch.float32)[:, None] * inv                 # (S, d/2)
    cos, sin = torch.cos(ang) * cs, torch.sin(ang) * cs
    if x.ndim == 4:
        cos, sin = cos[:, None], sin[:, None]
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


# -- attention ---------------------------------------------------------------


def _latents(p: dict, x: torch.Tensor, pos: torch.Tensor, cfg: dict, table):
    """x (B, S, D) float32 -> (q_nope, q_pe (B, S, H, .), c_kv (B, S, r),
    k_pe (B, S, rope)), rope applied."""
    eps, r = cfg["rms_norm_eps"], cfg["kv_lora_rank"]
    nope = cfg["qk_nope_head_dim"]
    cq = rms_norm(x @ _f(p["wq_a"]), p["q_norm"], eps)
    q = torch.einsum("bsr,rhk->bshk", cq, _f(p["wq_b"]))
    kv_a = x @ _f(p["wkv_a"])
    c_kv = rms_norm(kv_a[..., :r], p["kv_norm"], eps)
    k_pe = rope(kv_a[..., r:], pos, table)
    return q[..., :nope], rope(q[..., nope:], pos, table), c_kv, k_pe


def mla_prefill(p: dict, x: torch.Tensor, cfg: dict, table
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal MLA over positions 0..S-1 of x (B, S, D) -> (y (B, S, D),
    c_kv, k_pe): every head's keys and values expanded from the latents."""
    nope = cfg["qk_nope_head_dim"]
    x = _f(x)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    q_nope, q_pe, c_kv, k_pe = _latents(p, x, pos, cfg, table)
    kv = torch.einsum("bsr,rhn->bshn", c_kv, _f(p["wkv_b"]))
    k_nope, v = kv[..., :nope], kv[..., nope:]
    s = (torch.einsum("bshn,bthn->bhst", q_nope, k_nope)
         + torch.einsum("bshk,btk->bhst", q_pe, k_pe)) * table[2]
    causal = pos[None, :] <= pos[:, None]
    s = s.masked_fill(~causal, -math.inf)
    o = torch.einsum("bhst,bthv->bshv", torch.softmax(s, -1), v)
    return torch.einsum("bshv,hvd->bsd", o, _f(p["wo_mla"])), c_kv, k_pe


def mla_decode(p: dict, x: torch.Tensor, c_kv: torch.Tensor,
               k_pe: torch.Tensor, pos: int, cfg: dict, table
               ) -> torch.Tensor:
    """One position `pos` of x (B, D) attending over the cached latents
    of positions 0..pos-1 (c_kv (B, pos, r), k_pe (B, pos, rope)) and its
    own -> y (B, D), in the absorbed form."""
    nope = cfg["qk_nope_head_dim"]
    x = _f(x)[:, None]
    q_nope, q_pe, c_new, k_new = _latents(
        p, x, torch.tensor([pos], device=x.device), cfg, table)
    c_all = torch.cat([_f(c_kv), c_new], 1)                    # (B, T, r)
    k_all = torch.cat([_f(k_pe), k_new], 1)
    w = _f(p["wkv_b"])
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w[..., :nope])
    s = (torch.einsum("bhr,btr->bht", q_lat, c_all)
         + torch.einsum("bhk,btk->bht", q_pe[:, 0], k_all)) * table[2]
    o_lat = torch.einsum("bht,btr->bhr", torch.softmax(s, -1), c_all)
    o = torch.einsum("bhr,rhv->bhv", o_lat, w[..., nope:])
    return torch.einsum("bhv,hvd->bd", o, _f(p["wo_mla"]))


def attention_block(p: dict, x: torch.Tensor, c_kv: torch.Tensor,
                    k_pe: torch.Tensor, pos: int, cfg: dict, table
                    ) -> torch.Tensor:
    """The decode step's stream after attention: x + MLA(RMSNorm(x))."""
    h = rms_norm(x, p["norm1"]["scale"], cfg["rms_norm_eps"])
    return _f(x) + mla_decode(p["attn"], h, c_kv, k_pe, pos, cfg, table)


# -- FFN: the dense MLP and the routed experts -------------------------------


def swiglu(h: torch.Tensor, w1, w2, w3) -> torch.Tensor:
    return (F.silu(h @ _f(w1)) * (h @ _f(w3))) @ _f(w2)


def route(h: torch.Tensor, router: torch.Tensor, bias: torch.Tensor,
          cfg: dict) -> dict:
    """The router of tokens h (T, D) -> {gate (T, k), experts (T, k),
    margin (T,)}: margin, the least of the gaps between the k-th and
    (k+1)-th eligible choice scores and between the kept and the best
    dropped group's scores (where the choice hangs on rounding)."""
    k, G = cfg["num_experts_per_tok"], cfg["n_group"]
    s = torch.sigmoid(_f(h) @ _f(router))
    T, E = s.shape
    choice = (s + _f(bias)).view(T, G, E // G)
    gscore = choice.sort(-1, descending=True).values[..., :2].sum(-1)
    gorder = gscore.sort(-1, descending=True)
    kept = gorder.indices[:, :cfg["topk_group"]]
    allowed = torch.zeros(T, G, dtype=torch.bool, device=h.device)
    allowed.scatter_(1, kept, True)
    eligible = torch.where(allowed[..., None], choice,
                           -math.inf).reshape(T, E)
    order = eligible.sort(-1, descending=True)
    experts = order.indices[:, :k]
    margin = order.values[:, k - 1] - order.values[:, k]
    if cfg["topk_group"] < G:
        gv = gorder.values
        margin = torch.minimum(margin, gv[:, cfg["topk_group"] - 1]
                               - gv[:, cfg["topk_group"]])
    gate = s.gather(1, experts)
    if cfg["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True)
    return {"gate": gate * cfg["routed_scaling_factor"], "experts": experts,
            "margin": margin}


def moe(p: dict, h: torch.Tensor, r: dict, cfg: dict) -> torch.Tensor:
    """The held experts' part for the tokens routed to them (r: `route`'s
    choice) and the shared expert's, for tokens h (T, D)."""
    h = _f(h)
    y = swiglu(h, p["shared"]["w1"], p["shared"]["w2"], p["shared"]["w3"])
    first = cfg["first_expert"]
    for e in range(cfg["experts_held"]):
        tok, slot = torch.nonzero(r["experts"] == first + e, as_tuple=True)
        if tok.numel():
            out = swiglu(h[tok], p["we1"][e], p["we2"][e], p["we3"][e])
            y.index_add_(0, tok, r["gate"][tok, slot, None] * out)
    return y


def ffn(p: dict, h: torch.Tensor, cfg: dict, is_moe: bool,
        r: dict | None = None) -> torch.Tensor:
    """A layer's FFN of its normed input h (T, D): the dense MLP, or the
    MoE share routed by r (default: `route` of h)."""
    if not is_moe:
        m = p["mlp"]
        return swiglu(_f(h), m["w1"], m["w2"], m["w3"])
    m = p["moe"]
    r = route(h, m["router"], m["bias"], cfg) if r is None else r
    return moe(m, h, r, cfg)


# -- the model ---------------------------------------------------------------


def layer_is_moe(cfg: dict, i: int) -> bool:
    return i >= cfg["first_k_dense_replace"]


def forward(params: list[dict], embed: torch.Tensor, head: dict,
            tokens: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The full forward pass of tokens (B, S) -> float32 logits (B, S,
    V). params: one dict a layer ({norm1, attn, norm2, mlp | moe})."""
    table = rope_table(cfg, tokens.device)
    eps = cfg["rms_norm_eps"]
    x = _f(embed)[tokens]
    for i, p in enumerate(params):
        h = rms_norm(x, p["norm1"]["scale"], eps)
        x = x + mla_prefill(p["attn"], h, cfg, table)[0]
        h = rms_norm(x, p["norm2"]["scale"], eps)
        B, S, D = h.shape
        x = x + ffn(p, h.reshape(B * S, D), cfg,
                    layer_is_moe(cfg, i)).reshape(B, S, D)
    return logits(head, x, cfg)


def logits(head: dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    return rms_norm(x, head["final_norm"]["scale"], cfg["rms_norm_eps"]) \
        @ _f(head["unembed"])


# -- the kNN-LM head ---------------------------------------------------------


def knn_search(hidden: torch.Tensor, store: "mcam.Store", dim: int,
               k: int) -> dict:
    """`mcam.two_phase` of the hidden rows' first `dim` entries."""
    return mcam.two_phase(_f(hidden[:, :dim]), store, k)


def mixture(lm_logits: torch.Tensor, votes: torch.Tensor,
            labels: torch.Tensor, lam: float) -> torch.Tensor:
    """log((1 - lam) softmax(logits) + lam p_mem + 1e-20), (B, V)."""
    valid = labels >= 0
    w = torch.softmax(torch.where(valid, votes / 10.0, -math.inf), -1)
    w = torch.nan_to_num(w) * valid
    p_mem = torch.zeros_like(lm_logits).scatter_add_(
        1, torch.where(valid, labels, 0).to(torch.int64), w)
    p_lm = torch.softmax(_f(lm_logits), -1)
    return torch.log((1 - lam) * p_lm + lam * p_mem + 1e-20)
