"""Mixture-of-Experts FFN (port of `repro.models.moe`): DeepSeek-style
shared experts plus fine-grained routed experts.

Routing is the reference's capacity-based dispatch: tokens split into
`groups`, each (token, choice) takes the next slot of its expert's queue
of C slots (`_capacity`) and is dropped once the queue is full, and the
experts run as dense one-hot dispatch / combine products over (group,
expert, slot). Every routed expert's weights are read whatever the
routing, as in the JAX package; a gather or sort dispatch would be
another program.

Aux values: the switch-style load balance (1.0 when balanced) and the
router z-loss.

The router's `torch.topk` stands for `jax.lax.top_k`, which breaks ties
by the lower index; torch does not promise an order among ties, but the
router's float probabilities make a tie an event of measure zero.

A config whose `moe` is a `GroupRouterConfig` (port-only: DeepSeek-V3's
published router, `configs/deepseek_v3_671b.get_published_config`) takes
`_held_apply` instead: V3's group-limited sigmoid router over all
`n_routed` experts in float32 (`route_groups`), and no drops. The layer
holds the routed experts [first_expert, first_expert + experts_held)
(the leaves `we1`..`we3` have `experts_held` rows) and adds their part
of the result and the shared expert's; what the absent experts give is
left out, as on one chip of an expert-parallel deployment without its
exchange. Its dispatch is a per-expert bound that drops nothing: an
expert takes a token at most once, so its bound is every token, and
each held expert runs one product over the whole batch, weighted by its
gate (zero where the token chose another expert). Nothing waits for the
card: no count or offset is read on the host, and every shape is known
before the router runs. The price is operations: the products cost
n_routed / top_k (32 for V3) times the routed pairs'. An expert's
products are 2 * 3 * d_model * d_ff operations a token against its
3 * d_model * d_ff weights of 2 bytes, so a held expert over the whole
batch is bound by its operations once the batch passes the card's
operations-to-bytes ratio (about 295 tokens on an H100: 989.4 TFLOP/s
bfloat16 over 3.35 TB/s); at V3's widths and 512 tokens the 8 held
experts and the shared one are 406 GFLOP a layer (0.41 ms) against
0.24 ms to read their weights. Its aux losses are zero (V3 balances its
experts through the choice bias); aux["experts"] is the router's choice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GroupRouterConfig, ModelConfig, MoEConfig
from repro_torch.kernels._build import profiler_range
from repro_torch.models.layers import dense_init, div, one_hot
from repro_torch.models.sharding import Rules, constrain


#: spread of the seeded choice bias (`e_score_correction_bias`), which a
#: trained model learns; random weights draw it so that it moves choices
BIAS_STD = 0.05


def moe_init(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> dict:
    m: MoEConfig = cfg.moe
    grouped = isinstance(m, GroupRouterConfig)
    rows = m.held if grouped else m.n_routed
    p = {
        "router": dense_init(gen, (cfg.d_model, m.n_routed), torch.float32),
        "we1": dense_init(gen, (rows, cfg.d_model, m.d_ff), dtype),
        "we2": dense_init(gen, (rows, m.d_ff, cfg.d_model), dtype),
        "we3": dense_init(gen, (rows, cfg.d_model, m.d_ff), dtype),
    }
    if grouped:
        p["bias"] = torch.randn(m.n_routed, generator=gen,
                                device=gen.device) * BIAS_STD
    if m.n_shared:
        dsh = m.n_shared * m.d_ff
        p["shared"] = {
            "w1": dense_init(gen, (cfg.d_model, dsh), dtype),
            "w2": dense_init(gen, (dsh, cfg.d_model), dtype),
            "w3": dense_init(gen, (cfg.d_model, dsh), dtype),
        }
    return p


def _capacity(tokens_per_group: int, m: MoEConfig) -> int:
    c = int(tokens_per_group * m.top_k / m.n_routed * m.capacity_factor) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8 for clean tiling


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              rules: Rules | None = None) -> tuple[torch.Tensor, dict]:
    """x (B, S, D) -> (y, aux) with aux = {load_balance, z_loss}. `rules`
    names the layouts of the token groups and the expert queues
    (`sharding.constrain`; no value changes)."""
    m: MoEConfig = cfg.moe
    if isinstance(m, GroupRouterConfig):
        return _held_apply(p, x, m)
    rules = rules or Rules(batch=(), fsdp=(), tensor=(), expert=())
    B, S, D = x.shape
    T = B * S
    G = min(m.groups, T)
    while T % G:
        G -= 1
    Sg = T // G
    xt = x.reshape(G, Sg, D)
    xt = constrain(xt, rules, "batch", None, None)

    logits = xt.float() @ p["router"]                         # (G,Sg,E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, m.top_k, dim=-1)           # (G,Sg,k)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)         # renormalise

    E = m.n_routed
    C = _capacity(Sg, m)
    # position of each (token, choice) within its expert's queue
    sel = one_hot(eidx, E, torch.int32)                      # (G,Sg,k,E)
    flat_sel = sel.reshape(G, Sg * m.top_k, E)
    pos = torch.cumsum(flat_sel, dim=1) - flat_sel
    pos = pos.reshape(G, Sg, m.top_k, E)
    within = (pos < C) & (sel > 0)
    # one-hot queue slots (G,Sg,k,E,C); dropped choices select none
    slot_oh = one_hot(torch.where(within, pos, C), C + 1, x.dtype)[..., :C]
    dispatch = (slot_oh * within[..., None].to(x.dtype)).sum(2)
    dispatch = constrain(dispatch, rules, "batch", None, "expert", None)
    combine = (slot_oh * (gate[..., None, None]
                          * within[..., None].float()).to(x.dtype)).sum(2)
    combine = constrain(combine, rules, "batch", None, "expert", None)

    xe = torch.einsum("gsd,gsec->gecd", xt, dispatch)
    xe = constrain(xe, rules, "batch", "expert", None, None)
    h = torch.einsum("gecd,edf->gecf", xe, p["we1"])
    h = F.silu(h) * torch.einsum("gecd,edf->gecf", xe, p["we3"])
    ye = torch.einsum("gecf,efd->gecd", h, p["we2"])
    ye = constrain(ye, rules, "batch", "expert", None, None)
    y = torch.einsum("gecd,gsec->gsd", ye, combine)

    if m.n_shared:
        sh = p["shared"]
        hs = F.silu(xt @ sh["w1"]) * (xt @ sh["w3"])
        y = y + hs @ sh["w2"]

    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return y.reshape(B, S, D), {"load_balance": load_balance(probs, sel, m),
                                "z_loss": z_loss}


def route_groups(logits: torch.Tensor, bias: torch.Tensor,
                 m: GroupRouterConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's router on float32 logits (T, E) -> (gate weights
    (T, top_k) float32, expert ids (T, top_k)): sigmoid scores; the bias
    added for choosing; groups ranked by the sum of their 2 best biased
    scores, `topk_group` kept, the others' experts out; the top_k of
    the rest; the weights the chosen raw scores, normalised and scaled."""
    scores = torch.sigmoid(logits)
    T, E = scores.shape
    grouped = (scores + bias).view(T, m.n_group, E // m.n_group)
    group_score = grouped.topk(2, dim=-1).values.sum(-1)       # (T, G)
    kept = group_score.topk(m.topk_group, dim=-1).indices
    out = torch.ones_like(group_score, dtype=torch.bool).scatter_(1, kept,
                                                                  False)
    choice = grouped.masked_fill(out[..., None], -math.inf).reshape(T, E)
    eidx = choice.topk(m.top_k, dim=-1).indices
    gate = scores.gather(1, eidx)
    if m.norm_topk_prob:
        gate = gate / gate.sum(-1, keepdim=True)
    return gate * m.routed_scaling_factor, eidx


def _held_apply(p: dict, x: torch.Tensor,
                m: GroupRouterConfig) -> tuple[torch.Tensor, dict]:
    """The published router's layer on this chip's share of the experts
    (module docstring) -> (y, aux); aux["experts"] is the router's
    choice (T, top_k)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    with profiler_range("lm.router"):
        gate, eidx = route_groups(xt.float() @ p["router"], p["bias"], m)
    with profiler_range("lm.experts"):
        rel = eidx - m.first_expert
        mine = (rel >= 0) & (rel < m.held)                     # (T, k)
        rel = torch.where(mine, rel, 0)
        w = torch.zeros(xt.shape[0], m.held, dtype=torch.float32,
                        device=x.device).scatter_add_(1, rel, gate * mine)
        xe = xt.expand(m.held, *xt.shape)                      # (e, T, D)
        h = F.silu(torch.bmm(xe, p["we1"])) * torch.bmm(xe, p["we3"])
        ye = torch.bmm(h, p["we2"])                             # (e, T, D)
        y = torch.einsum("etd,te->td", ye.float(), w).to(x.dtype)
        sh = p["shared"]
        y = y + (F.silu(xt @ sh["w1"]) * (xt @ sh["w3"])) @ sh["w2"]
    zero = torch.zeros((), device=x.device)
    return y.reshape(B, S, D), {"load_balance": zero, "z_loss": zero,
                                "experts": eidx}


def load_balance(probs: torch.Tensor, sel: torch.Tensor,
                 m: MoEConfig) -> torch.Tensor:
    """The switch-style aux (1.0 when balanced) of router probabilities
    (G, Sg, E) and choices one-hot (G, Sg, k, E); the division by top_k
    rounds once (ROADMAP C.P8)."""
    me = probs.mean((0, 1))                                   # (E,)
    ce = div(sel.sum(2).float().mean((0, 1)), m.top_k)
    return m.n_routed * (me * ce).sum()
