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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import dense_init, div, one_hot
from repro_torch.models.sharding import Rules, constrain


def moe_init(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> dict:
    m: MoEConfig = cfg.moe
    p = {
        "router": dense_init(gen, (cfg.d_model, m.n_routed), torch.float32),
        "we1": dense_init(gen, (m.n_routed, cfg.d_model, m.d_ff), dtype),
        "we2": dense_init(gen, (m.n_routed, m.d_ff, cfg.d_model), dtype),
        "we3": dense_init(gen, (m.n_routed, cfg.d_model, m.d_ff), dtype),
    }
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


def load_balance(probs: torch.Tensor, sel: torch.Tensor,
                 m: MoEConfig) -> torch.Tensor:
    """The switch-style aux (1.0 when balanced) of router probabilities
    (G, Sg, E) and choices one-hot (G, Sg, k, E); the division by top_k
    rounds once (ROADMAP C.P8)."""
    me = probs.mean((0, 1))                                   # (E,)
    ce = div(sel.sum(2).float().mean((0, 1)), m.top_k)
    return m.n_routed * (me * ce).sum()
