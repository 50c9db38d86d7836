"""Recurrent blocks (port of `repro.models.ssm` on one device): xLSTM's
mLSTM and sLSTM cells and Mamba's selective SSM (S6).

* mLSTM: matrix-memory LSTM with exponential gating, in the reference's
  chunkwise-parallel form (attention-like within a chunk of up to 64
  steps, a recurrence across chunks, the same cumsum / cummax stabiliser
  and -1e30 initial m), and the exact per-step recurrence for decode.
  State (C (B, H, dh, dh), n (B, H, dh), m (B, H)), float32.
* sLSTM: scalar-memory LSTM with recurrent weights, a loop over time
  (the reference's `lax.scan`). State (c, n, h, m), each (B, H, dh).
* Mamba: the selective scan over time, seeded with the carried state and
  the depthwise causal convolution seeded with its ring of the last
  d_conv - 1 inputs. State (h (B, di, ds), conv (B, d_conv - 1, di)).

Each exposes init / *_apply_seq(x, state) -> (y, state) /
*_apply_step(x1, state) -> (y, state); states are new tensors, the given
ones are left as they were.

Numerics follow the reference. Mamba's scan is a loop over time,
h_t = a_t * h_{t-1} + b_t, where the reference's `associative_scan`
multiplies the a's in a tree (and XLA contracts `b * a + b'` under jit,
ROADMAP C.R3): in float32 the two agree within the parity tests'
tolerance, not bit for bit. mLSTM's key scale 1 / sqrt(dh) divides a
bf16 tensor by the number rounded to bf16, as JAX does (`layers.div`).
`jax.nn.log_sigmoid` is `F.logsigmoid` (both min(x, 0) - log1p(exp(-|x|)))
and `jax.nn.softplus` is JAX's logaddexp(x, 0).

Gradients follow jax.grad at kinks and ties too (ROADMAP C.P9): the
stabiliser's running max is `kinks.cummax` (a tie splits as JAX's
`associative_scan(max)` splits it), `|x|` is `kinks.abs` (+1 at 0) and
the softplus `kinks.softplus` (0.5 at 0).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kinks
from repro_torch.models.layers import dense_init, div
from repro_torch.models.sharding import aconstrain

# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def mlstm_init(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    D = cfg.d_model
    di = 2 * D                        # pre-up-projection inner width
    H = cfg.n_heads
    dh = di // H
    gate_bias = torch.cat([torch.zeros(H),
                           3.0 + torch.arange(H, dtype=torch.float32) * 0.5])
    return {
        "in_proj": dense_init(gen, (D, di), dtype),
        "wq": dense_init(gen, (di, H, dh), dtype),
        "wk": dense_init(gen, (di, H, dh), dtype),
        "wv": dense_init(gen, (di, H, dh), dtype),
        "w_gates": dense_init(gen, (D, 2 * H), dtype),    # (i, f) pre-acts
        "gate_bias": gate_bias.to(gen.device),             # forget bias high
        "w_ogate": dense_init(gen, (D, H, dh), dtype),
        "out_proj": dense_init(gen, (di, D), dtype),
    }


def _mlstm_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    H = cfg.n_heads
    xin = aconstrain(x @ p["in_proj"], "batch", None, "tensor")
    q = torch.einsum("bsd,dhk->bshk", xin, p["wq"])
    k = div(torch.einsum("bsd,dhk->bshk", xin, p["wk"]),
            math.sqrt(q.shape[-1]))
    v = torch.einsum("bsd,dhk->bshk", xin, p["wv"])
    gates = (x @ p["w_gates"]).float() + p["gate_bias"]
    li = gates[..., :H]                                   # log input gate
    lf = F.logsigmoid(gates[..., H:])                     # log forget gate
    o = torch.sigmoid(torch.einsum("bsd,dhk->bshk", x, p["w_ogate"]))
    return q, k, v, li, lf, o


def mlstm_state_init(cfg: ModelConfig, batch: int, device: torch.device,
                     dtype: torch.dtype = torch.float32) -> dict:
    H = cfg.n_heads
    dh = 2 * cfg.d_model // H
    kw = dict(dtype=dtype, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **kw),
            "n": torch.zeros((batch, H, dh), **kw),
            "m": torch.full((batch, H), -1e30, **kw)}


def mlstm_apply_seq(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    state: dict | None = None, chunk: int = 64):
    """Chunkwise-parallel mLSTM. x (B, S, D) -> (y (B, S, D), state); S a
    multiple of min(chunk, S), as the reference asserts."""
    B, S, D = x.shape
    H = cfg.n_heads
    q, k, v, li, lf, o = _mlstm_qkv(p, x, cfg)
    dh = q.shape[-1]
    if state is None:
        state = mlstm_state_init(cfg, B, x.device)
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"mlstm_apply_seq: S={S} is not a multiple of the "
                         f"chunk {L}")
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    C, n, m_in = state["C"], state["n"], state["m"]
    hs = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        qc, kc, vc = q[:, sl], k[:, sl], v[:, sl]         # (B,L,H,dh)
        lic = li[:, sl].transpose(1, 2)                   # (B,H,L)
        lfc = lf[:, sl].transpose(1, 2)
        b = torch.cumsum(lfc, -1)                         # decay-from-start
        a = lic - b                                       # log(i_j / decay_j)
        g = torch.maximum(m_in[..., None], kinks.cummax(a, -1))
        # intra-chunk weights w[t, j] = exp(a_j - g_t) for j <= t
        w = torch.exp(a[..., None, :] - g[..., :, None])  # (B,H,L,L)
        w = torch.where(causal, w, 0.0)
        qkt = torch.einsum("blhk,bjhk->bhlj", qc, kc).float()
        sc = qkt * w                                      # (B,H,L,L)
        inter = torch.exp(m_in[..., None] - g)            # (B,H,L)
        num = (torch.einsum("bhlj,bjhk->blhk", sc.to(vc.dtype), vc)
               + torch.einsum("blhk,bhkv,bhl->blhv", qc.float(), C,
                              inter).to(vc.dtype))
        # normalizer n_t^T q_t = sum_j w_tj (k_j . q_t)  [already in sc]
        nq = sc.sum(-1) + torch.einsum("bhk,blhk,bhl->bhl", n, qc.float(),
                                       inter)
        m_t = b + g                                       # (B,H,L)
        den = torch.maximum(kinks.abs(nq), torch.exp(-m_t)) + 1e-6
        hs.append(num / den.transpose(1, 2)[..., None].to(num.dtype))
        # chunk-end state
        g_out = g[..., -1]
        wout = torch.exp(a - g_out[..., None])            # (B,H,L)
        decay = torch.exp(m_in - g_out)
        C = (C * decay[..., None, None]
             + torch.einsum("bhl,blhk,blhv->bhkv", wout, kc.float(),
                            vc.float()))
        n = n * decay[..., None] + torch.einsum("bhl,blhk->bhk", wout,
                                                kc.float())
        m_in = b[..., -1] + g_out
    h = torch.cat(hs, 1).reshape(B, S, H, dh)
    y = (o * h).reshape(B, S, -1) @ p["out_proj"]
    return y, {"C": C, "n": n, "m": m_in}


def mlstm_apply_step(p: dict, x1: torch.Tensor, cfg: ModelConfig,
                     state: dict):
    """x1 (B, 1, D): one decode step (the exact per-step recurrence)."""
    q, k, v, li, lf, o = _mlstm_qkv(p, x1, cfg)
    q, k, v, o = (t[:, 0].float() for t in (q, k, v, o))
    li, lf = li[:, 0], lf[:, 0]                           # (B,H)
    C, n, m_in = state["C"], state["n"], state["m"]
    m_t = torch.maximum(lf + m_in, li)
    fp = torch.exp(lf + m_in - m_t)
    ip = torch.exp(li - m_t)
    C = C * fp[..., None, None] + ip[..., None, None] * (
        k[..., :, None] * v[..., None, :])                # (B,H,dh,dh)
    n = n * fp[..., None] + ip[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", C, q)
    den = torch.maximum(kinks.abs((n * q).sum(-1)), torch.exp(-m_t))
    den = den + 1e-6
    h = (o * (num / den[..., None]))[:, None]             # (B,1,H,dh)
    y = h.reshape(*x1.shape[:2], -1).to(x1.dtype) @ p["out_proj"]
    return y, {"C": C, "n": n, "m": m_t}


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------


def slstm_init(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    D = cfg.d_model
    H = cfg.n_heads
    dh = D // H
    p = {}
    for g in "zifo":
        p[f"w_{g}"] = dense_init(gen, (D, H, dh), dtype)
        p[f"r_{g}"] = dense_init(gen, (H, dh, dh), dtype)
        p[f"b_{g}"] = torch.full((H, dh), 3.0 if g == "f" else 0.0,
                                 dtype=torch.float32, device=gen.device)
    return p


def slstm_state_init(cfg: ModelConfig, batch: int, device: torch.device,
                     dtype: torch.dtype = torch.float32) -> dict:
    H = cfg.n_heads
    dh = cfg.d_model // H
    z = torch.zeros((batch, H, dh), dtype=dtype, device=device)
    return {"c": z, "n": z + 1e-6, "h": z,
            "m": torch.full_like(z, -1e30)}


def _slstm_cell(p: dict, xw: dict, state: dict) -> dict:
    """xw: gate -> (B, H, dh) float32 pre-activations of the input path."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    pre = {g: (xw[g]
               + torch.einsum("bhk,hkj->bhj", h, p[f"r_{g}"].float())
               + p[f"b_{g}"]) for g in "zifo"}
    z = torch.tanh(pre["z"])
    o = torch.sigmoid(pre["o"])
    li, lf = pre["i"], F.logsigmoid(pre["f"])
    m_t = torch.maximum(lf + m, li)
    ip = torch.exp(li - m_t)
    fp = torch.exp(lf + m - m_t)
    c = fp * c + ip * z
    n = fp * n + ip
    h = o * c / (kinks.abs(n) + 1e-6)
    return {"c": c, "n": n, "h": h, "m": m_t}


def _slstm_inputs(p: dict, x: torch.Tensor) -> dict:
    return {g: torch.einsum("bsd,dhk->bshk", x, p[f"w_{g}"]).float()
            for g in "zifo"}


def slstm_apply_seq(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    state: dict | None = None):
    B, S, D = x.shape
    if state is None:
        state = slstm_state_init(cfg, B, x.device)
    xw = _slstm_inputs(p, x)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, {g: xw[g][:, t] for g in "zifo"}, state)
        hs.append(state["h"])
    y = torch.stack(hs, 1).reshape(B, S, D).to(x.dtype)
    return y, state


def slstm_apply_step(p: dict, x1: torch.Tensor, cfg: ModelConfig,
                     state: dict):
    xw = _slstm_inputs(p, x1)
    state = _slstm_cell(p, {g: xw[g][:, 0] for g in "zifo"}, state)
    y = state["h"].reshape(x1.shape[0], 1, -1).to(x1.dtype)
    return y, state


# --------------------------------------------------------------------------
# Mamba (S6)
# --------------------------------------------------------------------------


def _mamba_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    s = cfg.ssm
    di = int(s.expand * cfg.d_model)
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return di, dt_rank, s.d_state, s.d_conv


def mamba_init(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    di, dt_rank, ds, dc = _mamba_dims(cfg)
    dev = gen.device
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(di, generator=gen, device=dev) * (hi - lo) + lo
    return {
        "in_proj": dense_init(gen, (cfg.d_model, 2 * di), dtype),
        "conv_w": dense_init(gen, (dc, di), dtype, scale_axis=dc),
        "x_proj": dense_init(gen, (di, dt_rank + 2 * ds), dtype),
        "dt_proj": dense_init(gen, (dt_rank, di), dtype),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "a_log": torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                        device=dev)).expand(di, ds).clone(),
        "d_skip": torch.ones(di, dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (di, cfg.d_model), dtype),
    }


def mamba_state_init(cfg: ModelConfig, batch: int, device: torch.device,
                     dtype: torch.dtype = torch.float32) -> dict:
    di, _, ds, dc = _mamba_dims(cfg)
    kw = dict(dtype=dtype, device=device)
    return {"h": torch.zeros((batch, di, ds), **kw),
            "conv": torch.zeros((batch, dc - 1, di), **kw)}


def _mamba_ssm_inputs(p: dict, xz: torch.Tensor, cfg: ModelConfig):
    di, dt_rank, ds, _ = _mamba_dims(cfg)
    x, z = xz[..., :di], xz[..., di:]
    dbc = x @ p["x_proj"]
    dt = kinks.softplus(dbc[..., :dt_rank] @ p["dt_proj"]
                   + p["dt_bias"]).float()                     # (B,S,di)
    Bm = dbc[..., dt_rank:dt_rank + ds].float()                # (B,S,ds)
    Cm = dbc[..., dt_rank + ds:].float()
    A = -torch.exp(p["a_log"])                                 # (di,ds)
    a_bar = torch.exp(dt[..., None] * A)                       # (B,S,di,ds)
    b_x = (dt * x.float())[..., None] * Bm[..., None, :]
    return x, z, a_bar, b_x, Cm


def _mamba_out(p: dict, y: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    y = y + p["d_skip"] * x.float()
    y = (y * F.silu(z.float())).to(dtype)
    return y @ p["out_proj"]


def mamba_apply_seq(p: dict, xin: torch.Tensor, cfg: ModelConfig,
                    state: dict | None = None):
    B, S, _ = xin.shape
    di, _, ds, dc = _mamba_dims(cfg)
    if state is None:
        state = mamba_state_init(cfg, B, xin.device)
    xz = aconstrain(xin @ p["in_proj"], "batch", None, "tensor")
    # depthwise causal conv over time, seeded with the conv ring state
    xpad = torch.cat([state["conv"].to(xz.dtype), xz[..., :di]], 1)
    idx = (torch.arange(S, device=xin.device)[:, None]
           + torch.arange(dc, device=xin.device)[None, :])     # (S, dc)
    xc = F.silu(torch.einsum("bswd,wd->bsd", xpad[:, idx], p["conv_w"]))
    x, z, a_bar, b_x, Cm = _mamba_ssm_inputs(
        p, torch.cat([xc, xz[..., di:]], -1), cfg)
    # the carried state is step 0 (a = 1); then h_t = a_t h_{t-1} + b_t
    h = state["h"].float()
    hs = []
    for t in range(S):
        h = h * a_bar[:, t] + b_x[:, t]
        hs.append(h)
    y = torch.einsum("bsdn,bsn->bsd", torch.stack(hs, 1), Cm)
    new_state = {"h": h, "conv": xpad[:, -(dc - 1):].float()}
    return _mamba_out(p, y, x, z, xin.dtype), new_state


def mamba_apply_step(p: dict, x1: torch.Tensor, cfg: ModelConfig,
                     state: dict):
    di, _, ds, dc = _mamba_dims(cfg)
    xz = x1 @ p["in_proj"]                                     # (B,1,2di)
    xpad = torch.cat([state["conv"].to(xz.dtype), xz[..., :di]], 1)
    xc = F.silu(torch.einsum("bwd,wd->bd", xpad, p["conv_w"]))[:, None]
    x, z, a_bar, b_x, Cm = _mamba_ssm_inputs(
        p, torch.cat([xc, xz[..., di:]], -1), cfg)
    h = state["h"].float() * a_bar[:, 0] + b_x[:, 0]
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None]
    return (_mamba_out(p, y, x, z, x1.dtype),
            {"h": h, "conv": xpad[:, 1:].float()})
