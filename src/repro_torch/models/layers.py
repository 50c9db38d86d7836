"""Transformer building blocks (port of `repro.models.layers` on one
device): initializers, norms, RoPE, grouped-query attention with its
decode cache, and MLPs.

Parameters are nested dicts of tensors applied by pure functions, as in
the JAX package. Its sharding hints (`aconstrain`, `PARAM_LOGICAL`,
`param_specs`) place nothing on one device and are not ported, nor are
the `REPRO_OPT` branches (TPU sharding tunings): this module has the
`REPRO_OPT=0` semantics and reads no environment variable. Multi-head
latent attention and M-RoPE (DeepSeek-V3, Qwen2-VL) raise
NotImplementedError naming their ROADMAP item.

Numerics follow the reference: norms take their statistics in float32
(population variance, rsqrt(var + 1e-6)) and cast back to the compute
dtype; attention scores are the compute dtype's product cast to float32,
masked with -1e30, and the softmax is cast back to the values' dtype
before the value product; `gelu` is the tanh approximation
(`jax.nn.gelu`'s default); RoPE's frequencies are the constant the
jitted reference folds in float64. In bfloat16 the two packages round
differently, in the last bit: XLA rounds after each elementwise op of a
composite (`jax.nn.gelu`, `jax.nn.silu`) and keeps some dot outputs in
float32 for the residual add they fuse with, where PyTorch rounds a
composite once and a product before the add. The parity tests state the
tolerance this needs.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.store import _not_ported

INT32_MAX = 2**31 - 1


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, name)


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """jax.nn.one_hot: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


# --------------------------------------------------------------------------
# Initializers.
# --------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: tuple, dtype: torch.dtype,
               scale_axis: int | None = None) -> torch.Tensor:
    """Normal init scaled by 1/sqrt(fan_in), on the generator's device;
    scale_axis is the explicit fan-in value (defaults to shape[0]). The
    draws are torch's, not jax.random's."""
    fan_in = shape[0] if scale_axis is None else scale_axis
    x = torch.randn(shape, generator=gen, device=gen.device)
    return (x / math.sqrt(fan_in)).to(dtype)


# --------------------------------------------------------------------------
# Norms.
# --------------------------------------------------------------------------


def norm_init(cfg: ModelConfig, device: torch.device, dim=None) -> dict:
    dim = dim or cfg.d_model
    p = {"scale": torch.ones(dim, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["nbias"] = torch.zeros(dim, dtype=torch.float32, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["nbias"]
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# Rotary embeddings.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    """1 / theta ** (2i / dim), float32. The reference's jitted program
    folds this constant in float64 (the exponents in float32) and rounds
    it once; so does this, on the host, once per (dim, theta, device)."""
    exps = np.arange(0, dim, 2, dtype=np.float32) / np.float32(dim)
    freqs = 1.0 / np.power(np.float64(theta), exps.astype(np.float64))
    return torch.from_numpy(freqs.astype(np.float32)).to(device)


def rope_sincos(pos: torch.Tensor, dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """pos (..., S) -> sin / cos (..., S, dim/2), float32."""
    ang = pos[..., None].float() * rope_freqs(dim, theta, pos.device)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); sin / cos (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.ndim == 2:
        sin, cos = sin[None], cos[None]
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention: one block, or an online softmax over kv chunks.
# --------------------------------------------------------------------------


def _attn_scores_mask(qpos: torch.Tensor, kpos: torch.Tensor,
                      window: int) -> torch.Tensor:
    m = kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  qpos: torch.Tensor, kpos: torch.Tensor, window: int = 0,
                  chunk: int = 0, kv_valid: torch.Tensor | None = None,
                  softcap: float = 0.0) -> torch.Tensor:
    """Grouped-query attention with absolute-position causal / window
    masking. q (B, S, H, D); k, v (B, T, KV, D); qpos (S,), kpos (T,)
    absolute positions; kv_valid optional (B, T) bool. Returns
    (B, S, H, D). With 0 < chunk < T, an online softmax over kv chunks of
    `chunk` positions (T a multiple of it)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    DV = v.shape[-1]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, KV, G, D) * scale

    def scores_of(kc, kposc, validc):
        s = torch.einsum("bskgd,btkd->bkgst", qg, kc).float()
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        m = _attn_scores_mask(qpos, kposc, window)
        if validc is not None:
            m = m[None, :, :] & validc[:, None, :]
            m = m[:, None, None]
        else:
            m = m[None, None, None]
        return torch.where(m, s, -1e30)

    if not chunk or T <= chunk:
        s = scores_of(k, kpos, kv_valid)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bkgst,btkd->bskgd", p, v)
        return o.reshape(B, S, H, DV)

    if T % chunk:
        raise ValueError(f"dot_attention: T={T} is not a multiple of "
                         f"chunk={chunk}")
    m_run = torch.full((B, KV, G, S), -math.inf, device=q.device)
    l_run = torch.zeros((B, KV, G, S), device=q.device)
    acc = torch.zeros((B, KV, G, S, DV), device=q.device)
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        vc = v[:, sl]
        s = scores_of(k[:, sl], kpos[sl],
                      None if kv_valid is None else kv_valid[:, sl])
        m_new = torch.maximum(m_run, s.amax(-1))
        corr = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(vc.dtype), vc).float()
        m_run = m_new
    o = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return o.movedim(3, 1).reshape(B, S, H, DV).to(q.dtype)


# --------------------------------------------------------------------------
# GQA attention layer (with sliding windows and decode caches).
# --------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype) -> dict:
    hd = cfg.hd
    p = {
        "wq": dense_init(gen, (cfg.d_model, cfg.n_heads, hd), dtype),
        "wk": dense_init(gen, (cfg.d_model, cfg.n_kv_heads, hd), dtype),
        "wv": dense_init(gen, (cfg.d_model, cfg.n_kv_heads, hd), dtype),
        "wo": dense_init(gen, (cfg.n_heads, hd, cfg.d_model), dtype,
                         scale_axis=cfg.n_heads * hd),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((cfg.n_heads, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads, hd), dtype=dtype, device=dev)
    return p


def _rope_for(cfg: ModelConfig, pos: torch.Tensor):
    if cfg.rope_type == "none":
        return None
    if cfg.rope_type == "mrope":
        return mrope_sincos()
    return rope_sincos(pos, cfg.hd, cfg.rope_theta)


def attn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
               layer_window: int = 0, cache: dict | None = None,
               pos0: int = 0) -> tuple[torch.Tensor, dict]:
    """x (B, S, D). cache None (train / prefill) or {k, v, kpos} for
    decode, written functionally: the returned cache is new tensors and
    the given one is left as it was. Returns (y, new_cache)."""
    B, S, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    qpos = pos0 + torch.arange(S, dtype=torch.int32, device=x.device)
    sc = _rope_for(cfg, qpos)
    if sc is not None:
        q = apply_rope(q, *sc)
        k = apply_rope(k, *sc)

    if cache is None:
        y = dot_attention(q, k, v, qpos=qpos, kpos=qpos,
                          window=layer_window, chunk=cfg.attn_chunk,
                          softcap=cfg.logit_softcap)
        new_cache = {"k": k, "v": v, "kpos": qpos}
    else:
        # write this step's k / v at its slot (a ring for window layers);
        # like lax.dynamic_update_slice, the start is clamped so the
        # S new rows fit
        T = cache["k"].shape[1]
        slot = (pos0 % T) if layer_window else min(pos0, T - 1)
        slot = max(0, min(slot, T - S))
        rows = torch.arange(slot, slot + S, device=x.device)
        ck = cache["k"].index_copy(1, rows, k.to(cache["k"].dtype))
        cv = cache["v"].index_copy(1, rows, v.to(cache["v"].dtype))
        kp = cache["kpos"].index_copy(0, rows, qpos)
        valid = kp <= pos0
        if layer_window:
            valid &= kp > pos0 - layer_window
        y = dot_attention(q, ck, cv, qpos=qpos, kpos=kp, window=layer_window,
                          chunk=0, kv_valid=valid.expand(B, T),
                          softcap=cfg.logit_softcap)
        new_cache = {"k": ck, "v": cv, "kpos": kp}
    y = torch.einsum("bshk,hkd->bsd", y, p["wo"])
    return y, new_cache


def attn_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                    layer_window: int, dtype: torch.dtype,
                    device: torch.device) -> dict:
    T = min(layer_window, max_seq) if layer_window else max_seq
    return {
        "k": torch.zeros((batch, T, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, T, cfg.n_kv_heads, cfg.hd), dtype=dtype,
                         device=device),
        "kpos": torch.full((T,), INT32_MAX, dtype=torch.int32,
                           device=device),
    }


def mrope_sincos(*_args, **_kwargs):
    raise _not_ported("M-RoPE (mrope_sincos, rope_type='mrope')", "A10b")


def mla_init(*_args, **_kwargs):
    raise _not_ported("multi-head latent attention (mla_init, mla_apply, "
                      "mla_cache_init; layer type 'mla')", "A10b")


mla_apply = mla_cache_init = mla_init


# --------------------------------------------------------------------------
# MLP.
# --------------------------------------------------------------------------

_ACTS = {"silu": F.silu,
         "gelu": lambda x: F.gelu(x, approximate="tanh"),
         "relu": F.relu}


def mlp_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             d_ff: int | None = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    dev = gen.device
    p = {"w1": dense_init(gen, (cfg.d_model, d_ff), dtype),
         "w2": dense_init(gen, (d_ff, cfg.d_model), dtype)}
    if cfg.mlp_gated:
        p["w3"] = dense_init(gen, (cfg.d_model, d_ff), dtype)
    if cfg.mlp_bias:
        p["mb1"] = torch.zeros(d_ff, dtype=dtype, device=dev)
        p["mb2"] = torch.zeros(cfg.d_model, dtype=dtype, device=dev)
    return p


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = _ACTS[cfg.mlp_act]
    h = x @ p["w1"]
    if cfg.mlp_bias:
        h = h + p["mb1"]
    h = act(h)
    if cfg.mlp_gated:
        h = h * (x @ p["w3"])
    y = h @ p["w2"]
    if cfg.mlp_bias:
        y = y + p["mb2"]
    return y
