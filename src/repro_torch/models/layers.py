"""Transformer building blocks (port of `repro.models.layers` on one
device): initializers, norms, RoPE and Qwen2-VL's M-RoPE, grouped-query
attention with its decode cache, DeepSeek-V3's multi-head latent
attention (MLA) with its absorbed decode over cached latents, and MLPs.

Parameters are nested dicts of tensors applied by pure functions, as in
the JAX package. Parameter layouts are resolved from leaf NAMES
(`PARAM_LOGICAL`, `logical_for`, `param_specs`: the reference's table,
with its `REPRO_OPT` level 1 embedding rows read from the environment
when this module is imported, as the reference reads them); the
activation hints (`sharding.aconstrain`) sit where the reference's do
and change no value. `REPRO_OPT` >= 4 makes the norm multiply in the
compute dtype (`apply_norm`), as the reference's level 4 does.

Numerics follow the reference: norms take their statistics in float32
(population variance, rsqrt(var + 1e-6)) and cast back to the compute
dtype; attention scores are the compute dtype's product cast to float32,
masked with -1e30, and the softmax is cast back to the values' dtype
before the value product; `gelu` is the tanh approximation
(`jax.nn.gelu`'s default); RoPE's frequencies are the constant the
jitted reference folds in float64. A Python number that meets a tensor
takes the tensor's dtype first, as JAX's weak typing does (`scalar`,
`div`): a bf16 tensor is scaled by the number rounded to bf16, and a
division rounds once on the card too (ROADMAP C.P8). In bfloat16 the
two packages round differently, in the last bit: XLA rounds after each elementwise op of a
composite (`jax.nn.gelu`, `jax.nn.silu`) and keeps some dot outputs in
float32 for the residual add they fuse with, where PyTorch rounds a
composite once and a product before the add. The parity tests state the
tolerance this needs.
"""

from __future__ import annotations

import functools
import math
import os
import re

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib
from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.models.sharding import ParamSpec, aconstrain

INT32_MAX = 2**31 - 1

# --------------------------------------------------------------------------
# Name -> logical axes registry. Arrays may carry extra LEADING axes (layer
# stacking); logical tuples are right-aligned and left-padded with None.
# --------------------------------------------------------------------------

# REPRO_OPT level 1: embeddings vocab-sharded only (FSDP-sharding d_model
# makes the unembed contraction partial-sum the float32 logits over the
# data axis); level 0: FSDP + vocab. Any value but "0" is level 1 here,
# as in the reference.
_EMBED_VOCAB_ONLY = os.environ.get("REPRO_OPT", "0") != "0"

_EMBED_LOGICAL = ([(r"^unembed$", (None, "tensor")),
                   (r"^embed$", ("tensor", None))] if _EMBED_VOCAB_ONLY else
                  [(r"^unembed$", ("fsdp", "tensor")),
                   (r"^embed$", ("tensor", "fsdp"))])

PARAM_LOGICAL = _EMBED_LOGICAL + [
    (r"pos_embed$", (None, "fsdp")),
    (r"w[qkv]$", ("fsdp", "tensor", None)),
    (r"b[qkv]$", ("tensor", None)),
    (r"wo$", ("tensor", None, "fsdp")),
    (r"w[13]$", ("fsdp", "tensor")),
    (r"w2$", ("tensor", "fsdp")),
    (r"wq_a$|wkv_a$", ("fsdp", None)),
    (r"wq_b$|wkv_b$", (None, "tensor", None)),
    (r"wo_mla$", ("tensor", None, "fsdp")),
    (r"router$", ("fsdp", None)),
    (r"we[13]$", ("expert", None, "fsdp")),
    (r"we2$", ("expert", "fsdp", None)),
    (r"w_gates$", ("fsdp", "tensor")),
    (r"w_ogate$", ("fsdp", "tensor", None)),
    (r"r_(z|i|f|o)$", ("tensor", None, None)),
    (r"w_(z|i|f|o)$", ("fsdp", "tensor", None)),
    (r"in_proj$", ("fsdp", "tensor")),
    (r"out_proj$", ("tensor", "fsdp")),
    (r"conv_w$", (None, "tensor")),
    (r"x_proj$", ("tensor", None)),
    (r"dt_proj$", (None, "tensor")),
    (r"a_log$", ("tensor", None)),
    (r"head_w$", ("fsdp", "tensor")),
    # everything else (norm scales, small biases, gate vectors): replicated
    (r".", ()),
]

# REPRO_OPT level (the norm reads level 4), read when imported
OPT_LEVEL = int(os.environ.get("REPRO_OPT", "0") or 0)


def logical_for(name: str, ndim: int) -> tuple:
    for pat, logical in PARAM_LOGICAL:
        if re.search(pat, name):
            pad = ndim - len(logical)
            return (None,) * pad + tuple(logical)
    return (None,) * ndim


def param_specs(params) -> object:
    """A tree of ParamSpec mirroring `params` (tensors, meta tensors or
    anything with `.ndim`), by each leaf's own key."""
    names, leaves = tree_lib.flatten_with_names(params)
    return tree_lib.unflatten(params, [
        ParamSpec(logical_for(n.split(tree_lib.SEP)[-1], leaf.ndim))
        for n, leaf in zip(names, leaves)])


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32") as a torch dtype."""
    return getattr(torch, name)


def one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """jax.nn.one_hot: an index outside [0, n) gives a row of zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def scalar(x: torch.Tensor, c: float) -> float:
    """c rounded to x's dtype, as JAX rounds a Python number that meets
    a tensor (weak typing); PyTorch would keep it in float32 opmath, so a
    bf16 tensor times 1 / sqrt(128) rounds otherwise. For a product:
    the rounded number times x rounds once, as in JAX."""
    return torch.tensor(c, dtype=x.dtype).item()


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded once, as JAX divides: the divisor a 0-dim tensor of
    x's dtype on x's device. A Python or CPU divisor makes CUDA multiply
    by its reciprocal, which rounds twice (ROADMAP C.P7, C.P8), and keeps
    it in float32 where JAX rounds it to x's dtype."""
    return torch.div(x, torch.full((), d, dtype=x.dtype, device=x.device))


def tanh_cap(s: torch.Tensor, cap: float) -> torch.Tensor:
    """tanh(s / cap) * cap (the reference's softcap), the division
    rounded once (`div`)."""
    return torch.tanh(div(s, cap)) * scalar(s, cap)


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
    return x.div_(math.sqrt(fan_in)).to(dtype)    # one float32 copy


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
    if OPT_LEVEL >= 4:
        # statistics in float32, the products in the compute dtype
        xf = x.float()
        if cfg.norm == "layernorm":
            mu = xf.mean(-1, keepdim=True)
            var = xf.var(-1, keepdim=True, correction=0)
            inv = torch.rsqrt(var + eps)
            return ((x - mu.to(x.dtype)) * inv.to(x.dtype)
                    * p["scale"].to(x.dtype) + p["nbias"].to(x.dtype))
        var = (xf * xf).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + eps).to(x.dtype) * p["scale"].to(x.dtype)
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


def mrope_sincos(pos3: torch.Tensor, dim: int, theta: float,
                 sections: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """pos3 (..., S, 3) -> sin / cos (..., S, dim/2), float32, the dim/2
    frequency slots split across the (temporal, height, width) position
    streams: slot f takes the stream its section names. The reference
    picks with a one-hot product, whose sums of x * 1 and zeros are
    exact; this picks the same entries by index."""
    if sum(sections) != dim // 2:
        raise ValueError(f"mrope_sincos: sections {sections} do not sum "
                         f"to dim / 2 = {dim // 2}")
    sin, cos = rope_sincos(pos3.movedim(-1, 0), dim, theta)  # (3,...,S,d/2)
    idx, slot = _mrope_index(tuple(sections), pos3.device)
    return sin[idx, ..., slot].movedim(0, -1), cos[idx, ..., slot].movedim(
        0, -1)


@functools.lru_cache(maxsize=None)
def _mrope_index(sections: tuple, device) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(stream, slot) of each frequency slot, made once per (sections,
    device) on the host."""
    idx = np.repeat(np.arange(3), np.asarray(sections))
    return (torch.from_numpy(idx).to(device),
            torch.arange(len(idx)).to(device))


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
    (B, S, H, DV), DV the values' width (MLA's differs from D). With
    0 < chunk < T, an online softmax over kv chunks of `chunk` positions
    (T a multiple of it); softcap > 0 caps the scores (`tanh_cap`)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    DV = v.shape[-1]
    G = H // KV
    qg = q.reshape(B, S, KV, G, D) * scalar(q, 1.0 / math.sqrt(D))

    def scores_of(kc, kposc, validc):
        s = torch.einsum("bskgd,btkd->bkgst", qg, kc).float()
        if softcap:
            s = tanh_cap(s, softcap)
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
    # jnp.maximum, whose gradient splits a tie in half (torch.clamp's not)
    floor = torch.full((), 1e-30, device=q.device)
    o = acc / torch.maximum(l_run, floor)[..., None]
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


def _rope_for(cfg: ModelConfig, pos: torch.Tensor,
              positions3: torch.Tensor | None = None):
    if cfg.rope_type == "none":
        return None
    if cfg.rope_type == "mrope":
        if positions3 is None:
            raise ValueError("rope_type 'mrope' needs the batch's "
                             "positions3 (B, S, 3)")
        return mrope_sincos(positions3, cfg.hd, cfg.rope_theta,
                            cfg.mrope_sections)
    return rope_sincos(pos, cfg.hd, cfg.rope_theta)


def _cache_rows(cache_len: int, slot: int, S: int,
                device: torch.device) -> torch.Tensor:
    """The rows a decode write of S positions at `slot` fills: like
    lax.dynamic_update_slice, the start is clamped so the S rows fit."""
    slot = max(0, min(slot, cache_len - S))
    return torch.arange(slot, slot + S, device=device)


def attn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
               layer_window: int = 0, cache: dict | None = None,
               pos0: int = 0, positions3: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, dict]:
    """x (B, S, D). cache None (train / prefill) or {k, v, kpos} for
    decode, written functionally: the returned cache is new tensors and
    the given one is left as it was. positions3 (B, S, 3): M-RoPE's
    position streams. Returns (y, new_cache)."""
    B, S, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = aconstrain(q, "batch", None, "tensor", None)
    k = aconstrain(k, "batch", None, "tensor", None)
    v = aconstrain(v, "batch", None, "tensor", None)
    qpos = pos0 + torch.arange(S, dtype=torch.int32, device=x.device)
    sc = _rope_for(cfg, qpos, positions3)
    if sc is not None:
        q = apply_rope(q, *sc)
        k = apply_rope(k, *sc)

    if cache is None:
        y = dot_attention(q, k, v, qpos=qpos, kpos=qpos,
                          window=layer_window, chunk=cfg.attn_chunk,
                          softcap=cfg.logit_softcap)
        new_cache = {"k": k, "v": v, "kpos": qpos}
    else:
        # write this step's k / v at its slot (a ring for window layers)
        T = cache["k"].shape[1]
        slot = (pos0 % T) if layer_window else min(pos0, T - 1)
        rows = _cache_rows(T, slot, S, x.device)
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
    y = aconstrain(y, "batch", None, "tensor", None)
    y = torch.einsum("bshk,hkd->bsd", y, p["wo"])
    y = aconstrain(y, "batch", None, None)
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


# --------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V3).
# --------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> dict:
    m: MLAConfig = cfg.mla
    dev = gen.device
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq_a": dense_init(gen, (cfg.d_model, m.q_lora_rank), dtype),
        "q_norm": torch.ones(m.q_lora_rank, dtype=torch.float32, device=dev),
        "wq_b": dense_init(gen, (m.q_lora_rank, cfg.n_heads, qk_dim), dtype),
        "wkv_a": dense_init(gen, (cfg.d_model,
                                  m.kv_lora_rank + m.qk_rope_dim), dtype),
        "kv_norm": torch.ones(m.kv_lora_rank, dtype=torch.float32,
                              device=dev),
        "wkv_b": dense_init(gen, (m.kv_lora_rank, cfg.n_heads,
                                  m.qk_nope_dim + m.v_dim), dtype),
        "wo_mla": dense_init(gen, (cfg.n_heads, m.v_dim, cfg.d_model),
                             dtype, scale_axis=cfg.n_heads * m.v_dim),
    }


def _rms(x: torch.Tensor, scale: torch.Tensor,
         eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * scale
    return y.to(x.dtype)


def mla_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              cache: dict | None = None, pos0: int = 0
              ) -> tuple[torch.Tensor, dict]:
    """x (B, S, D). Prefill (cache None): every head's keys and values
    expanded from the latents, full attention with qk width nope + rope
    and value width v_dim; the cache keeps the latents {ckv, krope,
    kpos}. Decode: the absorbed form, queries projected into the latent
    space and scored against the cached latents directly (no per-head
    keys or values are made). Returns (y, new_cache)."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    cq = _rms(x @ p["wq_a"], p["q_norm"])
    q = aconstrain(torch.einsum("bsr,rhk->bshk", cq, p["wq_b"]),
                   "batch", None, "tensor", None)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    kv_a = x @ p["wkv_a"]
    c_kv = _rms(kv_a[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = kv_a[..., m.kv_lora_rank:]                      # (B,S,rope)
    qpos = pos0 + torch.arange(S, dtype=torch.int32, device=x.device)
    sin, cos = rope_sincos(qpos, m.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, sin, cos)
    k_rope = apply_rope(k_rope[:, :, None, :], sin, cos)[:, :, 0]
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)

    if cache is None:
        kv = aconstrain(torch.einsum("bsr,rhn->bshn", c_kv, p["wkv_b"]),
                        "batch", None, "tensor", None)
        k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            B, S, H, m.qk_rope_dim)], -1)
        qf = torch.cat([q_nope, q_rope], -1)
        y = dot_attention(qf, k, v, qpos=qpos, kpos=qpos,
                          chunk=cfg.attn_chunk)
        new_cache = {"ckv": c_kv, "krope": k_rope, "kpos": qpos}
    else:
        rows = _cache_rows(cache["ckv"].shape[1],
                           min(pos0, cache["ckv"].shape[1] - 1), S,
                           x.device)
        ckv = cache["ckv"].index_copy(1, rows, c_kv.to(cache["ckv"].dtype))
        krp = cache["krope"].index_copy(1, rows,
                                        k_rope.to(cache["krope"].dtype))
        kp = cache["kpos"].index_copy(0, rows, qpos)
        w_uk = p["wkv_b"][..., :m.qk_nope_dim]               # (r, h, nope)
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)
        s = (torch.einsum("bshr,btr->bhst", q_abs, ckv)
             + torch.einsum("bshk,btk->bhst", q_rope, krp)).float()
        s = s * scale
        s = torch.where((kp <= pos0)[None, None, None, :], s, -1e30)
        prob = torch.softmax(s, -1).to(x.dtype)
        o_lat = torch.einsum("bhst,btr->bshr", prob, ckv)
        w_uv = p["wkv_b"][..., m.qk_nope_dim:]               # (r, h, v)
        y = torch.einsum("bshr,rhv->bshv", o_lat, w_uv)
        new_cache = {"ckv": ckv, "krope": krp, "kpos": kp}
    y = torch.einsum("bshv,hvd->bsd", y, p["wo_mla"])
    y = aconstrain(y, "batch", None, None)
    return y, new_cache


def mla_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                   dtype: torch.dtype, device: torch.device) -> dict:
    m: MLAConfig = cfg.mla
    return {
        "ckv": torch.zeros((batch, max_seq, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_seq, m.qk_rope_dim), dtype=dtype,
                             device=device),
        "kpos": torch.full((max_seq,), INT32_MAX, dtype=torch.int32,
                           device=device),
    }


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
    h = aconstrain(x @ p["w1"], "batch", None, "tensor")
    if cfg.mlp_bias:
        h = h + p["mb1"]
    h = act(h)
    if cfg.mlp_gated:
        h = h * aconstrain(x @ p["w3"], "batch", None, "tensor")
    y = h @ p["w2"]
    y = aconstrain(y, "batch", None, None)
    if cfg.mlp_bias:
        y = y + p["mb2"]
    return y
