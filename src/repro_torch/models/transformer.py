"""Decoder-only model assembly (port of `repro.models.transformer` on
one device) for every layer type of the reference: "attn" and "swa"
(dense GQA, full or windowed), "mla" (DeepSeek-V3's latent attention),
"hymba" / "hymba_g" (attention, windowed or global, in parallel with a
Mamba head), "mlstm" and "slstm" (xLSTM's cells), each with a dense MLP,
DeepSeek-style MoE or no FFN; token or embedding inputs (sinusoidal
positions for MusicGen, M-RoPE's `positions3` for Qwen2-VL).

Layers are partitioned into groups of consecutive identical layers
(`ModelConfig.layer_groups`), and each group's parameters are stacked on
a leading axis, as the JAX package stacks them for `lax.scan`; here a
Python loop runs the layers of a group, with no remat (training is not
ported yet). A parameter tree of the JAX package's `init` crosses over
as numpy arrays through `params_from_numpy`.

Public API (pure functions over the parameter dict):
  init(gen, cfg)                                   -> params
  forward(params, cfg, batch[, return_cache, last_only])
                                                   -> (logits, aux[, caches])
  init_cache(cfg, batch, max_seq, device)          -> caches
  decode_step(params, cfg, batch, caches, pos[, return_hidden])
                                                   -> (logits, caches[, hidden])
  params_from_numpy(params, cfg, device)           -> params

A batch is {"tokens": (B, S) int} or {"embeddings": (B, S, D)}, with
"positions3" (B, S, 3) for M-RoPE. `Transformer` holds the same dict as
an nn.Module.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.engine.store import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib

PORTED_LAYERS = ("attn", "swa", "mla", "hymba", "hymba_g", "mlstm", "slstm")


def _check_layer(ltype: str) -> None:
    if ltype not in PORTED_LAYERS:
        raise ValueError(f"unknown layer type {ltype!r}")


# --------------------------------------------------------------------------
# Init.
# --------------------------------------------------------------------------


def _init_layer(gen: torch.Generator, cfg: ModelConfig, ltype: str,
                is_moe: bool) -> dict:
    dt = L.dtype_of(cfg.param_dtype)
    p: dict[str, Any] = {"norm1": L.norm_init(cfg, gen.device)}
    if ltype in ("attn", "swa"):
        p["attn"] = L.attn_init(gen, cfg, dt)
    elif ltype == "mla":
        p["attn"] = L.mla_init(gen, cfg, dt)
    elif ltype in ("hymba", "hymba_g"):
        p["attn"] = L.attn_init(gen, cfg, dt)
        p["mamba"] = ssm_lib.mamba_init(gen, cfg, dt)
    elif ltype == "mlstm":
        p["cell"] = ssm_lib.mlstm_init(gen, cfg, dt)
    elif ltype == "slstm":
        p["cell"] = ssm_lib.slstm_init(gen, cfg, dt)
    else:
        _check_layer(ltype)
    has_ffn = cfg.d_ff > 0 or is_moe
    if has_ffn and not cfg.parallel_block:
        p["norm2"] = L.norm_init(cfg, gen.device)
    if is_moe:
        p["moe"] = moe_lib.moe_init(gen, cfg, dt)
    elif cfg.d_ff > 0:
        p["mlp"] = L.mlp_init(gen, cfg, dt)
    return p


def _dense_ffn_width(cfg: ModelConfig, is_moe: bool) -> int:
    if not is_moe and cfg.moe is not None and cfg.moe.dense_d_ff:
        return cfg.moe.dense_d_ff
    return cfg.d_ff


def _group_cfg(cfg: ModelConfig, is_moe: bool) -> ModelConfig:
    """Dense layers inside MoE models may use a wider dense FFN."""
    w = _dense_ffn_width(cfg, is_moe)
    return dataclasses.replace(cfg, d_ff=w) if w != cfg.d_ff else cfg


def _stacked(count: int, make) -> dict:
    """`count` layers from `make()` stacked on a leading axis, filled in
    place one layer at a time (a full-width group never exists twice;
    one layer is a view of itself)."""
    if count == 1:
        return tree_lib.tree_map(lambda a: a[None], make())
    out = None
    for i in range(count):
        layer = make()
        if out is None:
            out = tree_lib.tree_map(
                lambda a: a.new_empty((count,) + a.shape), layer)
        tree_lib.tree_map(lambda o, a: o[i].copy_(a), out, layer)
    return out


def init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on the generator's device, in the reference's
    layout and scales (`repro.models.transformer.init`); the draws are
    torch's, not jax.random's. Embedding inputs have no "embed" leaf."""
    groups = cfg.layer_groups()
    for ltype, _, _ in groups:
        _check_layer(ltype)
    dt = L.dtype_of(cfg.param_dtype)
    params: dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        params["embed"] = (torch.randn((cfg.vocab_size, cfg.d_model),
                                       generator=gen, device=gen.device)
                           * 0.02).to(dt)
    params["groups"] = []
    for ltype, is_moe, count in groups:
        gcfg = _group_cfg(cfg, is_moe)
        params["groups"].append(_stacked(
            count, lambda: _init_layer(gen, gcfg, ltype, is_moe)))
    params["final_norm"] = L.norm_init(cfg, gen.device)
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                         dt)
    return params


def _tensor_of(a, device) -> torch.Tensor:
    """A numpy array (or a JAX array through np.asarray) as a tensor with
    the same bits: bfloat16 arrives as ml_dtypes' bfloat16, which
    torch.from_numpy rejects, and crosses as its 16-bit words."""
    a = np.require(np.asarray(a), requirements=["C", "W"])
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(params, cfg: ModelConfig,
                      device: torch.device | str | None = None) -> dict:
    """Carry a parameter tree of the JAX package's `init(key, cfg)` across
    as numpy arrays: the same nesting (groups stacked on axis 0), every
    leaf's bits unchanged, on `device` (default: the card)."""
    for ltype, _, _ in cfg.layer_groups():
        _check_layer(ltype)
    dev = resolve_device(device)
    return tree_lib.tree_map(lambda a: _tensor_of(a, dev), params)


# --------------------------------------------------------------------------
# Layer application (shared by prefill and decode).
# --------------------------------------------------------------------------


def _layer_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, ltype: str,
                 is_moe: bool, *, cache: dict | None = None, pos0: int = 0,
                 positions3: torch.Tensor | None = None,
                 decode: bool = False) -> tuple[torch.Tensor, dict, dict]:
    """One layer -> (x, new_cache, aux). decode: the recurrent layers take
    their one-step form (the attention layers read it from the cache)."""
    aux = {"load_balance": torch.zeros((), device=x.device),
           "z_loss": torch.zeros((), device=x.device)}
    h = L.apply_norm(p["norm1"], x, cfg)
    if ltype in ("attn", "swa", "hymba", "hymba_g"):
        window = cfg.window if ltype in ("swa", "hymba") else 0
        is_hymba = ltype.startswith("hymba")
        acache = cache["attn"] if (is_hymba and cache is not None) else cache
        y, new_cache = L.attn_apply(p["attn"], h, cfg, layer_window=window,
                                    cache=acache, pos0=pos0,
                                    positions3=positions3)
        if is_hymba:
            if decode:
                ym, scache = ssm_lib.mamba_apply_step(p["mamba"], h, cfg,
                                                      cache["ssm"])
            else:
                ym, scache = ssm_lib.mamba_apply_seq(
                    p["mamba"], h, cfg, None if cache is None
                    else cache["ssm"])
            y = 0.5 * (y + ym)
            new_cache = {"attn": new_cache, "ssm": scache}
    elif ltype == "mla":
        y, new_cache = L.mla_apply(p["attn"], h, cfg, cache=cache, pos0=pos0)
    elif ltype == "mlstm":
        fn = ssm_lib.mlstm_apply_step if decode else ssm_lib.mlstm_apply_seq
        y, new_cache = fn(p["cell"], h, cfg, cache)
    elif ltype == "slstm":
        fn = ssm_lib.slstm_apply_step if decode else ssm_lib.slstm_apply_seq
        y, new_cache = fn(p["cell"], h, cfg, cache)
    else:
        _check_layer(ltype)
    if cfg.parallel_block:
        # command-r style: x + attn(norm(x)) + mlp(norm(x)), one norm
        f = _ffn(p, h, cfg, is_moe, aux)
        return x + y + f, new_cache, aux
    x = x + y
    if "norm2" in p and (is_moe or cfg.d_ff > 0):
        h2 = L.apply_norm(p["norm2"], x, cfg)
        x = x + _ffn(p, h2, cfg, is_moe, aux)
    return x, new_cache, aux


def _ffn(p: dict, h: torch.Tensor, cfg: ModelConfig, is_moe: bool,
         aux: dict) -> torch.Tensor:
    if is_moe:
        y, a = moe_lib.moe_apply(p["moe"], h, cfg)
        aux["load_balance"] = aux["load_balance"] + a["load_balance"]
        aux["z_loss"] = aux["z_loss"] + a["z_loss"]
        return y
    if cfg.d_ff > 0:
        return L.mlp_apply(p["mlp"], h, cfg)
    return torch.zeros_like(h)


def _run_group(params_g: dict, x: torch.Tensor, cfg: ModelConfig,
               ltype: str, is_moe: bool, *, caches: dict | None = None,
               pos0: int = 0, positions3: torch.Tensor | None = None,
               decode: bool = False, collect_cache: bool = False):
    """The group's stacked layers in order -> (x, stacked new caches or
    None, load_balance, z_loss)."""
    gcfg = _group_cfg(cfg, is_moe)
    n = tree_lib.leaves(params_g)[0].shape[0]
    lb = zl = torch.zeros((), device=x.device)
    new = []
    for i in range(n):
        p = tree_lib.tree_map(lambda a: a[i], params_g)
        c = None if caches is None else tree_lib.tree_map(lambda a: a[i],
                                                          caches)
        x, nc, aux = _layer_apply(p, x, gcfg, ltype, is_moe, cache=c,
                                  pos0=pos0, positions3=positions3,
                                  decode=decode)
        lb, zl = lb + aux["load_balance"], zl + aux["z_loss"]
        if collect_cache:
            new.append(nc)
    stacked = (tree_lib.tree_map(lambda *a: torch.stack(a), *new)
               if collect_cache else None)
    return x, stacked, lb, zl


# --------------------------------------------------------------------------
# Forward passes.
# --------------------------------------------------------------------------


def _embed_in(params: dict, cfg: ModelConfig, batch: dict,
              pos0: int = 0) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        x = params["embed"][batch["tokens"]].to(L.dtype_of(cfg.dtype))
    else:
        x = batch["embeddings"].to(L.dtype_of(cfg.dtype))
    if cfg.pos_embed == "sinusoidal":
        S, D = x.shape[1], x.shape[2]
        pos = pos0 + torch.arange(S, dtype=torch.int32, device=x.device)
        sin, cos = L.rope_sincos(pos, D, 10000.0)
        x = x + torch.cat([sin, cos], -1)[None].to(x.dtype)
    return x


def _logits_out(params: dict, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    """Logits in the compute dtype."""
    x = L.apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = x @ params["unembed"]
    if cfg.logit_softcap:
        logits = L.tanh_cap(logits.float(), cfg.logit_softcap).to(
            logits.dtype)
    return logits


def forward(params: dict, cfg: ModelConfig, batch: dict,
            return_cache: bool = False, last_only: bool = False):
    """Prefill forward. batch: tokens (B, S) | embeddings (B, S, D)
    [+ positions3 (B, S, 3)]. Returns (logits, aux[, caches]); last_only
    computes the logits of the final position only (prefill serving)."""
    x = _embed_in(params, cfg, batch)
    positions3 = batch.get("positions3")
    lb = zl = torch.zeros((), device=x.device)
    caches = []
    for params_g, (ltype, is_moe, _) in zip(params["groups"],
                                            cfg.layer_groups()):
        x, new_c, l, z = _run_group(params_g, x, cfg, ltype, is_moe,
                                    positions3=positions3,
                                    collect_cache=return_cache)
        if return_cache:
            caches.append(new_c)
        lb, zl = lb + l, zl + z
    if last_only:
        x = x[:, -1:]
    logits = _logits_out(params, cfg, x)
    aux = {"load_balance": lb, "z_loss": zl}
    if return_cache:
        return logits, aux, caches
    return logits, aux


# --------------------------------------------------------------------------
# Decode.
# --------------------------------------------------------------------------


def _cache_for_layer(cfg: ModelConfig, ltype: str, batch: int, max_seq: int,
                     device: torch.device) -> dict:
    """One layer's empty cache: attention keys / values in the compute
    dtype (a ring of `window` rows for windowed layers), MLA's latents,
    the recurrent states in float32."""
    dt = L.dtype_of(cfg.dtype)
    if ltype in ("attn", "swa"):
        w = cfg.window if ltype == "swa" else 0
        return L.attn_cache_init(cfg, batch, max_seq, w, dt, device)
    if ltype == "mla":
        return L.mla_cache_init(cfg, batch, max_seq, dt, device)
    if ltype in ("hymba", "hymba_g"):
        w = cfg.window if ltype == "hymba" else 0
        return {"attn": L.attn_cache_init(cfg, batch, max_seq, w, dt,
                                          device),
                "ssm": ssm_lib.mamba_state_init(cfg, batch, device)}
    if ltype == "mlstm":
        return ssm_lib.mlstm_state_init(cfg, batch, device)
    if ltype == "slstm":
        return ssm_lib.slstm_state_init(cfg, batch, device)
    _check_layer(ltype)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: torch.device | str | None = None) -> list:
    """Empty decode caches, one dict a group with each leaf stacked over
    the group's layers, on `device` (default: the card)."""
    dev = resolve_device(device)
    caches = []
    for ltype, _, count in cfg.layer_groups():
        one = _cache_for_layer(cfg, ltype, batch, max_seq, dev)
        caches.append(tree_lib.tree_map(
            lambda a: a.expand((count,) + a.shape).clone(), one))
    return caches


def decode_step(params: dict, cfg: ModelConfig, batch: dict, caches: list,
                pos: int, return_hidden: bool = False):
    """One token for every sequence. batch: tokens (B, 1) | embeddings
    (B, 1, D) [+ positions3 (B, 1, 3)]; pos: the current position (an
    int). Returns (logits (B, 1, V), new caches[, hidden (B, 1, D)]):
    `hidden` is the residual stream before the final norm, in the compute
    dtype. The given caches are left as they were."""
    x = _embed_in(params, cfg, batch, pos0=pos)
    positions3 = batch.get("positions3")
    new_caches = []
    for params_g, caches_g, (ltype, is_moe, _) in zip(
            params["groups"], caches, cfg.layer_groups()):
        x, nc, _, _ = _run_group(params_g, x, cfg, ltype, is_moe,
                                 caches=caches_g, pos0=pos,
                                 positions3=positions3, decode=True,
                                 collect_cache=True)
        new_caches.append(nc)
    logits = _logits_out(params, cfg, x)
    if return_hidden:
        return logits, new_caches, x
    return logits, new_caches


# --------------------------------------------------------------------------
# nn.Module view.
# --------------------------------------------------------------------------


def _module_of(tree) -> nn.Module:
    """A nested dict / list of tensors as nested modules whose parameters
    are those tensors (no copy, requires_grad off)."""
    if isinstance(tree, list):
        return nn.ModuleList([_module_of(c) for c in tree])
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            m.register_parameter(k, nn.Parameter(v, requires_grad=False))
        else:
            m.add_module(k, _module_of(v))
    return m


def _tree_of(m: nn.Module):
    if isinstance(m, nn.ModuleList):
        return [_tree_of(c) for c in m]
    out = {k: v for k, v in m.named_parameters(recurse=False)}
    out.update({k: _tree_of(c) for k, c in m.named_children()})
    return out


class Transformer(nn.Module):
    """The transformer as an nn.Module over the parameter dict of `init`
    (or `params_from_numpy`): it holds the same tensors, not copies."""

    def __init__(self, params: dict, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.params = _module_of(params)

    def tree(self) -> dict:
        """The parameters as the pure functions' dict (the same tensors)."""
        return _tree_of(self.params)

    def forward(self, batch: dict, **kwargs):
        return forward(self.tree(), self.cfg, batch, **kwargs)

    def decode_step(self, batch: dict, caches: list, pos: int, **kwargs):
        return decode_step(self.tree(), self.cfg, batch, caches, pos,
                           **kwargs)
