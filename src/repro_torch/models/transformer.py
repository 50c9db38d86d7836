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
Python loop runs the layers of a group, each layer's parameters one
`unbind` of the stacked leaves (whose backward is one `stack`, where
indexing layer by layer would sum a stacked-size zero tensor a layer).
With `cfg.remat` and gradients enabled, each layer's body runs under
`torch.utils.checkpoint` (the reference's `jax.checkpoint(body)`): its
activations are recomputed in backward, with the same bits. A parameter
tree of the JAX package's `init` crosses over as numpy arrays through
`params_from_numpy`.

Public API (pure functions over the parameter dict):
  init(gen, cfg)                                   -> params
  forward(params, cfg, batch[, return_cache, last_only, rules])
                                                   -> (logits, aux[, caches])
  loss_fn(params, cfg, batch[, rules])             -> (loss, aux)
  init_cache(cfg, batch, max_seq, device)          -> caches
  decode_step(params, cfg, batch, caches, pos[, return_hidden, rules])
                                                   -> (logits, caches[, hidden])
  params_from_numpy(params, cfg, device)           -> params
  abstract_params(cfg) / shardings(cfg, mesh, rules)

`rules` (`models/sharding.Rules`) names the activations' layouts at the
reference's `constrain` sites; without it every name resolves to
unsharded. A parameter leaf may be a `sharding.Placed` tensor: the
top-level leaves are assembled once a call, and a group's stacked leaves
one layer at a time inside the layer's (checkpointed) body, so no whole
second copy of the model exists; gradients flow back into the blocks.
The reference's `REPRO_OPT` level 2 (an XLA optimization barrier on
each block output, `_barrier`) and level 5 (the decode residual's
layout, `_decode_stream`) change no value; they sit where the
reference's do.

A batch is {"tokens": (B, S) int} or {"embeddings": (B, S, D)}, with
"positions3" (B, S, 3) for M-RoPE, and "labels" (B, S) for the loss.
`Transformer` holds the same dict as an nn.Module.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.engine.store import resolve_device
from repro_torch.kernels._build import profiler_range
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.sharding import (NamedSharding, Rules, aconstrain,
                                         constrain, gathered, legalize_spec)

_NO_RULES = Rules(batch=(), fsdp=(), tensor=(), expert=())

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


_tensor_of = tree_lib.tensor_of


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


def _barrier(y: torch.Tensor) -> torch.Tensor:
    """REPRO_OPT level 2: the reference's `optimization_barrier` on a block
    output, which keeps XLA from hoisting the next norm's float32 upcast
    above the tensor-parallel psum. Eager PyTorch runs the ops as written,
    so at every level this is the identity."""
    return y


def _decode_stream(x: torch.Tensor, decode: bool) -> torch.Tensor:
    """REPRO_OPT level 5: the decode residual stream's layout, its hidden
    dim over the FSDP axes (`aconstrain`: no value changes)."""
    if decode and L.OPT_LEVEL >= 5:
        x = aconstrain(x, "batch", None, "fsdp")
    return x


def _layer_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, ltype: str,
                 is_moe: bool, rules: Rules, *, cache: dict | None = None,
                 pos0: int = 0, positions3: torch.Tensor | None = None,
                 decode: bool = False, taps: list | None = None
                 ) -> tuple[torch.Tensor, dict, dict]:
    """One layer -> (x, new_cache, aux). decode: the recurrent layers take
    their one-step form (the attention layers write their rows into
    `cache` and read it). taps: a list that gets the layer's {"x": input,
    "attn": the attention's output, "ffn_in": the FFN's normed input,
    "ffn": its output[, "experts": the published router's choice]}
    (`decode_step`)."""
    aux = {"load_balance": torch.zeros((), device=x.device),
           "z_loss": torch.zeros((), device=x.device)}
    tap = {"x": x}
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
        with profiler_range("lm.mla"):
            y, new_cache = L.mla_apply(p["attn"], h, cfg, cache=cache,
                                       pos0=pos0)
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
        f = _barrier(_ffn(p, h, cfg, is_moe, rules, aux))
        return _decode_stream(x + _barrier(y) + f, decode), new_cache, aux
    x = x + _barrier(y)
    tap["attn"] = y
    if "norm2" in p and (is_moe or cfg.d_ff > 0):
        h2 = L.apply_norm(p["norm2"], x, cfg)
        f = _ffn(p, h2, cfg, is_moe, rules, aux)
        tap.update(ffn_in=h2, ffn=f)
        if "experts" in aux:
            tap["experts"] = aux["experts"]
        x = x + _barrier(f)
    if taps is not None:
        taps.append(tap)
    return _decode_stream(x, decode), new_cache, aux


def _ffn(p: dict, h: torch.Tensor, cfg: ModelConfig, is_moe: bool,
         rules: Rules, aux: dict) -> torch.Tensor:
    if is_moe:
        with profiler_range("lm.moe"):
            y, a = moe_lib.moe_apply(p["moe"], h, cfg, rules)
        aux["load_balance"] = aux["load_balance"] + a["load_balance"]
        aux["z_loss"] = aux["z_loss"] + a["z_loss"]
        if "experts" in a:
            aux["experts"] = a["experts"]
        return y
    if cfg.d_ff > 0:
        with profiler_range("lm.mlp"):
            return L.mlp_apply(p["mlp"], h, cfg)
    return torch.zeros_like(h)


def _unstacked(tree) -> list:
    """A group's stacked tree as one tree a layer: views from one `unbind`
    of each leaf (of each block of a Placed leaf)."""
    parts = [a.unbind(0) for a in tree_lib.leaves(tree)]
    return [tree_lib.unflatten(tree, [p[i] for p in parts])
            for i in range(len(parts[0]))]


def _run_group(params_g: dict, x: torch.Tensor, cfg: ModelConfig,
               ltype: str, is_moe: bool, rules: Rules, *,
               caches: dict | None = None, pos0: int = 0,
               positions3: torch.Tensor | None = None,
               decode: bool = False, collect_cache: bool = False,
               taps: list | None = None):
    """The group's stacked layers in order -> (x, stacked new caches or
    None, load_balance, z_loss). With cfg.remat, gradients enabled and no
    decode, each layer's body is checkpointed (recomputed in backward).
    A layer's Placed leaves are assembled inside its body, so under remat
    the assembled weights are freed after the forward and assembled again
    in backward. Given `caches` (decode), each layer's new cache is
    written into its slice of them (the attention layers write their rows
    there directly; a leaf made anew, such as a recurrent state, is
    copied in), and they are returned."""
    gcfg = _group_cfg(cfg, is_moe)
    layers = _unstacked(params_g)
    layer_caches = (_unstacked(caches) if caches is not None
                    else [None] * len(layers))
    remat = cfg.remat and not decode and torch.is_grad_enabled()
    lb = zl = torch.zeros((), device=x.device)
    new = []

    def body(p, x, c):
        return _layer_apply(gathered(p), x, gcfg, ltype, is_moe, rules,
                            cache=c, pos0=pos0, positions3=positions3,
                            decode=decode, taps=taps)
    for p, c in zip(layers, layer_caches):
        if remat:
            # the body draws no random numbers: no RNG state to stash
            x, nc, aux = checkpoint(body, p, x, c, use_reentrant=False,
                                    preserve_rng_state=False)
        else:
            x, nc, aux = body(p, x, c)
        lb, zl = lb + aux["load_balance"], zl + aux["z_loss"]
        if caches is not None:
            tree_lib.tree_map(lambda old, n: n is old or old.copy_(n), c, nc)
        elif collect_cache:
            new.append(nc)
    if caches is not None:
        return x, caches, lb, zl
    stacked = (tree_lib.tree_map(lambda *a: torch.stack(a), *new)
               if collect_cache else None)
    return x, stacked, lb, zl


# --------------------------------------------------------------------------
# Forward passes.
# --------------------------------------------------------------------------


def _embed_in(params: dict, cfg: ModelConfig, batch: dict,
              rules: Rules = _NO_RULES, pos0: int = 0) -> torch.Tensor:
    if cfg.input_mode == "tokens":
        x = params["embed"][batch["tokens"]].to(L.dtype_of(cfg.dtype))
    else:
        x = batch["embeddings"].to(L.dtype_of(cfg.dtype))
    if cfg.pos_embed == "sinusoidal":
        S, D = x.shape[1], x.shape[2]
        pos = pos0 + torch.arange(S, dtype=torch.int32, device=x.device)
        sin, cos = L.rope_sincos(pos, D, 10000.0)
        x = x + torch.cat([sin, cos], -1)[None].to(x.dtype)
    return constrain(x, rules, "batch", None, None)


def _logits_out(params: dict, cfg: ModelConfig, x: torch.Tensor,
                rules: Rules = _NO_RULES) -> torch.Tensor:
    """Logits in the compute dtype."""
    x = L.apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        logits = x @ params["unembed"]
    if cfg.logit_softcap:
        logits = L.tanh_cap(logits.float(), cfg.logit_softcap).to(
            logits.dtype)
    return constrain(logits, rules, "batch", None, "tensor")


def _top_level(params: dict) -> dict:
    """The parameter dict with its Placed leaves outside the layer groups
    (embeddings, final norm) assembled; the groups as they are."""
    return {k: v if k == "groups" else gathered(v)
            for k, v in params.items()}


def forward(params: dict, cfg: ModelConfig, batch: dict,
            return_cache: bool = False, last_only: bool = False, *,
            rules: Rules | None = None):
    """Prefill forward. batch: tokens (B, S) | embeddings (B, S, D)
    [+ positions3 (B, S, 3)]. Returns (logits, aux[, caches]); last_only
    computes the logits of the final position only (prefill serving)."""
    rules = rules or _NO_RULES
    params = _top_level(params)
    x = _embed_in(params, cfg, batch, rules)
    positions3 = batch.get("positions3")
    lb = zl = torch.zeros((), device=x.device)
    caches = []
    for params_g, (ltype, is_moe, _) in zip(params["groups"],
                                            cfg.layer_groups()):
        x, new_c, l, z = _run_group(params_g, x, cfg, ltype, is_moe, rules,
                                    positions3=positions3,
                                    collect_cache=return_cache)
        if return_cache:
            caches.append(new_c)
        lb, zl = lb + l, zl + z
    if last_only:
        x = x[:, -1:]
    logits = _logits_out(params, cfg, x, rules)
    aux = {"load_balance": lb, "z_loss": zl}
    if return_cache:
        return logits, aux, caches
    return logits, aux


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            rules: Rules | None = None) -> tuple[torch.Tensor, dict]:
    """The reference's vocab-parallel cross entropy (on one device the
    same sums): logsumexp over the float32 logits minus the label's logit
    (a one-hot contraction; a label of -1 selects nothing and is masked),
    averaged over the unmasked positions (at least 1); MoE models add
    aux_weight * load_balance + 1e-3 * z_loss. Returns (loss, {"nll",
    "load_balance"}), "nll" being the loss, as the reference returns it."""
    logits, aux = forward(params, cfg, batch, rules=rules)
    labels = batch["labels"]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)                          # (B, S)
    onehot = L.one_hot(labels, cfg.vocab_size, logits.dtype)
    label_logit = torch.einsum("bsv,bsv->bs", lf, onehot.float())
    nll = lse - label_logit
    mask = (labels >= 0).float()
    loss = torch.div((nll * mask).sum(), torch.clamp(mask.sum(), min=1.0))
    if cfg.moe is not None:
        loss = (loss + cfg.moe.aux_weight * aux["load_balance"]
                + 1e-3 * aux["z_loss"])
    return loss, {"nll": loss, "load_balance": aux["load_balance"]}


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
                pos: int, return_hidden: bool = False, *,
                rules: Rules | None = None, inplace: bool = False,
                taps: list | None = None):
    """One token for every sequence. batch: tokens (B, 1) | embeddings
    (B, 1, D) [+ positions3 (B, 1, 3)]; pos: the current position (an
    int). Returns (logits (B, 1, V), new caches[, hidden (B, 1, D)]):
    `hidden` is the residual stream before the final norm, in the compute
    dtype.

    Each layer writes its new latent / key / value rows into its slice of
    the group's stacked cache, and the caches written are returned. By
    default the given caches are left as they were: they are cloned once
    first. With `inplace` (the serve path, `launch/serve.py` and
    `steps.make_serve_step_with_mcam(..., inplace=True)`) the caller hands
    its caches over: the given tensors are written and returned, no cache
    row is copied, and the caller keeps no copy of the state before the
    step. The values are the same either way. taps: a list that gets one
    dict a layer (`_layer_apply`) and then {"x": the head's input}, for
    checking the program layer by layer.

    Profiler ranges: `lm.decode` (the whole step), `lm.mla`, `lm.mlp`,
    `lm.moe` (inside it `lm.router`, `lm.experts` on the published
    router), `lm.logits`."""
    with profiler_range("lm.decode"):
        rules = rules or _NO_RULES
        params = _top_level(params)
        x = _embed_in(params, cfg, batch, rules, pos0=pos)
        x = _decode_stream(x, True)
        positions3 = batch.get("positions3")
        if not inplace:
            caches = tree_lib.tree_map(torch.clone, caches)
        for params_g, caches_g, (ltype, is_moe, _) in zip(
                params["groups"], caches, cfg.layer_groups()):
            x, _, _, _ = _run_group(params_g, x, cfg, ltype, is_moe, rules,
                                    caches=caches_g, pos0=pos,
                                    positions3=positions3, decode=True,
                                    taps=taps)
        if taps is not None:
            taps.append({"x": x})
        with profiler_range("lm.logits"):
            logits = _logits_out(params, cfg, x, rules)
    if return_hidden:
        return logits, caches, x
    return logits, caches


# --------------------------------------------------------------------------
# Abstract params + shardings (no allocation).
# --------------------------------------------------------------------------


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device: shapes and dtypes,
    no storage."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def abstract_params(cfg: ModelConfig) -> dict:
    """`init`'s tree on the meta device: every leaf's shape and dtype, no
    storage (a full-width model allocates nothing)."""
    return init(_MetaGenerator(), cfg)


def shardings(cfg: ModelConfig, mesh, rules: Rules) -> dict:
    """The NamedSharding tree of the parameters: each leaf's logical axes
    (`layers.param_specs`) resolved by `rules` and legalized against its
    dims."""
    aps = abstract_params(cfg)
    return tree_lib.tree_map(
        lambda leaf, spec: NamedSharding(mesh, legalize_spec(
            rules.resolve(*spec.logical), leaf.shape, mesh)),
        aps, L.param_specs(aps))


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
