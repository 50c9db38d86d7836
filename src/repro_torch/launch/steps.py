"""Step builders (port of `repro.launch.steps`): the LM's train step
and the execution knobs it depends on (`adapt_config`, `microbatch_for`,
`optimizer_for`), the sharding trees of a deployment's mesh, the
two-stage hardware-aware trainer's steps, and the LM's prefill and serve
steps with the kNN-LM head over the MCAM store.

Sharding summary (logical axes resolved by `models.sharding.Rules` and
legalized against the actual dims: an axis that does not divide its dim
is dropped):

  params      name-based specs (`layers.PARAM_LOGICAL`); FSDP rows over
              ("pod", "data"), tensor columns over "model", experts over
              "model" with FSDP'd expert FFN width.
  opt state   a moment with its parameter's shape inherits that shape's
              sharding (ZeRO); other states shard dim 0 over FSDP.
  batch       (accum, microbatch, ...) with microbatch over ("pod", "data").
  kv caches   batch over DP; heads over "model" when divisible, else the
              sequence; with `seq` rules the sequence over every axis.

`REPRO_OPT` is read when the modules are imported, as the reference
reads it: level 1 shards the embeddings by vocab only
(`layers.PARAM_LOGICAL`), 2 and 5 are layouts (`transformer._barrier`,
`_decode_stream`), 3 gives decode its own rules (`rules_for`), 4 makes
the norm multiply in the compute dtype (`layers.apply_norm`) and 6 turns
attention chunking off for training at <= 4k positions
(`adapt_config`).

`make_train_step` has no `unroll_accum`: the reference's switch between a
`lax.scan` and an unrolled loop over microbatches has no meaning in an
eager step, whose accumulation is a Python loop already.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import hat as hat_lib
from repro_torch.engine.api import SearchRequest
from repro_torch.engine.store import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels._build import profiler_range
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import div
from repro_torch.models.sharding import (NamedSharding, P, Placed, Rules,
                                         gathered, legalize_spec,
                                         rules_for_mesh)
from repro_torch.optim import clip_scale, make_optimizer
from repro_torch.optim.optimizers import norm_of
from repro_torch.runtime.compression import with_error_feedback

# microbatch sizes for train_4k (global batch 256), the reference's
TRAIN_MICROBATCH = {
    "llama3-405b": 64,
    "deepseek-v3-671b": 64,
    "qwen1.5-110b": 128,
    "command-r-plus-104b": 128,
}

# optimizer choice at scale (moment memory), the reference's
ARCH_OPTIMIZER = {
    "llama3-405b": ("adamw", {"state_dtype": torch.bfloat16}),
    "qwen1.5-110b": ("adamw", {"state_dtype": torch.bfloat16}),
    "command-r-plus-104b": ("adamw", {"state_dtype": torch.bfloat16}),
    "deepseek-v3-671b": ("adafactor", {}),
}

def decode_rules(mesh) -> Rules:
    """REPRO_OPT >= 3: serving rules. Decode activations (B x 1 x D) are
    replicated over data parallelism, so they do not conflict with the
    weights' FSDP rows on that axis; the KV cache shards its sequence
    over every mesh axis."""
    names = mesh.axis_names
    dp = ("pod", "data") if "pod" in names else ("data",)
    return Rules(batch=(), fsdp=dp, tensor=("model",), expert=("model",),
                 seq=dp + ("model",))


OPT_LEVEL = int(os.environ.get("REPRO_OPT", "0") or 0)


def rules_for(mesh, shape: ShapeConfig) -> Rules:
    if shape.kind == "decode" and OPT_LEVEL >= 3:
        return decode_rules(mesh)
    return rules_for_mesh(mesh)


def adapt_config(cfg: ModelConfig, shape: ShapeConfig,
                 dp: int = 1) -> ModelConfig:
    """Resolve the execution knobs that depend on the deployment: MoE
    token groups (one per 1,024 tokens, a multiple of the data-parallel
    width `dp`), no remat outside training, 2,048-position attention
    chunks from 16k positions; REPRO_OPT >= 6: no chunking for training
    at <= 4,096 positions."""
    upd = {}
    if cfg.moe is not None:
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        g = max(dp, tokens // 1024)
        g = (g // dp) * dp or dp
        upd["moe"] = dataclasses.replace(cfg.moe, groups=g)
    if shape.kind != "train":
        upd["remat"] = False
    if shape.seq_len >= 16384 and cfg.attn_chunk:
        upd["attn_chunk"] = 2048
    if OPT_LEVEL >= 6 and shape.kind == "train" and shape.seq_len <= 4096:
        upd["attn_chunk"] = 0
    return dataclasses.replace(cfg, **upd) if upd else cfg


def microbatch_for(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if shape.kind != "train":
        return shape.global_batch
    if shape.microbatch:
        return shape.microbatch
    return TRAIN_MICROBATCH.get(cfg.name, shape.global_batch)


def optimizer_for(cfg: ModelConfig, tc: TrainConfig):
    name, kw = ARCH_OPTIMIZER.get(cfg.name, (tc.optimizer, {}))
    return make_optimizer(name, tc.learning_rate, **kw)


# --------------------------------------------------------------------------
# Sharding trees.
# --------------------------------------------------------------------------


def param_shardings(cfg: ModelConfig, mesh, rules: Rules):
    return tfm.shardings(cfg, mesh, rules)


def opt_shardings(opt_shapes, params_abs, p_shardings, mesh, rules: Rules):
    """Moments with a parameter's shape inherit that shape's sharding (the
    last parameter of the shape, as the reference keys them); other
    states shard dim 0 over FSDP; scalars replicate. `opt_shapes` is any
    state tree with shaped leaves (`optimizer.init(abstract_params)`)."""
    by_shape = {}
    for p, sh in zip(tree_lib.leaves(params_abs),
                     tree_lib.leaves(p_shardings)):
        by_shape[tuple(p.shape)] = sh
    rep = NamedSharding(mesh, P())
    fsdp = rules.resolve("fsdp")[0]

    def mk(leaf):
        shape = tuple(leaf.shape)
        if shape in by_shape and len(shape):
            return by_shape[shape]
        if len(shape) >= 1:
            return NamedSharding(mesh, legalize_spec(P(fsdp), shape, mesh))
        return rep

    return tree_lib.tree_map(mk, opt_shapes)


_CACHE_LOGICAL = {
    "k": (None, "batch", None, "tensor", None),
    "v": (None, "batch", None, "tensor", None),
    "kpos": (),
    "ckv": (None, "batch", None, "tensor"),
    "krope": (None, "batch", None, None),
    "C": (None, "batch", "tensor", None, None),
    "n": (None, "batch", "tensor", None),
    "m": (None, "batch", None),
    "h": (None, "batch", "tensor", None),
    "c": (None, "batch", "tensor", None),
    "conv": (None, "batch", None, "tensor"),
}


def cache_shardings(cfg: ModelConfig, batch: int, max_seq: int, mesh,
                    rules: Rules):
    """KV caches: batch over DP; the model axis goes to KV heads when
    divisible, otherwise to the sequence axis (the attention contraction
    then reduces small softmax statistics instead of gathering the
    cache); with `seq` rules (decode_rules) the sequence shards over
    them. Returns (the sharding tree, the caches on the meta device)."""
    tensor_size = (int(np.prod([mesh.shape[a] for a in rules.tensor]))
                   if rules.tensor else 1)
    seq_size = (int(np.prod([mesh.shape[a] for a in rules.seq]))
                if rules.seq else 0)
    cache_abs = tfm.init_cache(cfg, batch, max_seq, device="meta")
    out = []
    for path, leaf in zip(*tree_lib.flatten_with_names(cache_abs)):
        name = path.split(tree_lib.SEP)[-1]     # the leaf's own key
        nd = leaf.dim()
        if (name in ("k", "v", "ckv") and nd >= 4 and seq_size
                and leaf.shape[2] % seq_size == 0):
            # serving layout: sequence sharded over every mesh axis
            logical = (None, None, "seq", None, None)[:nd]
        elif name in ("k", "v", "ckv") and nd >= 4:
            # (Lg, B, T, KV[, hd]) / (Lg, B, T, r)
            if leaf.shape[3] % tensor_size == 0:
                logical = (None, "batch", None, "tensor", None)[:nd]
            elif leaf.shape[2] % tensor_size == 0:
                logical = (None, "batch", "tensor", None, None)[:nd]
            else:
                logical = (None, "batch", None, None, None)[:nd]
        else:
            logical = _CACHE_LOGICAL.get(name, ())[:nd]
            logical = (None,) * (nd - len(logical)) + tuple(logical)
        spec = legalize_spec(rules.resolve(*logical), leaf.shape, mesh)
        out.append(NamedSharding(mesh, spec))
    return tree_lib.unflatten(cache_abs, out), cache_abs


class InputSpec(NamedTuple):
    """A model input's stand-in (`jax.ShapeDtypeStruct`'s counterpart):
    shape, dtype and a sharding legalized for that shape."""
    shape: tuple
    dtype: torch.dtype
    sharding: NamedSharding


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: Rules
                ) -> dict[str, InputSpec]:
    """The stand-ins of every model input of the step `shape` runs:
    tokens or embeddings (+ positions3 for M-RoPE), and labels for
    training, with a leading (accum, microbatch) for training and
    (batch,) otherwise; decode is one position."""
    def struct(shp, dtype, logical):
        spec = legalize_spec(rules.resolve(*logical), shp, mesh)
        return InputSpec(tuple(shp), dtype, NamedSharding(mesh, spec))

    S = shape.seq_len
    if shape.kind == "train":
        mb = microbatch_for(cfg, shape)
        lead = (shape.global_batch // mb, mb)
        llog = (None, "batch")
    else:
        lead = (shape.global_batch,)
        llog = ("batch",)
    batch = {}
    seq = S if shape.kind != "decode" else 1
    if cfg.input_mode == "tokens":
        batch["tokens"] = struct(lead + (seq,), torch.int32, llog + (None,))
    else:
        batch["embeddings"] = struct(lead + (seq, cfg.d_model),
                                     torch.bfloat16, llog + (None, None))
        if cfg.rope_type == "mrope":
            batch["positions3"] = struct(lead + (seq, 3), torch.int32,
                                         llog + (None, None))
    if shape.kind == "train":
        batch["labels"] = struct(lead + (seq,), torch.int32, llog + (None,))
    return batch


# --------------------------------------------------------------------------
# Steps.
# --------------------------------------------------------------------------


def _full(x, device: torch.device) -> torch.Tensor:
    """A tensor as it is; a Placed leaf assembled on `device`."""
    return x.full(device) if isinstance(x, Placed) else x


def _write(x, full: torch.Tensor) -> None:
    """After a leaf's assembled copy `full` was updated in place: its
    blocks get the new values (a tensor was `full` itself)."""
    if isinstance(x, Placed):
        x.write(full)


def _blockwise(fn, *xs):
    """fn of tensors, or of the blocks of Placed leaves of one layout (a
    Placed of the results)."""
    if not isinstance(xs[0], Placed):
        return fn(*xs)
    return xs[0].with_canonical({k: fn(*(x.tiles[k][0] for x in xs))
                                 for k in xs[0].tiles})


def _grads(params: dict, cfg: ModelConfig, mb: dict,
           rules: Rules | None = None
           ) -> tuple[torch.Tensor, list]:
    """(loss, one gradient a parameter leaf, in visiting order) of one
    microbatch. The leaves are detached aliases of the parameters (no
    copy), so the caller's tensors carry no graph; a Placed leaf's
    gradient is a Placed of its blocks' gradients (its blocks' first
    replicas are the inputs autograd differentiates). Every gradient is
    row-major (`contiguous`): autograd may return one transposed (the
    tied embedding's), and the norm's sum over it would then run in
    another order than over the same values laid out as the parameter."""
    leaves, inputs = [], []
    for p in tree_lib.leaves(params):
        if isinstance(p, Placed):
            a = p.with_canonical({k: t.detach().requires_grad_()
                                  for k, t in p.canonical().items()})
            inputs.extend(a.canonical().values())
        else:
            a = p.detach().requires_grad_()
            inputs.append(a)
        leaves.append(a)
    loss, _ = tfm.loss_fn(tree_lib.unflatten(params, leaves), cfg, mb,
                          rules=rules)
    flat = iter(g.contiguous() for g in torch.autograd.grad(
        loss, inputs, allow_unused=True, materialize_grads=True))
    grads = [a.with_canonical({k: next(flat) for k in a.tiles})
             if isinstance(a, Placed) else next(flat) for a in leaves]
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    rules: Rules | None = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    reference's train step; every batch leaf carries a leading
    accumulation axis. `rules` names the activations' layouts (the
    model's `constrain` sites; no value changes). Returns (train_step,
    optimizer).

    In order: the gradients of `loss_fn` (`torch.autograd.grad` over the
    parameter leaves) summed over the accumulation axis in the parameter
    dtype (the first microbatch's gradient is the sum's start, which the
    reference's zeros + g equals but for the sign of a zero), divided by
    `accum` and the loss sum too (`layers.div`: rounded once; with a
    power-of-two `accum` as exact as the reference's jitted product by
    the reciprocal, ROADMAP C.R5); with `tc.grad_compression == "int8"`
    the int8 codec with error feedback (`opt_state["ef_residual"]`,
    zeros when absent; updated on every step, as the reference's); the
    global norm and clipping to `tc.grad_clip`; `optimizer.update`; the
    parameters as `(p + u).to(p.dtype)`; and the in-step anomaly guard:
    `ok = isfinite(loss) & isfinite(grad_norm)` keeps every parameter and
    optimizer-state leaf as it was unless ok, decided by `torch.where` on
    the device, with no host sync in the step. metrics: {"loss",
    "grad_norm", "applied"} (0-dim float32 tensors; applied is 1.0 or 0.0).

    Donation: the reference jits the step with params and optimizer state
    donated (`donate_argnums=(0, 1)`), so XLA reuses their buffers. Here
    the step writes its results into the given tensors (`copy_` under
    `no_grad`) and returns the same containers: the caller's params and
    opt_state are the new ones, as after a donating call. The update runs
    one leaf at a time, so only one leaf's float32 temporaries are alive
    at once; the values equal the out-of-place computation's. A state without "ef_residual"
    gains it under int8 compression.

    On a mesh (the reference's step under `active_mesh` with inputs
    placed by `param_shardings` / `opt_shardings` / `input_specs`): any
    parameter, state or batch leaf may be a `sharding.Placed` tensor, and
    every value equals the unplaced step's bit for bit, as GSPMD's do.
    The step computes on the mesh's first device: the batch is assembled
    there, each layer's weights inside the layer's body (`transformer`),
    and each gradient leaf for the norm (one leaf at a time). With an
    elementwise optimizer (adamw, sgd) and state placed as its parameter,
    a leaf updates block by block on the blocks' devices; otherwise the
    leaf, its gradient and state are assembled, updated and written back
    to their blocks, leaf by leaf. No second copy of the whole model is
    made. The reference's `unroll_accum` (its dry run's cost calibration
    unrolls the accumulation scan) has no counterpart: the accumulation
    here is a Python loop over the microbatches."""
    optimizer = optimizer_for(cfg, tc)

    def train_step(params, opt_state, batch):
        pleaves = tree_lib.leaves(params)
        dev = pleaves[0].device     # a Placed leaf's: its mesh's first
        batch = {k: _full(v, dev) for k, v in batch.items()}
        accum = tree_lib.leaves(batch)[0].shape[0]
        # lists replaced entry by entry: one leaf's temporary at a time
        lsum, grads = None, None
        for i in range(accum):
            loss, g_i = _grads(params, cfg, {k: v[i]
                                             for k, v in batch.items()},
                               rules)
            if grads is None:
                lsum, grads = loss, g_i
                continue
            lsum = lsum + loss
            for j in range(len(grads)):
                grads[j] = _blockwise(torch.add, grads[j], g_i[j])
                g_i[j] = None
        loss = div(lsum, accum)
        for j in range(len(grads)):
            grads[j] = _blockwise(lambda g: div(g, accum), grads[j])
        with torch.no_grad():
            if tc.grad_compression == "int8":
                grads = _error_feedback(params, opt_state, grads, dev)
            gnorm = norm_of(_full(g, dev) for g in grads)
            scale = clip_scale(gnorm, tc.grad_clip)
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
            inner = {k: v for k, v in opt_state.items() if k != "ef_residual"}
            step_node = inner["step"]
            step = _full(step_node, dev)
            nodes = {k: tree_lib.nodes_at(params, v)
                     for k, v in inner.items() if k != "step"}
            for i, p in enumerate(pleaves):
                g = grads[i]
                grads[i] = None
                _update_placed(optimizer, p, g, step,
                               {k: v[i] for k, v in nodes.items()}, scale,
                               ok, dev)
                del g
            step.copy_(torch.where(ok, step + 1, step))
            _write(step_node, step)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "applied": ok.to(torch.float32)}
        return params, opt_state, metrics

    return train_step, optimizer


def _error_feedback(params, opt_state: dict, grads: list,
                    device: torch.device) -> list:
    """The int8 codec with error feedback, leaf by leaf (the codec scales
    each tensor alone, so a Placed leaf is assembled first): `grads`
    with each entry replaced by its decompressed gradient; the new
    residual is written into opt_state["ef_residual"] (created as zeros,
    laid out as the parameters, first)."""
    if opt_state.get("ef_residual") is None:
        def zeros(t):
            return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        opt_state["ef_residual"] = tree_lib.tree_map(
            lambda p: p.map(zeros) if isinstance(p, Placed) else zeros(p),
            params)
    for j, r in enumerate(tree_lib.leaves(opt_state["ef_residual"])):
        rf = _full(r, device)
        (g,), (new_r,) = with_error_feedback([_full(grads[j], device)], [rf])
        grads[j] = grads[j].blocks_of(g) if isinstance(grads[j], Placed) \
            else g
        rf.copy_(new_r)
        _write(r, rf)
    return grads


def _update_leaf(optimizer, p: torch.Tensor, g: torch.Tensor,
                 step: torch.Tensor, state: dict,
                 scale: torch.Tensor, ok: torch.Tensor) -> None:
    """Clip, update and guard one parameter leaf (with its gradient g and
    its state nodes `state`, {name: node}), writing into the given
    tensors."""
    state = {k: [v] for k, v in state.items()}
    u, new = optimizer.update([g * scale.to(g.dtype)],
                              {**state, "step": step}, [p])
    p.copy_(torch.where(ok, (p + u[0]).to(p.dtype), p))
    for k, olds in state.items():
        for o, n in zip(tree_lib.leaves(olds), tree_lib.leaves(new[k])):
            o.copy_(torch.where(ok, n, o))


def _update_placed(optimizer, p, g, step: torch.Tensor, state: dict,
                   scale: torch.Tensor, ok: torch.Tensor,
                   device: torch.device) -> None:
    """`_update_leaf` of a leaf whose parts may be Placed: block by block
    on each block's device when the optimizer is elementwise and every
    state leaf is laid out as the placed parameter (the replicas then
    copied from the first); otherwise on the leaf, gradient and state
    assembled on `device` (tensors as they are), written back to their
    blocks."""
    sleaves = [x for node in state.values() for x in tree_lib.leaves(node)]
    if (optimizer.elementwise and isinstance(p, Placed)
            and all(p.same_layout(x) for x in sleaves)):
        for k, pt in p.canonical().items():
            d = pt.device
            _update_leaf(optimizer, pt, g.tiles[k][0], step.to(d),
                         {n: tree_lib.tree_map(lambda x: x.tiles[k][0], v)
                          for n, v in state.items()},
                         scale.to(d), ok.to(d))
        for x in [p] + sleaves:
            x.sync()
        return
    pf = _full(p, device)
    fstate = {n: tree_lib.tree_map(lambda x: _full(x, device), v)
              for n, v in state.items()}
    _update_leaf(optimizer, pf, _full(g, device), step, fstate, scale, ok)
    _write(p, pf)
    for x, xf in zip(sleaves, [y for v in fstate.values()
                               for y in tree_lib.leaves(v)]):
        _write(x, xf)


def make_hat_train_steps(apply_fn, hat_cfg, pre_optimizer,
                         meta_optimizer=None, *, n_way: int,
                         device: torch.device | str | None = None,
                         mesh=None, data_axes=("data",)):
    """Two-stage hardware-aware trainer steps (paper Sec. 3.3).

    Stage 1 (`pretrain_step(params, opt_state, batch)`): controller + linear
    head, plain CE over the full training class set. Stage 2
    (`meta_step(params, opt_state, ep_arrays, key)`): episodic CE through
    the simulated MCAM (`core.hat.meta_loss`), whose forward is the
    engine's differentiable episodic path, so the trained controller
    serves with the same votes through `MemoryStore` + `search`. Each step
    returns (params, opt_state, loss); parameters and state are new
    tensors, nothing is updated in place.

    apply_fn: (backbone_params, images) -> embeddings. key: an int or an
    integer array, folded into the step's noise-stream coordinate.
    `place(tree)` puts a batch or episode (numpy arrays or tensors) on
    `device` (default: the card) as tensors (float arrays as float32);
    with a `mesh`, each leaf is then a `sharding.Placed` tensor,
    row-sharded over the mesh's `data_axes` when its leading dim divides
    by their shard count and replicated otherwise, as the reference's
    `place` shards it. The steps assemble Placed inputs on their compute
    device (`Placed.full`), so their values equal the unplaced steps'.
    Returns (pretrain_step, meta_step, place)."""
    pretrain, _ = hat_lib.make_train_steps(apply_fn, hat_cfg, pre_optimizer)
    _, meta = hat_lib.make_train_steps(apply_fn, hat_cfg,
                                       meta_optimizer or pre_optimizer)
    dev = resolve_device(device)

    def pretrain_step(params, opt_state, batch):
        return pretrain(params, opt_state, gathered(batch))

    def meta_step(params, opt_state, ep_arrays, key):
        return meta(params, opt_state,
                    {**gathered(ep_arrays), "n_way": n_way}, key)

    def place(tree):
        """Every leaf as a tensor on the device, placed on the mesh when
        there is one."""
        def put(a):
            t = torch.as_tensor(a)
            if t.is_floating_point():
                t = t.to(torch.float32)
            t = t.to(dev)
            if mesh is None:
                return t
            shards = int(np.prod([mesh.shape[a] for a in data_axes]))
            row = t.dim() and t.shape[0] % shards == 0
            return Placed.place(t, NamedSharding(
                mesh, P(tuple(data_axes)) if row else P()))
        return tree_lib.tree_map(put, tree)

    return pretrain_step, meta_step, place


def make_prefill_step(cfg, *, rules: Rules | None = None):
    def prefill_step(params, batch):
        logits, aux, caches = tfm.forward(params, cfg, batch,
                                          return_cache=True, last_only=True,
                                          rules=rules)
        return logits, caches
    return prefill_step


def make_serve_step(cfg, *, rules: Rules | None = None,
                    inplace: bool = False):
    """serve_step(params, caches, batch, pos) -> (logits, caches);
    inplace: the step takes the caches over (`transformer.decode_step`)."""
    def serve_step(params, caches, batch, pos):
        return tfm.decode_step(params, cfg, batch, caches, pos, rules=rules,
                               inplace=inplace)
    return serve_step


def knn_lm_head(logits: torch.Tensor, hidden: torch.Tensor, store, dim: int,
                vocab_size: int, lam: float = 0.3, engine=None,
                request: SearchRequest | None = None) -> torch.Tensor:
    """The kNN-LM mixture of one decode step: logits (B, 1, V) and hidden
    (B, 1, D) of `decode_step(return_hidden=True)` -> log((1 - lam) p_lm +
    lam p_mem + 1e-20), (B, 1, V) float32. The query is the hidden row's
    first `dim` entries. engine None: softmax of -dist / 10 over the
    ideal LUT distance to every store row; else `engine.search(store, q,
    request)` and a softmax of votes / 10 over the k candidates, invalid
    ones filled with -1e30 and masked after (an all-invalid row adds
    nothing). p_mem is each candidate's weight added into its label's
    entry of a (B, V) row (a scatter-add: no (B, k, V) one-hot is made).
    Inside the profiler range `lm.knn_head`."""
    with profiler_range("lm.knn_head"):
        q = hidden[:, 0][:, :dim]                              # (B, dim)
        if engine is None:
            q1h = kernel_ops.query_onehot(store.quantize_queries(q),
                                          torch.float32)
            dist = q1h @ store.proj.float().T                  # (B, N)
            w = torch.softmax(div(-dist, 10.0), dim=-1)
            labels = store.labels.expand(w.shape)
            valid = labels >= 0
        else:
            res = engine.search(store, q, request)
            valid = res.labels >= 0                            # (B, k)
            w = torch.softmax(torch.where(valid, div(res.votes, 10.0),
                                          -1e30), dim=-1)
            labels = res.labels
        p_mem = torch.zeros(w.shape[0], vocab_size, dtype=w.dtype,
                            device=w.device).scatter_add_(
            1, torch.where(valid, labels, 0).to(torch.int64), w * valid)
        p_lm = torch.softmax(logits[:, 0], dim=-1)
        mixed = torch.log((1 - lam) * p_lm + lam * p_mem + 1e-20)
    return mixed[:, None]


def make_serve_step_with_mcam(cfg, mem_cfg, lam: float = 0.3,
                              engine=None, k: int = 32,
                              mode: str = "two_phase",
                              nprobe: int | None = None, *,
                              rules: Rules | None = None,
                              inplace: bool = False,
                              taps: list | None = None):
    """Paper-integrated serving: the decoded hidden state queries the MCAM
    store, and the vote distribution over the store's labels (token ids)
    mixes with the LM softmax (`knn_lm_head`): a kNN-LM head served from
    the simulated NAND-CAM.

    engine None: the dense ideal-distance softmax over the whole store.
    engine a RetrievalEngine: `SearchRequest(mode, k, nprobe)`, 'two_phase'
    (shortlist + exact noisy rescore: the weights are the noisy votes) or
    'ideal' (top-k by ideal distance, votes -dist); nprobe routes a
    partitioned store (`MemoryStore.shard`). `mem_cfg.dim` is the query
    width.

    inplace: the step takes the caches over and writes its rows into them
    (`transformer.decode_step`); taps: a list each step's decode fills
    with one dict a layer (cleared first).

    Returns serve_step(params, caches, batch, pos, store) -> (mixed
    (B, 1, V) float32 log-probabilities, caches)."""
    request = SearchRequest(mode=mode, k=k, nprobe=nprobe)

    def serve_step(params, caches, batch, pos, store):
        if taps is not None:
            taps.clear()
        logits, caches, hidden = tfm.decode_step(
            params, cfg, batch, caches, pos, return_hidden=True,
            rules=rules, inplace=inplace, taps=taps)
        return knn_lm_head(logits, hidden, store, mem_cfg.dim,
                           cfg.vocab_size, lam, engine, request), caches

    return serve_step
