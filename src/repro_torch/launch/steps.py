"""Step builders (port of `repro.launch.steps` on one device): the LM's
train step and the execution knobs it depends on (`adapt_config`,
`microbatch_for`, `optimizer_for`), the two-stage hardware-aware
trainer's steps, and the LM's prefill and serve steps with the kNN-LM
head over the MCAM store. The mesh-sharded variants, the sharding trees
and the dry-run's input specs wait for ROADMAP Queue A9, as do the
reference's `REPRO_OPT` levels (sharding and tuning knobs of its TPU
meshes): this module has the `REPRO_OPT=0` semantics."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import hat as hat_lib
from repro_torch.engine.api import SearchRequest
from repro_torch.engine.store import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import div, one_hot
from repro_torch.optim import clip_scale, global_norm, make_optimizer
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

def adapt_config(cfg: ModelConfig, shape: ShapeConfig,
                 dp: int = 1) -> ModelConfig:
    """Resolve the execution knobs that depend on the deployment: MoE
    token groups (one per 1,024 tokens, a multiple of the data-parallel
    width `dp`), no remat outside training, 2,048-position attention
    chunks from 16k positions."""
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


def _grads(params: dict, cfg: ModelConfig, mb: dict
           ) -> tuple[torch.Tensor, list]:
    """(loss, one gradient a parameter leaf, in visiting order) of one
    microbatch. The leaves are detached aliases of the parameters (no
    copy), so the caller's tensors carry no graph."""
    leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(params)]
    loss, _ = tfm.loss_fn(tree_lib.unflatten(params, leaves), cfg, mb)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), list(grads)


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    reference's train step on one device; every batch leaf carries a
    leading accumulation axis. Returns (train_step, optimizer).

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
    gains it under int8 compression."""
    optimizer = optimizer_for(cfg, tc)

    def train_step(params, opt_state, batch):
        accum = tree_lib.leaves(batch)[0].shape[0]
        # lists replaced entry by entry: one leaf's temporary at a time
        lsum, grads = None, None
        for i in range(accum):
            loss, g_i = _grads(params, cfg, {k: v[i]
                                             for k, v in batch.items()})
            if grads is None:
                lsum, grads = loss, g_i
                continue
            lsum = lsum + loss
            for j in range(len(grads)):
                grads[j] = grads[j] + g_i[j]
                g_i[j] = None
        loss = div(lsum, accum)
        for j in range(len(grads)):
            grads[j] = div(grads[j], accum)
        with torch.no_grad():
            if tc.grad_compression == "int8":
                grads = _error_feedback(params, opt_state, grads)
            gnorm = global_norm(grads)
            scale = clip_scale(gnorm, tc.grad_clip)
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
            inner = {k: v for k, v in opt_state.items() if k != "ef_residual"}
            step = inner["step"]
            nodes = {k: tree_lib.nodes_at(params, v)
                     for k, v in inner.items() if k != "step"}
            for i, p in enumerate(tree_lib.leaves(params)):
                g = grads[i]
                grads[i] = None
                _update_leaf(optimizer, p, g, step, nodes, i, scale, ok)
                del g
            step.copy_(torch.where(ok, step + 1, step))
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "applied": ok.to(torch.float32)}
        return params, opt_state, metrics

    return train_step, optimizer


def _error_feedback(params, opt_state: dict, grads: list) -> list:
    """The int8 codec with error feedback, leaf by leaf (the codec scales
    each tensor alone): `grads` with each entry replaced by its
    decompressed gradient; the new residual is written into
    opt_state["ef_residual"] (created as zeros first)."""
    if opt_state.get("ef_residual") is None:
        opt_state["ef_residual"] = tree_lib.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    for j, r in enumerate(tree_lib.leaves(opt_state["ef_residual"])):
        (grads[j],), (new_r,) = with_error_feedback([grads[j]], [r])
        r.copy_(new_r)
    return grads


def _update_leaf(optimizer, p: torch.Tensor, g: torch.Tensor,
                 step: torch.Tensor, nodes: dict, i: int,
                 scale: torch.Tensor, ok: torch.Tensor) -> None:
    """Clip, update and guard parameter leaf i (with its gradient g and
    its state nodes), writing into the given tensors."""
    state = {k: [v[i]] for k, v in nodes.items()}
    u, new = optimizer.update([g * scale.to(g.dtype)],
                              {**state, "step": step}, [p])
    p.copy_(torch.where(ok, (p + u[0]).to(p.dtype), p))
    for k, olds in state.items():
        for o, n in zip(tree_lib.leaves(olds), tree_lib.leaves(new[k])):
            o.copy_(torch.where(ok, n, o))


def make_hat_train_steps(apply_fn, hat_cfg, pre_optimizer,
                         meta_optimizer=None, *, n_way: int,
                         device: torch.device | str | None = None):
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
    `device` (default: the card) as tensors. Returns (pretrain_step,
    meta_step, place)."""
    pretrain_step, _ = hat_lib.make_train_steps(apply_fn, hat_cfg,
                                                pre_optimizer)
    _, meta = hat_lib.make_train_steps(apply_fn, hat_cfg,
                                       meta_optimizer or pre_optimizer)
    dev = resolve_device(device)

    def meta_step(params, opt_state, ep_arrays, key):
        return meta(params, opt_state, {**ep_arrays, "n_way": n_way}, key)

    def place(tree):
        """Every leaf as a tensor on the device (float arrays as float32)."""
        def put(a):
            t = torch.as_tensor(a)
            if t.is_floating_point():
                t = t.to(torch.float32)
            return t.to(dev)
        return tree_lib.tree_map(put, tree)

    return pretrain_step, meta_step, place


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        logits, aux, caches = tfm.forward(params, cfg, batch,
                                          return_cache=True, last_only=True)
        return logits, caches
    return prefill_step


def make_serve_step(cfg):
    def serve_step(params, caches, batch, pos):
        return tfm.decode_step(params, cfg, batch, caches, pos)
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
    nothing)."""
    q = hidden[:, 0][:, :dim]                                  # (B, dim)
    if engine is None:
        q1h = kernel_ops.query_onehot(store.quantize_queries(q),
                                      torch.float32)
        dist = q1h @ store.proj.float().T                      # (B, N)
        w = torch.softmax(div(-dist, 10.0), dim=-1)
        onehot = one_hot(store.labels, vocab_size, w.dtype)
        p_mem = w @ onehot                                     # (B, V)
    else:
        res = engine.search(store, q, request)
        valid = res.labels >= 0                                # (B, k)
        w = torch.softmax(torch.where(valid, div(res.votes, 10.0), -1e30),
                          dim=-1)
        w = w * valid
        labels = torch.where(valid, res.labels, 0)
        onehot = one_hot(labels, vocab_size, w.dtype)
        p_mem = torch.einsum("bk,bkv->bv", w, onehot)          # (B, V)
    p_lm = torch.softmax(logits[:, 0], dim=-1)
    mixed = torch.log((1 - lam) * p_lm + lam * p_mem + 1e-20)
    return mixed[:, None]


def make_serve_step_with_mcam(cfg, mem_cfg, lam: float = 0.3,
                              engine=None, k: int = 32,
                              mode: str = "two_phase",
                              nprobe: int | None = None):
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

    Returns serve_step(params, caches, batch, pos, store) -> (mixed
    (B, 1, V) float32 log-probabilities, caches)."""
    request = SearchRequest(mode=mode, k=k, nprobe=nprobe)

    def serve_step(params, caches, batch, pos, store):
        logits, caches, hidden = tfm.decode_step(
            params, cfg, batch, caches, pos, return_hidden=True)
        return knn_lm_head(logits, hidden, store, mem_cfg.dim,
                           cfg.vocab_size, lam, engine, request), caches

    return serve_step
