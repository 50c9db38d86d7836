"""Step builders (port of `repro.launch.steps` on one device): the
two-stage hardware-aware trainer's steps (the mesh-sharded variant waits
for ROADMAP Queue A9), and the LM's prefill and serve steps with the
kNN-LM head over the MCAM store. The LM's train step is ROADMAP A10c."""

from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import hat as hat_lib
from repro_torch.engine.api import SearchRequest
from repro_torch.engine.store import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import div, one_hot


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
