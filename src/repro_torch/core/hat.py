"""Hardware-Aware Training (paper Sec. 3.3; port of `repro.core.hat`).

Two stages:
  1. `pretrain_loss`: controller + linear classifier, plain cross-entropy
     over the full training label set (transferable features).
  2. `meta_loss`: episodic N-way K-shot cross-entropy through the full
     MCAM simulator: asymmetric fake-quant, MTMC encoding with a 1/CL
     straight-through gradient, noisy string currents, a sigmoid-gradient
     sense-amp STE and vote accumulation. The forward is
     `RetrievalEngine.episode_scores`, the training twin of the served
     search, so a trained controller serves with the same votes.

`apply_fn(params, images) -> embeddings` is a pure function of a nested
dict of tensors (`models.controller.apply_conv4`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib
from repro_torch.core.avss import SearchConfig


@dataclasses.dataclass(frozen=True)
class HATConfig:
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    clip_std: float = 2.5
    sa_tau: float = 0.02       # sigmoid-STE temperature for the SA step
    temperature: float = 0.15  # softmax temperature on class vote scores


def simulate_mcam(q_emb: torch.Tensor, s_emb: torch.Tensor,
                  s_labels: torch.Tensor, n_classes: int, hat: HATConfig,
                  key, noisy: bool = True) -> torch.Tensor:
    """Differentiable end-to-end MCAM search -> (B, n_classes) class scores
    (`RetrievalEngine.episode_scores`). key: an int or integer array,
    folded into the noise-stream coordinate."""
    from repro_torch.engine import RetrievalEngine
    return RetrievalEngine(hat.search).episode_scores(
        q_emb, s_emb, s_labels, n_classes, clip_std=hat.clip_std,
        sa_tau=hat.sa_tau, key=key, noisy=noisy)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    idx = labels.to(device=logits.device, dtype=torch.int64)[:, None]
    return -torch.take_along_dim(logp, idx, dim=-1).mean()


def pretrain_loss(params, batch, apply_fn) -> torch.Tensor:
    """Stage 1: CE over the full training class set via a linear head."""
    emb = apply_fn(params["backbone"], batch["image"])
    logits = emb @ params["head"]["w"] + params["head"]["b"]
    return cross_entropy(logits, batch["label"])


def meta_loss(params, episode, apply_fn, hat: HATConfig, key,
              noisy: bool = True) -> torch.Tensor:
    """Stage 2: episodic CE through the simulated MCAM. The temperature
    divides as a 0-dim float32 tensor filled on the scores' device,
    rounding once as JAX's does (ROADMAP C.P3, C.P7)."""
    s_emb = apply_fn(params["backbone"], episode["support_images"])
    q_emb = apply_fn(params["backbone"], episode["query_images"])
    scores = simulate_mcam(q_emb, s_emb, episode["support_labels"],
                           episode["n_way"], hat, key, noisy=noisy)
    temp = torch.full((), hat.temperature, dtype=torch.float32,
                      device=scores.device)
    return cross_entropy(torch.div(scores, temp), episode["query_labels"])


# ---------------------------------------------------------------------------
# Training steps.
# ---------------------------------------------------------------------------


def value_and_grad(loss_fn, params, *args):
    """(loss, gradient tree) of `loss_fn(params, *args)` with respect to
    every leaf of `params`."""
    leaves = [p.detach().requires_grad_(True)
              for p in tree_lib.leaves(params)]
    live = tree_lib.unflatten(params, leaves)
    with torch.enable_grad():
        loss = loss_fn(live, *args)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_lib.unflatten(params, list(grads))


def apply_updates(params, updates):
    return tree_lib.tree_map(lambda p, u: (p + u).detach(), params, updates)


def make_train_steps(apply_fn, hat: HATConfig, optimizer):
    """(pretrain_step, meta_step) over one optimizer with (init, update) in
    the optax-like protocol of `repro_torch.optim`. The launch layer's
    two-stage trainer is `repro_torch.launch.steps.make_hat_train_steps`;
    this simpler helper mirrors the reference's."""

    def pretrain_step(params, opt_state, batch):
        loss, grads = value_and_grad(pretrain_loss, params, batch, apply_fn)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    def meta_step(params, opt_state, episode, key):
        loss, grads = value_and_grad(meta_loss, params, episode, apply_fn,
                                     hat, key)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return pretrain_step, meta_step
