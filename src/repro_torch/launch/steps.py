"""The two-stage hardware-aware trainer's steps (port of
`repro.launch.steps.make_hat_train_steps`, one device; the mesh-sharded
variant waits for ROADMAP Queue A9)."""

from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import hat as hat_lib
from repro_torch.engine.store import resolve_device


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
