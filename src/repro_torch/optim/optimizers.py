"""Optimizers in the optax-like (init, update) protocol (port of
`repro.optim.optimizers`: AdamW, the warmup-cosine schedule and global-norm
clipping; `adamw8bit`, `adafactor` and `sgd` wait, ROADMAP Queue A5).

Parameters, gradients and state are nested containers of tensors
(`repro_torch.tree`). `update(grads, state, params)` returns the updates
(to be added to the parameters) and the new state; nothing is changed in
place. AdamW is the reference's formula, not `torch.optim.AdamW`'s: b2 =
0.95 by default, the decoupled decay `lr * wd * p` inside the update, and
bias correction as written there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch import tree as tree_lib

Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Schedule:
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(np.float32(math.pi) * t)))
        return torch.where(step < warmup, warm, cos)
    return sched


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_lib.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    g = global_norm(grads)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return tree_lib.tree_map(lambda x: x * scale.to(x.dtype), grads), g


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          state_dtype: torch.dtype = torch.float32) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=state_dtype,  # noqa: E731
                                  device=p.device)
        dev = tree_lib.leaves(params)[0].device
        return {"m": tree_lib.tree_map(z, params),
                "v": tree_lib.tree_map(z, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        sf = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=sf.device), sf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=sf.device), sf)

        def upd(g, m, v, p):
            gf = g.to(torch.float32)
            m32 = b1 * m.to(torch.float32) + (1 - b1) * gf
            v32 = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
            mh = m32 / bc1
            vh = v32 / bc2
            u = -lr_t * (mh / (torch.sqrt(vh) + eps)
                         + weight_decay * p.to(torch.float32))
            return u.to(p.dtype), m32.to(state_dtype), v32.to(state_dtype)

        out = [upd(*xs) for xs in zip(
            *(tree_lib.leaves(t) for t in (grads, state["m"], state["v"],
                                           params)))]
        updates, m, v = (tree_lib.unflatten(params, [o[j] for o in out])
                         for j in range(3))
        return updates, {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


def adamw_state_from_numpy(state: dict, params_from_numpy) -> dict:
    """Carry AdamW state across from the JAX package: its {"m", "v",
    "step"} as numpy arrays. `params_from_numpy` maps a parameter-shaped
    numpy tree to this package's tensors, as the parameters themselves are
    carried (for Conv4, `models.controller.conv4_from_numpy`: HWIO ->
    OIHW)."""
    m = params_from_numpy(state["m"])
    dev = tree_lib.leaves(m)[0].device
    return {"m": m, "v": params_from_numpy(state["v"]),
            "step": torch.tensor(int(state["step"]), dtype=torch.int32,
                                 device=dev)}
