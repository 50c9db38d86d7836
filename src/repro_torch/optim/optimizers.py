"""Optimizers in the optax-like (init, update) protocol (port of
`repro.optim.optimizers`):

* adamw      -- configurable moment dtype.
* adamw8bit  -- int8 moments with per-block absmax scales (blocks of the
                trailing 256 elements of the flattened parameter).
* adafactor  -- factored second moment for >= 2-D parameters (row and
                column statistics).
* sgd        -- momentum SGD.

plus the warmup-cosine schedule and global-norm clipping. Parameters,
gradients and state are nested containers of tensors (`repro_torch.tree`);
every state tensor lives on its parameter's device. `update(grads, state,
params)` returns the updates (to be added to the parameters) and the new
state; nothing is changed in place. The formulas are the reference's, not
`torch.optim`'s (AdamW: b2 = 0.95 by default, the decoupled decay `lr * wd
* p` inside the update, bias correction as written there). Divisors are
tensors on the dividend's device, so a division rounds once on the card
too (ROADMAP C.P7); constants are filled on the device, since a tensor
copied from the host would wait for the stream.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as tree_lib
from repro_torch.engine.store import resolve_device

Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, new_state)
    # each element's update reads only that element of the parameter, the
    # gradient and the state (and scalars): a block of a leaf updates alone
    # with the same bits (adamw, sgd; not the blockwise-quantized or the
    # factored states)
    elementwise: bool = False


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Schedule:
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)

        def over(x, n):
            return torch.div(x, torch.full((), float(n), device=x.device))
        warm = peak_lr * torch.clamp(over(step + 1, max(warmup, 1)), max=1.0)
        t = torch.clamp(over(step - warmup, max(total - warmup, 1)), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(np.float32(math.pi) * t)))
        return torch.where(step < warmup, warm, cos)
    return sched


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def global_norm(tree) -> torch.Tensor:
    return norm_of(tree_lib.leaves(tree))


def norm_of(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """`global_norm` of the tensors `leaves` yields, read one at a time."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / (norm + 1e-9)): the factor clipping applies."""
    return torch.clamp(torch.div(torch.full((), float(max_norm),
                                            device=norm.device),
                                 norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    g = global_norm(grads)
    scale = clip_scale(g, max_norm)
    return tree_lib.tree_map(lambda x: x * scale.to(x.dtype), grads), g


def _bias_corrections(b1: float, b2: float, step: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    sf = step.to(torch.float32)
    return tuple(1 - torch.pow(torch.full((), b, dtype=torch.float32,
                                          device=sf.device), sf)
                 for b in (b1, b2))


def _per_leaf(params, *trees, is_leaf=None) -> list[tuple]:
    """(param, leaf of each tree) tuples in visiting order; the trees have
    params' structure with `is_leaf` nodes (state dicts) at its leaves."""
    return list(zip(tree_lib.leaves(params),
                    *(tree_lib.leaves(t, is_leaf) for t in trees)))


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
        bc1, bc2 = _bias_corrections(b1, b2, step)

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

    return Optimizer(init, update, elementwise=True)


# ---------------------------------------------------------------------------
# 8-bit AdamW: int8 moments + per-block absmax scales.
# ---------------------------------------------------------------------------

_BLOCK = 256


def _q8(x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 tensor -> (q (blocks, 256) int8, scale (blocks, 1) f32): the
    flattened tensor zero-padded to whole blocks, each block scaled by its
    absolute maximum / 127 (+ 1e-12) and rounded half to even."""
    flat = x32.reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % _BLOCK)).reshape(-1, _BLOCK)
    scale = torch.div(blocks.abs().amax(1, keepdim=True),
                      torch.full((), 127.0, device=x32.device)) + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dq8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def _is_q8(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def adamw8bit(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
              weight_decay: float = 0.1) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        def z(p):
            q, s = _q8(torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device))
            return {"q": q, "s": s}
        dev = tree_lib.leaves(params)[0].device
        return {"m": tree_lib.tree_map(z, params),
                "v": tree_lib.tree_map(z, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        bc1, bc2 = _bias_corrections(b1, b2, step)

        def upd(p, g, m, v):
            gf = g.to(torch.float32)
            m32 = b1 * _dq8(m["q"], m["s"], p.shape) + (1 - b1) * gf
            v32 = b2 * _dq8(v["q"], v["s"], p.shape) + (1 - b2) * gf * gf
            v32 = torch.clamp(v32, min=0.0)
            u = -lr_t * ((m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
                         + weight_decay * p.to(torch.float32))
            mq, ms = _q8(m32)
            vq, vs = _q8(v32)
            return u.to(p.dtype), {"q": mq, "s": ms}, {"q": vq, "s": vs}

        out = [upd(*xs) for xs in _per_leaf(params, grads, state["m"],
                                            state["v"], is_leaf=_is_q8)]
        updates, m, v = (tree_lib.unflatten(params, [o[j] for o in out])
                         for j in range(3))
        return updates, {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments).
# ---------------------------------------------------------------------------


def _is_factors(x) -> bool:
    return isinstance(x, dict) and set(x) in ({"vr", "vc"}, {"v"})


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        def z(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        dev = tree_lib.leaves(params)[0].device
        return {"f": tree_lib.tree_map(z, params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        beta = 1.0 - torch.pow(step.to(torch.float32) + 1.0, -decay)

        def upd(p, g, f):
            gf = g.to(torch.float32)
            g2 = gf * gf + eps
            if p.dim() >= 2:
                vr = beta * f["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * f["vc"] + (1 - beta) * g2.mean(-2)
                denom = torch.div(
                    vr[..., None] * vc[..., None, :],
                    torch.clamp(vr.mean(-1)[..., None, None], min=eps))
                u = gf * torch.rsqrt(denom + eps)
                nf = {"vr": vr, "vc": vc}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                u = gf * torch.rsqrt(v + eps)
                nf = {"v": v}
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            clip = torch.full((), clip_threshold, dtype=torch.float32,
                              device=rms.device)
            u = u / torch.clamp(torch.div(rms, clip), min=1.0)
            u = -lr_t * (u + weight_decay * p.to(torch.float32))
            return u.to(p.dtype), nf

        out = [upd(*xs) for xs in _per_leaf(params, grads, state["f"],
                                            is_leaf=_is_factors)]
        updates, f = (tree_lib.unflatten(params, [o[j] for o in out])
                      for j in range(2))
        return updates, {"f": f, "step": step}

    return Optimizer(init, update)


def sgd(lr, momentum: float = 0.9) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        dev = tree_lib.leaves(params)[0].device
        return {"mu": tree_lib.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(step)
        mu = tree_lib.tree_map(
            lambda m, g: momentum * m + g.to(torch.float32),
            state["mu"], grads)
        updates = tree_lib.tree_map(lambda m, p: (-lr_t * m).to(p.dtype),
                                    mu, params)
        return updates, {"mu": mu, "step": step}

    return Optimizer(init, update, elementwise=True)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    """The optimizer `name` (adamw, adamw8bit, adafactor, sgd); another
    name raises KeyError, as the reference's lookup does."""
    return {"adamw": adamw, "adamw8bit": adamw8bit,
            "adafactor": adafactor, "sgd": sgd}[name](lr, **kw)


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


def state_from_numpy(state: dict, device=None) -> dict:
    """Carry any optimizer state of the JAX package across as numpy arrays
    -- adamw's {"m", "v", "step"} (float32 or bfloat16 moments),
    adamw8bit's int8 blocks and scales, adafactor's factors, sgd's
    momentum, and the train step's "ef_residual" -- every leaf's bits
    unchanged (bf16 as its 16-bit words), on `device` (default: the
    card). The state of a tree whose parameters cross over unchanged (the
    LM's); Conv4's take `adamw_state_from_numpy`."""
    dev = resolve_device(device)
    return tree_lib.tree_map(lambda a: tree_lib.tensor_of(a, dev), state)
