"""Gradient compression, int8 with error feedback (port of
`repro.runtime.compression`).

Each tensor is quantised to int8 with its own absmax scale (absmax / 127
+ 1e-20, rounded half to even and clipped to [-127, 127]); the residual
that the codec lost is added to the next step's gradient (error
feedback), so the error stays bounded instead of accumulating. The train
step applies it when `TrainConfig.grad_compression == "int8"`. On one
device nothing is reduced: the codec runs locally and its decompressed
values are what the optimizer sees.

The division by 127 rounds once (`models.layers.div`), as eager JAX's;
under `jax.jit` the reference multiplies by 1/127 instead (ROADMAP C.R5).
"""

from __future__ import annotations

import torch

from repro_torch import tree as tree_lib
from repro_torch.models.layers import div


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    scale = div(xf.abs().amax(), 127.0) + 1e-20
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def compress(tree) -> tuple:
    """(int8 tree, float32 scale tree), one 0-dim scale a leaf."""
    out = [_quantize(x) for x in tree_lib.leaves(tree)]
    return (tree_lib.unflatten(tree, [q for q, _ in out]),
            tree_lib.unflatten(tree, [s for _, s in out]))


def decompress(qs, scales, dtype: torch.dtype = torch.float32):
    return tree_lib.tree_map(lambda q, s: q.to(dtype) * s.to(dtype), qs,
                             scales)


def with_error_feedback(grads, residual):
    """Add the carried residual (None: zeros), compress, and return (the
    decompressed gradients in the gradients' dtypes -- the values that
    are applied -- and the new float32 residual)."""
    if residual is None:
        residual = tree_lib.tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    corrected = tree_lib.tree_map(lambda g, r: g.float() + r, grads,
                                  residual)
    qs, scales = compress(corrected)
    deq = decompress(qs, scales)
    new_residual = tree_lib.tree_map(lambda c, d: c - d, corrected, deq)
    deq = tree_lib.tree_map(lambda d, g: d.to(g.dtype), deq, grads)
    return deq, new_residual
