"""Affine quantization and std-based calibration (PyTorch port of
`repro.core.quantization`). The STE / fake-quant training path waits for
the HAT slice (ROADMAP Queue A5)."""

from __future__ import annotations

import torch


def affine_quantize(x: torch.Tensor, levels: int, lo: torch.Tensor,
                    hi: torch.Tensor) -> torch.Tensor:
    """Clip to [lo, hi], scale to [0, levels), round half to even, clamp.

    `torch.round` rounds half to even, as `jnp.round` does; `floor(x + 0.5)`
    would not match the reference on exact halves.

    The scale divides a tensor by a tensor: `number / tensor` in PyTorch is
    `tensor.reciprocal() * number`, which rounds twice where JAX's division
    rounds once, and so moves some words by one level. The numerator is a
    0-dim CPU tensor, which a CUDA division takes as a scalar operand
    without a copy to the card."""
    scale = torch.div(torch.tensor(float(levels - 1), dtype=torch.float32),
                      hi - lo)
    q = torch.round((torch.clamp(x, lo, hi) - lo) * scale)
    return torch.clamp(q, 0, levels - 1)


def clip_range(x: torch.Tensor, clip_std: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Std-determined clip range, clamped to the data extent.

    The std is the population std (`correction=0`), as `jnp.std` computes
    it; `torch.std`'s default `correction=1` would widen the range."""
    xs = x.detach()
    mu = xs.mean()
    sd = xs.std(correction=0) + 1e-8
    lo = torch.maximum(mu - clip_std * sd, xs.min())
    hi = torch.minimum(mu + clip_std * sd, xs.max() + 1e-8)
    return lo, hi
