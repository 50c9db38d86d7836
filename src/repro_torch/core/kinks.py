"""`abs` and `clip` whose gradients at their kinks follow jax.grad.

The forward values are torch.abs's and torch.clamp's; only the gradient
at the kink differs, and it matters for hardware-aware training:

  * jax.grad(jnp.abs)(0.0) is 1.0; torch.abs gives 0 there. A mismatch
    |q - s| is 0 in every cell where the query word equals the stored
    word, which is most cells of a trained store.
  * jnp.clip is maximum then minimum, and each splits the gradient in
    half at a tie: 0.5 at a bound; torch.clamp gives 1 there. Quantized
    values sit on the bounds 0 and levels - 1 wherever the range clipped
    them, and the clipped data minimum sits on `lo` itself.

torch.maximum / torch.minimum split a tie's gradient in half as JAX's
max / min do, so `clip` is written with them.
"""

from __future__ import annotations

import torch


def abs(x: torch.Tensor) -> torch.Tensor:  # noqa: A001 - mirrors jnp.abs
    """|x| with gradient sign(x), +1 at 0."""
    return torch.where(x >= 0, x, -x)


def _bound(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=like.dtype)
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """minimum(maximum(x, lo), hi): the gradient is 1 inside (lo, hi), 0.5
    on a bound and 0 outside, as jnp.clip's."""
    return torch.minimum(torch.maximum(x, _bound(lo, x)), _bound(hi, x))
