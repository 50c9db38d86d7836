"""`abs`, `clip`, `cummax` and `softplus` whose gradients at their kinks
and ties follow jax.grad.

The forward values are torch.abs's, torch.clamp's, torch.cummax's and the
softplus `max(x, 0) + log1p(exp(-|x|))`; only the gradient at a kink or
tie differs, and it matters for training:

  * jax.grad(jnp.abs)(0.0) is 1.0; torch.abs gives 0 there. A mismatch
    |q - s| is 0 in every cell where the query word equals the stored
    word, which is most cells of a trained store.
  * jnp.clip is maximum then minimum, and each splits the gradient in
    half at a tie: 0.5 at a bound; torch.clamp gives 1 there. Quantized
    values sit on the bounds 0 and levels - 1 wherever the range clipped
    them, and the clipped data minimum sits on `lo` itself.

  * jax.lax.cummax differentiates as `associative_scan(lax.max)`, whose
    max splits a tie's gradient in half at every level of the scan;
    torch.cummax sends it all to one index. mLSTM's stabiliser takes a
    running max of log-gates, where bf16 values tie.
  * jax.nn.softplus is logaddexp(x, 0), whose custom JVP is exp(x - out):
    0.5 at x = 0, where the written-out max(x, 0) + log1p(exp(-|x|))
    differentiates to 1 (Mamba's dt).

torch.maximum / torch.minimum split a tie's gradient in half as JAX's
max / min do, so `clip` and `cummax` are written with them.
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


def cummax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The running maximum along `dim` (torch.cummax's values), computed as
    jax.lax.associative_scan computes it -- max of adjacent pairs, the
    scan of those by recursion, the even entries from it, interleaved --
    so that a tie splits its gradient as jax.grad of jax.lax.cummax does."""
    return _max_scan(x.movedim(dim, -1)).movedim(-1, dim)


def _max_scan(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n < 2:
        return x
    odd = _max_scan(torch.maximum(x[..., 0:n - 1:2], x[..., 1::2]))
    even = torch.maximum(odd if n % 2 else odd[..., :-1], x[..., 2::2])
    even = torch.cat([x[..., :1], even], -1)
    # interleave: even entries hold ceil(n / 2) values, odd floor(n / 2)
    pairs = torch.stack([even[..., :odd.shape[-1]], odd], -1).flatten(-2)
    return torch.cat([pairs, even[..., odd.shape[-1]:]], -1)


def _drop_posinf(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isposinf(x), 0.0, x)


class _Softplus(torch.autograd.Function):
    """logaddexp(x, 0) with JAX's JVP (`exp(x - out)`, +inf read as 0)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(_drop_posinf(x) - _drop_posinf(out))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: max(x, 0) + log1p(exp(-|x|)), with gradient
    exp(x - softplus(x)) (0.5 at x = 0)."""
    return _Softplus.apply(x)
