"""Affine quantization, std-based calibration and the straight-through
fake-quant of hardware-aware training (PyTorch port of
`repro.core.quantization`).

The query is quantized to 4 levels (one MCAM word) while supports get
`levels` (3 * CL + 1 for MTMC), over one shared clip range: the paper's
asymmetric QAT. Training and serving run the same `affine_quantize`;
training passes `round_fn=ste_round`, which changes the gradient and not
the values.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import kinks


class _SteRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, with the identity as its gradient."""
    return _SteRound.apply(x)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    levels: int
    clip_std: float = 2.5  # clip to mean +/- clip_std * std before scaling


def affine_quantize(x: torch.Tensor, levels: int, lo: torch.Tensor,
                    hi: torch.Tensor, round_fn=torch.round) -> torch.Tensor:
    """Clip to [lo, hi], scale to [0, levels), round half to even, clamp.
    Training passes `round_fn=ste_round`: the same values, the STE's
    gradient; both clips take jnp.clip's gradient at a bound (kinks.clip).

    `torch.round` rounds half to even, as `jnp.round` does; `floor(x + 0.5)`
    would not match the reference on exact halves.

    The scale divides a tensor by a tensor: `number / tensor` in PyTorch is
    `tensor.reciprocal() * number`, which rounds twice where JAX's division
    rounds once, and so moves some words by one level. The numerator is a
    0-dim CPU tensor, which a CUDA division takes as a scalar operand
    without a copy to the card."""
    scale = torch.div(torch.tensor(float(levels - 1), dtype=torch.float32),
                      hi - lo)
    q = round_fn((kinks.clip(x, lo, hi) - lo) * scale)
    return kinks.clip(q, 0.0, float(levels - 1))


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


def fake_quant(x: torch.Tensor, spec: QuantSpec,
               rng_range: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> tuple[torch.Tensor, torch.Tensor,
                          tuple[torch.Tensor, torch.Tensor]]:
    """Quantize to [0, levels) with the STE. Returns (q, x_dequant,
    (lo, hi)): q is float-typed and integer-valued, x_dequant maps it back
    to the input scale."""
    lo, hi = clip_range(x, spec.clip_std) if rng_range is None else rng_range
    scale = torch.div(torch.tensor(float(spec.levels - 1),
                                   dtype=torch.float32), hi - lo)
    q = affine_quantize(x, spec.levels, lo, hi, round_fn=ste_round)
    return q, q / scale + lo, (lo, hi)


def quantize_asymmetric(query: torch.Tensor, support: torch.Tensor,
                        support_levels: int, clip_std: float = 2.5,
                        query_levels: int = 4,
                        rng: tuple[torch.Tensor, torch.Tensor] | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's asymmetric QAT: one clip range over the support and query
    sample (or `rng`, e.g. a MemoryStore's calibrated (lo, hi)) and
    different level counts. Returns (q_query, q_support), integer-valued
    float tensors."""
    if rng is None:
        rng = clip_range(torch.cat([support.reshape(-1), query.reshape(-1)]),
                         clip_std)
    qq, _, _ = fake_quant(query, QuantSpec(query_levels, clip_std), rng)
    qs, _, _ = fake_quant(support, QuantSpec(support_levels, clip_std), rng)
    return qq, qs
