"""Optimizers in the optax-like (init, update) protocol (port of
`repro.optim`)."""

from repro_torch.optim.optimizers import (Optimizer, adamw,  # noqa: F401
                                         clip_by_global_norm, global_norm,
                                         warmup_cosine)
