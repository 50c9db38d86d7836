"""Optimizers in the optax-like (init, update) protocol (port of
`repro.optim`)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adafactor, adamw, adamw8bit, make_optimizer, sgd,
    clip_by_global_norm, warmup_cosine, global_norm)
