"""Atomic, manifest-last checkpoints in the JAX package's on-disk format
(port of `repro.checkpoint`)."""

from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager, latest_step, restore, save)
