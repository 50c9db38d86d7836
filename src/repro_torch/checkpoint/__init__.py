"""Atomic, manifest-last checkpoints in the JAX package's on-disk format."""
