"""Threefry-2x32 key derivation of `jax.random` in numpy (the default
`threefry2x32` implementation), so that the port derives the reference's
keys without JAX:

    key_data(fold_in(PRNGKey(seed), step))

equals `jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(seed),
step))` bit for bit. Keys are (2,) uint32 arrays, the key data of a legacy
JAX key. The arithmetic is int64 holding uint32 values, masked after every
add and shift, as `core.mcam._mix` is written.
"""

from __future__ import annotations

import numpy as np

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry_2x32(key, x0: int, x1: int) -> tuple[int, int]:
    """The 20-round threefry-2x32 block of key (k0, k1) on the count words
    (x0, x1) (`jax._src.prng._threefry2x32_lowering`, unrolled)."""
    k0, k1 = (int(k) & _MASK for k in key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [(int(x0) + ks[0]) & _MASK, (int(x1) + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def threefry_seed(data: int) -> tuple[int, int]:
    """The raw key of a 32-bit seed: (data >> 32, data & 0xFFFFFFFF), i.e.
    (0, data) below 2**32."""
    if not 0 <= int(data) < 2**32:
        raise ValueError(f"threefry_seed: {data} is not a uint32")
    return 0, int(data)


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (JAX's name)
    """Key data of `jax.random.PRNGKey(seed)` for 0 <= seed < 2**32."""
    return np.array(threefry_seed(seed), dtype=np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """Key data of `jax.random.fold_in(key, data)`: the threefry block of
    the key on `threefry_seed(data)`."""
    return np.array(threefry_2x32(np.asarray(key, dtype=np.uint32),
                                  *threefry_seed(data)), dtype=np.uint32)
