"""A numpy copy of ``jax.random``'s threefry2x32 generator, for the draws
GradientShap makes.

It covers ``key(seed)``, ``split(key, num)`` and ``uniform(key, shape)`` in
float32, bit for bit with ``jax.random`` under ``jax_threefry_partitionable``
(on by default since JAX 0.5): a split and a draw hash a 64-bit iota over
the output shape, split into two uint32 counters, under the key. A key is a
``(2,)`` uint32 array, what ``jax.random.key_data`` returns. The draws are
small (one value per sample), so they are made on the host.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotate_left(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1, x2)``,
    uint32 arrays of one shape, under the key ``(k1, k2)``."""
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1) ^ np.uint32(k2) ^ _PARITY)
    x0, x1 = x1 + ks[0], x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = x0 ^ _rotate_left(x1, r)
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))`` for a seed in [0, 2**31)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside [0, 2**31)")
    return np.array([0, seed], dtype=np.uint32)


def _hash_iota(k: np.ndarray, shape) -> tuple:
    counts = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (counts >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (counts & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return threefry2x32(k[0], k[1], hi, lo)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` as a ``(num, 2)`` uint32 array."""
    bits1, bits2 = _hash_iota(k, (num,))
    return np.stack([bits1, bits2], axis=-1)


def uniform(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1), 23 random
    mantissa bits of each value's 32."""
    bits1, bits2 = _hash_iota(k, tuple(shape))
    mantissa = ((bits1 ^ bits2) >> np.uint32(9)) | np.uint32(0x3F800000)
    return mantissa.view(np.float32) - np.float32(1.0)
