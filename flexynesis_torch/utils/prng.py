"""A copy of ``jax.random``'s threefry2x32 generator, for the draws
GradientShap makes.

It covers ``key(seed)``, ``split(key, num)``, ``fold_in(key, data)`` and
``uniform(key, shape)`` in float32, bit for bit with ``jax.random`` under
``jax_threefry_partitionable`` (on by default since JAX 0.5): a split and a
draw hash a 64-bit iota over the output shape, split into two uint32
counters, under the key; ``fold_in`` hashes the counter pair (0, data). A key
is a ``(2,)`` uint32 array, what ``jax.random.key_data`` returns. These
draws are small (one uniform per sample) and are made on the host with
numpy.

``normal(key, shape, device)`` is ``jax.random.normal`` in float32:
``sqrt(2) * erfinv(u)`` with ``u`` uniform on ``(nextafter(-1, 0), 1)``,
``u = max(lo, 2 * f + lo)`` for a uniform ``f`` on [0, 1) (the width
``1 - lo`` rounds to 2 in float32). Its draws have as many values as an
input layer, so the hash runs on ``device``, in int64 tensors masked to 32
bits after every add, shift and rotation (``torch_bits``), bit for bit with
the numpy hash; ``row_offset`` draws only rows from that offset on of a
larger (rows, ...) draw, counter for counter, so a shard of a batch draws its
own slice of the batch's noise. The inverse error function is XLA's float32
``ErfInv`` (Giles' polynomial in ``w = -log1p(-u * u)``), written out here:
``torch.erfinv`` parts from it by up to 11 ulp, the copy by at most a few
(``log1p`` differs in the last place).
"""

from __future__ import annotations

import math

import numpy as np
import torch

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


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a data value in [0, 2**32)."""
    a, b = threefry2x32(k[0], k[1], np.zeros(1, np.uint32), np.array([data], np.uint32))
    return np.array([a[0], b[0]], dtype=np.uint32)


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


_MASK32 = 0xFFFFFFFF


def _rotate_left_torch(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _MASK32) | (v >> (32 - r))


def torch_bits(k: np.ndarray, shape, device, row_offset: int = 0) -> torch.Tensor:
    """The 32 random bits of each value of a ``shape`` draw (``bits1 ^
    bits2`` of the hash, as ``uniform`` takes them), as int64 values in
    [0, 2**32) on ``device``; with ``row_offset`` the draw's rows are rows
    ``row_offset`` on of a larger draw with the same trailing shape."""
    shape = tuple(int(d) for d in shape)
    inner = math.prod(shape[1:])
    start = row_offset * inner
    counts = torch.arange(start, start + math.prod(shape), dtype=torch.int64, device=device)
    k1, k2 = int(k[0]), int(k[1])
    ks = (k1, k2, k1 ^ k2 ^ int(_PARITY))
    x0 = ((counts >> 32) + ks[0]) & _MASK32
    x1 = ((counts & _MASK32) + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = x0 ^ _rotate_left_torch(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return (x0 ^ x1).reshape(shape)


# Giles' single-precision erfinv coefficients, for w < 5 and w >= 5 (XLA's
# ErfInv32), highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv of ``x`` in (-1, 1)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, torch.tensor(a, dtype=torch.float32, device=x.device),
                        torch.tensor(b, dtype=torch.float32, device=x.device))
        p = c if p is None else c + p * w
    return p * x


def normal(k: np.ndarray, shape, device, row_offset: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32 on ``device`` (rows
    ``row_offset`` on of a larger draw with ``row_offset``)."""
    bits = torch_bits(k, shape, device, row_offset)
    mantissa = (bits >> 9) | 0x3F800000
    f = mantissa.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = torch.clamp(f * 2.0 + lo, min=lo)
    return erfinv_f32(u) * float(np.float32(np.sqrt(2.0)))
