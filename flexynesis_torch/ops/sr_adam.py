"""Adam with stochastically rounded bfloat16 parameter storage.

Counterpart of ``flexynesis_tpu/ops/sr_adam.py``, the optimizer of every
fresh-initialised trial round of the HPO engine (``param_dtype=
"bfloat16_sr"``): parameter leaves of at least ``SR_MIN_SIZE`` elements per
trial are stored in bfloat16, their moments mirror that type, the arithmetic
is float32, and each bfloat16 store rounds stochastically: 16 hashed bits
are added below the bfloat16 mantissa cut and the value is truncated, so the
rounding is unbiased and an exactly zero parameter stays exactly zero.

Trees are lists of tensors in the JAX flatten order (sorted dict keys), each
with the leading trial axis K where the caller stacks trials. The hash of a
leaf runs over the flat index of one trial's leaf with that trial's seed, as
``vmap`` of the JAX step sees it, and the seed mixing is the JAX one, modulo
2^32: ``leaf_seed = seed + i * P2 + count * P3``.

Unsigned 32-bit arithmetic is done in int64 and masked to 32 bits after every
add and multiply. The float arithmetic follows the program XLA compiles from
the JAX step, so that the CPU gives JAX's bits: the two Adam moments are
fused multiply-adds of the old moment's product (computed through float64,
exact up to a double rounding that is vanishingly rare), the update divides once by
``b1c * (sqrt(v / b2c) + eps)``, the parameter step is ``p - lr * u``
rounded once, and the square root is correctly rounded. Where the clip is
active the norm's order of summation differs from XLA's, so the clip scale,
and through it the step, may differ in the last place.

The int8 moments (``q8_encode_*``, ``moment_dtype="int8"``) are not ported:
the JAX engine reaches them only through ``trial_optimizer("int8")``, which
neither its CLI nor its CV rounds set (they run the bfloat16 default).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

SR_MIN_SIZE = 65536  # leaves below this per trial stay float32
P1 = 2654435761
P2 = 2246822519
P3 = 3266489917
MASK32 = 0xFFFFFFFF


def _u32(t: torch.Tensor) -> torch.Tensor:
    return t & MASK32


def hash_bits(shape: Sequence[int], seed, trial_axis: bool = False,
              device=None) -> torch.Tensor:
    """Per-element uint32 hash (a murmur-style finalizer over the flat index),
    as int64 values in [0, 2^32).

    ``seed`` is an int or a tensor of uint32 values. With ``trial_axis``,
    ``shape`` is (K, *s), ``seed`` has K values (or one for all), and trial k
    hashes the flat index of an ``s``-shaped leaf with its seed."""
    shape = tuple(int(d) for d in shape)
    if not torch.is_tensor(seed):
        seed = torch.full((), seed, dtype=torch.int64, device=device)
    seed = seed.to(torch.int64)
    inner = shape[1:] if trial_axis else shape
    n = 1
    for d in inner:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=seed.device).reshape(inner)
    if trial_axis:
        seed = seed.reshape((-1,) + (1,) * len(inner))
    h = _u32(_u32(idx + seed) * P1)
    h = h ^ (h >> 16)
    h = _u32(h * P2)
    h = h ^ (h >> 13)
    h = _u32(h * P3)
    return h ^ (h >> 16)


def sr_bf16(x32: torch.Tensor, seed, trial_axis: bool = False) -> torch.Tensor:
    """Stochastic rounding float32 -> bfloat16 with the hash's low 16 bits."""
    bits = hash_bits(x32.shape, seed, trial_axis, device=x32.device)
    xi = _u32(x32.contiguous().view(torch.int32).to(torch.int64))
    yi = (xi + (bits & 0xFFFF)) & 0xFFFF0000
    yi = yi - ((yi >> 31) << 32)  # the same 32 bits as a signed int32
    return yi.to(torch.int32).view(torch.float32).to(torch.bfloat16)


def cast_params_for_sr(params: List[torch.Tensor]) -> List[torch.Tensor]:
    """Large leaves to bfloat16 storage; small leaves stay float32."""
    return [a.to(torch.bfloat16) if a.numel() >= SR_MIN_SIZE else a for a in params]


def cast_stacked_params_for_sr(params: List[torch.Tensor], k: int) -> List[torch.Tensor]:
    """The same for K-stacked leaves: the threshold applies to one trial's
    leaf, not to the stack."""
    return [a.to(torch.bfloat16) if a.numel() // k >= SR_MIN_SIZE else a for a in params]


class SRAdamState:
    """(m, v, count): moments mirroring each parameter leaf's type, and the
    step count shared by the trials."""

    def __init__(self, m: List[torch.Tensor], v: List[torch.Tensor], count: int = 0):
        self.m, self.v, self.count = m, v, count


def sr_adam_init(params: List[torch.Tensor]) -> SRAdamState:
    """Zero moments of each leaf's shape and type (the JAX "mirror"
    moments)."""
    zeros = [torch.zeros_like(a) for a in params]
    return SRAdamState(zeros, [torch.zeros_like(a) for a in params], 0)


def _f32(v: float) -> float:
    """The float32 nearest ``v``, as a Python float (JAX's weakly typed
    constants)."""
    return float(torch.tensor(v, dtype=torch.float32))


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once (through float64, where the product of
    two floats is exact); ``b`` a tensor or a float32 value."""
    b = b.double() if torch.is_tensor(b) else b
    return (a.double() * b + c.double()).float()


def _trial_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (K,) per-trial value shaped to broadcast against a (K, ...) leaf."""
    return t.reshape((-1,) + (1,) * (ndim - 1))


def global_norm_f32(tree: List[torch.Tensor], trial_axis: bool = False) -> torch.Tensor:
    """Float32 global L2 norm of a list of leaves (bfloat16-safe); per trial
    (a (K,) tensor) with ``trial_axis``."""
    if trial_axis:
        return torch.sqrt(sum(x.float().square().flatten(1).sum(1) for x in tree))
    return torch.sqrt(sum(x.float().square().sum() for x in tree))


def sr_adam_step(params: List[torch.Tensor], state: SRAdamState, grads: List[torch.Tensor],
                 lr, seed, *, masks: Optional[List[Optional[torch.Tensor]]] = None,
                 trial_axis: bool = False, grad_clip: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
    """One Adam step over a mixed bfloat16/float32 list of leaves; returns
    (new params, new state).

    Global-norm clipping folds in as a gradient scale; ``masks`` (per leaf,
    None or a 0/1 tensor broadcasting against it) multiply the gradients
    before the norm (a padded trial's norm is its small architecture's) and
    the update. With ``trial_axis`` every leaf is (K, ...), the norm and clip
    are per trial, and ``lr`` and ``seed`` hold one value per trial (or one
    shared value)."""
    count = state.count + 1
    dev = params[0].device
    # 1 - b ** count as XLA computes it in float32: the power of the float32
    # base, rounded once, then the subtraction. Divisors are tensors on the
    # device: a division by a Python number may become a product with its
    # reciprocal.
    b1c = torch.full((), _f32(1.0 - _f32(_f32(b1) ** count)), device=dev)
    b2c = torch.full((), _f32(1.0 - _f32(_f32(b2) ** count)), device=dev)
    one_m_b1, one_m_b2 = _f32(1.0 - b1), _f32(1.0 - b2)
    if masks is None:
        masks = [None] * len(params)
    grads = [g if k is None else g * k for g, k in zip(grads, masks)]
    gnorm = global_norm_f32(grads, trial_axis)
    gscale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
    if not torch.is_tensor(lr):
        lr = torch.full((), lr, dtype=torch.float32, device=dev)
    if not torch.is_tensor(seed):
        seed = torch.full((), seed, dtype=torch.int64, device=dev)
    seed = seed.to(device=dev, dtype=torch.int64)

    new_p, new_m, new_v = [], [], []
    for i, (lp, lm, lv, lg, lk) in enumerate(zip(params, state.m, state.v, grads, masks)):
        nd = lp.dim()
        scale = _trial_view(gscale, nd) if trial_axis else gscale
        g32 = lg.float() * scale
        m32 = _fma(lm.float(), _f32(b1), g32 * one_m_b1)
        v32 = _fma(lv.float(), _f32(b2), (g32 * one_m_b2) * g32)
        denom = b1c * (torch.sqrt((v32 / b2c).double()).float() + eps)
        u = m32 / denom
        if lk is not None:
            u = u * lk
        lr_t = _trial_view(lr, nd) if trial_axis and lr.dim() else lr
        p32 = _fma(-lr_t, u, lp.float())
        leaf_seed = _u32(seed + ((i * P2 + count * P3) & MASK32))
        if lp.dtype == torch.bfloat16:
            new_p.append(sr_bf16(p32, leaf_seed, trial_axis))
        else:
            new_p.append(p32.to(lp.dtype))
        new_m.append(m32.to(lm.dtype))
        new_v.append(v32.to(lv.dtype))
    return new_p, SRAdamState(new_m, new_v, count)


def trial_update_step(params, opt_state, grads, lr, seed, *, sr: bool, tx=None,
                      masks=None, trial_axis: bool = True):
    """One optimizer step of both trial engines: SR-Adam when ``sr``, else the
    ``trial_optimizer`` chain ``tx``, with the per-trial lr (and the masks)
    applied outside the transform. ``seed`` (the SR bits' seed, uint32
    values) is drawn by the caller per step, where JAX splits the trial's
    key. Returns (params', opt_state')."""
    if sr:
        return sr_adam_step(params, opt_state, grads, lr, seed, masks=masks,
                            trial_axis=trial_axis)
    if masks is not None:
        # masked gradients BEFORE the chain: the clip norm sees only the
        # trainable (real) parameters
        grads = [g if k is None else g * k for g, k in zip(grads, masks)]
    updates, opt_state = tx.update(grads, opt_state)
    if not torch.is_tensor(lr):
        lr = torch.full((), lr, dtype=torch.float32, device=params[0].device)
    new = []
    for p, u, k in zip(params, updates, masks or [None] * len(params)):
        lr_t = _trial_view(lr, u.dim()) if trial_axis and lr.dim() else lr
        # p - lr * u rounded once (XLA contracts it; so does ClippedAdam's
        # add with alpha); a mask comes after the product, as in JAX
        new.append(_fma(-lr_t, u, p) if k is None else p + (-lr_t * u) * k)
    return new, opt_state
