"""Adam for the trial engines, with the moments stored in a chosen type.

Counterpart of ``flexynesis_tpu/ops/optim.py``: ``scale_by_adam_lowp`` (Adam's
scaling with float32 arithmetic and moments stored in ``state_dtype``) and
``trial_optimizer`` (global-norm clipping to 1.0, then that scaling; the
learning rate is applied outside, per trial). With float32 moments it is the
float32-parameter chain of ``parallel/trials.py::_Round`` (``param_dtype=
"float32"``), the reference the stacked steps are checked with.

Leaves are lists of tensors with a leading trial axis K, and the clip norm is
each trial's own, as ``vmap`` of the JAX chain computes it. The arithmetic is
``train/trainer.py::ClippedAdam``'s, multi-tensor ops included, so float32
moments give ClippedAdam's bits for each trial.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamState(NamedTuple):
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def _per_trial(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape((-1,) + (1,) * (ndim - 1))


class ScaleByAdam:
    """optax.scale_by_adam with the moments stored in ``state_dtype``; the
    arithmetic is float32."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 state_dtype=torch.bfloat16):
        self.b1, self.b2, self.eps, self.state_dtype = b1, b2, eps, state_dtype

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p, dtype=self.state_dtype) for p in params],
                         [torch.zeros_like(p, dtype=self.state_dtype) for p in params])

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamState):
        count = state.count + 1
        mu = [m.float() if m.dtype != torch.float32 else m.clone() for m in state.mu]
        nu = [v.float() if v.dtype != torch.float32 else v.clone() for v in state.nu]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        torch._foreach_div_(updates, denom)
        store = [t.to(self.state_dtype) for t in mu], [t.to(self.state_dtype) for t in nu]
        return updates, AdamState(count, *store)


def scale_by_adam_lowp(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                       state_dtype=torch.bfloat16) -> ScaleByAdam:
    """Adam's scaling with moments stored in ``state_dtype``; with float32 it
    is optax.scale_by_adam."""
    return ScaleByAdam(b1, b2, eps, state_dtype)


def clip_scale(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """(K,) factors of optax.clip_by_global_norm for each trial's leaves: 1
    below ``max_norm``, else max_norm / norm. The norms are those of
    ClippedAdam: multi-tensor norms of each trial's slice of every leaf."""
    K = grads[0].shape[0]
    norms = torch.stack(torch._foreach_norm([g[k] for g in grads for k in range(K)]))
    # each trial's norms contiguous, as ClippedAdam reduces them
    norm = torch.linalg.vector_norm(norms.reshape(len(grads), K).T.contiguous(), dim=1)
    return torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)


class TrialOptimizer:
    """clip_by_global_norm(grad_clip) per trial, then Adam's scaling."""

    def __init__(self, adam: ScaleByAdam, grad_clip: float = 1.0):
        self.adam, self.grad_clip = adam, grad_clip

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return self.adam.init(params)

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamState):
        scale = clip_scale(grads, self.grad_clip)
        grads = [g * _per_trial(scale, g.dim()) for g in grads]
        return self.adam.update(grads, state)


def trial_optimizer(moment_dtype: str = "bfloat16") -> TrialOptimizer:
    """The trial engines' chain: global-norm clip 1.0 per trial, then Adam's
    scaling with the moments stored as ``moment_dtype``. The 8-bit moments
    (``"int8"``, ``"int8_m"``) exist only inside SR-Adam
    (``ops/sr_adam.py``); this chain, their fallback outside SR, stores
    bfloat16 there, as JAX's does."""
    if moment_dtype in ("int8", "int8_m"):
        moment_dtype = "bfloat16"
    return TrialOptimizer(scale_by_adam_lowp(state_dtype=MOMENT_DTYPES[moment_dtype]))
