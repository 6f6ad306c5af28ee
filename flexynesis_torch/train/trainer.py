"""Training loop: the counterpart of ``flexynesis_tpu/train/trainer.py``.

* The whole training set lives on the model's device as ``{x: {layer: (N, F)},
  y: {var: (N,)}}``; a batch is gathered on the device by one row of a seeded
  per-epoch permutation table, so no data crosses to the device after set-up.
* Optimizer: ``ClippedAdam``, global-norm clipping to 1.0 then Adam(b1 0.9,
  b2 0.999, eps 1e-8), written to optax's formulas (``optax.chain(
  clip_by_global_norm(1.0), adam(lr))``). ``torch.nn.utils.clip_grad_norm_``
  adds 1e-6 to the norm and ``torch.optim.Adam`` orders its arithmetic
  differently, so neither is used.
* Early stopping on the validation loss with Lightning's ``mode="min"``
  semantics; the validation loss is the plain sum of the per-variable losses
  (not the uncertainty-weighted total), as in the JAX trainer.
* The parameters and buffers of the best epoch by validation loss are copied
  and returned.

Losses stay on the device during an epoch; the host reads one number per
epoch (the validation loss, for early stopping).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@dataclass
class TrainResult:
    state: Dict[str, torch.Tensor]  # best parameters and buffers (state_dict)
    val_loss: float
    epochs_run: int
    history: Dict[str, list] = field(default_factory=dict)
    wall_time_s: float = 0.0


class EarlyStopper:
    """val_loss early stopping: Lightning EarlyStopping(mode="min") semantics."""

    def __init__(self, patience: int, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.count = 0

    def update(self, value: float) -> bool:
        """Returns True when training should stop."""
        if self.patience is None or self.patience < 0:
            return False
        if value < self.best - self.min_delta:
            self.best = value
            self.count = 0
            return False
        self.count += 1
        return self.count >= self.patience


class ClippedAdam:
    """optax.chain(clip_by_global_norm(grad_clip), adam(lr, b1, b2, eps)).

    ``step(grads)`` updates the parameters in place; ``None`` gradients (a
    parameter the loss does not reach) count as zeros, as in JAX."""

    def __init__(self, params: List[torch.Tensor], lr: float, grad_clip: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.grad_clip = float(lr), float(grad_clip)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        # optax.clip_by_global_norm: g where norm < c, else g / norm * c
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        grads = torch._foreach_mul(grads, scale)
        # optax.scale_by_adam, then scale_by_learning_rate; one multi-tensor
        # launch per line instead of one per parameter
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(self.params, update, alpha=-self.lr)


def gather(data: dict, idx: torch.Tensor) -> dict:
    """Rows ``idx`` of every leaf of a batch tree (``{x: {...}, y: {...}}``,
    the triplet model's anchor tensors); entries under a ``_`` key (the
    GNN's ``_adj``, the triplet model's ``_full_x``) are whole, as in JAX."""
    return {k: v if k.startswith("_") else
            gather(v, idx) if isinstance(v, dict) else v.index_select(0, idx)
            for k, v in data.items()}


class Trainer:
    """Trains ``module`` with ``loss_fn(batch, generator, train)``, which returns
    ``(total_loss, {var: loss})`` and runs the module in training mode (batch
    statistics, dropout drawn from ``generator``) when ``train`` is True."""

    def __init__(self, module: torch.nn.Module, loss_fn: Callable, lr: float,
                 grad_clip: float = 1.0):
        self.module = module
        self.loss_fn = loss_fn
        self.params = [p for p in module.parameters() if p.requires_grad]
        self.optimizer = ClippedAdam(self.params, lr, grad_clip)

    def train_step(self, batch: dict, generator: torch.Generator) -> torch.Tensor:
        """One optimizer step on ``batch``; returns the loss, on the device."""
        total, _ = self.loss_fn(batch, generator, True)
        grads = torch.autograd.grad(total, self.params, allow_unused=True)
        self.optimizer.step(grads)
        return total.detach()

    def train_epoch(self, perm: torch.Tensor, data: dict,
                    generator: torch.Generator) -> torch.Tensor:
        """One step per row of ``perm`` (n_batches, batch_size) of row indices
        into ``data``; returns the mean step loss, on the device."""
        losses = [self.train_step(gather(data, idx), generator) for idx in perm]
        return torch.stack(losses).mean()

    @torch.no_grad()
    def validate(self, data: dict) -> torch.Tensor:
        _, losses = self.loss_fn(data, None, False)
        return sum(losses.values())

    def _snapshot(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    def fit(self, train_data: dict, val_data: Optional[dict], *, n_samples: int,
            batch_size: int, max_epochs: int, early_stop_patience: int = -1,
            seed: int = 0) -> TrainResult:
        """Train; returns the best-by-val-loss state when ``val_data`` is given,
        the last state otherwise. The per-epoch permutations come from a CPU
        ``torch.Generator`` seeded with ``seed``, the dropout masks from one on
        the module's device, so a seed gives the same batches on every device."""
        device = next(self.module.parameters()).device
        batch_size = min(batch_size, n_samples)
        n_batches = max(n_samples // batch_size, 1)
        perm_gen = torch.Generator().manual_seed(seed)
        dropout_gen = torch.Generator(device=device).manual_seed(seed)

        stopper = EarlyStopper(early_stop_patience)
        best_val = float("inf")
        best = None
        history = {"train_loss": [], "val_loss": []}
        t0 = time.perf_counter()
        epochs_run = 0
        for epoch in range(max_epochs):
            perm = torch.randperm(n_samples, generator=perm_gen)
            perm = perm[: n_batches * batch_size].reshape(n_batches, batch_size)
            train_loss = self.train_epoch(perm.to(device), train_data, dropout_gen)
            epochs_run = epoch + 1
            history["train_loss"].append(train_loss)
            if val_data is None:
                continue
            val_loss = float(self.validate(val_data))
            history["val_loss"].append(val_loss)
            if val_loss < best_val:
                best_val = val_loss
                best = self._snapshot()
            if stopper.update(val_loss):
                break
        history["train_loss"] = [float(t) for t in history["train_loss"]]
        if val_data is None:
            best = self._snapshot()
            best_val = history["train_loss"][-1] if history["train_loss"] else 0.0
        elif best is None:  # no finite validation loss: score the last state
            best = self._snapshot()
            best_val = float(self.validate(val_data))
        return TrainResult(state=best, val_loss=best_val, epochs_run=epochs_run,
                           history=history, wall_time_s=time.perf_counter() - t0)


def train_val_split(n: int, val_size: float, seed: int = 42):
    """Random train/val split of sample indices (reference main.py:267-280);
    the same numpy draws as the JAX package."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = int(np.ceil(n * val_size))
    return perm[n_val:], perm[:n_val]


def kfold_indices(n: int, k: int = 5, seed: int = 42):
    """K-fold splits of sample indices (reference main.py:267-280 CV branch)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, k)
    out = []
    for i in range(k):
        val = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        out.append((train, val))
    return out
