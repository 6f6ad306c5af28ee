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
* ``trainable_mask`` (the fine-tuner's freeze configurations): a callable
  over the Flax top-level names (``encoder_gex``, ``head_subtype``, ...; the
  port's modules carry those names, so it is the first part of a parameter's
  name). A frozen parameter gets no gradient, no Adam update and no share of
  the global-norm clip, so it stays bit-identical through a fit; the running
  statistics of a frozen BatchNorm still update, as JAX's trial engine lets
  them. JAX's ``Trainer`` passes a frozen leaf's raw gradient through
  ``optax.masked`` and adds it to the parameter, so its frozen leaves move:
  a departure, kept on purpose (the reference freezes with
  ``requires_grad=False``).
* ``Trainer(mesh=...)`` with a ``data`` axis that spans the live
  ``torch.distributed`` group is the data-parallel fit, JAX's
  ``Trainer(mesh=)``: one process per device, each forwarding its rows of
  every global batch, BatchNorm statistics and the loss over the global
  batch and the gradients summed over the ranks before the clip
  (``ops/collectives.py``), so every rank holds the same parameters and
  the fit is the one-process fit's.
* ``fit(checkpoint_dir=...)`` saves the state every ``checkpoint_every``
  epochs (``train/checkpoint.py``) and resumes from the latest: parameters,
  buffers, Adam's moments and count, both generators, the early stopper and
  the best state so far, so a resumed fit returns what an uninterrupted one
  returns. (JAX keeps no best state in its checkpoint and restarts the best
  tracking on resume.)

Losses stay on the device during an epoch; the host reads one number per
epoch (the validation loss, for early stopping).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops.collectives import all_reduce_grads, data_axis


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


def data_group(mesh):
    """The process group of a fit's data axis, or None.

    A mesh with a ``data`` axis selects the data-parallel fit when that axis
    spans the live ``torch.distributed`` group (one process per device,
    ``parallel/distributed.py``), a group of one rank included; a data axis
    of one device without a group is the plain fit; any other data axis
    raises."""
    if mesh is None or "data" not in mesh.axis_names:
        return None
    import torch.distributed as dist

    size = mesh.shape["data"]
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != size:
            raise ValueError(f"the mesh's data axis has {size} devices but the process "
                             f"group {dist.get_world_size()} ranks")
        return dist.group.WORLD
    if size == 1:
        return None
    raise ValueError(f"a data axis of {size} devices needs a torch.distributed group of "
                     f"{size} processes, one per device "
                     "(flexynesis_torch.parallel.distributed.initialize)")


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
                 grad_clip: float = 1.0,
                 trainable_mask: Optional[Callable[[str], bool]] = None, mesh=None):
        self.module = module
        self.loss_fn = loss_fn
        self.data_group = data_group(mesh)
        self.param_names = [n for n, p in module.named_parameters() if p.requires_grad
                            and (trainable_mask is None or trainable_mask(n.split(".")[0]))]
        named = dict(module.named_parameters())
        self.params = [named[n] for n in self.param_names]
        self.optimizer = ClippedAdam(self.params, lr, grad_clip)

    def train_step(self, batch: dict, generator: torch.Generator) -> torch.Tensor:
        """One optimizer step on ``batch``; returns the loss, on the device.
        On a data axis the ranks' gradients are summed before the clip."""
        if self.data_group is None:
            total, _ = self.loss_fn(batch, generator, True)
            grads = torch.autograd.grad(total, self.params, allow_unused=True)
        else:
            with data_axis(self.data_group):
                total, _ = self.loss_fn(batch, generator, True)
                grads = torch.autograd.grad(total, self.params, allow_unused=True)
                grads = all_reduce_grads(grads, self.params)
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

    def _checkpoint_tensors(self, gens, best) -> Dict[str, torch.Tensor]:
        out = {f"state/{n}": t for n, t in self.module.state_dict().items()}
        opt = self.optimizer
        out.update({f"mu/{n}": t for n, t in zip(self.param_names, opt.mu)})
        out.update({f"nu/{n}": t for n, t in zip(self.param_names, opt.nu)})
        out.update({f"gen/{i}": g.get_state() for i, g in enumerate(gens)})
        if best is not None:
            out.update({f"best/{n}": t for n, t in best.items()})
        return out

    def _restore(self, tensors: Dict[str, torch.Tensor], gens):
        """Load a checkpoint's module state, moments and generator states;
        returns its best state (or None)."""
        device = next(self.module.parameters()).device
        self.module.load_state_dict({n[6:]: t for n, t in tensors.items()
                                     if n.startswith("state/")})
        opt = self.optimizer
        with torch.no_grad():
            for i, n in enumerate(self.param_names):
                opt.mu[i].copy_(tensors[f"mu/{n}"])
                opt.nu[i].copy_(tensors[f"nu/{n}"])
        for i, g in enumerate(gens):
            g.set_state(tensors[f"gen/{i}"])
        best = {n[5:]: t.to(device) for n, t in tensors.items() if n.startswith("best/")}
        return best or None

    def fit(self, train_data: dict, val_data: Optional[dict], *, n_samples: int,
            batch_size: int, max_epochs: int, early_stop_patience: int = -1,
            seed: int = 0, log_every: int = 0, checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 10, on_epoch_end=None) -> TrainResult:
        """Train; returns the best-by-val-loss state when ``val_data`` is given,
        the last state otherwise. The per-epoch permutations come from a CPU
        ``torch.Generator`` seeded with ``seed``, the dropout masks from one on
        the module's device, so a seed gives the same batches on every device.
        ``checkpoint_dir`` saves the state every ``checkpoint_every`` epochs and
        resumes from its latest step. ``log_every`` > 0 prints the losses of
        every ``log_every``-th epoch, as JAX's trainer prints them (each such
        line reads the epoch's loss from the device). ``on_epoch_end(epoch,
        train_loss, val_loss)`` is called after each validated epoch (a live
        loss plot)."""
        device = next(self.module.parameters()).device
        batch_size = min(batch_size, n_samples)
        n_batches = max(n_samples // batch_size, 1)
        perm_gen = torch.Generator().manual_seed(seed)
        dropout_gen = torch.Generator(device=device).manual_seed(seed)
        gens = (perm_gen, dropout_gen)

        stopper = EarlyStopper(early_stop_patience)
        best_val = float("inf")
        best = None
        history = {"train_loss": [], "val_loss": []}
        start_epoch = 0
        ckpt = None
        if checkpoint_dir:
            from .checkpoint import TrainCheckpointer

            ckpt = TrainCheckpointer(checkpoint_dir, checkpoint_every)
            restored = ckpt.restore()
            if restored is not None:
                tensors, meta = restored
                best = self._restore(tensors, gens)
                self.optimizer.count = int(meta["count"])
                start_epoch = int(meta["epoch"])
                best_val = float(meta["best_val"])
                stopper.best, stopper.count = float(meta["stopper_best"]), int(meta["stopper_count"])
                print(f"[INFO] Resumed training from epoch {start_epoch} "
                      f"(best val {best_val:.4f})")
        t0 = time.perf_counter()
        epochs_run = start_epoch
        for epoch in range(start_epoch, max_epochs):
            perm = torch.randperm(n_samples, generator=perm_gen)
            perm = perm[: n_batches * batch_size].reshape(n_batches, batch_size)
            train_loss = self.train_epoch(perm.to(device), train_data, dropout_gen)
            epochs_run = epoch + 1
            history["train_loss"].append(train_loss)
            stop = False
            if val_data is not None:
                val_loss = float(self.validate(val_data))
                history["val_loss"].append(val_loss)
                if val_loss < best_val:
                    best_val = val_loss
                    best = self._snapshot()
                if log_every and epoch % log_every == 0:
                    print(f"[epoch {epoch}] train_loss={float(train_loss):.4f} "
                          f"val_loss={val_loss:.4f}")
                if on_epoch_end is not None:
                    on_epoch_end(epoch, float(train_loss), val_loss)
                stop = stopper.update(val_loss)
            elif log_every and epoch % log_every == 0:
                print(f"[epoch {epoch}] train_loss={float(train_loss):.4f}")
            if ckpt is not None:
                ckpt.maybe_save(epochs_run, self._checkpoint_tensors(gens, best), {
                    "count": self.optimizer.count, "best_val": best_val,
                    "stopper_best": stopper.best, "stopper_count": stopper.count})
            if stop:
                break
        if ckpt is not None:
            ckpt.close()
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
