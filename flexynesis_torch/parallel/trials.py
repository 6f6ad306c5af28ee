"""Train K HPO trials of one DirectPred architecture at once.

Counterpart of ``flexynesis_tpu/parallel/trials.py`` (``_init_stacked``,
``ParallelTrials.run``, ``vmapped_grid_fit``, ``equal_kfold_indices``),
without the device mesh and the round checkpoint. The JAX engine vmaps the
model's loss over a stacked trial axis; here ``parallel/stacked.py`` writes
that axis out, so one host issue trains K trials: with ``fused_kernels`` every
block of a training step is one launch of kernel B1 for all trials, and every
block of a validation one launch of B2.

The rules the JAX engine fixes, kept here:

* each trial has its own lr; the optimizer is SR-bf16 Adam
  (``ops/sr_adam.py``), with the global-norm clip per trial (a ``_Round``
  given ``param_dtype="float32"`` runs the float32 chain
  ``ops/optim.py::trial_optimizer("float32")`` instead, the reference that
  checks the stacked steps against single trials);
* early stopping: a trial's stall count grows in every epoch whose validation
  loss does not beat its best; the round stops when EVERY trial has stalled
  for ``early_stop_patience`` epochs; ``best_epoch`` is at least 1;
* the validation loss is the plain sum of the per-variable losses in eval
  mode (running statistics);
* randomness follows the seeds: trials that share one seed (a
  same-architecture HPO round) share their initial parameters, batch order,
  dropout masks and SR bits, drawn once; trials with different seeds (a
  mixed round) draw their own. The bits differ from JAX's threefry bits: the
  port draws from torch generators (batch order from a CPU generator seeded
  with the trial's seed, as the single-model ``Trainer`` does; dropout masks
  and SR seeds from generators on the device).

The host reads only the (K,) validation losses, once per epoch, after the
epoch's steps and its validation are issued; ``host_work(budget_s)`` (the
pipelined GP ask, ``train/gp.py::AskSession.work``) runs just before that
read, while the card finishes the epoch.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops.optim import trial_optimizer
from ..ops.sr_adam import cast_stacked_params_for_sr, sr_adam_init, trial_update_step
from .stacked import StackedDirectPred, TrialNoise


def _clone_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: t.detach().clone() for n, t in module.state_dict().items()}


def _init_stacked(model, seeds, stacked: Optional[StackedDirectPred] = None):
    """(params, buffers) of K fresh trials, trial k initialised by
    ``model.init_params(seeds[k])`` (a seed shared by several trials is
    drawn once). The template's own weights are restored afterwards."""
    stacked = stacked or StackedDirectPred(model, len(seeds))
    saved = _clone_state(model.module)
    by_seed = {}
    for s in dict.fromkeys(int(s) for s in np.asarray(seeds)):
        model.init_params(s)
        by_seed[s] = _clone_state(model.module)
    model.module.load_state_dict(saved)
    return stacked.stack([by_seed[int(s)] for s in np.asarray(seeds)])


def equal_kfold_indices(n: int, k: int, seed: int = 42):
    """(k, n_tr) / (k, n_val) equal-size fold index tables (trims n % k)."""
    rng = np.random.default_rng(seed)
    n_cv = (n // k) * k
    perm = rng.permutation(n)[:n_cv]
    folds = perm.reshape(k, n_cv // k)
    train = np.stack(
        [np.concatenate([folds[j] for j in range(k) if j != i]) for i in range(k)]
    )
    return train, folds


def _gather(data: dict, rows: torch.Tensor) -> dict:
    """Rows of every leaf of a ``{x: {...}, y: {...}}`` tree: ``rows`` (B,)
    gives (B, ...) leaves, ``rows`` (K, B) gives (K, B, ...) leaves."""
    flat = rows.reshape(-1)
    return {k: {n: t.index_select(0, flat).reshape(*rows.shape, *t.shape[1:])
                for n, t in v.items()} for k, v in data.items()}


class _Round:
    """The state of one round of K stacked trials and its training loop."""

    def __init__(self, model, params, buffers, *, lrs, seeds, masks=None,
                 param_dtype: str = "bfloat16_sr"):
        self.model = model
        self.device = model.device
        self.K = len(lrs)
        self.stacked = StackedDirectPred(model, self.K)
        self.seeds = [int(s) for s in np.asarray(seeds)]
        self.shared = len(set(self.seeds)) == 1
        self.sr = param_dtype == "bfloat16_sr"
        names = self.stacked.leaf_names
        if self.sr:
            stored = cast_stacked_params_for_sr([params[n] for n in names], self.K)
            self.params = dict(zip(names, stored))
        else:
            self.params = dict(params)
        self.buffers = buffers
        self.views = self.stacked.flax_layout(self.params)
        self.tx = None if self.sr else trial_optimizer("float32")
        self.opt_state = sr_adam_init(self.views) if self.sr else self.tx.init(self.views)
        self.lrs = torch.as_tensor(np.asarray(lrs, np.float32), device=self.device)
        self.masks = masks
        dev = self.device
        self.noise = TrialNoise(torch.Generator(device=dev).manual_seed(self.seeds[0]),
                                shared=self.shared)
        self.sr_gen = torch.Generator(device=dev).manual_seed(self.seeds[0] ^ 0x9E3779B9)
        self.perm_gens = [torch.Generator().manual_seed(s)
                          for s in (self.seeds[:1] if self.shared else self.seeds)]

    def params32(self, grad: bool = False) -> Dict[str, torch.Tensor]:
        """Float32 parameters for a forward (copies of bfloat16 leaves),
        leaves of autograd with ``grad``."""
        out = {}
        for n, t in self.params.items():
            t = t.float() if t.dtype != torch.float32 else t.detach()
            out[n] = t.requires_grad_() if grad else t
        return out

    def step(self, batch: dict, sr_seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step of every trial on ``batch``; returns the (K,)
        training losses before the step, on the device. ``sr_seed`` (one
        value, or one per trial) replaces the step's draw of SR seeds."""
        names = self.stacked.leaf_names
        work = self.params32(grad=True)
        total, _ = self.stacked.loss(work, self.buffers, batch, self.noise, True)
        grads = torch.autograd.grad(total.sum(), [work[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(work[n]) if g is None else g
                 for n, g in zip(names, grads)}
        with torch.no_grad():
            seed = sr_seed
            if self.sr and seed is None:
                seed = torch.randint(0, 2 ** 32, (1 if self.shared else self.K,),
                                     generator=self.sr_gen, device=self.device)
            new, self.opt_state = trial_update_step(
                self.views, self.opt_state, self.stacked.flax_layout(grads), self.lrs,
                seed, sr=self.sr, tx=self.tx, masks=self.masks)
            for view, value in zip(self.views, new):
                view.copy_(value)
        return total.detach()

    @torch.no_grad()
    def validate(self, batch: dict) -> torch.Tensor:
        """(K,) sums of the per-variable eval-mode losses, on the device."""
        _, losses = self.stacked.loss(self.params32(), self.buffers, batch, None, False)
        return sum(losses.values())

    def epoch_rows(self, train_idx: np.ndarray, n_batches: int, batch_size: int):
        """This epoch's row table, (n_batches, B) shared or (n_batches, K, B)."""
        n_tr = train_idx.shape[1]
        rows = []
        for k, gen in enumerate(self.perm_gens):
            perm = torch.randperm(n_tr, generator=gen).numpy()[: n_batches * batch_size]
            rows.append(train_idx[k][perm].reshape(n_batches, batch_size))
        table = rows[0] if self.shared else np.stack(rows, axis=1)
        return torch.from_numpy(np.ascontiguousarray(table)).to(self.device)

    def fit(self, data: dict, train_idx: np.ndarray, val_batch: dict, *, batch_size: int,
            max_epochs: int, early_stop_patience: int,
            host_work: Optional[Callable[[float], object]] = None,
            wall_est: Optional[float] = None) -> dict:
        n_tr = train_idx.shape[1]
        batch_size = min(batch_size, n_tr)
        n_batches = max(n_tr // batch_size, 1)
        K = self.K
        best = np.full(K, np.inf)
        best_epoch = np.zeros(K, dtype=int)
        stall = np.zeros(K, dtype=int)
        epochs_run = 0
        for epoch in range(max_epochs):
            t_ep = time.perf_counter()
            table = self.epoch_rows(train_idx, n_batches, batch_size)
            for s in range(n_batches):
                self.step(_gather(data, table[s]))
            vloss = self.validate(val_batch)
            if host_work is not None:
                # the card finishes the epoch while the host runs a slice of
                # the next round's GP ask (about 90% of the last epoch's wall)
                spent = time.perf_counter() - t_ep
                host_work(max(0.0, 0.9 * wall_est - spent) if wall_est is not None else 0.05)
            v = vloss.cpu().numpy()
            wall_est = time.perf_counter() - t_ep
            epochs_run = epoch + 1
            improved = v < best
            best = np.where(improved, v, best)
            best_epoch = np.where(improved, epochs_run, best_epoch)
            stall = np.where(improved, 0, stall + 1)
            if early_stop_patience > 0 and np.all(stall >= early_stop_patience):
                break
        return {
            "best_val_loss": best,
            "best_epoch": np.maximum(best_epoch, 1),
            "epochs_run": epochs_run,
            "epoch_wall_s": wall_est,
            "final_params": self.params32(),
            "final_buffers": self.buffers,
        }


def _val_batch(data: dict, val_idx: np.ndarray, device) -> dict:
    """The validation rows: one (n_val, ...) batch where every trial has the
    same rows, else (K, n_val, ...)."""
    shared = bool(np.all(val_idx == val_idx[:1]))
    rows = val_idx[0] if shared else val_idx
    return _gather(data, torch.from_numpy(np.ascontiguousarray(rows)).to(device))


def vmapped_grid_fit(model, dataset, *, start_params=None, start_stats=None,
                     lrs, seeds, train_idx, val_idx, masks=None,
                     batch_size: int = 32, max_epochs: int = 50,
                     early_stop_patience: int = -1,
                     host_work: Optional[Callable[[float], object]] = None) -> dict:
    """Train T trials with per-trial data splits concurrently.

    Every trial sees its own train/val rows of the dataset (``train_idx``
    (T, n_tr), ``val_idx`` (T, n_val)), its own lr and seed and optionally its
    own element masks (per leaf, in the JAX flatten order and Flax layout,
    ``parallel/hetero.py``). ``start_params`` / ``start_stats``: None for
    fresh per-seed parameters, or the state (parameters and buffers by
    ``state_dict`` name) of one model broadcast to all trials, or stacked
    (T, ...) states. Returns {best_val_loss (T,), best_epoch (T,),
    epochs_run}."""
    T = len(lrs)
    train_idx, val_idx = np.asarray(train_idx), np.asarray(val_idx)
    stacked = StackedDirectPred(model, T)
    if start_params is None:
        params, buffers = _init_stacked(model, seeds, stacked)
    else:
        params = {n: start_params[n] for n in stacked.leaf_names}
        buffers = {n: start_stats[n] for n in stacked.buffer_names}
        # stacked only if EVERY leaf has the trial axis: a (T,)-shaped bias
        # of one model must not pass for a stack
        already = all(t.shape[:1] == (T,) for t in [*params.values(), *buffers.values()])

        def place(tree):
            return {n: (t if already else t.expand(T, *t.shape)).to(model.device).clone()
                    for n, t in tree.items()}
        params, buffers = place(params), place(buffers)
    trial_round = _Round(model, params, buffers, lrs=lrs, seeds=seeds, masks=masks)
    data = model.make_batch(dataset)
    out = trial_round.fit(data, train_idx, _val_batch(data, val_idx, model.device),
                          batch_size=batch_size, max_epochs=max_epochs,
                          early_stop_patience=early_stop_patience, host_work=host_work)
    return {k: out[k] for k in ("best_val_loss", "best_epoch", "epochs_run")}


class ParallelTrials:
    """Train K trials of one model template concurrently on one split."""

    def __init__(self, model, dataset):
        self.model = model
        self.dataset = dataset
        self._data = None
        # wall time of the last epoch per trial count: budgets host_work
        # across run() calls (HPO rounds repeat the shape)
        self._epoch_wall_est: Dict[int, float] = {}

    def run(self, lrs, seeds, *, train_idx, val_idx, batch_size: int, max_epochs: int,
            early_stop_patience: int = -1,
            host_work: Optional[Callable[[float], object]] = None) -> dict:
        """Train len(lrs) fresh trials (trial k initialised from seeds[k]) on
        one train/validation split, as the sequential objective evaluates
        each trial. Returns per-trial best validation losses and epochs,
        ``epochs_run``, and the final float32 ``final_params`` and
        ``final_buffers`` (stacked, by ``state_dict`` name)."""
        K = len(lrs)
        if self._data is None:  # the dataset stays on the device across rounds
            self._data = self.model.make_batch(self.dataset)
        train_idx = np.tile(np.asarray(train_idx), (K, 1))
        val_idx = np.tile(np.asarray(val_idx), (K, 1))
        params, buffers = _init_stacked(self.model, seeds)
        trial_round = _Round(self.model, params, buffers, lrs=lrs, seeds=seeds)
        out = trial_round.fit(self._data, train_idx,
                              _val_batch(self._data, val_idx, self.model.device),
                              batch_size=batch_size, max_epochs=max_epochs,
                              early_stop_patience=early_stop_patience, host_work=host_work,
                              wall_est=self._epoch_wall_est.get(K))
        self._epoch_wall_est[K] = out.pop("epoch_wall_s")
        return out
