"""Train K HPO trials of one architecture at once.

Counterpart of ``flexynesis_tpu/parallel/trials.py`` (``_init_stacked``,
``ParallelTrials.run`` with its round checkpoint, ``vmapped_grid_fit``,
``equal_kfold_indices``), for the five classes (the stacked class is chosen
by the template's ``model_name``), on one device or split over the ``trial``
axis of a mesh (``_ShardedRound``, ``parallel/mesh.py``). Batch entries
under a ``_`` key (the triplet model's ``_full_x``, the GNN's ``_adj``, a
padded round's ``_aux``) pass whole into every step, as in JAX; the GNN's
operator needs no passing at initialisation (the port's modules know their
shapes without a forward, where JAX's ``init`` traces one). The JAX engine vmaps the model's loss over a
stacked trial axis; here ``parallel/stacked.py`` writes that axis out, so one
host issue trains K trials: with ``fused_kernels`` every DirectPred block of
a training step is one launch of kernel B1 for all trials and every block of
a validation one launch of B2, and every decoded layer of a VAE step or
validation one launch of B3. ``vmapped_grid_fit`` gives each trial its own
data split (the CV folds of ``train/hpo.py``), and a padded round's ``aux``
(``parallel/hetero.py``) goes into every training and validation batch as
``_aux``, as the JAX engine puts it there.

The rules the JAX engine fixes, kept here:

* each trial has its own lr, and the global-norm clip is per trial; a
  ``ParallelTrials`` round (fresh-initialised) runs SR-bf16 Adam
  (``ops/sr_adam.py``; its ``moment_dtype="int8"`` stores 8-bit moments);
  ``vmapped_grid_fit`` defaults to JAX's float32
  parameters with bfloat16 Adam moments (``trial_optimizer("bfloat16")``,
  the fine-tuner's grid), and its HPO callers (mixed and CV rounds) ask for
  ``param_dtype="bfloat16_sr"``, as JAX's do; a ``_Round`` given
  ``param_dtype="float32"`` and no ``moment_dtype`` runs the float32 chain,
  the reference that checks the stacked steps against single trials;
* early stopping: a trial's stall count grows in every epoch whose validation
  loss does not beat its best; the round stops when EVERY trial has stalled
  for ``early_stop_patience`` epochs; ``best_epoch`` is at least 1;
* the validation loss is the plain sum of the per-variable losses in eval
  mode (running statistics);
* randomness follows the seeds: trials that share one seed (a
  same-architecture HPO round) share their initial parameters, batch order,
  dropout masks, VAE noise and SR bits, drawn once; trials with different
  seeds (mixed and CV rounds) draw their own. The bits differ from JAX's
  threefry bits: the port draws from torch generators (batch order from a
  CPU generator seeded with the trial's seed, as the single-model
  ``Trainer`` does; dropout masks, eps, priors and SR seeds from generators
  on the device).

The host reads only the (K,) validation losses, once per epoch, after the
epoch's steps and its validation are issued; ``host_work(budget_s)`` (the
pipelined GP ask, ``train/gp.py::AskSession.work``) runs just before that
read, while the card finishes the epoch.

``ParallelTrials.run(checkpoint_dir=...)`` saves the round's whole state
every ``epochs_per_eval`` epochs (never after the last), and a rerun of the
same round resumes from it: parameters, buffers, the optimizer's moments and
count, the early-stopping arrays and every generator (``TrialNoise``'s, the
SR seeds', each permutation generator), so the resumed round returns what
an uninterrupted one returns. A fingerprint of the round (class, config,
conv type, lrs, seeds, schedule, split rows, moment and parameter types and
the optimizer's state layout, its dtypes included) must match, else the file
is ignored with a warning; the file is deleted when the round ends. A sharded
round writes and reads the same file as the unsharded one. The file format is ``train/checkpoint.py``'s,
not JAX's orbax directory, so the two packages do not share round
checkpoints.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..kernels.fused_linear import planned_for
from ..ops.optim import AdamState, trial_optimizer
from ..ops.sr_adam import (Q8, SRAdamState, cast_stacked_params_for_sr, sr_adam_init,
                           trial_update_step)
from ..utils.profiling import count, host_wait, span
from .mesh import device_context, replica, split_rows, to_device
from .stacked import TrialNoise, stacked_model


def _clone_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: t.detach().clone() for n, t in module.state_dict().items()}


def _init_stacked(model, seeds, stacked=None):
    """(params, buffers) of K fresh trials, trial k initialised by
    ``model.init_params(seeds[k])`` (a seed shared by several trials is
    drawn once). The template's own weights are restored afterwards."""
    stacked = stacked or stacked_model(model, len(seeds))
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
    """Rows of every leaf of a batch tree: ``rows`` (B,) gives (B, ...)
    leaves, ``rows`` (K, B) gives (K, B, ...) leaves; entries under a ``_``
    key (``_full_x``, ``_adj``, ``_aux``) are whole, as in JAX."""
    flat = rows.reshape(-1)
    return {k: v if k.startswith("_") else
            _gather(v, rows) if isinstance(v, dict) else
            v.index_select(0, flat).reshape(*rows.shape, *v.shape[1:])
            for k, v in data.items()}


class _Round:
    """The state of one round of K stacked trials and its training loop.

    ``trials`` makes it one shard of a larger round (``_ShardedRound``): the
    indices, among ``seeds`` (the whole round's), of the trials it holds;
    ``params``, ``buffers``, ``lrs``, ``masks`` and ``aux`` hold only those
    trials, on the template ``model``'s device. Every draw (the noise, the SR
    seeds, the batch order) is made for the whole round and the shard takes
    its trials' share, and kernels B1 and B2 plan their launches as for the
    whole round (``kernels/fused_linear.py::planned_for``), so a sharded
    trial k trains as unsharded trial k."""

    def __init__(self, model, params, buffers, *, lrs, seeds, masks=None, aux=None,
                 param_dtype: str = "bfloat16_sr", moment_dtype: str = "float32",
                 trials=None):
        self.model = model
        self.device = model.device
        self.seeds = [int(s) for s in np.asarray(seeds)]
        self.trials = list(range(len(self.seeds))) if trials is None else [int(t) for t in trials]
        self.K = len(self.trials)
        if len(lrs) != self.K:
            raise ValueError(f"{len(lrs)} lrs for {self.K} trials")
        self.stacked = stacked_model(model, self.K)
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
        self.tx = None if self.sr else trial_optimizer(moment_dtype)
        self.opt_state = (sr_adam_init(self.views, moment_dtype) if self.sr
                          else self.tx.init(self.views))
        with host_wait():   # a copy from pageable memory waits for the stream
            self.lrs = torch.as_tensor(np.asarray(lrs, np.float32), device=self.device)
        self.masks = masks
        self.aux = aux
        dev = self.device
        self.noise = TrialNoise(torch.Generator(device=dev).manual_seed(self.seeds[0]),
                                self.seeds, None if trials is None else self.trials)
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

    def _with_aux(self, batch: dict) -> dict:
        return batch if self.aux is None else {**batch, "_aux": self.aux}

    def step(self, batch: dict, sr_seed: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step of every trial on ``batch``; returns the (K,)
        training losses before the step, on the device. ``sr_seed`` (one
        value, or one per trial) replaces the step's draw of SR seeds."""
        names = self.stacked.leaf_names
        work = self.params32(grad=True)
        with planned_for(len(self.seeds)):
            total, _ = self.stacked.loss(work, self.buffers, self._with_aux(batch), self.noise,
                                         True)
        grads = torch.autograd.grad(total.sum(), [work[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(work[n]) if g is None else g
                 for n, g in zip(names, grads)}
        with torch.no_grad(), span("optim.update"):
            seed = sr_seed
            if self.sr and seed is None:
                seed = self.noise.spread(torch.randint(
                    0, 2 ** 32, (self.noise.n_draws,), generator=self.sr_gen,
                    device=self.device))
            new, self.opt_state = trial_update_step(
                self.views, self.opt_state, self.stacked.flax_layout(grads), self.lrs,
                seed, sr=self.sr, tx=self.tx, masks=self.masks)
            for view, value in zip(self.views, new):
                view.copy_(value)
        return total.detach()

    @torch.no_grad()
    def validate(self, batch: dict) -> torch.Tensor:
        """(K,) sums of the per-variable eval-mode losses, on the device."""
        with planned_for(len(self.seeds)):
            _, losses = self.stacked.loss(self.params32(), self.buffers, self._with_aux(batch),
                                          None, False)
        return sum(losses.values())

    def epoch_rows(self, train_idx: np.ndarray, n_batches: int, batch_size: int):
        """This epoch's row table: (n_batches, B) where every trial of the
        whole round draws the same rows, else (n_batches, K, B) for this
        round's trials. Trials that share a seed share the permutation, each
        applying it to its own training rows; ``train_idx`` holds the whole
        round's rows (one row of it per trial of ``seeds``)."""
        table = _round_rows(self.perm_gens, self.shared, train_idx, n_batches, batch_size)
        if table.ndim == 3 and len(self.trials) != train_idx.shape[0]:
            table = table[:, self.trials]
        with host_wait():   # a copy from pageable memory waits for the stream
            return torch.from_numpy(np.ascontiguousarray(table)).to(self.device)

    def train_step(self, data: dict, rows: torch.Tensor) -> torch.Tensor:
        """One step on the rows ``rows`` of ``data`` (the epoch table's row)."""
        return self.step(_gather(data, rows))

    def final_state(self):
        """(float32 parameters, buffers), stacked."""
        return self.params32(), self.buffers

    def generators(self) -> List[torch.Generator]:
        return [self.noise.generator, self.sr_gen, *self.perm_gens]

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        """The round's tensors for a checkpoint: parameters, buffers, the
        optimizer's moments (an 8-bit moment's codes and scales) and every
        generator's state."""
        out = {f"params/{n}": t for n, t in self.params.items()}
        out.update({f"buffers/{n}": t for n, t in self.buffers.items()})
        out.update(_moment_items(self.opt_state))
        out.update({f"gen/{i}": g.get_state() for i, g in enumerate(self.generators())})
        return out

    def load_state_tensors(self, tensors: Dict[str, torch.Tensor], count: int) -> None:
        """Restore what ``state_tensors`` saved (shapes and types checked)."""
        pairs = ([(self.params[n], tensors[f"params/{n}"]) for n in self.params]
                 + [(self.buffers[n], tensors[f"buffers/{n}"]) for n in self.buffers]
                 + [(t, tensors[k]) for k, t in _moment_items(self.opt_state).items()])
        for dst, src in pairs:
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"state layout changed: {tuple(src.shape)} {src.dtype} "
                                 f"for {tuple(dst.shape)} {dst.dtype}")
        with torch.no_grad():
            for dst, src in pairs:
                dst.copy_(src)
        self.opt_state = _with_count(self.opt_state, count)
        for i, g in enumerate(self.generators()):
            g.set_state(tensors[f"gen/{i}"])

    @property
    def count(self) -> int:
        return int(self.opt_state.count)

    @property
    def opt_kind(self) -> str:
        return type(self.opt_state).__name__

    def moment_layout(self) -> list:
        """The optimizer state's layout: each moment tensor's shape and type."""
        return _moment_layout(self.opt_state)

    def fit(self, data: dict, train_idx: np.ndarray, val_batch: dict, **kw) -> dict:
        """``_fit_round`` of this round."""
        return _fit_round(self, data, train_idx, val_batch, **kw)


def _round_rows(perm_gens, shared: bool, train_idx: np.ndarray, n_batches: int,
                batch_size: int) -> np.ndarray:
    """A whole round's epoch table from its permutation generators (one
    shared, or one per trial): (n_batches, B) where every trial draws the
    same rows, else (n_batches, K, B)."""
    K, n_tr = train_idx.shape
    perms = [torch.randperm(n_tr, generator=gen).numpy()[: n_batches * batch_size]
             for gen in perm_gens]
    rows = np.stack([train_idx[k][perms[0 if shared else k]] for k in range(K)])
    table = rows.reshape(K, n_batches, batch_size).transpose(1, 0, 2)
    return table[:, 0] if np.all(rows == rows[:1]) else table


def _fit_round(rnd, data, train_idx: np.ndarray, val_batch, *, batch_size: int,
               max_epochs: int, early_stop_patience: int,
               host_work: Optional[Callable[[float], object]] = None,
               wall_est: Optional[float] = None, checkpoint=None, epochs_per_eval: int = 5,
               on_epoch_end: Optional[Callable[[int, np.ndarray, np.ndarray], None]] = None,
               ) -> dict:
    """Train a round (a ``_Round`` or a ``_ShardedRound``) until every trial
    has stalled or ``max_epochs``; with a ``_RoundCheckpoint``, resume from it
    and save every ``epochs_per_eval`` epochs, never after the last.
    ``on_epoch_end(epoch, train_losses, val_losses)`` gets each trial's mean
    training loss of the epoch and its validation loss, (K,) arrays. Early
    stopping is one decision per epoch over all K trials, sharded or not."""
    n_tr = train_idx.shape[1]
    batch_size = min(batch_size, n_tr)
    n_batches = max(n_tr // batch_size, 1)
    K = rnd.K
    best = np.full(K, np.inf)
    best_epoch = np.zeros(K, dtype=int)
    stall = np.zeros(K, dtype=int)
    epochs_run = 0
    if checkpoint is not None:
        resumed = checkpoint.load(rnd)
        if resumed is not None:
            best, best_epoch, stall, epochs_run = resumed
    chunk = max(int(epochs_per_eval), 1)
    for epoch in range(epochs_run, max_epochs):
        t_ep = time.perf_counter()
        with span("engine.epoch_rows"):
            table = rnd.epoch_rows(train_idx, n_batches, batch_size)
        tlosses = []
        for s in range(n_batches):
            with span("engine.step"):
                count("engine.steps")
                count("engine.trial_samples", K * table.shape[-1])
                tlosses.append(rnd.train_step(data, table[s]))
        with span("engine.validate"):
            vloss = rnd.validate(val_batch)
        if host_work is not None:
            # the card finishes the epoch while the host runs a slice of
            # the next round's GP ask (about 90% of the last epoch's wall)
            spent = time.perf_counter() - t_ep
            host_work(max(0.0, 0.9 * wall_est - spent) if wall_est is not None else 0.05)
        with host_wait():
            v = vloss.cpu().numpy()
        wall_est = time.perf_counter() - t_ep
        epochs_run = epoch + 1
        if on_epoch_end is not None:
            with host_wait():
                train_losses = (sum(tlosses) / n_batches).cpu().numpy()
            on_epoch_end(epoch, train_losses, v)
        improved = v < best
        best = np.where(improved, v, best)
        best_epoch = np.where(improved, epochs_run, best_epoch)
        stall = np.where(improved, 0, stall + 1)
        stop = early_stop_patience > 0 and np.all(stall >= early_stop_patience)
        if (checkpoint is not None and not stop and epochs_run < max_epochs
                and epochs_run % chunk == 0):
            checkpoint.save(rnd, best, best_epoch, stall, epochs_run)
        if stop:
            break
    if checkpoint is not None:
        checkpoint.clear()
    params, buffers = rnd.final_state()
    return {
        "best_val_loss": best,
        "best_epoch": np.maximum(best_epoch, 1),
        "epochs_run": epochs_run,
        "epoch_wall_s": wall_est,
        "final_params": params,
        "final_buffers": buffers,
    }


def _slice_trials(tree, rows: slice, device):
    """Trials ``rows`` of every tensor of a per-trial tree (masks, aux) on
    ``device``; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _slice_trials(v, rows, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_slice_trials(v, rows, device) for v in tree]
    return tree[rows].to(device)


class _ShardedRound:
    """A round of K trials split over the devices of a ``trial`` mesh
    (``parallel/mesh.py``): shard i holds a contiguous slice of the trials as
    a ``_Round`` on its device, with a copy of the template there, and runs
    inside that device's context (the kernels launch on the current device's
    stream). Trials are independent, so no collective is needed: the host
    issues each step to every shard in turn (launches are asynchronous, so
    the devices overlap), concatenates the (K,) losses, and the early stop
    is decided over all K. Every shard draws the whole round's noise, SR
    seeds and batch order and takes its trials' share (``_Round``'s
    ``trials``), so sharded trial k is unsharded trial k. The checkpoint
    holds the trial-axis concatenation of the shards' tensors and one copy
    of the generators (every shard's are alike): the file of the unsharded
    round, which resumes into any split."""

    def __init__(self, model, params, buffers, *, lrs, seeds, mesh, masks=None, aux=None,
                 param_dtype: str = "bfloat16_sr", moment_dtype: str = "float32"):
        self.model = model
        self.K = len(lrs)
        self.devices = mesh.axis_devices("trial")
        self.parts = split_rows(self.K, len(self.devices))
        lrs = np.asarray(lrs, np.float32)
        self.shards = []
        for d, sl in zip(self.devices, self.parts):
            with device_context(d):
                self.shards.append(_Round(
                    replica(model, d),
                    {n: t[sl].to(d) for n, t in params.items()},
                    {n: t[sl].to(d) for n, t in buffers.items()},
                    lrs=lrs[sl], seeds=seeds, masks=_slice_trials(masks, sl, d),
                    aux=_slice_trials(aux, sl, d), param_dtype=param_dtype,
                    moment_dtype=moment_dtype, trials=range(self.K)[sl]))
        first = self.shards[0]
        self.stacked, self.seeds, self.shared = first.stacked, first.seeds, first.shared

    @property
    def count(self) -> int:
        return self.shards[0].count

    @property
    def opt_kind(self) -> str:
        return self.shards[0].opt_kind

    def shard_data(self, data: dict) -> list:
        """``data`` (the dataset's batch tree) on every shard's device."""
        return [to_device(data, d) for d in self.devices]

    def val_batches(self, data: list, val_idx: np.ndarray) -> list:
        """Each shard's validation batch: the shared rows, or its trials'."""
        shared = bool(np.all(val_idx == val_idx[:1]))
        return [_val_batch(dd, val_idx[:1] if shared else val_idx[sl], d)
                for dd, d, sl in zip(data, self.devices, self.parts)]

    def epoch_rows(self, train_idx: np.ndarray, n_batches: int, batch_size: int) -> np.ndarray:
        """The whole round's epoch table (numpy), drawn by the first shard's
        permutation generators (the checkpoint keeps the first shard's)."""
        first = self.shards[0]
        return _round_rows(first.perm_gens, first.shared, train_idx, n_batches, batch_size)

    def train_step(self, data: list, rows: np.ndarray) -> torch.Tensor:
        """One step of every shard on its rows (its trials' share of a
        per-trial table); the (K,) losses on the first device."""
        losses = []
        for shard, dd, d, sl in zip(self.shards, data, self.devices, self.parts):
            r = rows if rows.ndim == 1 else rows[sl]
            with device_context(d):
                with host_wait():
                    rows_d = torch.from_numpy(np.ascontiguousarray(r)).to(d)
                losses.append(shard.train_step(dd, rows_d))
        return torch.cat([t.to(self.devices[0]) for t in losses])

    def validate(self, batches: list) -> torch.Tensor:
        out = []
        for shard, b, d in zip(self.shards, batches, self.devices):
            with device_context(d):
                out.append(shard.validate(b))
        return torch.cat([t.to(self.devices[0]) for t in out])

    def final_state(self):
        """(float32 parameters, buffers) of all K trials, on the first
        device."""
        states = [s.final_state() for s in self.shards]
        d0 = self.devices[0]
        cat = lambda trees: {n: torch.cat([t[n].to(d0) for t in trees]) for n in trees[0]}
        return cat([p for p, _ in states]), cat([b for _, b in states])

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        parts = [s.state_tensors() for s in self.shards]
        out = {k: (v if k.startswith("gen/") else
                   torch.cat([p[k].detach().cpu() for p in parts]))
               for k, v in parts[0].items()}
        return out

    def load_state_tensors(self, tensors: Dict[str, torch.Tensor], count: int) -> None:
        for shard, sl in zip(self.shards, self.parts):
            shard.load_state_tensors({k: v if k.startswith("gen/") else v[sl]
                                      for k, v in tensors.items()}, count)

    def moment_layout(self) -> list:
        """The whole round's optimizer state layout, as one ``_Round`` of K
        trials would hold it."""
        return [((self.K,) + shape[1:], dtype) for shape, dtype in
                _moment_layout(self.shards[0].opt_state)]

    def fit(self, data, train_idx: np.ndarray, val_batch, **kw) -> dict:
        return _fit_round(self, data, train_idx, val_batch, **kw)


def _moment_items(state) -> Dict[str, torch.Tensor]:
    """The moment tensors of an SR-Adam or Adam state by checkpoint name:
    ``m/{i}`` and ``v/{i}``, an 8-bit moment as ``m/{i}/q`` and ``m/{i}/s``."""
    out = {}
    for tag, moments in zip(("m", "v"), _moments(state)):
        for i, t in enumerate(moments):
            if isinstance(t, Q8):
                out[f"{tag}/{i}/q"], out[f"{tag}/{i}/s"] = t.q, t.s
            else:
                out[f"{tag}/{i}"] = t
    return out


def _moment_layout(state) -> list:
    return [(tuple(t.shape), str(t.dtype)) for t in _moment_items(state).values()]


def _moments(state):
    """The two moment lists of an SR-Adam or Adam state."""
    return (state.m, state.v) if isinstance(state, SRAdamState) else (state.mu, state.nu)


def _with_count(state, count: int):
    if isinstance(state, SRAdamState):
        return SRAdamState(state.m, state.v, count)
    return AdamState(count, state.mu, state.nu)


class _RoundCheckpoint:
    """One round's state in ``directory/round.safetensors``
    (``train/checkpoint.py``), tagged with the round's fingerprint."""

    def __init__(self, directory: str, fingerprint: str, K: int):
        self.path = os.path.join(os.path.abspath(directory), "round.safetensors")
        self.fingerprint, self.K = fingerprint, K
        os.makedirs(os.path.dirname(self.path), exist_ok=True)

    def save(self, trial_round: "_Round", best, best_epoch, stall, epochs_run: int) -> None:
        from ..train.checkpoint import save_state

        tensors = trial_round.state_tensors()
        tensors.update(best=torch.from_numpy(np.asarray(best, np.float64)),
                       best_epoch=torch.from_numpy(np.asarray(best_epoch, np.int64)),
                       stall=torch.from_numpy(np.asarray(stall, np.int64)))
        save_state(self.path, tensors, {"epochs_run": int(epochs_run), "k": self.K,
                                        "fingerprint": self.fingerprint,
                                        "count": trial_round.count})

    def load(self, trial_round: "_Round"):
        """(best, best_epoch, stall, epochs_run) restored into ``trial_round``,
        or None (no file, or a foreign or stale one: a warning)."""
        from ..train.checkpoint import load_state

        if not os.path.exists(self.path):
            return None
        try:
            tensors, meta = load_state(self.path)
            if int(meta["k"]) != self.K:
                raise ValueError("trial count changed")
            if meta["fingerprint"] != self.fingerprint:
                raise ValueError("different trial round")
            trial_round.load_state_tensors(tensors, int(meta["count"]))
        except Exception as e:  # a stale or foreign round: start fresh
            print(f"[WARN] Trial-round checkpoint not resumable ({e}); starting fresh")
            return None
        epochs_run = int(meta["epochs_run"])
        print(f"[INFO] Resumed trial round from epoch {epochs_run} "
              f"({os.path.dirname(self.path)})")
        return (tensors["best"].numpy().copy(), tensors["best_epoch"].numpy().copy(),
                tensors["stall"].numpy().copy(), epochs_run)

    def clear(self) -> None:
        if os.path.exists(self.path):
            os.remove(self.path)


def _round_fingerprint(trial_round, *, lrs, seeds, train_idx, val_idx, batch_size: int,
                       max_epochs: int, chunk: int, early_stop_patience: int,
                       moment_dtype: str, param_dtype: str) -> str:
    """The identity of a round (trials.py:514-560 of the JAX package): its
    class, config and conv type, lrs, seeds, schedule, split rows, moment and
    parameter types and the optimizer's state layout (its kind, each moment
    tensor's shape and type, as one unsharded round holds them: a mesh does
    not change the identity)."""
    model = trial_round.model
    config = sorted((k, str(v)) for k, v in (getattr(model, "config", None) or {}).items())
    ident = (type(model).__name__ + repr(config) + str(getattr(model, "gnn_conv_type", ""))
             + trial_round.opt_kind + repr(trial_round.moment_layout()))
    return hashlib.sha256(
        np.asarray(lrs, np.float64).tobytes() + np.asarray(seeds, np.int64).tobytes()
        + np.asarray([batch_size, max_epochs, chunk, early_stop_patience], np.int64).tobytes()
        + np.asarray(train_idx).tobytes() + np.asarray(val_idx).tobytes()
        + moment_dtype.encode() + param_dtype.encode() + ident.encode()
    ).hexdigest()[:16]


def _val_batch(data: dict, val_idx: np.ndarray, device) -> dict:
    """The validation rows: one (n_val, ...) batch where every trial has the
    same rows, else (K, n_val, ...)."""
    shared = bool(np.all(val_idx == val_idx[:1]))
    rows = val_idx[0] if shared else val_idx
    with host_wait():
        rows = torch.from_numpy(np.ascontiguousarray(rows)).to(device)
    return _gather(data, rows)


def _make_round(model, params, buffers, *, lrs, seeds, mesh=None, **kw):
    """A ``_Round``, or a ``_ShardedRound`` over ``mesh``'s trial axis."""
    if mesh is None:
        return _Round(model, params, buffers, lrs=lrs, seeds=seeds, **kw)
    return _ShardedRound(model, params, buffers, lrs=lrs, seeds=seeds, mesh=mesh, **kw)


def _round_inputs(trial_round, data: dict, val_idx: np.ndarray):
    """(training data, validation batch) of a round: as they are for one
    round, on every shard's device for a sharded one."""
    if isinstance(trial_round, _ShardedRound):
        shards = trial_round.shard_data(data)
        return shards, trial_round.val_batches(shards, val_idx)
    return data, _val_batch(data, val_idx, trial_round.device)


def vmapped_grid_fit(model, dataset, *, start_params=None, start_stats=None,
                     lrs, seeds, train_idx, val_idx, masks=None, aux=None,
                     batch_size: int = 32, max_epochs: int = 50,
                     early_stop_patience: int = -1, moment_dtype: str = "bfloat16",
                     param_dtype: str = "float32", mesh=None,
                     host_work: Optional[Callable[[float], object]] = None,
                     on_epoch_end: Optional[Callable] = None) -> dict:
    """Train T trials with per-trial data splits concurrently.

    Every trial sees its own train/val rows of the dataset (``train_idx``
    (T, n_tr), ``val_idx`` (T, n_val)), its own lr and seed and optionally its
    own element masks (per leaf, in the JAX flatten order and Flax layout,
    ``parallel/hetero.py``) and ``aux`` (a padded VAE round's per-trial
    ``latent_mask`` and ``latent_dim``, put in every batch as ``_aux``).
    ``start_params`` / ``start_stats``: None for fresh per-seed parameters,
    or the state (parameters and buffers by ``state_dict`` name) of one model
    broadcast to all trials, or stacked (T, ...) states. ``param_dtype`` and
    ``moment_dtype`` take JAX's defaults: float32 parameters with bfloat16
    Adam moments (the fine-tuner's grid); ``"bfloat16_sr"`` runs SR-bf16
    Adam (the HPO rounds), with 8-bit moments for ``moment_dtype="int8"``.
    ``mesh`` splits the T trials over its ``trial`` axis (``_ShardedRound``;
    JAX's callers pass a mesh only where T divides evenly). ``on_epoch_end``
    goes to ``_fit_round``. Returns {best_val_loss (T,), best_epoch (T,),
    epochs_run}."""
    T = len(lrs)
    train_idx, val_idx = np.asarray(train_idx), np.asarray(val_idx)
    stacked = stacked_model(model, T)
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
    trial_round = _make_round(model, params, buffers, lrs=lrs, seeds=seeds, mesh=mesh,
                              masks=masks, aux=aux, param_dtype=param_dtype,
                              moment_dtype=moment_dtype)
    data, val_batch = _round_inputs(trial_round, model.make_batch(dataset), val_idx)
    out = trial_round.fit(data, train_idx, val_batch,
                          batch_size=batch_size, max_epochs=max_epochs,
                          early_stop_patience=early_stop_patience, host_work=host_work,
                          on_epoch_end=on_epoch_end)
    return {k: out[k] for k in ("best_val_loss", "best_epoch", "epochs_run")}


class ParallelTrials:
    """Train K trials of one model template concurrently on one split.

    ``mesh`` splits the trials over its ``trial`` axis; ``moment_dtype``
    ("bfloat16", "float32", "int8" or "int8_m") and ``param_dtype``
    ("bfloat16_sr", the default, or "float32") take JAX's defaults: SR-bf16
    parameters with mirrored (bfloat16) moments, 8-bit ones for "int8"; with
    float32 parameters the Adam chain stores its moments as ``moment_dtype``
    (bfloat16 for the 8-bit names, as JAX falls back)."""

    def __init__(self, model, dataset, mesh=None, moment_dtype: str = "bfloat16",
                 param_dtype: str = "bfloat16_sr"):
        self.model = model
        self.dataset = dataset
        self.mesh = mesh
        self.moment_dtype = moment_dtype
        self.param_dtype = param_dtype
        self._data = None
        # wall time of the last epoch per trial count: budgets host_work
        # across run() calls (HPO rounds repeat the shape)
        self._epoch_wall_est: Dict[int, float] = {}

    def run(self, lrs, seeds, *, train_idx, val_idx, batch_size: int, max_epochs: int,
            early_stop_patience: int = -1, epochs_per_eval: int = 5,
            checkpoint_dir: Optional[str] = None,
            host_work: Optional[Callable[[float], object]] = None,
            on_epoch_end: Optional[Callable] = None) -> dict:
        """Train len(lrs) fresh trials (trial k initialised from seeds[k]) on
        one train/validation split, as the sequential objective evaluates
        each trial. Returns per-trial best validation losses and epochs,
        ``epochs_run``, and the final float32 ``final_params`` and
        ``final_buffers`` (stacked, by ``state_dict`` name). ``checkpoint_dir``
        saves the round every ``epochs_per_eval`` epochs and resumes a rerun
        of the same round from it (into any split over a mesh);
        ``on_epoch_end`` goes to ``_fit_round``."""
        K = len(lrs)
        if self._data is None:  # the dataset stays on the device across rounds
            self._data = self.model.make_batch(self.dataset)
        tiled_train = np.tile(np.asarray(train_idx), (K, 1))
        tiled_val = np.tile(np.asarray(val_idx), (K, 1))
        params, buffers = _init_stacked(self.model, seeds)
        trial_round = _make_round(self.model, params, buffers, lrs=lrs, seeds=seeds,
                                  mesh=self.mesh, param_dtype=self.param_dtype,
                                  moment_dtype=self.moment_dtype)
        checkpoint = None
        if checkpoint_dir is not None:
            fp = _round_fingerprint(
                trial_round, lrs=lrs, seeds=seeds, train_idx=train_idx, val_idx=val_idx,
                batch_size=batch_size, max_epochs=max_epochs,
                chunk=max(int(epochs_per_eval), 1), early_stop_patience=early_stop_patience,
                moment_dtype=self.moment_dtype, param_dtype=self.param_dtype)
            checkpoint = _RoundCheckpoint(checkpoint_dir, fp, K)
        data, val_batch = _round_inputs(trial_round, self._data, tiled_val)
        out = trial_round.fit(data, tiled_train, val_batch,
                              batch_size=batch_size, max_epochs=max_epochs,
                              early_stop_patience=early_stop_patience, host_work=host_work,
                              wall_est=self._epoch_wall_est.get(K), checkpoint=checkpoint,
                              epochs_per_eval=epochs_per_eval, on_epoch_end=on_epoch_end)
        self._epoch_wall_est[K] = out.pop("epoch_wall_s")
        return out
