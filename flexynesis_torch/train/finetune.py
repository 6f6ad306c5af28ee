"""Fine-tuning a trained model on held-out samples (transfer learning).

Counterpart of ``flexynesis_tpu/train/finetune.py`` (reference
main.py:459-659, ``FineTuner``): a grid of 3 learning rates {lr, lr/10,
lr/100} x 3 freeze configurations (encoders frozen / supervisor heads frozen
/ nothing frozen) x k folds of the fine-tuning samples, k = min(n_splits,
max(n // 2, 2)); the (lr, freeze) cell with the lowest mean fold validation
loss wins, and the model retrains on all the fine-tuning samples with it,
for the winning cell's rounded mean stop epoch.

``_grid_parallel`` (the default) trains the whole grid as ONE stacked round
on ``parallel/trials.py::vmapped_grid_fit``: 9 x k trials, each with its own
fold rows (``equal_kfold_indices``, n % k samples trimmed), lr and seed, the
trained state broadcast to every trial, and a 0/1 update mask per trial and
leaf for its freeze configuration; float32 parameters with bfloat16 Adam
moments, as in JAX; split over the local devices' trial mesh where 9 x k
divides evenly (``parallel/mesh.py::auto_trial_mesh``), or over an explicit
``mesh``. With ``fused_kernels`` a DirectPred training step of the
grid is one launch of kernel B1 per block for all trials (each trial's x rows
its own fold's), a validation one launch of B2 per block, and a
supervised_vae's MMD terms one launch of B3 each. ``_grid_sequential`` fits
the cells one at a time with ``Trainer``. Each cell's stop epoch is its best
epoch plus the patience, capped at the epochs the round ran (early stopping
in a stacked round waits for every trial).

Freezing matches the Flax top-level names that start with ``encoder`` or
``head_``; the port's modules carry the Flax names, so a parameter's top-level
name is the first part of its name (``parallel/stacked.py::flax_path``), for
``FusedMLP`` blocks too. The final fit freezes for real: frozen parameters
stay bit-identical (``train/trainer.py``), where JAX's ``Trainer`` lets
``optax.masked`` add their raw gradients (a departure, kept on purpose; the
grid freezes alike in both packages). The running statistics of a frozen
BatchNorm still update, in the grid and in the final fit, as in JAX. A
MultiTripletNetwork's anchor and partner tables are rebuilt over the
fine-tuning samples (JAX keeps the training set's tables, so its anchor
indices point past the fine-tuning set and its gathers clamp them: another
departure, kept on purpose).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .trainer import Trainer, kfold_indices

FREEZE_CONFIGS: List[Dict[str, bool]] = [
    {"encoders": True, "supervisors": False},
    {"encoders": False, "supervisors": True},
    {"encoders": False, "supervisors": False},
]


def _make_mask_fn(freeze: Dict[str, bool]) -> Callable[[str], bool]:
    """callable(top-level name) -> True where the subtree trains."""

    def is_trainable(top: str) -> bool:
        if freeze.get("encoders") and top.startswith("encoder"):
            return False
        if freeze.get("supervisors") and top.startswith("head_"):
            return False
        return True

    return is_trainable


def trial_masks(stacked, freezes: List[Dict[str, bool]], device) -> List[torch.Tensor]:
    """Per-leaf 0/1 update masks of shape (T, 1, ..., 1), in the stacked
    model's leaf order, trial t frozen as ``freezes[t]``."""
    fns = [_make_mask_fn(f) for f in freezes]
    masks = []
    for name in stacked.leaf_names:
        top = stacked.flax_paths[name][0]
        ndim = stacked.net.get_parameter(name).dim()
        col = torch.tensor([float(fn(top)) for fn in fns], dtype=torch.float32, device=device)
        masks.append(col.reshape((-1,) + (1,) * ndim))
    return masks


class FineTuner:
    def __init__(self, model, dataset, n_splits: int = 5, max_epochs: int = 50,
                 early_stop_patience: int = 3, seed: int = 42, mesh=None):
        """``mesh``: an explicit trial mesh for the grid (used where the grid
        splits evenly over it); None takes the shared policy over the local
        devices, as JAX's fine-tuner does."""
        self.model = model
        self.mesh = mesh
        self.dataset = dataset
        self.n_splits = n_splits
        self.max_epochs = max_epochs
        self.early_stop_patience = early_stop_patience
        self.seed = seed
        if hasattr(model, "_build_sampler"):
            # the triplet model draws anchors and partners from tables over the
            # rows it trains on: rebuild them over the fine-tuning samples (JAX
            # keeps the training set's, whose indices overrun this dataset)
            model._build_sampler(dataset)
        base_lr = float(model.config["lr"])
        self.learning_rates = [base_lr, base_lr / 10, base_lr / 100]

    def _state(self) -> Dict[str, torch.Tensor]:
        return {n: t.detach().clone() for n, t in self.model.module.state_dict().items()}

    def _fit_once(self, lr: float, freeze: Dict[str, bool], train_idx, val_idx,
                  max_epochs: Optional[int] = None) -> Tuple[float, dict, int]:
        """One fit from the model's current state, which is left as it was;
        returns (val_loss, the fitted state, epochs_run)."""
        model = self.model
        start = self._state()
        trainer = Trainer(model.module, model.loss_fn, lr=lr,
                          trainable_mask=_make_mask_fn(freeze))
        res = trainer.fit(
            model.make_batch(self.dataset, train_idx),
            model.make_batch(self.dataset, val_idx) if val_idx is not None else None,
            n_samples=len(train_idx), batch_size=min(32, len(train_idx)),
            max_epochs=self.max_epochs if max_epochs is None else max_epochs,
            early_stop_patience=self.early_stop_patience, seed=self.seed,
        )
        model.module.load_state_dict(start)
        return res.val_loss, res.state, res.epochs_run

    def run_experiments(self, parallel: bool = True):
        """The grid (stacked with ``parallel``), then the final fit on every
        fine-tuning sample; the model keeps the fitted state."""
        n = self.model.n_train_samples(self.dataset)
        k = min(self.n_splits, max(n // 2, 2))
        best = self._grid_parallel(n, k) if parallel else self._grid_sequential(n, k)
        _, lr, freeze, final_epochs = best
        # no validation split in the final fit, so no early stopping: cap it
        # at the winning cell's mean stop epoch (reference main.py:647-659)
        final_epochs = max(1, int(round(final_epochs)))
        print(f"[INFO] Final fine-tuning with lr={lr:.2g}, freeze={freeze}, "
              f"epochs={final_epochs}")
        _, state, _ = self._fit_once(lr, freeze, np.arange(n), None, max_epochs=final_epochs)
        self.model.module.load_state_dict(state)
        self.model.module.eval()
        self.final_choice = (lr, freeze, final_epochs)
        return self.model

    def _grid_sequential(self, n: int, k: int):
        folds = kfold_indices(n, k, seed=self.seed)
        best = None
        for lr in self.learning_rates:
            for freeze in FREEZE_CONFIGS:
                losses, epochs = [], []
                for tr, va in folds:
                    loss, _, n_ep = self._fit_once(lr, freeze, tr, va)
                    losses.append(loss)
                    epochs.append(n_ep)
                avg, avg_ep = float(np.mean(losses)), float(np.mean(epochs))
                print(f"[INFO] finetune lr={lr:.2g} freeze={freeze}: "
                      f"avg val loss {avg:.4f} (avg epochs {avg_ep:.1f})")
                if best is None or avg < best[0]:
                    best = (avg, lr, freeze, avg_ep)
        return best

    def _grid_parallel(self, n: int, k: int):
        """Every (lr, freeze, fold) cell as one stacked round."""
        from ..parallel.stacked import stacked_model
        from ..parallel.trials import equal_kfold_indices, vmapped_grid_fit

        model = self.model
        fold_train, fold_val = equal_kfold_indices(n, k, seed=self.seed)
        combos = [(lr, freeze) for lr in self.learning_rates for freeze in FREEZE_CONFIGS]
        T = len(combos) * k
        lrs = np.asarray([lr for lr, _ in combos for _ in range(k)], np.float32)
        masks = trial_masks(stacked_model(model, T),
                            [freeze for _, freeze in combos for _ in range(k)], model.device)
        print(f"[INFO] Fine-tuning grid: {len(combos)} (lr x freeze) combos "
              f"x {k} folds = {T} concurrent stacked fits")
        # the grid splits over the local devices where T divides evenly
        # (the shared policy, parallel/mesh.py::auto_trial_mesh)
        from ..parallel.mesh import auto_trial_mesh, local_devices

        if self.mesh is None:
            mesh = auto_trial_mesh(T, local_devices(model.device.type))
        else:
            mesh = self.mesh if T % self.mesh.size == 0 else None
        state = self._state()
        out = vmapped_grid_fit(
            model, self.dataset, start_params=state, start_stats=state, lrs=lrs,
            seeds=np.arange(self.seed, self.seed + T),
            train_idx=np.tile(fold_train, (len(combos), 1)),
            val_idx=np.tile(fold_val, (len(combos), 1)), masks=masks,
            batch_size=min(32, fold_train.shape[1]), max_epochs=self.max_epochs,
            early_stop_patience=self.early_stop_patience, mesh=mesh,
        )
        per_combo = out["best_val_loss"].reshape(len(combos), k).mean(axis=1)
        # the round stops when every cell has stalled: each cell's own stop
        # epoch is its best epoch + patience, capped at the epochs run
        epochs_run = int(out["epochs_run"])
        stop_ep = np.asarray(out["best_epoch"], dtype=float)
        if self.early_stop_patience > 0:
            stop_ep = np.minimum(stop_ep + self.early_stop_patience, epochs_run)
        else:
            stop_ep = np.full_like(stop_ep, epochs_run)
        per_combo_ep = stop_ep.reshape(len(combos), k).mean(axis=1)
        for (lr, freeze), avg, avg_ep in zip(combos, per_combo, per_combo_ep):
            print(f"[INFO] finetune lr={lr:.2g} freeze={freeze}: "
                  f"avg val loss {avg:.4f} (avg stop epoch {avg_ep:.1f})")
        bi = int(np.argmin(per_combo))
        lr, freeze = combos[bi]
        return float(per_combo[bi]), lr, freeze, float(per_combo_ep[bi])
