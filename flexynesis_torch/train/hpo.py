"""Hyperparameter optimisation.

Counterpart of ``flexynesis_tpu/train/hpo.py`` (``HyperparameterTuning``;
reference main.py:28-456): GP Bayesian optimisation with 10 initial points,
trials trained on a validation split or by k-fold CV (``use_cv``),
HPO-level patience, the YAML search-space override and the
dataset-size-derived batch-size space (main.py:183-190). The same seed gives
the same suggestions, splits, folds and batch-size space as the JAX package;
the trained models differ, because the two packages draw initial weights and
noise from different generators.

``batch_ask`` suggestions per GP round: one trains as one sequential trial
(``objective``); several suggestions (of any of the five classes) train at
once on the trial engine (``parallel/trials.py``), grouped by
``_bucket_by_architecture``:

* a group of one architecture (only ``lr`` differs) is one stacked program
  (``_run_parallel_group``): ``ParallelTrials`` with SR-bf16 Adam and one
  shared seed, so the trials share initialisation, batches and dropout;
* a group of mixed architectures (the usual case: the default space samples
  latent, hidden factor and supervisor widths) trains padded to its largest
  dims with element masks (``_run_parallel_group_hetero``,
  ``parallel/hetero.py``), each trial from its own seed; a GNN group also
  shares its conv count, activation and readout. As in JAX, only the
  classes whose class name is in ``PADDABLE_MODELS`` form such groups:
  supervised_vae's suggestions (class ``SupervisedVAE``) group by
  architecture identity, so a sampled architecture trains alone.

Every stacked round (same-architecture, mixed, CV) splits its trials over a
trial mesh (``_trial_mesh``, hpo.py:166-182 of the JAX package): an explicit
``mesh=`` where the round's trial count divides over it, else the local
devices of the tuner's type where it divides evenly over more than one; the
same-architecture engines are cached per architecture and mesh size.

MultiTripletNetwork trains over anchors (samples with a first-target label):
its splits, folds and batch-size space count anchors (``n_units``). The GNN's
conv type (``gnn_conv_type``) is fixed for a tuner and reaches every model and
template it builds (``_model_args``).

With ``use_cv`` the ``cv_splits`` (k, 5 by default and from the CLI) folds
run on the same engine while ``parallel_folds`` is True (the default, as in
JAX): the folds of one suggestion as one stacked program
(``_objective_cv_parallel``), and a group of K suggestions as one program of
K x k trials (``_run_parallel_group_cv``), padded where the architectures
differ; each suggestion scores the mean of its folds' best validation
losses. Folds are ``equal_kfold_indices`` (n % k rows trimmed). Setting
``parallel_folds = False`` gives JAX's sequential fold fits (hpo.py:199-228):
each suggestion trains alone, k fresh ``model.fit`` runs over
``kfold_indices`` (no rows trimmed), and no pipelined ask is made.

With ``pipeline_ask`` the next round's suggestions (``AskSession``, with this
round's as constant-liar pending) are computed in the gaps while a round
trains. A batched round and a CV run keep no model, so the best
configuration is retrained on the whole training set at the end
(``objective(full_train=True)``).

``checkpoint_path`` (the CLI's ``--hpo_checkpoint``) makes a long search
preemption-safe, as in JAX (hpo.py:271-298, :480-530): after every tell the
GP's ``state_dict()``, the best parameters, loss and epochs, the iteration
and ``config_name`` go to that JSON file (written to ``<path>.tmp``, then
``os.replace``-d), and a rerun resumes from it. The file is plain JSON, so a
state the JAX CLI wrote resumes here and the reverse. Each same-architecture
group's stacked round also checkpoints mid-round in its own
``<path>.round-<sha256[:12]>`` directory (``parallel/trials.py``), removed
when the round ends; that file is the port's own format and is not shared
with the JAX package.

``plot_losses`` (notebooks) draws a ``LiveLossPlot`` (``train/live_plot.py``)
per trial after each epoch: for a sequential trial, and for each trial and
CV fold of a stacked round from the round's per-trial losses. JAX draws one
only on its sequential paths (hpo.py:209-216); its stacked rounds draw none.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import List, Optional

import numpy as np

from ..config import get_search_space
from ..utils.device import resolve_device
from .gp import BayesianOptimizer
from .space import Categorical, SearchSpace, load_and_convert_config
from .trainer import kfold_indices, train_val_split


class HyperparameterTuning:
    def __init__(
        self,
        dataset,
        model_class,
        config_name: str,
        target_variables: List[str],
        batch_variables: Optional[List[str]] = None,
        surv_event_var: Optional[str] = None,
        surv_time_var: Optional[str] = None,
        n_iter: int = 10,
        config_path: Optional[str] = None,
        plot_losses: bool = False,
        val_size: float = 0.2,
        use_cv: bool = False,
        cv_splits: int = 5,
        use_loss_weighting: bool = True,
        early_stop_patience: int = -1,
        device_type: Optional[str] = None,
        seed: int = 42,
        device="auto",
        gnn_conv_type: Optional[str] = None,
        input_layers: Optional[List[str]] = None,
        output_layers: Optional[List[str]] = None,
        batch_ask: int = 1,
        pipeline_ask: bool = True,
        checkpoint_path: Optional[str] = None,
        mesh=None,
    ):
        self.dataset = dataset
        self.model_class = model_class
        self.config_name = config_name
        self.target_variables = target_variables
        self.batch_variables = batch_variables
        self.surv_event_var = surv_event_var
        self.surv_time_var = surv_time_var
        self.n_iter = n_iter
        self.plot_losses = plot_losses
        self.val_size = val_size
        self.use_cv = use_cv
        self.n_splits = cv_splits
        self.use_loss_weighting = use_loss_weighting
        self.early_stop_patience = early_stop_patience
        self.device_type = device_type
        self.seed = seed
        self.device = device
        self.gnn_conv_type = gnn_conv_type
        self.input_layers = input_layers
        self.output_layers = output_layers
        # the triplet model trains over anchors (reference main.py:159-162)
        self.n_units = model_class.n_units(dataset, target_variables)
        self.batch_ask = max(int(batch_ask), 1)
        self.pipeline_ask = bool(pipeline_ask)
        self.checkpoint_path = checkpoint_path
        self._host_work = None
        # templates and trial engines reused across GP rounds (the dataset
        # stays on the device for each engine)
        self._templates: dict = {}
        self._pts: dict = {}
        # an explicit trial mesh, or None: a mesh per round over the local
        # devices where the round splits evenly (_trial_mesh)
        self.mesh = mesh
        # CV folds train as one stacked program; False fits them one after
        # another, as the reference does (JAX's hpo.py:102-104)
        self.parallel_folds = True

        if config_path:
            external = load_and_convert_config(config_path)
            if self.config_name not in external:
                raise ValueError(
                    f"'{self.config_name}' not found in the provided config file."
                )
            self.space: SearchSpace = external[self.config_name]
        else:
            self.space = get_search_space(self.config_name)
            self.space.append(self.get_batch_space())

    def get_batch_space(self, min_size: int = 32, max_size: int = 128) -> Categorical:
        """Power-of-two batch sizes capped by log2(0.8 * n) (main.py:183-190)."""
        m = int(np.log2(self.n_units * 0.8))
        st = int(np.log2(min_size))
        end = min(int(np.log2(max_size)), m)
        sizes = [int(2**x) for x in range(st, end + 1)] or [min_size]
        return Categorical(sizes, name="batch_size")

    def _model_args(self, params: dict) -> dict:
        args = {
            "config": params,
            "dataset": self.dataset,
            "target_variables": self.target_variables,
            "batch_variables": self.batch_variables,
            "surv_event_var": self.surv_event_var,
            "surv_time_var": self.surv_time_var,
            "use_loss_weighting": self.use_loss_weighting,
            "device_type": self.device_type,
            "device": self.device,
        }
        if self.model_class.__name__ == "GNN":
            args["gnn_conv_type"] = self.gnn_conv_type
        if self.model_class.__name__ == "CrossModalPred":
            args["input_layers"] = self.input_layers
            args["output_layers"] = self.output_layers
        return args

    def objective(self, params: dict, full_train: bool = False):
        """Train with ``params``; returns (val_loss, epochs_run, model), the
        fold means under ``use_cv`` (main.py:228-332). With ``full_train``,
        train on the whole training set for ``params["epochs"]`` epochs and
        return the model (the retrain after batched rounds and CV,
        hpo.py:188-198)."""
        n = self.n_units
        if full_train:
            model = self.model_class(**self._model_args(params))
            model.fit(self.dataset, lr=params["lr"], batch_size=int(params["batch_size"]),
                      max_epochs=int(params["epochs"]), early_stop_patience=-1,
                      seed=self.seed)
            return model
        if self.use_cv:
            if self.parallel_folds:
                return self._objective_cv_parallel(params, n)
            splits = kfold_indices(n, self.n_splits, seed=self.seed)
        else:
            splits = [train_val_split(n, self.val_size, seed=self.seed)]
        losses, epochs = [], []
        for train_idx, val_idx in splits:
            model = self.model_class(**self._model_args(params))
            on_epoch_end = None
            if self.plot_losses:  # a live loss plot per trial and fold (notebooks)
                from .live_plot import LiveLossPlot

                on_epoch_end = LiveLossPlot(hyperparams=params).update
            res = model.fit(
                self.dataset, train_idx, val_idx, lr=params["lr"],
                batch_size=int(params["batch_size"]), max_epochs=int(params["epochs"]),
                early_stop_patience=self.early_stop_patience, seed=self.seed,
                on_epoch_end=on_epoch_end,
            )
            losses.append(res.val_loss)
            epochs.append(res.epochs_run)
        return float(np.mean(losses)), int(np.mean(epochs)), model

    def _trial_mesh(self, n_trials: int):
        """The trial mesh of an ``n_trials`` round, or None (hpo.py:166-182):
        an explicit ``mesh`` where the round splits evenly over it, else
        ``auto_trial_mesh`` over this process's devices of the tuner's type
        (None on one device or for an uneven split)."""
        from ..parallel.mesh import auto_trial_mesh, local_devices

        if self.mesh is not None:
            return self.mesh if n_trials % self.mesh.size == 0 else None
        return auto_trial_mesh(n_trials, local_devices(resolve_device(self.device).type))

    def _objective_cv_parallel(self, params: dict, n: int):
        """The k CV folds of one suggestion as one stacked program
        (hpo.py:232-267): equal folds (n % k rows trimmed; the final retrain
        uses every row), a seed per fold, the suggestion's lr for every fold.
        Returns (mean best validation loss, mean best epoch, None)."""
        from ..parallel.trials import equal_kfold_indices, vmapped_grid_fit

        k = self.n_splits
        tr, va = equal_kfold_indices(n, k, seed=self.seed)
        out = vmapped_grid_fit(
            self._get_template(params), self.dataset,
            lrs=np.full(k, float(params["lr"]), np.float32),
            seeds=np.arange(self.seed, self.seed + k),
            train_idx=tr, val_idx=va,
            batch_size=int(params["batch_size"]), max_epochs=int(params["epochs"]),
            early_stop_patience=self.early_stop_patience, param_dtype="bfloat16_sr",
            mesh=self._trial_mesh(k), on_epoch_end=self._stacked_plots([params] * k),
        )
        avg_loss = float(np.mean(out["best_val_loss"]))
        avg_epochs = int(np.mean(out["best_epoch"]))
        print(f"[INFO] {k}-fold CV (stacked, concurrent): avg val loss {avg_loss:.4f}")
        return avg_loss, avg_epochs, None

    def _stacked_plots(self, trial_params: List[dict]):
        """With ``plot_losses``, a live loss plot per trial of a stacked round
        (each CV fold its own, as JAX plots each fold), fed by the round's
        ``on_epoch_end``; else None."""
        if not self.plot_losses:
            return None
        from .live_plot import LiveLossPlot

        plots = [LiveLossPlot(hyperparams=p) for p in trial_params]

        def on_epoch_end(epoch, train_losses, val_losses):
            for plot, t, v in zip(plots, train_losses, val_losses):
                plot.update(epoch, float(t), float(v))
        return on_epoch_end

    # ------------------------------------------------------- batched rounds

    def _template_key(self, params: dict) -> tuple:
        return tuple((k, params[k]) for k in sorted(params) if k != "lr")

    def _get_template(self, params: dict):
        """Model template for an architecture, cached across GP rounds."""
        key = self._template_key(params)
        if key not in self._templates:
            self._templates[key] = self.model_class(**self._model_args(params))
        return self._templates[key]

    # the families whose parameters pad to a common max shape
    # (parallel/hetero.py), by class name as JAX checks them (hpo.py:302-309):
    # the class SupervisedVAE is not "supervised_vae", so its suggestions
    # group by architecture identity, in JAX and here
    PADDABLE_MODELS = ("DirectPred", "MultiTripletNetwork", "supervised_vae",
                       "CrossModalPred", "GNN")

    def _bucket_by_architecture(self, suggestions):
        """Group suggestions that can train as one stacked program
        (hpo.py:311-334): for a paddable class only epochs and batch size
        must match (``hetero.bucket_key``), the architecture dims pad to the
        group's maximum; other classes group by architecture identity, lr
        free."""
        from ..parallel.hetero import bucket_key

        name = self.model_class.__name__
        buckets: dict = {}
        for params in suggestions:
            key = (bucket_key(name, params) if name in self.PADDABLE_MODELS
                   else tuple((k, params[k]) for k in sorted(params) if k != "lr"))
            buckets.setdefault(key, []).append(params)
        return list(buckets.values())

    def _arch_identical(self, group) -> bool:
        keys = [tuple((k, p[k]) for k in sorted(p) if k != "lr") for p in group]
        return len(set(keys)) == 1

    def _group_results(self, out, n):
        return [(float(out["best_val_loss"][k]), int(out["best_epoch"][k]), None)
                for k in range(n)]

    def _run_parallel_group(self, group):
        """A same-architecture group: one stacked program, lr per trial, one
        shared seed (hpo.py:457-512)."""
        from ..parallel.trials import ParallelTrials

        train_idx, val_idx = train_val_split(self.n_units, self.val_size, seed=self.seed)
        mesh = self._trial_mesh(len(group))
        # one engine per architecture and mesh size (hpo.py:464-471)
        key = (self._template_key(group[0]), 0 if mesh is None else mesh.size)
        pt = self._pts.get(key)
        if pt is None:
            pt = self._pts[key] = ParallelTrials(self._get_template(group[0]), self.dataset,
                                                 mesh=mesh)
        print(f"[INFO] Training {len(group)} same-architecture trials concurrently (stacked)")
        # the round checkpoints mid-round beside the JSON state, in a
        # directory of its own (keyed by its suggestions), so replaying
        # earlier groups after a restart cannot clobber it
        ckpt_dir = None
        if self.checkpoint_path:
            digest = hashlib.sha256(
                json.dumps(group, sort_keys=True, default=str).encode()).hexdigest()[:12]
            ckpt_dir = f"{self.checkpoint_path}.round-{digest}"
        out = pt.run(
            lrs=np.asarray([p["lr"] for p in group], np.float32),
            seeds=np.full(len(group), self.seed, np.int64),
            train_idx=train_idx, val_idx=val_idx,
            batch_size=int(group[0]["batch_size"]), max_epochs=int(group[0]["epochs"]),
            early_stop_patience=self.early_stop_patience, checkpoint_dir=ckpt_dir,
            host_work=self._host_work, on_epoch_end=self._stacked_plots(group),
        )
        if ckpt_dir is not None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        # no model is kept per trial: the best configuration retrains at the
        # end of perform_tuning
        return self._group_results(out, len(group))

    def _run_parallel_group_hetero(self, group):
        """A mixed-architecture group: parameters padded to the group's
        largest dims, one stacked program with per-trial element masks, each
        trial from its own seed (hpo.py:340-385)."""
        from ..parallel.hetero import build_padded_trials, max_config
        from ..parallel.trials import vmapped_grid_fit

        K = len(group)
        train_idx, val_idx = train_val_split(self.n_units, self.val_size, seed=self.seed)
        template_cfg = dict(group[0])
        template_cfg.update(max_config(group, [
            len(self.dataset.features[k]) for k in self.dataset.dat.keys()]))
        template = self._get_template(template_cfg)
        seeds = np.arange(self.seed, self.seed + K)
        trials = build_padded_trials(template, group, seeds)
        print(f"[INFO] Training {K} mixed-architecture trials concurrently "
              "(padded, stacked)")
        out = vmapped_grid_fit(
            template, self.dataset,
            start_params=trials["params"], start_stats=trials["buffers"],
            lrs=np.asarray([p["lr"] for p in group], np.float32), seeds=seeds,
            train_idx=np.tile(train_idx, (K, 1)), val_idx=np.tile(val_idx, (K, 1)),
            masks=trials["masks"], aux=trials.get("aux"),
            batch_size=int(group[0]["batch_size"]), max_epochs=int(group[0]["epochs"]),
            early_stop_patience=self.early_stop_patience, param_dtype="bfloat16_sr",
            mesh=self._trial_mesh(K), host_work=self._host_work,
            on_epoch_end=self._stacked_plots(group),
        )
        return self._group_results(out, K)

    def _run_parallel_group_cv(self, group):
        """K suggestions x k CV folds as one stacked program of K x k trials
        (hpo.py:387-455): the fold tables tiled across the suggestions, each
        suggestion's lr repeated across its folds, the per-fold seeds tiled
        (as K runs of ``_objective_cv_parallel``), padded to the group's
        largest dims with each suggestion's masks repeated across its folds
        where the architectures differ. Each suggestion scores its fold
        means."""
        from ..parallel.trials import equal_kfold_indices, vmapped_grid_fit

        n, k, K = self.n_units, self.n_splits, len(group)
        tr, va = equal_kfold_indices(n, k, seed=self.seed)
        lrs = np.repeat(np.asarray([p["lr"] for p in group], np.float32), k)
        seeds = np.tile(np.arange(self.seed, self.seed + k), K)
        if self._arch_identical(group):
            template = self._get_template(group[0])
            trials: dict = {}
        else:
            from ..parallel.hetero import build_padded_trials, max_config

            template_cfg = dict(group[0])
            template_cfg.update(max_config(group, [
                len(self.dataset.features[key]) for key in self.dataset.dat.keys()]))
            template = self._get_template(template_cfg)
            trials = build_padded_trials(template, [p for p in group for _ in range(k)], seeds)
        print(f"[INFO] Training {K} suggestions x {k} CV folds = {K * k} trials "
              "concurrently (stacked)")
        out = vmapped_grid_fit(
            template, self.dataset,
            start_params=trials.get("params"), start_stats=trials.get("buffers"),
            lrs=lrs, seeds=seeds, train_idx=np.tile(tr, (K, 1)), val_idx=np.tile(va, (K, 1)),
            masks=trials.get("masks"), aux=trials.get("aux"),
            batch_size=int(group[0]["batch_size"]), max_epochs=int(group[0]["epochs"]),
            early_stop_patience=self.early_stop_patience, param_dtype="bfloat16_sr",
            mesh=self._trial_mesh(K * k), host_work=self._host_work,
            on_epoch_end=self._stacked_plots([p for p in group for _ in range(k)]),
        )
        loss = np.asarray(out["best_val_loss"]).reshape(K, k).mean(axis=1)
        ep = np.asarray(out["best_epoch"]).reshape(K, k).mean(axis=1)
        return [(float(loss[i]), int(round(ep[i])), None) for i in range(K)]

    # -------------------------------------------------------------- tuning

    def _save_checkpoint(self, opt, best_params, best_loss, best_epochs, iteration) -> None:
        """The HPO state as JSON (hpo.py:271-285), replaced atomically."""
        if not self.checkpoint_path:
            return
        state = {
            "optimizer": opt.state_dict(),
            "best_params": best_params,
            "best_loss": best_loss,
            "best_epochs": best_epochs,
            "iteration": iteration,
            "config_name": self.config_name,
        }
        tmp = self.checkpoint_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(state, fh)
        os.replace(tmp, self.checkpoint_path)

    def _load_checkpoint(self, opt):
        """The saved state, loaded into ``opt``, when the file exists and
        belongs to this config (hpo.py:287-298); else None."""
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            with open(self.checkpoint_path) as fh:
                state = json.load(fh)
            if state.get("config_name") == self.config_name:
                opt.load_state_dict(state["optimizer"])
                print(f"[INFO] Resuming HPO from iteration {state['iteration']} "
                      f"(best loss {state['best_loss']})")
                return state
        return None

    def perform_tuning(self, hpo_patience: int = 0):
        """GP rounds of ``batch_ask`` suggestions, each group trained and told
        in turn (hpo.py:514-617); returns the best model and its parameters
        (``epochs`` set to its best epoch count). A batched round and a CV
        run keep no model, so the best configuration then retrains on the
        full set."""
        opt = BayesianOptimizer(self.space, n_initial_points=10, seed=self.seed)
        best_loss = np.inf
        best_params = None
        best_epochs = 0
        best_model = None
        no_improvement = 0
        i = 0
        resume = self._load_checkpoint(opt)
        if resume is not None:
            best_loss = resume["best_loss"]
            best_params = resume["best_params"]
            best_epochs = resume.get("best_epochs", 0)
            i = resume["iteration"]
        pipeline = self.pipeline_ask and self.batch_ask > 1
        suggestions = opt.ask(min(self.batch_ask, self.n_iter - i)) if i < self.n_iter else []
        while suggestions:
            groups = self._bucket_by_architecture(suggestions)
            # the next round's ask runs in this round's gaps, with this
            # round's suggestions pending, if a group trains on the engine
            # (sequential CV folds train no group there)
            q_next = min(self.batch_ask, self.n_iter - i - len(suggestions))
            drains = any(len(g) > 1 for g in groups) and (
                not self.use_cv or self.parallel_folds)
            session = (opt.ask_session(q_next, pending=suggestions)
                       if pipeline and drains and q_next > 0 else None)
            self._host_work = session.work if session is not None else None
            for group in groups:
                t0 = time.perf_counter()
                results = None
                if len(group) > 1 and self.use_cv and self.parallel_folds:
                    # suggestions x folds train as one program of K x k trials
                    results = self._run_parallel_group_cv(group)
                elif len(group) > 1 and not self.use_cv:
                    results = (self._run_parallel_group(group) if self._arch_identical(group)
                               else self._run_parallel_group_hetero(group))
                for gi, params in enumerate(group):
                    loss, epochs, model = (results[gi] if results is not None
                                           else self.objective(params))
                    opt.tell(params, loss)
                    i += 1
                    if loss < best_loss:
                        best_loss, best_params, best_epochs, best_model = (
                            loss, dict(params), epochs, model)
                        no_improvement = 0
                    else:
                        no_improvement += 1
                    print(f"[INFO] HPO iter {i}/{self.n_iter}: loss={loss:.4f} "
                          f"best={best_loss:.4f} ({time.perf_counter() - t0:.1f}s cum. "
                          f"for group) params={params}")
                    self._save_checkpoint(opt, best_params, float(best_loss), best_epochs, i)
            self._host_work = None
            if hpo_patience > 0 and no_improvement >= hpo_patience:
                print(f"[INFO] No improvement for {hpo_patience} HPO iterations — "
                      "stopping early.")
                break
            if session is not None:
                # any ask work the round did not hide
                suggestions = session.finish()
            elif i < self.n_iter:
                suggestions = opt.ask(min(self.batch_ask, self.n_iter - i))
            else:
                suggestions = []
        if best_params is None:
            raise RuntimeError("no HPO trial produced a finite validation loss")
        best_params = dict(best_params)
        best_params["epochs"] = max(best_epochs, 1)
        if self.use_cv or best_model is None:
            # CV keeps no single model: retrain on the full set
            print(f"[INFO] Final full-data training with best params: {best_params}")
            best_model = self.objective(best_params, full_train=True)
        return best_model, best_params
