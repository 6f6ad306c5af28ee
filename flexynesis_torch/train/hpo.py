"""Hyperparameter optimisation.

Counterpart of ``flexynesis_tpu/train/hpo.py`` (``HyperparameterTuning``;
reference main.py:28-456): GP Bayesian optimisation with 10 initial points,
trials trained on a validation split, HPO-level patience, the YAML
search-space override and the dataset-size-derived batch-size space
(main.py:183-190). The same seed gives the same suggestions, splits and
batch-size space as the JAX package; the trained models differ, because the
two packages draw initial weights and dropout masks from different generators.

``batch_ask`` suggestions per GP round: one trains as one sequential trial
(``objective``); several DirectPred suggestions train at once on the trial
engine (``parallel/trials.py``), grouped by ``_bucket_by_architecture``:

* a group of one architecture (only ``lr`` differs) is one stacked program
  (``_run_parallel_group``): ``ParallelTrials`` with SR-bf16 Adam and one
  shared seed, so the trials share initialisation, batches and dropout;
* a group of mixed architectures (the usual case: the default space samples
  latent, hidden factor and supervisor widths) trains padded to its largest
  dims with element masks (``_run_parallel_group_hetero``,
  ``parallel/hetero.py``), each trial from its own seed.

With ``pipeline_ask`` the next round's suggestions (``AskSession``, with this
round's as constant-liar pending) are computed in the gaps while a round
trains. A batched round keeps no model, so the best configuration is
retrained on the whole training set at the end (``objective(full_train=
True)``).

Not ported yet, and refused by the CLI: cross-validated trials, batched rounds
of the VAE-MMD classes (ROADMAP A item 1) and the HPO state checkpoint.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from ..config import get_search_space
from .gp import BayesianOptimizer
from .space import Categorical, SearchSpace, load_and_convert_config
from .trainer import train_val_split


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
        val_size: float = 0.2,
        use_loss_weighting: bool = True,
        early_stop_patience: int = -1,
        device_type: Optional[str] = None,
        seed: int = 42,
        device="auto",
        input_layers: Optional[List[str]] = None,
        output_layers: Optional[List[str]] = None,
        batch_ask: int = 1,
        pipeline_ask: bool = True,
    ):
        self.dataset = dataset
        self.model_class = model_class
        self.config_name = config_name
        self.target_variables = target_variables
        self.batch_variables = batch_variables
        self.surv_event_var = surv_event_var
        self.surv_time_var = surv_time_var
        self.n_iter = n_iter
        self.val_size = val_size
        self.use_loss_weighting = use_loss_weighting
        self.early_stop_patience = early_stop_patience
        self.device_type = device_type
        self.seed = seed
        self.device = device
        self.input_layers = input_layers
        self.output_layers = output_layers
        self.n_units = len(dataset)
        self.batch_ask = max(int(batch_ask), 1)
        if self.batch_ask > 1 and model_class.__name__ not in self.BATCHED_MODELS:
            raise NotImplementedError(
                f"batched GP rounds of {model_class.__name__} need the VAE-MMD trial "
                "engine (B3's trial axis, supervised_vae_trial_mask, masked_mmd_loss), "
                "not ported to flexynesis_torch yet (ROADMAP A item 1)"
            )
        self.pipeline_ask = bool(pipeline_ask)
        self._host_work = None
        # templates and trial engines reused across GP rounds (the dataset
        # stays on the device for each engine)
        self._templates: dict = {}
        self._pts: dict = {}

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
        if self.model_class.__name__ == "CrossModalPred":
            args["input_layers"] = self.input_layers
            args["output_layers"] = self.output_layers
        return args

    # the model classes whose suggestions train as batched rounds here
    BATCHED_MODELS = ("DirectPred",)

    def objective(self, params: dict, full_train: bool = False):
        """Train with ``params`` on a validation split; returns (val_loss,
        epochs_run, model) (main.py:228-332). With ``full_train``, train on
        the whole training set for ``params["epochs"]`` epochs and return
        the model (the retrain after batched rounds, hpo.py:188-198)."""
        model = self.model_class(**self._model_args(params))
        if full_train:
            model.fit(self.dataset, lr=params["lr"], batch_size=int(params["batch_size"]),
                      max_epochs=int(params["epochs"]), early_stop_patience=-1,
                      seed=self.seed)
            return model
        train_idx, val_idx = train_val_split(self.n_units, self.val_size, seed=self.seed)
        res = model.fit(
            self.dataset, train_idx, val_idx, lr=params["lr"],
            batch_size=int(params["batch_size"]), max_epochs=int(params["epochs"]),
            early_stop_patience=self.early_stop_patience, seed=self.seed,
        )
        return float(res.val_loss), int(res.epochs_run), model

    # ------------------------------------------------------- batched rounds

    def _template_key(self, params: dict) -> tuple:
        return tuple((k, params[k]) for k in sorted(params) if k != "lr")

    def _get_template(self, params: dict):
        """Model template for an architecture, cached across GP rounds."""
        key = self._template_key(params)
        if key not in self._templates:
            self._templates[key] = self.model_class(**self._model_args(params))
        return self._templates[key]

    def _bucket_by_architecture(self, suggestions):
        """Group suggestions that can train as one stacked program: DirectPred
        pads its architecture dims, so only epochs and batch size must match
        (``hetero.bucket_key``)."""
        from ..parallel.hetero import bucket_key

        buckets: dict = {}
        for params in suggestions:
            buckets.setdefault(bucket_key(self.model_class.__name__, params), []).append(params)
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
        key = self._template_key(group[0])
        pt = self._pts.get(key)
        if pt is None:
            pt = self._pts[key] = ParallelTrials(self._get_template(group[0]), self.dataset)
        print(f"[INFO] Training {len(group)} same-architecture trials concurrently (stacked)")
        out = pt.run(
            lrs=np.asarray([p["lr"] for p in group], np.float32),
            seeds=np.full(len(group), self.seed, np.int64),
            train_idx=train_idx, val_idx=val_idx,
            batch_size=int(group[0]["batch_size"]), max_epochs=int(group[0]["epochs"]),
            early_stop_patience=self.early_stop_patience, host_work=self._host_work,
        )
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
            masks=trials["masks"],
            batch_size=int(group[0]["batch_size"]), max_epochs=int(group[0]["epochs"]),
            early_stop_patience=self.early_stop_patience, host_work=self._host_work,
        )
        return self._group_results(out, K)

    # -------------------------------------------------------------- tuning

    def perform_tuning(self, hpo_patience: int = 0):
        """GP rounds of ``batch_ask`` suggestions, each group trained and told
        in turn (hpo.py:514-617); returns the best model and its parameters
        (``epochs`` set to its best epoch count). A batched round keeps no
        model, so the best configuration then retrains on the full set."""
        opt = BayesianOptimizer(self.space, n_initial_points=10, seed=self.seed)
        best_loss = np.inf
        best_params = None
        best_epochs = 0
        best_model = None
        no_improvement = 0
        i = 0
        pipeline = self.pipeline_ask and self.batch_ask > 1
        suggestions = opt.ask(min(self.batch_ask, self.n_iter)) if self.n_iter > 0 else []
        while suggestions:
            groups = self._bucket_by_architecture(suggestions)
            # the next round's ask runs in this round's gaps, with this
            # round's suggestions pending, if a group trains on the engine
            q_next = min(self.batch_ask, self.n_iter - i - len(suggestions))
            session = (opt.ask_session(q_next, pending=suggestions)
                       if pipeline and any(len(g) > 1 for g in groups) and q_next > 0
                       else None)
            self._host_work = session.work if session is not None else None
            for group in groups:
                t0 = time.perf_counter()
                results = None
                if len(group) > 1:
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
        best_params["epochs"] = max(best_epochs, 1)
        if best_model is None:
            print(f"[INFO] Final full-data training with best params: {best_params}")
            best_model = self.objective(best_params, full_train=True)
        return best_model, best_params
