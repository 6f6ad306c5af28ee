"""Hyperparameter optimisation, sequential path.

Counterpart of ``flexynesis_tpu/train/hpo.py`` (``HyperparameterTuning``,
``get_batch_space``, ``objective`` and ``perform_tuning``; reference
main.py:28-456): GP Bayesian optimisation with 10 initial points, one trial
per suggestion trained with a validation split, HPO-level patience, the YAML
search-space override and the dataset-size-derived batch-size space
(main.py:183-190). The same seed gives the same suggestions, splits and
batch-size space as the JAX package; the trained models differ, because the
two packages draw initial weights and dropout masks from different generators.

Not ported yet, and refused by the CLI: batches of suggestions trained at once
and cross-validated trials (the JAX package's vmapped trial engine, ROADMAP
A.8), and the HPO state checkpoint.
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

    def objective(self, params: dict):
        """Train with ``params`` on a validation split; returns (val_loss,
        epochs_run, model) (main.py:228-332). Training on the full set, which
        the JAX package does after cross-validation or a resumed tuning run,
        waits for ROADMAP A.8 and item 9."""
        model = self.model_class(**self._model_args(params))
        train_idx, val_idx = train_val_split(self.n_units, self.val_size, seed=self.seed)
        res = model.fit(
            self.dataset, train_idx, val_idx, lr=params["lr"],
            batch_size=int(params["batch_size"]), max_epochs=int(params["epochs"]),
            early_stop_patience=self.early_stop_patience, seed=self.seed,
        )
        return float(res.val_loss), int(res.epochs_run), model

    def perform_tuning(self, hpo_patience: int = 0):
        """One GP suggestion per round, trained and told in turn; returns the
        best model and its parameters (``epochs`` set to the epochs it ran)."""
        opt = BayesianOptimizer(self.space, n_initial_points=10, seed=self.seed)
        best_loss = np.inf
        best_params = None
        best_epochs = 0
        best_model = None
        no_improvement = 0
        for i in range(1, self.n_iter + 1):
            (params,) = opt.ask(1)
            t0 = time.perf_counter()
            loss, epochs, model = self.objective(params)
            opt.tell(params, loss)
            if loss < best_loss:
                best_loss, best_params, best_epochs, best_model = loss, dict(params), epochs, model
                no_improvement = 0
            else:
                no_improvement += 1
            print(f"[INFO] HPO iter {i}/{self.n_iter}: loss={loss:.4f} "
                  f"best={best_loss:.4f} ({time.perf_counter() - t0:.1f}s) "
                  f"params={params}")
            if hpo_patience > 0 and no_improvement >= hpo_patience:
                print(f"[INFO] No improvement for {hpo_patience} HPO iterations — "
                      "stopping early.")
                break
        if best_params is None:
            raise RuntimeError("no HPO trial produced a finite validation loss")
        best_params["epochs"] = max(best_epochs, 1)
        return best_model, best_params
