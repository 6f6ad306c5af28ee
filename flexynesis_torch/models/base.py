"""Host-side model scaffolding.

Counterpart of ``flexynesis_tpu/models/base.py``: ``BaseModel`` holds config,
dataset metadata and the ``nn.Module``; it trains (``make_batch``,
``loss_fn``, ``fit``) and serves ``predict`` and ``transform``. The module is
built on the ``meta`` device and moved to the model's device without drawing
numbers; ``init_params`` fills it from a seeded ``torch.Generator`` and
``inference.reconstruct_model`` loads saved weights into it.
``compute_feature_importance`` runs marker finding (``interpret/``).

Subclasses extend ``loss_fn`` through ``_extra_losses(out, batch, generator)``
(the VAE's MMD) and ``make_batch`` through ``batch_layers`` (CrossModalPred's
reconstruction targets).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops.collectives import forward_rows
from ..ops.losses import compute_total_loss, cox_ph_loss, masked_ce_loss, masked_mse_loss
from ..utils.csvio import Table
from ..utils.device import resolve_device


def num_classes_for(ann_values: np.ndarray) -> int:
    """Output width of a categorical head: count of distinct encoded labels
    (NaN counts as one extra pseudo-class, as in the reference)."""
    return int(np.unique(np.asarray(ann_values)).size)


def supervised_loss_terms(outputs: Dict[str, torch.Tensor], y: Dict[str, torch.Tensor],
                          variables: List[str], variable_types: Dict[str, str],
                          surv_event_var: Optional[str],
                          surv_time_var: Optional[str]) -> Dict[str, torch.Tensor]:
    """Per-variable masked losses (reference direct_pred.py:238-253)."""
    losses = {}
    for var in variables:
        if surv_event_var is not None and var == surv_event_var:
            losses[var] = cox_ph_loss(outputs[var], y[surv_time_var], y[surv_event_var])
        elif variable_types[var] == "numerical":
            losses[var] = masked_mse_loss(outputs[var], y[var])
        else:
            losses[var] = masked_ce_loss(outputs[var], y[var])
    return losses


class BaseModel:
    model_name: str = "BaseModel"

    # cohorts above this size run the eval forward in chunks to bound memory
    EVAL_CHUNK = 8192

    def __init__(
        self,
        config: Dict[str, Any],
        dataset,
        target_variables: List[str],
        batch_variables: Optional[List[str]] = None,
        surv_event_var: Optional[str] = None,
        surv_time_var: Optional[str] = None,
        use_loss_weighting: bool = True,
        device_type: Optional[str] = None,
        device="auto",
    ):
        self.config = dict(config)
        self.target_variables = list(target_variables)
        self.surv_event_var = surv_event_var
        self.surv_time_var = surv_time_var
        if surv_event_var is not None and surv_time_var is not None:
            if surv_event_var not in self.target_variables:
                self.target_variables = self.target_variables + [surv_event_var]
        self.batch_variables = list(batch_variables) if batch_variables else None
        self.variables = (
            self.target_variables + self.batch_variables
            if self.batch_variables
            else self.target_variables
        )
        self.use_loss_weighting = use_loss_weighting
        self.device_type = device_type
        self.device = resolve_device(device)

        self.variable_types = dataset.variable_types
        self.label_mappings = dataset.label_mappings
        self.ann = dataset.ann
        self.layers = list(dataset.dat.keys())
        self.input_dims = [len(dataset.features[k]) for k in self.layers]
        self.feature_names = {k: list(v) for k, v in dataset.features.items()}

        self.output_dims = {}
        for var in self.variables:
            if self.variable_types[var] == "numerical":
                self.output_dims[var] = 1
            else:
                self.output_dims[var] = num_classes_for(dataset.ann[var])

        self.feature_importances: Dict[str, List[dict]] = {}

        with torch.device("meta"):
            module = self._build_module()
        self.module = module.to_empty(device=self.device).eval()

    def _build_module(self) -> torch.nn.Module:
        raise NotImplementedError

    def init_params(self, seed: int = 42) -> torch.nn.Module:
        """Fresh parameters from ``torch.Generator().manual_seed(seed)``."""
        self.module.reset_parameters(torch.Generator().manual_seed(seed))
        return self.module

    # ------------------------------------------------------------ training API

    @property
    def batch_layers(self) -> List[str]:
        """The layers ``make_batch`` puts in a batch: those the module reads."""
        return self.layers

    def make_batch(self, dataset, indices=None) -> dict:
        """``{x: {layer: (n, F)}, y: {var: (n,)}}`` float32 tensors on the
        model's device for the ``batch_layers``, optionally the rows
        ``indices`` only."""
        dat, ann = dataset.as_arrays()
        y_vars = set(self.variables)
        if self.surv_time_var:
            y_vars.add(self.surv_time_var)
        rows = slice(None) if indices is None else np.asarray(indices)

        def put(a):
            return torch.from_numpy(
                np.ascontiguousarray(np.asarray(a)[rows], dtype=np.float32)
            ).to(self.device)

        return {"x": {k: put(dat[k]) for k in self.batch_layers},
                "y": {v: put(ann[v]) for v in sorted(y_vars)}}

    def loss_fn(self, batch: dict, generator: Optional[torch.Generator] = None,
                train: bool = True):
        """``(total_loss, {name: loss})`` of the module on ``batch``: the
        supervised losses and the ``_extra_losses``. In training mode the
        module uses batch statistics and draws its noise (dropout, the VAE's
        reparameterisation) from ``generator``; validation passes None."""
        self.module.train(train)
        # on the data axis of a multi-process fit each rank forwards its rows
        # of the global batch and the outputs are gathered
        # (ops/collectives.py); else the forward of the whole batch
        out = forward_rows(lambda xs: self._module_train({**batch, "x": xs}, generator),
                           batch["x"])
        losses = supervised_loss_terms(
            out["outputs"], batch["y"], self.variables, self.variable_types,
            self.surv_event_var, self.surv_time_var,
        )
        losses.update(self._extra_losses(out, batch, generator))
        total = compute_total_loss(losses, out.get("log_vars"), self.use_loss_weighting)
        return total, losses

    def _module_train(self, batch: dict, generator: Optional[torch.Generator]) -> dict:
        """The module's outputs on ``batch`` in its current mode (the GNN
        adds its operator)."""
        return self.module(batch["x"], generator)

    def _module_eval(self, x: Dict[str, torch.Tensor]) -> dict:
        """The module's eval outputs on ``x`` (the GNN adds its operator)."""
        return self.module(x)

    def _extra_losses(self, out: dict, batch: dict,
                      generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """Model-specific loss terms (the VAE's MMD); none here."""
        return {}

    @classmethod
    def n_units(cls, dataset, target_variables: List[str]) -> int:
        """The rows a model of this class trains over in ``dataset``: its
        splits, folds and batch-size space count them (the triplet model's
        anchors)."""
        return len(dataset)

    def n_train_samples(self, dataset) -> int:
        """The rows ``make_batch`` indexes (the triplet model's anchors)."""
        return len(dataset)

    def fit(self, dataset, train_idx=None, val_idx=None, *, lr: float,
            batch_size: int, max_epochs: int, early_stop_patience: int = -1,
            seed: int = 42, on_epoch_end=None, mesh=None, checkpoint_dir=None):
        """Train this model on (a subset of) a dataset from fresh parameters
        drawn with ``seed``; keeps the best state and returns the TrainResult,
        also kept as ``train_result``. ``on_epoch_end`` goes to the trainer;
        ``mesh`` with a ``data`` axis over the live process group runs the
        data-parallel fit; ``checkpoint_dir`` makes the fit resumable: a
        rerun with the same directory resumes from its latest checkpoint
        (``train/trainer.py``)."""
        from ..train.trainer import Trainer

        self.init_params(seed)
        if train_idx is None:
            train_idx = np.arange(self.n_train_samples(dataset))
        train_data = self.make_batch(dataset, train_idx)
        val_data = self.make_batch(dataset, val_idx) if val_idx is not None else None
        trainer = Trainer(self.module, self.loss_fn, lr=lr, mesh=mesh)
        res = trainer.fit(
            train_data, val_data, n_samples=len(train_idx), batch_size=batch_size,
            max_epochs=max_epochs, early_stop_patience=early_stop_patience, seed=seed,
            checkpoint_dir=checkpoint_dir, on_epoch_end=on_epoch_end,
        )
        self.module.load_state_dict(res.state)
        self.module.eval()
        self.train_result = res
        return res

    # ----------------------------------------------------------- inference API

    def make_eval_x(self, dataset) -> Dict[str, torch.Tensor]:
        """{layer: (n, features) float32 tensor on the model's device}."""
        dat, _ = dataset.as_arrays()
        return {
            k: torch.from_numpy(np.ascontiguousarray(dat[k], dtype=np.float32)).to(self.device)
            for k in self.layers
        }

    @torch.inference_mode()
    def _forward_eval(self, x: Dict[str, torch.Tensor]) -> dict:
        self.module.eval()
        n = next(iter(x.values())).shape[0]
        if n <= self.EVAL_CHUNK:
            return self._module_eval(x)
        outs = [
            self._module_eval({k: v[s:s + self.EVAL_CHUNK] for k, v in x.items()})
            for s in range(0, n, self.EVAL_CHUNK)
        ]

        # concatenate the batch-axis leaves (embeddings, outputs, x_hat, ...);
        # the others, such as the (1,)-shaped log_vars, are the same in every
        # chunk (flexynesis_tpu/models/base.py:333-345)
        def combine(parts):
            if isinstance(parts[0], dict):
                return {k: combine([p[k] for p in parts]) for k in parts[0]}
            if parts[0].dim() > 0 and parts[0].shape[0] == self.EVAL_CHUNK:
                return torch.cat(parts)
            return parts[0]

        return combine(outs)

    def predict(self, dataset) -> Dict[str, np.ndarray]:
        """Per-variable predictions: softmax probabilities for categorical
        variables, raw outputs for numerical ones."""
        out = self._forward_eval(self.make_eval_x(dataset))
        preds = {}
        for var in self.variables:
            logits = out["outputs"][var]
            if self.variable_types[var] == "categorical":
                logits = torch.softmax(logits, dim=-1)
            preds[var] = logits.cpu().numpy()
        return preds

    def transform(self, dataset) -> Table:
        """Latent embeddings as a sample-indexed table."""
        out = self._forward_eval(self.make_eval_x(dataset))
        emb = out["embeddings"].cpu().numpy()
        return Table(
            index=list(dataset.samples),
            columns=[f"E{i}" for i in range(emb.shape[1])],
            values=emb,
        )

    # ------------------------------------------------------ feature importance

    def _attribution_forward(self, x: Dict[str, torch.Tensor], target_var: str) -> torch.Tensor:
        """The eval forward with autograd on, ``x -> outputs[target_var]``
        (B, n_out): running statistics, no dropout, the VAE's z = mean.
        (``_forward_eval`` runs under ``inference_mode`` and cannot serve.)"""
        self.module.eval()
        return self._module_eval(x)["outputs"][target_var]

    def compute_feature_importance(self, dataset, target_var: str,
                                   method: str = "IntegratedGradients",
                                   steps_or_samples: int = 5, batch_size: int = 512,
                                   rng_seed: int = 42, mesh=None) -> List[dict]:
        """Per-class feature attributions of one target variable, as rows
        (reference direct_pred.py:432-590; ``interpret/attribution.py``);
        also kept in ``feature_importances[target_var]``. ``mesh`` splits the
        sample axis over its devices."""
        from ..interpret.attribution import compute_feature_importance

        rows = compute_feature_importance(self, dataset, target_var, method=method,
                                          steps_or_samples=steps_or_samples,
                                          batch_size=batch_size, rng_seed=rng_seed, mesh=mesh)
        self.feature_importances[target_var] = rows
        return rows
