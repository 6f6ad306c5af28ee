"""Host-side model scaffolding, inference half.

Counterpart of ``flexynesis_tpu/models/base.py``: ``BaseModel`` holds config,
dataset metadata and the ``nn.Module``, and serves ``predict`` and
``transform``. The module is built on the ``meta`` device and moved to the
model's device without drawing numbers; ``init_params`` fills it from a seeded
``torch.Generator`` and ``inference.reconstruct_model`` loads saved weights
into it. Training (``loss_fn``, ``fit``) is the next slice (ROADMAP A.3-A.5).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.csvio import Table
from ..utils.device import resolve_device


def num_classes_for(ann_values: np.ndarray) -> int:
    """Output width of a categorical head: count of distinct encoded labels
    (NaN counts as one extra pseudo-class, as in the reference)."""
    return int(np.unique(np.asarray(ann_values)).size)


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

        with torch.device("meta"):
            module = self._build_module()
        self.module = module.to_empty(device=self.device).eval()

    def _build_module(self) -> torch.nn.Module:
        raise NotImplementedError

    def init_params(self, seed: int = 42) -> torch.nn.Module:
        """Fresh parameters from ``torch.Generator().manual_seed(seed)``."""
        self.module.reset_parameters(torch.Generator().manual_seed(seed))
        return self.module

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
            return self.module(x)
        outs = [
            self.module({k: v[s:s + self.EVAL_CHUNK] for k, v in x.items()})
            for s in range(0, n, self.EVAL_CHUNK)
        ]
        out = dict(outs[0])
        out["embeddings"] = torch.cat([o["embeddings"] for o in outs])
        out["outputs"] = {
            var: torch.cat([o["outputs"][var] for o in outs])
            for var in outs[0]["outputs"]
        }
        return out

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
