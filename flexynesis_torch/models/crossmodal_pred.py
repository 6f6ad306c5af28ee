"""CrossModalPred: cross-modality translation on the VAE-MMD network.

Counterpart of ``flexynesis_tpu/models/crossmodal_pred.py`` (reference
models/crossmodal_pred.py): encodes the ``input_layers`` and reconstructs the
``output_layers`` (both default to every layer of the dataset); the loss is
the MMD plus reconstruction MSE averaged over the output layers, plus the
supervised losses. ``decode(dataset)`` returns the reconstructed output
layers, one table each.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from torch import nn

from ..utils.csvio import Table
from .supervised_vae import SupervisedVAE, SupervisedVAENet


class CrossModalPredNet(SupervisedVAENet):
    def __init__(self, input_layer_names, output_layer_names, input_dims,
                 output_layer_dims, latent_dim: int, hidden_dim_factor: float,
                 supervisor_hidden_dim: int, output_dims: Dict[str, int],
                 use_loss_weighting: bool = True):
        super().__init__(input_layer_names, input_dims, latent_dim, hidden_dim_factor,
                         supervisor_hidden_dim, output_dims, use_loss_weighting,
                         decoded=list(zip(output_layer_names, output_layer_dims)))


class CrossModalPred(SupervisedVAE):
    model_name = "CrossModalPred"

    def __init__(self, config, dataset, target_variables, batch_variables=None,
                 surv_event_var=None, surv_time_var=None, use_loss_weighting=True,
                 device_type=None, device="auto",
                 input_layers: Optional[List[str]] = None,
                 output_layers: Optional[List[str]] = None):
        all_layers = list(dataset.dat.keys())
        self.input_layers = list(input_layers) if input_layers else all_layers
        self.output_layers = list(output_layers) if output_layers else all_layers
        self._dataset_features = dataset.features
        super().__init__(config, dataset, target_variables, batch_variables=batch_variables,
                         surv_event_var=surv_event_var, surv_time_var=surv_time_var,
                         use_loss_weighting=use_loss_weighting, device_type=device_type,
                         device=device)
        # the module reads the input layers only (transform, predict)
        self.layers = list(self.input_layers)
        self.input_dims = [len(dataset.features[k]) for k in self.layers]

    @property
    def decoded_layers(self):
        return self.output_layers

    @property
    def batch_layers(self):
        """The input layers and the output layers, the reconstruction targets
        (flexynesis_tpu crossmodal_pred.py:169-181)."""
        return list(dict.fromkeys(self.input_layers + self.output_layers))

    def _build_module(self) -> nn.Module:
        return CrossModalPredNet(
            input_layer_names=self.input_layers,
            output_layer_names=self.output_layers,
            input_dims=[len(self._dataset_features[k]) for k in self.input_layers],
            output_layer_dims=[len(self._dataset_features[k]) for k in self.output_layers],
            latent_dim=int(self.config["latent_dim"]),
            hidden_dim_factor=float(self.config["hidden_dim_factor"]),
            supervisor_hidden_dim=int(self.config["supervisor_hidden_dim"]),
            output_dims=dict(self.output_dims),
            use_loss_weighting=self.use_loss_weighting,
        )

    def decode(self, dataset) -> Dict[str, Table]:
        """The reconstructed output layers, sample by feature
        (flexynesis_tpu crossmodal_pred.py:210-222)."""
        out = self._forward_eval(self.make_eval_x(dataset))
        return {
            ln: Table(index=list(dataset.samples), columns=list(dataset.features[ln]),
                      values=out["x_hat"][ln].cpu().numpy())
            for ln in self.output_layers
        }
