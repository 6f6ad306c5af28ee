"""GNN (early fusion): one FlexGCN over the gene-interaction node tensor.

Counterpart of ``flexynesis_tpu/models/gnn.py`` (reference gnn_early.py): a
FlexGCN encoder (``ops/graph_conv.py``) over ``MultiOmicDatasetNW``'s node
features (nodes = genes, node features = per-layer values), the conv type
from ``--gnn_conv_type``, one edge list shared by all samples, plain MLP
supervisor heads (no kernel of the port), the standard multi-task losses,
and per-node attributions split back per omic layer.

The aggregation operator is built once per model, on the host, and lives on
the model's device: dense (N, N) below ``SPARSE_NODE_THRESHOLD`` nodes and a
padded dst-sorted edge list from there; config ``gnn_sparse`` (true, false or
"auto", strings case-insensitive) overrides. Training batches carry it as
``_adj`` (passed whole by the trainers, as in JAX); eval and attribution
forwards pass ``self._adj``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..ops.graph_conv import (
    SPARSE_NODE_THRESHOLD,
    FlexGCN,
    Operator,
    build_operator,
    build_sparse_operator,
    operator_to,
)
from ..ops.mlp import MLP, dropout, own
from .base import BaseModel

Tensors = Dict[str, torch.Tensor]


class GNNNet(nn.Module):
    def __init__(self, n_nodes: int, n_node_feats: int, node_embedding_dim: int,
                 latent_dim: int, num_convs: int, conv_type: str, activation: str,
                 readout: str, supervisor_hidden_dim: int, output_dims: Dict[str, int],
                 use_loss_weighting: bool = True):
        super().__init__()
        self.n_nodes = int(n_nodes)
        self.n_node_feats = int(n_node_feats)
        self.variables = list(output_dims)
        self.use_loss_weighting = use_loss_weighting
        self.encoder = FlexGCN(n_nodes, n_node_feats, node_embedding_dim, latent_dim,
                               num_convs=num_convs, conv_type=conv_type,
                               activation=activation, readout=readout)
        for var, n_out in output_dims.items():
            self.add_module(f"head_{var}", MLP(latent_dim, supervisor_hidden_dim, n_out))
        if use_loss_weighting:
            for var in self.variables:
                self.register_parameter(f"log_var_{var}", nn.Parameter(torch.zeros(1)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.encoder.reset_parameters(generator)
        for var in self.variables:
            getattr(self, f"head_{var}").reset_parameters(generator)
            if self.use_loss_weighting:
                getattr(self, f"log_var_{var}").zero_()

    def forward(self, x: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
                adj: Operator) -> dict:
        """``generator`` draws the dropout masks in training mode."""
        if self.training and generator is None:
            raise ValueError("training-mode dropout needs a torch.Generator")
        drop = (lambda h, rate: dropout(h, rate, generator)) if self.training else None
        return self.forward_with(dict(self.named_parameters()), dict(self.named_buffers()),
                                 x, adj, self.training, drop)

    def forward_with(self, params: Tensors, buffers: Tensors, x: Dict[str, torch.Tensor],
                     adj: Operator, train: bool, drop: Optional[Callable]) -> dict:
        """The network on given parameters and running statistics (each with
        an optional leading trial axis K): x {"all": (B, N * feats)} or
        (K, B, N * feats) -> embeddings, outputs and log_vars."""
        flat = x["all"]
        nodes = flat.reshape(*flat.shape[:-1], self.n_nodes, self.n_node_feats)
        emb = self.encoder.forward_with(own(params, "encoder"), own(buffers, "encoder"),
                                        nodes, adj, train, drop)
        outputs = {var: getattr(self, f"head_{var}").forward_with(
            own(params, f"head_{var}"), own(buffers, f"head_{var}"), emb, train, drop)
            for var in self.variables}
        out = {"embeddings": emb, "outputs": outputs}
        if self.use_loss_weighting:
            out["log_vars"] = {var: params[f"log_var_{var}"] for var in self.variables}
        return out


def sparse_choice(config: dict) -> object:
    """``gnn_sparse`` as True, False or "auto"; anything else raises (a
    string "false" must not select the sparse path by being truthy)."""
    value = config.get("gnn_sparse", "auto")
    if isinstance(value, str):
        norm = value.strip().lower()
        if norm in ("true", "false", "auto"):
            return {"true": True, "false": False, "auto": "auto"}[norm]
    elif isinstance(value, (bool, np.bool_)):
        return bool(value)
    raise ValueError(f"gnn_sparse must be true/false/'auto', got {value!r}")


class GNN(BaseModel):
    model_name = "GNN"

    def __init__(self, config, dataset, target_variables, batch_variables=None,
                 surv_event_var=None, surv_time_var=None, use_loss_weighting=True,
                 device_type=None, device="auto", gnn_conv_type: str = "GC"):
        self.gnn_conv_type = gnn_conv_type or "GC"
        self.n_nodes = len(dataset.node_names)
        self.n_node_feats = dataset.node_features.shape[2]
        sparse = sparse_choice(config)
        if sparse == "auto":
            sparse = self.n_nodes >= SPARSE_NODE_THRESHOLD
        self.sparse = bool(sparse)
        build = build_sparse_operator if self.sparse else build_operator
        operator = build(dataset.edge_index, self.n_nodes, self.gnn_conv_type)
        self.nw_dataset = dataset
        super().__init__(config, dataset, target_variables, batch_variables=batch_variables,
                         surv_event_var=surv_event_var, surv_time_var=surv_time_var,
                         use_loss_weighting=use_loss_weighting, device_type=device_type,
                         device=device)
        # built once, on the model's device, for the model's lifetime
        self._adj = operator_to(operator, self.device)

    def _build_module(self) -> nn.Module:
        return GNNNet(
            n_nodes=self.n_nodes,
            n_node_feats=self.n_node_feats,
            node_embedding_dim=int(self.config["node_embedding_dim"]),
            latent_dim=int(self.config["latent_dim"]),
            num_convs=int(self.config["num_convs"]),
            conv_type=self.gnn_conv_type,
            activation=str(self.config.get("activation", "relu")),
            readout=str(self.config.get("gnn_readout", "flatten")),
            supervisor_hidden_dim=int(self.config["supervisor_hidden_dim"]),
            output_dims=dict(self.output_dims),
            use_loss_weighting=self.use_loss_weighting,
        )

    def make_batch(self, dataset, indices=None) -> dict:
        # the operator rides in the batch under a "_" key: the trainers pass
        # it whole, never row-sliced
        batch = super().make_batch(dataset, indices)
        batch["_adj"] = self._adj
        return batch

    def _module_train(self, batch: dict, generator: Optional[torch.Generator]) -> dict:
        return self.module(batch["x"], generator, batch.get("_adj", self._adj))

    def _module_eval(self, x: Dict[str, torch.Tensor]) -> dict:
        return self.module(x, None, self._adj)

    def compute_feature_importance(self, dataset, target_var: str,
                                   method: str = "IntegratedGradients",
                                   steps_or_samples: int = 5) -> List[dict]:
        """Node attributions split per original omic layer (gnn_early.py:599-633):
        one row per (class, layer, node)."""
        from ..interpret.attribution import abs_attribution_sums

        sums, n_class, n = abs_attribution_sums(self, dataset, target_var, method=method,
                                                steps_or_samples=steps_or_samples)
        orig_layers = list(getattr(dataset, "multiomic_dataset", dataset).dat.keys())
        node_names = list(dataset.node_names)
        rows = []
        for c in range(n_class):
            imp = (sums[c]["all"].cpu().numpy() / n).reshape(self.n_nodes, self.n_node_feats)
            label = (dataset.label_mappings[target_var].get(c)
                     if target_var in dataset.label_mappings else "")
            for li, layer in enumerate(orig_layers):
                col = li if self.n_node_feats > 1 else 0
                rows += [{"target_variable": target_var, "target_class": c,
                          "target_class_label": label, "layer": layer, "name": name,
                          "importance": value}
                         for name, value in zip(node_names, imp[:, col])]
        self.feature_importances[target_var] = rows
        return rows
