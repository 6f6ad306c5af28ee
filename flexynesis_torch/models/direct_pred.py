"""DirectPred: per-modality MLP encoders -> fusion -> multi-task heads.

Counterpart of ``flexynesis_tpu/models/direct_pred.py`` (reference
models/direct_pred.py:73-105). Submodules and parameters carry the Flax
module's names (``encoder_<layer>``, ``fusion_block``, ``head_<var>``,
``log_var_<var>``) so ``convert.from_flax`` maps one tree onto the other.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.fused_mlp import FusedMLP
from ..ops.initializers import reset_linear_
from ..ops.mlp import MLP
from .base import BaseModel


class DirectPredNet(nn.Module):
    def __init__(self, layer_names: Sequence[str], input_dims: Sequence[int],
                 latent_dim: int, hidden_dim_factor: float,
                 supervisor_hidden_dim: int, output_dims: Dict[str, int],
                 use_loss_weighting: bool = True, fused_kernels: bool = False):
        super().__init__()
        block = FusedMLP if fused_kernels else MLP
        self.layer_names = list(layer_names)
        self.variables = list(output_dims)
        self.use_loss_weighting = use_loss_weighting
        for ln, d in zip(self.layer_names, input_dims):
            self.add_module(
                f"encoder_{ln}", block(d, int(d * hidden_dim_factor), latent_dim)
            )
        if len(self.layer_names) > 1:
            self.fusion_block = nn.Linear(latent_dim * len(self.layer_names), latent_dim)
        else:
            self.fusion_block = None
        for var, n_out in output_dims.items():
            self.add_module(
                f"head_{var}", block(latent_dim, supervisor_hidden_dim, n_out)
            )
        if use_loss_weighting:
            for var in self.variables:
                self.register_parameter(f"log_var_{var}", nn.Parameter(torch.zeros(1)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for ln in self.layer_names:
            getattr(self, f"encoder_{ln}").reset_parameters(generator)
        if self.fusion_block is not None:
            reset_linear_(self.fusion_block, generator)
        for var in self.variables:
            getattr(self, f"head_{var}").reset_parameters(generator)
            if self.use_loss_weighting:
                getattr(self, f"log_var_{var}").zero_()

    def encode(self, x: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the blocks' dropout masks in training mode."""
        embs = [getattr(self, f"encoder_{ln}")(x[ln], generator)
                for ln in self.layer_names]
        concat = torch.cat(embs, dim=-1)
        if self.fusion_block is not None:
            return self.fusion_block(concat)
        return concat

    def forward(self, x: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> dict:
        emb = self.encode(x, generator)
        out = {
            "embeddings": emb,
            "outputs": {var: getattr(self, f"head_{var}")(emb, generator)
                        for var in self.variables},
        }
        if self.use_loss_weighting:
            out["log_vars"] = {
                var: getattr(self, f"log_var_{var}") for var in self.variables
            }
        return out


class DirectPred(BaseModel):
    model_name = "DirectPred"

    def _build_module(self) -> nn.Module:
        return DirectPredNet(
            layer_names=self.layers,
            input_dims=self.input_dims,
            latent_dim=int(self.config["latent_dim"]),
            hidden_dim_factor=float(self.config["hidden_dim_factor"]),
            supervisor_hidden_dim=int(self.config["supervisor_hidden_dim"]),
            output_dims=dict(self.output_dims),
            use_loss_weighting=self.use_loss_weighting,
            fused_kernels=bool(self.config.get("fused_kernels", False)),
        )
