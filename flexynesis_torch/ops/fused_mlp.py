"""FusedMLP: the MLP block whose Linear->BatchNorm->ReLU is one CUDA kernel.

Counterpart of ``flexynesis_tpu/ops/fused_mlp.py::FusedMLP``, selected by the
``fused_kernels`` config key. The parameters keep the Flax module's layout:
``layer_1_kernel`` is ``(in, hidden)``, the layout kernel B2 takes, and the
BatchNorm scale, bias and running statistics are plain tensors. In eval mode
the block runs kernel B2 (``kernels/fused_linear.py``) on CUDA tensors and its
plain version on CPU tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.fused_linear import fused_linear_bn_relu_eval
from .initializers import reset_linear_, torch_linear_uniform_
from .mlp import BN_EPS


class FusedMLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 dropout_rate: float = 0.1):
        super().__init__()
        hidden = max(int(hidden_dim), 2)
        self.dropout_rate = dropout_rate
        self.layer_1_kernel = nn.Parameter(torch.empty(input_dim, hidden))
        self.layer_1_bias = nn.Parameter(torch.empty(hidden))
        self.bn_scale = nn.Parameter(torch.empty(hidden))
        self.bn_bias = nn.Parameter(torch.empty(hidden))
        self.register_buffer("running_mean", torch.empty(hidden))
        self.register_buffer("running_var", torch.empty(hidden))
        self.layer_out = nn.Linear(hidden, output_dim, bias=output_dim > 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.layer_1_kernel.shape[0]
        torch_linear_uniform_(self.layer_1_kernel, fan_in, generator)
        torch_linear_uniform_(self.layer_1_bias, fan_in, generator)
        self.bn_scale.fill_(1.0)
        self.bn_bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        reset_linear_(self.layer_out, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "training-mode FusedMLP needs kernel B1 (fused Linear->BatchNorm"
                "->ReLU with batch statistics), the next slice of the port "
                "(ROADMAP B.1)"
            )
        h = fused_linear_bn_relu_eval(
            x, self.layer_1_kernel, self.layer_1_bias, self.bn_scale,
            self.bn_bias, self.running_mean, self.running_var, BN_EPS,
        )
        return self.layer_out(h)
