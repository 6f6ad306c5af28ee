"""FusedMLP: the MLP block whose Linear->BatchNorm->ReLU is one CUDA kernel.

Counterpart of ``flexynesis_tpu/ops/fused_mlp.py::FusedMLP``, selected by the
``fused_kernels`` config key. The parameters keep the Flax module's layout:
``layer_1_kernel`` is ``(in, hidden)``, the layout kernel B2 takes, and the
BatchNorm scale, bias and running statistics are plain tensors. In training
mode the block runs kernel B1 (batch statistics) and then updates the running
statistics as the JAX block does: ``ra = 0.9 * ra + 0.1 * mean`` and
``ra_var = 0.9 * ra_var + 0.1 * var * n / max(n - 1, 1)`` (torch's unbiased
convention, unlike ``MLP``). Dropout is applied outside the kernel, from the
caller's ``torch.Generator``. In eval mode the block runs kernel B2. Both
kernels live in ``kernels/fused_linear.py``; CPU tensors take their plain
versions.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.fused_linear import fused_linear_bn_relu, fused_linear_bn_relu_eval
from .initializers import reset_linear_, torch_linear_uniform_
from .mlp import BN_EPS, BN_MOMENTUM, dropout


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

    def forward(self, x: torch.Tensor, generator: torch.Generator = None) -> torch.Tensor:
        """``generator`` draws the dropout mask in training mode."""
        if self.training:
            if generator is None:
                raise ValueError("training-mode dropout needs a torch.Generator")
            h, mu, var = fused_linear_bn_relu(
                x, self.layer_1_kernel, self.layer_1_bias, self.bn_scale,
                self.bn_bias, BN_EPS,
            )
            n = x.shape[0]
            with torch.no_grad():
                self.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mu)
                self.running_var.mul_(1 - BN_MOMENTUM).add_(
                    (BN_MOMENTUM * n / max(n - 1, 1)) * var
                )
            return self.layer_out(dropout(h, self.dropout_rate, generator))
        h = fused_linear_bn_relu_eval(
            x, self.layer_1_kernel, self.layer_1_bias, self.bn_scale,
            self.bn_bias, self.running_mean, self.running_var, BN_EPS,
        )
        return self.layer_out(h)
