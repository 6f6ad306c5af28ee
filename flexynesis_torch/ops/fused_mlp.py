"""FusedMLP: the MLP block whose Linear->BatchNorm->ReLU is one CUDA kernel.

Counterpart of ``flexynesis_tpu/ops/fused_mlp.py::FusedMLP``, selected by the
``fused_kernels`` config key. The parameters keep the Flax module's layout:
``layer_1_kernel`` is ``(in, hidden)``, the layout kernel B2 takes, and the
BatchNorm scale, bias and running statistics are plain tensors. In training
mode the block runs kernel B1 (batch statistics) and then updates the running
statistics as the JAX block does: ``ra = 0.9 * ra + 0.1 * mean`` and
``ra_var = 0.9 * ra_var + 0.1 * var * n / max(n - 1, 1)`` (torch's unbiased
convention, unlike ``MLP``). Dropout is applied outside the kernel, from the
caller's ``torch.Generator``. On the data axis of a fit over several
processes, B1 runs on the gathered global batch (its statistics are inside
the kernel) and each rank keeps its rows. In eval mode the block runs kernel
B2. Both
kernels live in ``kernels/fused_linear.py`` and take a leading trial axis, as
``forward_with`` does (see ``ops/mlp.py``); CPU tensors take their plain
versions.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.fused_linear import fused_linear_bn_relu, fused_linear_bn_relu_eval
from .collectives import gather_rows
from .initializers import reset_linear_, torch_linear_uniform_
from .mlp import BN_EPS, Dropout, Tensors, linear, module_forward, update_running_


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
        return module_forward(self, x, generator)

    def forward_with(self, params: Tensors, buffers: Tensors, x: torch.Tensor,
                     train: bool, drop: Dropout) -> torch.Tensor:
        """The block on ``params`` and ``buffers`` named as the module's own
        (each with an optional leading trial axis): kernel B1, the running
        statistics updated in place and ``drop(h, rate)`` in training mode,
        kernel B2 in eval mode."""
        args = (x, params["layer_1_kernel"], params["layer_1_bias"], params["bn_scale"],
                params["bn_bias"])
        rm, rv = buffers["running_mean"], buffers["running_var"]
        if train:
            # on the data axis B1 runs on the gathered global rows and each
            # rank keeps its own (ops/collectives.py)
            x_all, own_rows = gather_rows(x)
            h, mu, var = fused_linear_bn_relu(x_all, *args[1:], BN_EPS)
            update_running_(rm, rv, mu, var, n=x_all.shape[-2])
            if own_rows is not None:
                h = h[own_rows]
            h = drop(h, self.dropout_rate)
        else:
            h = fused_linear_bn_relu_eval(*args, rm, rv, BN_EPS)
        return linear(h, params["layer_out.weight"], params.get("layer_out.bias"))
