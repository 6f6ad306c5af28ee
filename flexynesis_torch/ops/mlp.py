"""The MLP block of encoders and supervisor heads.

Counterpart of ``flexynesis_tpu/ops/mlp.py::MLP`` (reference modules.py:106-150):
Linear -> BatchNorm1d(eps 1e-5, momentum 0.1) -> ReLU -> Dropout(0.1) -> Linear.
The hidden width is clamped to at least 2 and the output layer has no bias
when ``output_dim == 1``.
"""

from __future__ import annotations

import torch
from torch import nn

from .initializers import reset_linear_

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention (flax's 0.9)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout whose mask comes from an explicit generator."""
    keep = torch.rand(x.shape, generator=generator, device=generator.device) >= rate
    return x * keep.to(x.device, x.dtype) / (1.0 - rate)


class MLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 dropout_rate: float = 0.1):
        super().__init__()
        hidden = max(int(hidden_dim), 2)
        self.dropout_rate = dropout_rate
        self.layer_1 = nn.Linear(input_dim, hidden)
        self.batchnorm = nn.BatchNorm1d(hidden, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.layer_out = nn.Linear(hidden, output_dim, bias=output_dim > 1)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_linear_(self.layer_1, generator)
        self.batchnorm.reset_parameters()
        reset_linear_(self.layer_out, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator = None) -> torch.Tensor:
        """``generator`` draws the dropout mask in training mode."""
        h = torch.relu(self.batchnorm(self.layer_1(x)))
        if self.training:
            if generator is None:
                raise ValueError("training-mode dropout needs a torch.Generator")
            h = dropout(h, self.dropout_rate, generator)
        return self.layer_out(h)
