"""The MLP block of encoders and supervisor heads.

Counterpart of ``flexynesis_tpu/ops/mlp.py::MLP`` (reference modules.py:106-150):
Linear -> BatchNorm(eps 1e-5) -> ReLU -> Dropout(0.1) -> Linear. The hidden
width is clamped to at least 2 and the output layer has no bias when
``output_dim == 1``.

BatchNorm follows Flax ``nn.BatchNorm`` (``use_fast_variance=True``) in
training mode, not ``torch.nn.BatchNorm1d``: the batch variance is the biased
``max(E[h^2] - E[h]^2, 0)``, used both to normalise and to update the running
statistics as ``new = 0.9 * old + 0.1 * batch``. (``BatchNorm1d`` would update
``running_var`` with the unbiased variance.) The ``BatchNorm1d`` submodule
holds the parameters and running statistics, so the layout ``convert.py``
maps is unchanged, and it runs the eval-mode normalisation.
"""

from __future__ import annotations

import torch
from torch import nn

from .initializers import reset_linear_

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # weight of the new batch in the running statistics (flax's 1 - 0.9)


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
        if not self.training:
            return self.layer_out(torch.relu(self.batchnorm(self.layer_1(x))))
        if generator is None:
            raise ValueError("training-mode dropout needs a torch.Generator")
        h = self.layer_1(x)
        bn = self.batchnorm
        mu = h.mean(dim=0)
        var = torch.clamp((h * h).mean(dim=0) - mu * mu, min=0.0)
        with torch.no_grad():
            bn.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mu)
            bn.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var)
        h = torch.relu((h - mu) * torch.rsqrt(var + BN_EPS) * bn.weight + bn.bias)
        return self.layer_out(dropout(h, self.dropout_rate, generator))
