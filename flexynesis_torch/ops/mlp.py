"""The blocks of encoders, decoders and supervisor heads.

Counterpart of ``flexynesis_tpu/ops/mlp.py`` (reference modules.py):

* ``MLP`` (modules.py:106-150): Linear -> BatchNorm(eps 1e-5) -> ReLU ->
  Dropout(0.1) -> Linear. The hidden width is clamped to at least 2 and the
  output layer has no bias when ``output_dim == 1``.
* ``_HiddenStack``: Linear -> LeakyReLU(0.2) -> BatchNorm, per hidden width,
  shared by
* ``Encoder`` (modules.py:10-57): the stack, then the ``FC_mean`` and
  ``FC_var`` heads, and
* ``Decoder`` (modules.py:60-103): the stack, then a sigmoid ``FC_output``.
  Encoder and Decoder weights are Xavier-uniform.

BatchNorm follows Flax ``nn.BatchNorm`` (``use_fast_variance=True``) in
training mode, not ``torch.nn.BatchNorm1d``: the batch variance is the biased
``max(E[h^2] - E[h]^2, 0)``, used both to normalise and to update the running
statistics as ``new = 0.9 * old + 0.1 * batch``. (``BatchNorm1d`` would update
``running_var`` with the unbiased variance.) The ``BatchNorm1d`` submodules
hold the parameters and running statistics, so the layout ``convert.py``
maps is unchanged, and they run the eval-mode normalisation.

Random draws in a forward pass (dropout masks, the VAE's noise) come from an
explicit ``torch.Generator`` on the generator's device and are moved to the
tensors' device, so one CPU generator gives a run on the card and a run on
the CPU the same numbers.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .initializers import reset_linear_

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # weight of the new batch in the running statistics (flax's 1 - 0.9)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout whose mask comes from an explicit generator."""
    keep = torch.rand(x.shape, generator=generator, device=generator.device) >= rate
    return x * keep.to(x.device, x.dtype) / (1.0 - rate)


def standard_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """N(0, 1) float32 draws of ``shape`` from ``generator``, on ``device``."""
    return torch.randn(shape, generator=generator, device=generator.device).to(device)


def batch_norm(h: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    """``bn`` applied to ``h``: running statistics in eval mode; in training
    mode Flax's batch statistics and running-statistics update."""
    if not bn.training:
        return bn(h)
    mu = h.mean(dim=0)
    var = torch.clamp((h * h).mean(dim=0) - mu * mu, min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mu)
        bn.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var)
    return (h - mu) * torch.rsqrt(var + BN_EPS) * bn.weight + bn.bias


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
        if self.training and generator is None:
            raise ValueError("training-mode dropout needs a torch.Generator")
        h = torch.relu(batch_norm(self.layer_1(x), self.batchnorm))
        if self.training:
            h = dropout(h, self.dropout_rate, generator)
        return self.layer_out(h)


class _HiddenStack(nn.Module):
    """Linear -> LeakyReLU(0.2) -> BatchNorm per width in ``hidden_dims``;
    submodules ``dense_<i>`` and ``bn_<i>`` as in Flax."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int]):
        super().__init__()
        self.depth = len(hidden_dims)
        for i, h in enumerate(hidden_dims):
            self.add_module(f"dense_{i}", nn.Linear(input_dim, int(h)))
            self.add_module(f"bn_{i}", nn.BatchNorm1d(int(h), eps=BN_EPS, momentum=BN_MOMENTUM))
            input_dim = int(h)
        self.output_dim = input_dim

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.depth):
            reset_linear_(getattr(self, f"dense_{i}"), generator, xavier=True)
            getattr(self, f"bn_{i}").reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            h = torch.nn.functional.leaky_relu(getattr(self, f"dense_{i}")(x), 0.2)
            x = batch_norm(h, getattr(self, f"bn_{i}"))
        return x


class Encoder(nn.Module):
    """The hidden stack, then the mean and log-variance heads; returns
    ``(mean, log_var)``."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int], latent_dim: int):
        super().__init__()
        self.hidden_layers = _HiddenStack(input_dim, hidden_dims)
        self.FC_mean = nn.Linear(self.hidden_layers.output_dim, latent_dim)
        self.FC_var = nn.Linear(self.hidden_layers.output_dim, latent_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.hidden_layers.reset_parameters(generator)
        reset_linear_(self.FC_mean, generator, xavier=True)
        reset_linear_(self.FC_var, generator, xavier=True)

    def forward(self, x: torch.Tensor):
        h = self.hidden_layers(x)
        return self.FC_mean(h), self.FC_var(h)


class Decoder(nn.Module):
    """The hidden stack, then a sigmoid output layer."""

    def __init__(self, input_dim: int, hidden_dims: Sequence[int], output_dim: int):
        super().__init__()
        self.hidden_layers = _HiddenStack(input_dim, hidden_dims)
        self.FC_output = nn.Linear(self.hidden_layers.output_dim, output_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.hidden_layers.reset_parameters(generator)
        reset_linear_(self.FC_output, generator, xavier=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.FC_output(self.hidden_layers(x)))
