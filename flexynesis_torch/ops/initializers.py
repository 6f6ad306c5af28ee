"""torch.nn.Linear's default initialisation, drawn from an explicit generator.

Counterpart of ``flexynesis_tpu/ops/initializers.py`` (torch_linear_kernel_init,
make_torch_bias_init): weights and biases are U(-1/sqrt(fan_in), +1/sqrt(fan_in)).
Values are drawn on the CPU from a ``torch.Generator`` and then copied to the
tensor's device, so one seed gives the same parameters on every device.
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def torch_linear_uniform_(tensor: torch.Tensor, fan_in: int,
                          generator: torch.Generator) -> torch.Tensor:
    """Fill ``tensor`` in place with U(+-1/sqrt(fan_in)) drawn from ``generator``."""
    bound = 1.0 / math.sqrt(fan_in)
    values = torch.empty(tensor.shape, dtype=tensor.dtype)
    values.uniform_(-bound, bound, generator=generator)
    return tensor.copy_(values)


@torch.no_grad()
def reset_linear_(linear: torch.nn.Linear, generator: torch.Generator) -> None:
    fan_in = linear.in_features
    torch_linear_uniform_(linear.weight, fan_in, generator)
    if linear.bias is not None:
        torch_linear_uniform_(linear.bias, fan_in, generator)
