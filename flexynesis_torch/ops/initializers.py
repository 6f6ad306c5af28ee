"""Parameter initialisation drawn from an explicit generator.

Counterpart of ``flexynesis_tpu/ops/initializers.py``:

* torch_linear_kernel_init and make_torch_bias_init: torch.nn.Linear's
  default, weights and biases U(-1/sqrt(fan_in), +1/sqrt(fan_in));
* xavier_uniform: U(+-sqrt(6 / (fan_in + fan_out))) for the Encoder and
  Decoder weights.

Values are drawn on the CPU from a ``torch.Generator`` and then copied to the
tensor's device, so one seed gives the same parameters on every device.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import host_wait


@torch.no_grad()
def torch_linear_uniform_(tensor: torch.Tensor, fan_in: int,
                          generator: torch.Generator) -> torch.Tensor:
    """Fill ``tensor`` in place with U(+-1/sqrt(fan_in)) drawn from ``generator``."""
    bound = 1.0 / math.sqrt(fan_in)
    values = torch.empty(tensor.shape, dtype=tensor.dtype)
    values.uniform_(-bound, bound, generator=generator)
    with host_wait():   # a copy from pageable memory waits for the stream
        return tensor.copy_(values)


@torch.no_grad()
def reset_linear_(linear: torch.nn.Linear, generator: torch.Generator,
                  xavier: bool = False) -> None:
    """torch's default initialisation of ``linear``, or Xavier-uniform weights
    with the default bias where ``xavier`` is set (the Encoder and Decoder)."""
    fan_in = linear.in_features
    if xavier:
        xavier_uniform_(linear.weight, generator)
    else:
        torch_linear_uniform_(linear.weight, fan_in, generator)
    if linear.bias is not None:
        torch_linear_uniform_(linear.bias, fan_in, generator)


@torch.no_grad()
def xavier_uniform_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill a Linear weight ``(fan_out, fan_in)`` in place with
    U(+-sqrt(6 / (fan_in + fan_out))) drawn from ``generator``."""
    fan_out, fan_in = weight.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    values = torch.empty(weight.shape, dtype=weight.dtype)
    values.uniform_(-bound, bound, generator=generator)
    with host_wait():
        return weight.copy_(values)
