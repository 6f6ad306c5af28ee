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
maps is unchanged, and the eval-mode normalisation is ``F.batch_norm``'s.

Every block's ``forward_with`` (``MLP``, ``_HiddenStack``, ``Encoder``,
``Decoder``, and ``FusedMLP``'s) is its function on given parameters and
running statistics, which may carry a leading trial axis K: the module's
``forward`` and the stacked trials of ``parallel/stacked.py`` run the same
body.

Random draws in a forward pass (dropout masks, the VAE's noise) come from an
explicit ``torch.Generator`` on the generator's device and are moved to the
tensors' device, so one CPU generator gives a run on the card and a run on
the CPU the same numbers.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .collectives import global_moments, row_draw
from .initializers import reset_linear_

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # weight of the new batch in the running statistics (flax's 1 - 0.9)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout whose mask comes from an explicit generator (a
    per-row draw: on the data axis, this rank's rows of the global batch's
    mask, ``ops/collectives.py``)."""
    keep = row_draw(lambda shape: torch.rand(shape, generator=generator,
                                             device=generator.device), x.shape) >= rate
    return x * keep.to(x.device, x.dtype) / (1.0 - rate)


def standard_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """N(0, 1) float32 draws of ``shape`` from ``generator``, on ``device``
    (inside a data-axis forward a per-row draw, as ``dropout``)."""
    return row_draw(lambda s: torch.randn(s, generator=generator, device=generator.device),
                    shape).to(device)


Tensors = Dict[str, torch.Tensor]
Dropout = Callable[[torch.Tensor, float], torch.Tensor]


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``nn.Linear``'s function, or K of them: ``weight`` (out, in) or
    (K, out, in), ``bias`` (out,) or (K, out); with K, ``x`` is (K, B, in) or
    one (B, in) shared by the trials."""
    if weight.dim() == 2:
        return F.linear(x, weight, bias)
    if weight.shape[0] == 1:
        # one trial runs as the first of two: a batched product of one
        # matrix may take another kernel (a matrix-vector one for one output
        # column), so a trial's arithmetic would depend on how many trials
        # share its launch, and a shard of one trial on a trial mesh
        # (parallel/trials.py) would part from the unsharded round
        two = (x if x.dim() == 2 else x.expand(2, *x.shape[1:]),
               weight.expand(2, *weight.shape[1:]),
               None if bias is None else bias.expand(2, *bias.shape[1:]))
        return linear(*two)[:1]
    if x.dim() == 3 and bias is not None:
        return torch.baddbmm(bias.unsqueeze(-2), x, weight.mT)
    y = torch.matmul(x, weight.mT)
    return y if bias is None else y + bias.unsqueeze(-2)


def update_running_(running_mean: torch.Tensor, running_var: torch.Tensor,
                    mu: torch.Tensor, var: torch.Tensor, n: Optional[int] = None) -> None:
    """``new = 0.9 * old + 0.1 * batch`` in place; ``n`` (the batch's rows)
    scales the variance by n / (n - 1), torch's unbiased convention."""
    w = BN_MOMENTUM if n is None else BN_MOMENTUM * n / max(n - 1, 1)
    with torch.no_grad():
        running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mu)
        running_var.mul_(1 - BN_MOMENTUM).add_(w * var)


def batch_norm_train(h: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor) -> torch.Tensor:
    """Flax's training-mode BatchNorm over the rows (axis -2) of ``h`` (B, H)
    or (K, B, H), each trial with its own statistics; updates the running
    statistics ((H,) or (K, H)) in place. On the data axis the statistics
    span every rank's rows (``ops/collectives.py::global_moments``)."""
    mu, mean_sq = global_moments(h)
    var = torch.clamp(mean_sq - mu * mu, min=0.0)
    update_running_(running_mean, running_var, mu, var)
    return ((h - mu.unsqueeze(-2)) * torch.rsqrt(var + BN_EPS).unsqueeze(-2)
            * scale.unsqueeze(-2) + shift.unsqueeze(-2))


def batch_norm_eval(h: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm (``F.batch_norm``) of ``h`` (B, H), or of (K, B, H)
    with (K, H) statistics, as one (B, K * H) call."""
    rows = h.movedim(-2, 0)
    y = F.batch_norm(rows.reshape(rows.shape[0], -1), running_mean.reshape(-1),
                     running_var.reshape(-1), scale.reshape(-1), shift.reshape(-1),
                     False, 0.0, BN_EPS)
    return y.reshape(rows.shape).movedim(0, -2)


def module_forward(block: nn.Module, x: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """``block.forward_with`` on the module's own state; ``generator`` draws
    the dropout mask in training mode."""
    if block.training and generator is None:
        raise ValueError("training-mode dropout needs a torch.Generator")
    return block.forward_with(dict(block.named_parameters()), dict(block.named_buffers()),
                              x, block.training, lambda h, rate: dropout(h, rate, generator))


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
        return module_forward(self, x, generator)

    def forward_with(self, params: Tensors, buffers: Tensors, x: torch.Tensor,
                     train: bool, drop: Dropout) -> torch.Tensor:
        """The block on ``params`` and ``buffers`` named as the module's own
        (each with an optional leading trial axis); in training mode batch
        statistics, the running ones updated in place, and ``drop(h, rate)``."""
        norm = batch_norm_train if train else batch_norm_eval
        h = norm(linear(x, params["layer_1.weight"], params["layer_1.bias"]),
                 params["batchnorm.weight"], params["batchnorm.bias"],
                 buffers["batchnorm.running_mean"], buffers["batchnorm.running_var"])
        h = torch.relu(h)
        if train:
            h = drop(h, self.dropout_rate)
        return linear(h, params["layer_out.weight"], params.get("layer_out.bias"))


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
        return self.forward_with(dict(self.named_parameters()), dict(self.named_buffers()), x,
                                 self.training)

    def forward_with(self, params: Tensors, buffers: Tensors, x: torch.Tensor,
                     train: bool) -> torch.Tensor:
        """The stack on ``params`` and ``buffers`` named as the module's own
        (each with an optional leading trial axis); in training mode batch
        statistics, the running ones updated in place."""
        norm = batch_norm_train if train else batch_norm_eval
        for i in range(self.depth):
            h = F.leaky_relu(linear(x, params[f"dense_{i}.weight"], params[f"dense_{i}.bias"]),
                             0.2)
            x = norm(h, params[f"bn_{i}.weight"], params[f"bn_{i}.bias"],
                     buffers[f"bn_{i}.running_mean"], buffers[f"bn_{i}.running_var"])
        return x


def own(tree: Tensors, prefix: str) -> Tensors:
    """The entries of ``tree`` under ``prefix.``, named as the submodule's own."""
    start = len(prefix) + 1
    return {n[start:]: t for n, t in tree.items() if n.startswith(prefix + ".")}


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
        return self.forward_with(dict(self.named_parameters()), dict(self.named_buffers()), x,
                                 self.training)

    def forward_with(self, params: Tensors, buffers: Tensors, x: torch.Tensor, train: bool):
        """``(mean, log_var)`` on given parameters (see ``_HiddenStack``)."""
        h = self.hidden_layers.forward_with(own(params, "hidden_layers"),
                                            own(buffers, "hidden_layers"), x, train)
        return (linear(h, params["FC_mean.weight"], params["FC_mean.bias"]),
                linear(h, params["FC_var.weight"], params["FC_var.bias"]))


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
        return self.forward_with(dict(self.named_parameters()), dict(self.named_buffers()), x,
                                 self.training)

    def forward_with(self, params: Tensors, buffers: Tensors, x: torch.Tensor,
                     train: bool) -> torch.Tensor:
        """The reconstruction on given parameters (see ``_HiddenStack``)."""
        h = self.hidden_layers.forward_with(own(params, "hidden_layers"),
                                            own(buffers, "hidden_layers"), x, train)
        return torch.sigmoid(linear(h, params["FC_output.weight"], params["FC_output.bias"]))
