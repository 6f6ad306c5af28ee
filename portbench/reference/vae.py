"""Plain float32 supervised VAE with MMD regularisation, as flexynesis describes it.

Per omic layer an encoder (Linear -> LeakyReLU(0.2) -> BatchNorm, then a
mean and a log-variance Linear), a Linear over the concatenated means and
one over the concatenated log-variances, the latent ``z = mean + log_var *
eps`` in training (``mean`` in eval mode: flexynesis multiplies the
log-variance itself by the noise), a decoder per layer (Linear ->
LeakyReLU(0.2) -> BatchNorm -> Linear -> sigmoid) and an MLP head per
target (``directpred.block``). The loss is the masked cross-entropy and
``mmd_loss``, the mean over decoded layers of MMD(prior, z) + the
reconstruction MSE, with the Gaussian kernel exp(-|a - b|^2 / d^2) over the
latent width d; Kendall's weighting joins the two in training, validation
adds them. Noise (``eps``, the priors, the heads' keep masks) is given.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .directpred import block, cross_entropy, total_loss

Tensors = Dict[str, torch.Tensor]


def _stack(p: Tensors, stats: Tensors, name: str, x: torch.Tensor, train: bool,
           cfg: dict) -> torch.Tensor:
    h = F.leaky_relu(x @ p[f"{name}.W1"].T + p[f"{name}.b1"], 0.2)
    eps = float(cfg["bn_eps"])
    if train:
        mu, var = h.mean(0), h.var(0, unbiased=False)
        mom = float(cfg["bn_momentum"])
        stats[f"{name}.rm"] = (1 - mom) * stats[f"{name}.rm"] + mom * mu.detach()
        stats[f"{name}.rv"] = (1 - mom) * stats[f"{name}.rv"] + mom * var.detach()
    else:
        mu, var = stats[f"{name}.rm"], stats[f"{name}.rv"]
    return (h - mu) / torch.sqrt(var + eps) * p[f"{name}.g"] + p[f"{name}.beta"]


def _lin(p: Tensors, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.W"].T + p[f"{name}.b"]


def kernel_mean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a.shape[-1]
    return torch.exp(-torch.cdist(a, b).square() / float(d * d)).mean()


def mmd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return kernel_mean(a, a) + kernel_mean(b, b) - 2.0 * kernel_mean(a, b)


def forward(p: Tensors, stats: Tensors, x: Dict[str, torch.Tensor], layers: Sequence[str],
            target: str, train: bool, eps, keep, cfg: dict):
    """(logits, z, {layer: x_hat}); ``stats`` is updated in training mode."""
    hs = {ln: _stack(p, stats, f"enc.{ln}", x[ln], train, cfg) for ln in layers}
    mean = _lin(p, "FC_mean",
                torch.cat([_lin(p, f"enc.{ln}.FC_mean", hs[ln]) for ln in layers], -1))
    log_var = _lin(p, "FC_log_var",
                   torch.cat([_lin(p, f"enc.{ln}.FC_var", hs[ln]) for ln in layers], -1))
    z = mean + log_var * eps if train else mean
    logits = block(p, stats, f"head.{target}", z, train, keep, cfg)
    x_hat = {ln: torch.sigmoid(_lin(p, f"dec.{ln}.FC_output",
                                    _stack(p, stats, f"dec.{ln}", z, train, cfg)))
             for ln in layers}
    return logits, z, x_hat


def losses(p, stats, x, y, layers, target, train, eps, keep, priors: List[torch.Tensor],
           cfg) -> Dict[str, torch.Tensor]:
    logits, z, x_hat = forward(p, stats, x, layers, target, train, eps, keep, cfg)
    terms = [mmd(prior, z) + (x_hat[ln] - x[ln]).square().mean()
             for ln, prior in zip(layers, priors)]
    return {target: cross_entropy(logits, y), "mmd_loss": torch.stack(terms).mean()}


def loss_and_grads(p: Tensors, stats: Tensors, x, y, layers, target, draws, cfg
                   ) -> Tuple[float, Tensors]:
    """(training loss, gradients) of one step; ``draws`` in the order the
    model makes them: eps, the head's keep mask, one prior per layer."""
    normals = [t for kind, t in draws if kind == "normal"]
    keeps = [t for kind, t in draws if kind == "keep"]
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in p.items()}
    parts = losses(leaves, stats, x, y, layers, target, True, normals[0], keeps[0],
                   normals[1:], cfg)
    total = total_loss(parts, leaves)
    grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
    return float(total.detach()), {n: torch.zeros_like(t) if g is None else g
                                   for (n, t), g in zip(leaves.items(), grads)}


@torch.no_grad()
def eval_loss(p, stats, x, y, layers, target, priors, cfg) -> float:
    parts = losses(p, dict(stats), x, y, layers, target, False, None, None, priors, cfg)
    return float(sum(parts.values()))
