"""Masked, static-shape supervised losses.

Counterpart of the supervised part of ``flexynesis_tpu/ops/losses.py``
(reference direct_pred.py:165-223 and modules.py:265-305). Missing labels are
masked with fixed-shape arithmetic, never boolean indexing, so one batch shape
serves every step and no value leaves the device:

* ``masked_mse_loss``    - NaN targets masked;
* ``masked_ce_loss``     - targets -1 or NaN masked;
* ``cox_ph_loss``        - negative Cox partial log-likelihood; invalid rows
                           sort last and are zeroed before any exp or log;
* ``compute_total_loss`` - Kendall et al. uncertainty weighting,
                           sum exp(-s) * L + s;
* ``gaussian_kernel``, ``compute_mmd``, ``mmd_loss`` - the VAE-MMD loss
                           (reference supervised_vae.py:494-550) in plain
                           torch ops: the ``fused_kernels: false`` path and
                           the oracle of kernel B3 (``kernels/mmd.py``);
* ``masked_mmd_loss``    - the same loss restricted to a padded trial's
                           active latent dims (the mixed-architecture trial
                           rounds of ``parallel/hetero.py``);
* ``triplet_margin_loss`` - MultiTripletNetwork's margin loss on squared
                           distances (``models/triplet_encoder.py``).

The MMD and triplet functions take an optional leading trial axis K: ``z``
(K, B, L) against a prior of (K, N, L) or one (N, L) shared by the trials
gives (K,) losses, as ``vmap`` of the JAX function gives them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .mlp import standard_normal

N_PRIOR_SAMPLES = 200  # draws from N(0, I) that the latent is held against


def masked_mse_loss(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """MSE over entries whose target is not NaN; 0.0 when nothing is valid."""
    y_hat = y_hat.reshape(-1)
    y = y.reshape(-1).to(y_hat.dtype)
    valid = torch.isfinite(y)
    y_safe = torch.where(valid, y, torch.zeros_like(y))
    sq = (y_hat - y_safe).square() * valid
    n = valid.sum()
    loss = sq.sum() / n.clamp(min=1)
    return torch.where(n > 0, loss, torch.zeros_like(loss))


def masked_ce_loss(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cross entropy ignoring targets encoded as -1 (or NaN); 0.0 if all missing."""
    y = y.reshape(-1).to(torch.float32)
    valid = (y != -1) & torch.isfinite(y)
    y_idx = torch.where(valid, y, torch.zeros_like(y)).long()
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -log_probs.gather(-1, y_idx[:, None])[:, 0] * valid
    n = valid.sum()
    loss = nll.sum() / n.clamp(min=1)
    return torch.where(n > 0, loss, torch.zeros_like(loss))


def cox_ph_loss(outputs: torch.Tensor, durations: torch.Tensor,
                events: torch.Tensor) -> torch.Tensor:
    """Negative Cox partial log-likelihood, NaN-masked and static-shape.

    Rows with a NaN duration, event or output sort last in the descending-time
    order and contribute nothing; ties keep the naive cumulative sum. Bad rows
    are zeroed before exp/log touch them (double ``where``), so the gradient
    stays finite on all-invalid, all-censored and non-finite batches; a
    non-finite loss falls back to 0.0 (reference modules.py:303-304)."""
    outputs = outputs.reshape(-1).to(torch.float32)
    durations = durations.reshape(-1).to(torch.float32)
    events = events.reshape(-1).to(torch.float32)
    zero = torch.zeros_like(outputs)

    valid = torch.isfinite(durations) & torch.isfinite(events) & torch.isfinite(outputs)
    d_sortkey = torch.where(valid, durations, torch.full_like(durations, -torch.inf))
    order = torch.argsort(-d_sortkey, stable=True)

    valid_sorted = valid[order]
    out_sorted = torch.where(valid_sorted, outputs[order], zero)
    events_sorted = torch.where(valid_sorted, events[order], zero)

    # stabilised log-cumsum-exp of the risk over the descending-time order
    m = torch.where(valid_sorted, out_sorted, torch.full_like(out_sorted, -torch.inf)).max()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    hazards = torch.exp(out_sorted - m) * valid_sorted
    # clamped away from 0 so an empty prefix routes its gradient to the constant
    csum = torch.clamp(torch.cumsum(hazards, dim=0), min=torch.finfo(torch.float32).tiny)
    log_risk_set = torch.log(csum) + m

    uncensored = (events_sorted * (out_sorted - log_risk_set)).sum()
    n_events = torch.where(valid, events, zero).sum()
    loss = -uncensored / n_events.clamp(min=1.0)
    loss = torch.where(n_events > 0, loss, torch.zeros_like(loss))
    return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))


def compute_total_loss(losses: Dict[str, torch.Tensor],
                       log_vars: Optional[Dict[str, torch.Tensor]] = None,
                       use_loss_weighting: bool = True) -> torch.Tensor:
    """Uncertainty-weighted (or plain) sum of per-variable losses.

    With weighting on and more than one loss, total = sum_i exp(-s_i) * L_i + s_i
    with learnable s_i (reference direct_pred.py:192-223)."""
    if use_loss_weighting and log_vars is not None and len(losses) > 1:
        total = 0.0
        for name, loss in losses.items():
            s = log_vars[name].reshape(())
            total = total + torch.exp(-s) * loss + s
        return total
    return sum(losses.values())


def gaussian_kernel(x: torch.Tensor, y: torch.Tensor, divisor=None) -> torch.Tensor:
    """(..., N, M) matrix exp(-||x_i - y_j||^2 / d^2), d = x.shape[-1], through
    the Gram expansion ||x||^2 + ||y||^2 - 2 x.y clamped at 0, as
    ``flexynesis_tpu/ops/losses.py::gaussian_kernel`` computes it; x (..., N,
    d) and y (..., M, d) broadcast over their leading axes. ``divisor``
    replaces d^2 (a padded trial's own latent_dim^2, broadcastable to the
    result)."""
    d = x.shape[-1]
    x2 = x.square().sum(dim=-1, keepdim=True)
    y2 = y.square().sum(dim=-1).unsqueeze(-2)
    sq = torch.clamp(x2 + y2 - 2.0 * (x @ y.mT), min=0.0)
    return torch.exp(-sq / (d * float(d) if divisor is None else divisor))


def kernel_mean(x: torch.Tensor, y: torch.Tensor, divisor=None) -> torch.Tensor:
    """The mean of ``gaussian_kernel`` over its last two axes."""
    return gaussian_kernel(x, y, divisor).mean(dim=(-2, -1))


def compute_mmd(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Maximum mean discrepancy between two sample sets (per trial, with a
    leading trial axis)."""
    return kernel_mean(x, x) + kernel_mean(y, y) - 2.0 * kernel_mean(x, y)


def recon_mse(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reconstruction MSE over the last two axes (per trial)."""
    return (x_hat - x).square().mean(dim=(-2, -1))


def prior_or_draw(z: torch.Tensor, prior: Optional[torch.Tensor],
                  generator: Optional[torch.Generator], n_prior_samples: int):
    """``prior`` as given, else ``n_prior_samples`` N(0, I) draws of z's width
    from ``generator``."""
    if prior is not None:
        return prior
    if generator is None:
        raise ValueError("the MMD prior needs draws or a torch.Generator")
    return standard_normal((n_prior_samples, z.shape[-1]), generator, z.device)


def mmd_loss(z: torch.Tensor, x_hat: torch.Tensor, x: torch.Tensor,
             prior: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             n_prior_samples: int = N_PRIOR_SAMPLES) -> torch.Tensor:
    """MMD(prior, z) + the reconstruction MSE. ``prior`` holds the N(0, I)
    draws; without it they are drawn from ``generator``."""
    prior = prior_or_draw(z, prior, generator, n_prior_samples)
    return compute_mmd(prior, z) + recon_mse(x_hat, x)


def masked_mmd_loss(z: torch.Tensor, x_hat: torch.Tensor, x: torch.Tensor,
                    latent_mask: torch.Tensor, latent_dim: torch.Tensor,
                    prior: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    n_prior_samples: int = N_PRIOR_SAMPLES) -> torch.Tensor:
    """``mmd_loss`` over a padded trial's first ``latent_dim`` latent dims
    (``flexynesis_tpu/ops/losses.py::masked_mmd_loss``): the prior draws and
    z are multiplied by ``latent_mask`` (L,) before the Gram expansion and
    the kernel is divided by the trial's latent_dim^2, so a padded trial
    gives its small architecture's exact loss. With a trial axis,
    ``latent_mask`` is (K, L) and ``latent_dim`` (K,)."""
    prior = prior_or_draw(z, prior, generator, n_prior_samples)
    mask = latent_mask.unsqueeze(-2)
    d2 = latent_dim.to(torch.float32).square().reshape(*latent_dim.shape, 1, 1)
    p, zm = prior * mask, z * mask
    mmd = kernel_mean(p, p, d2) + kernel_mean(zm, zm, d2) - 2.0 * kernel_mean(p, zm, d2)
    return mmd + recon_mse(x_hat, x)


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """mean(relu(||a - p||^2 - ||a - n||^2 + margin)) over the rows (axis -2)
    of (B, L) or (K, B, L) embeddings, on SQUARED distances as the reference
    computes it (triplet_encoder.py:178-194;
    ``flexynesis_tpu/models/triplet_encoder.py::_squared_triplet_loss``),
    which is not ``torch.nn.TripletMarginLoss``."""
    d_pos = (anchor - positive).square().sum(dim=-1)
    d_neg = (anchor - negative).square().sum(dim=-1)
    return torch.clamp(d_pos - d_neg + margin, min=0.0).mean(dim=-1)
