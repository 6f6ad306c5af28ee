"""Plain float32 DirectPred, as flexynesis describes it.

One MLP block per omic layer (Linear -> BatchNorm -> ReLU -> Dropout(0.1)
-> Linear), a Linear fusion of the concatenated layer embeddings, one MLP
block per target; masked cross-entropy, and Kendall's uncertainty weighting
(``exp(-s) L + s``) where there is more than one loss. Training-mode
BatchNorm normalises with the biased batch variance and moves the running
statistics by 0.1 of the batch's. Eval mode normalises with the running
statistics.

Parameters are a flat dict of plain tensors named ``<block>.W1`` (H, F),
``<block>.b1``, ``<block>.g``, ``<block>.beta``, ``<block>.W2`` (O, H),
``<block>.b2`` (absent for one output), running statistics ``<block>.rm``
and ``<block>.rv``, ``fusion.W`` and ``fusion.b``, and ``logvar.<target>``.
Blocks are ``enc.<layer>`` and ``head.<target>``. Dropout takes its keep
masks as given (``keeps``, one per block in the order encoders, then heads).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]


def block(p: Tensors, stats: Tensors, name: str, x: torch.Tensor, train: bool,
          keep: Optional[torch.Tensor], cfg: dict) -> torch.Tensor:
    h = x @ p[f"{name}.W1"].T + p[f"{name}.b1"]
    eps = float(cfg["bn_eps"])
    if train:
        mu = h.mean(0)
        var = h.var(0, unbiased=False)
        hn = (h - mu) / torch.sqrt(var + eps)
        mom = float(cfg["bn_momentum"])
        stats[f"{name}.rm"] = (1 - mom) * stats[f"{name}.rm"] + mom * mu.detach()
        stats[f"{name}.rv"] = (1 - mom) * stats[f"{name}.rv"] + mom * var.detach()
    else:
        hn = (h - stats[f"{name}.rm"]) / torch.sqrt(stats[f"{name}.rv"] + eps)
    a = torch.relu(hn * p[f"{name}.g"] + p[f"{name}.beta"])
    if train:
        a = a * keep / (1.0 - float(cfg["dropout"]))
    out = a @ p[f"{name}.W2"].T
    if f"{name}.b2" in p:
        out = out + p[f"{name}.b2"]
    return out


def forward(p: Tensors, stats: Tensors, x: Dict[str, torch.Tensor], layers: Sequence[str],
            target: str, train: bool, keeps: Optional[List[torch.Tensor]],
            cfg: dict) -> torch.Tensor:
    """The target's logits (B, C); ``stats`` is updated in training mode."""
    keeps = list(keeps) if train else [None] * (len(layers) + 1)
    embs = [block(p, stats, f"enc.{ln}", x[ln], train, keeps[i], cfg)
            for i, ln in enumerate(layers)]
    emb = torch.cat(embs, dim=-1)
    if len(layers) > 1:
        emb = emb @ p["fusion.W"].T + p["fusion.b"]
    return block(p, stats, f"head.{target}", emb, train, keeps[len(layers)], cfg)


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows with a label (code >= 0)."""
    valid = y >= 0
    return F.cross_entropy(logits[valid], y[valid].long(), reduction="mean")


def total_loss(losses: Dict[str, torch.Tensor], p: Tensors) -> torch.Tensor:
    """Kendall's weighting where there is more than one loss, else the loss."""
    if len(losses) > 1:
        return sum(torch.exp(-p[f"logvar.{k}"].reshape(())) * v + p[f"logvar.{k}"].reshape(())
                   for k, v in losses.items())
    return sum(losses.values())


def loss_and_grads(p: Tensors, stats: Tensors, x, y, layers, target, keeps,
                   cfg) -> Tuple[float, Tensors]:
    """(training loss, gradients of every parameter) of one step's batch."""
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in p.items()}
    logits = forward(leaves, stats, x, layers, target, True, keeps, cfg)
    total = total_loss({target: cross_entropy(logits, y)}, leaves)
    grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
    return float(total.detach()), {n: torch.zeros_like(t) if g is None else g
                                   for (n, t), g in zip(leaves.items(), grads)}


@torch.no_grad()
def eval_loss(p: Tensors, stats: Tensors, x, y, layers, target, cfg) -> float:
    logits = forward(p, dict(stats), x, layers, target, False, None, cfg)
    return float(cross_entropy(logits, y))
