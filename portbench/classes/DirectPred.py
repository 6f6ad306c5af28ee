"""DirectPred: an MLP encoder per omic layer, a Linear fusion of the layer
embeddings, an MLP head per target (``reference/directpred.py``)."""

from __future__ import annotations

from typing import Sequence

from portbench.classes._mlp import (arch_of, canon, dataset, hidden_width, keep_width,  # noqa: F401
                                    rows_of, widths)
from portbench.reference import directpred
from portbench.reference.init import law as init_law  # noqa: F401  (torch's law everywhere)


def matmul_shapes(arch: dict, input_dims: Sequence[int], n_classes: int,
                  dataset=None) -> list:
    """The (in, out) of every matrix product of one model of ``arch`` over
    layers of ``input_dims`` with one categorical target of ``n_classes``;
    the widths alone fix them (``dataset`` is not read)."""
    lat = int(arch["latent_dim"])
    sup = max(int(arch["supervisor_hidden_dim"]), 2)
    fac = float(arch["hidden_dim_factor"])
    shapes = []
    for f in input_dims:
        h = hidden_width(f, fac)
        shapes += [(f, h), (h, lat)]
    if len(input_dims) > 1:
        shapes.append((len(input_dims) * lat, lat))
    return shapes + [(lat, sup), (sup, n_classes)]


def noise_sites() -> list:
    """Noise drawn outside ``ops/mlp.py`` and the stacked rounds: none."""
    return []


def noise_blocks(layers, target, cfg, w) -> list:
    """(block, rate) of each keep mask, in draw order: the configuration's
    dropout at every site, whatever the trial's widths ``w``."""
    blocks = [f"enc.{ln}" for ln in layers] + [f"head.{target}"]
    return [(block, float(cfg["dropout"])) for block in blocks]


def train_loss_and_grads(p, stats, x, y, layers, target, draws, cfg):
    """(loss, gradients) of one training step on the given noise ``draws``
    ((kind, tensor) in the order the model draws them)."""
    keeps = [t for kind, t in draws if kind == "keep"]
    return directpred.loss_and_grads(p, stats, x, y, layers, target, keeps, cfg)


def eval_loss(p, stats, x, y, layers, target, draws, cfg) -> float:
    """The validation loss: the plain sum of the losses in eval mode."""
    return directpred.eval_loss(p, stats, x, y, layers, target, cfg)


def eval_forward(p, stats, x, layers, target, cfg):
    """The target's eval-mode logits."""
    return directpred.forward(p, stats, x, layers, target, False, None, cfg)
