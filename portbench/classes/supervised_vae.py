"""supervised_vae: per omic layer an encoder and a decoder, a reparameterised
latent, an MLP head per target, an MMD term per decoded layer
(``reference/vae.py``)."""

from __future__ import annotations

from typing import Sequence

from portbench.classes._mlp import (arch_of, canon, dataset, hidden_width, keep_width,  # noqa: F401
                                    rows_of, widths)
from portbench.reference import init, vae


def init_law(name: str) -> str:
    """Xavier-uniform for the encoders' and decoders' weights, else the
    published default (``reference/init.py``)."""
    if name.startswith(("enc.", "dec.")) and name.rsplit(".", 1)[-1].startswith("W"):
        return "xavier"
    return init.law(name)


def matmul_shapes(arch: dict, input_dims: Sequence[int], n_classes: int,
                  dataset=None) -> list:
    """The (in, out) of every matrix product of one model of ``arch``; the
    widths alone fix them (``dataset`` is not read)."""
    lat = int(arch["latent_dim"])
    sup = max(int(arch["supervisor_hidden_dim"]), 2)
    fac = float(arch["hidden_dim_factor"])
    n_layers = len(input_dims)
    shapes = []
    for f in input_dims:
        h = hidden_width(f, fac)
        shapes += [(f, h), (h, lat), (h, lat)]           # hidden, FC_mean, FC_var
    shapes += [(n_layers * lat, lat)] * 2                # FC_mean, FC_log_var
    for f in input_dims:
        h = hidden_width(f, fac)
        shapes += [(lat, h), (h, f)]                     # decoder
    return shapes + [(lat, sup), (sup, n_classes)]


def noise_sites() -> list:
    """The model's own dropout and normal draws (eps, the heads' dropout,
    the priors), beside ``ops/mlp.py``'s and the stacked rounds'."""
    from flexynesis_torch.models import supervised_vae

    return [(supervised_vae, "dropout", "keep"), (supervised_vae, "standard_normal", "normal")]


def noise_blocks(layers, target, cfg, w) -> list:
    """(block, rate) of each keep mask, in draw order: the configuration's
    dropout at every site, whatever the trial's widths ``w``."""
    return [(f"head.{target}", float(cfg["dropout"]))]


def train_loss_and_grads(p, stats, x, y, layers, target, draws, cfg):
    """(loss, gradients) of one training step on the given noise ``draws``."""
    return vae.loss_and_grads(p, stats, x, y, layers, target, draws, cfg)


def eval_loss(p, stats, x, y, layers, target, draws, cfg) -> float:
    """The validation loss: the plain sum of the losses in eval mode."""
    priors = [t for kind, t in draws if kind == "normal"]
    return vae.eval_loss(p, stats, x, y, layers, target, priors, cfg)


def eval_forward(p, stats, x, layers, target, cfg):
    """The target's eval-mode logits."""
    return vae.forward(p, stats, x, layers, target, False, None, None, cfg)[0]
