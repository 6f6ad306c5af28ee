"""One interface over the reference models, by the configuration's class."""

from __future__ import annotations

from . import directpred, vae


def train_loss_and_grads(model_class: str, p, stats, x, y, layers, target, draws, cfg):
    """(loss, gradients) of one training step on the given noise ``draws``
    ((kind, tensor) in the order the model draws them)."""
    if model_class == "DirectPred":
        keeps = [t for kind, t in draws if kind == "keep"]
        return directpred.loss_and_grads(p, stats, x, y, layers, target, keeps, cfg)
    if model_class == "supervised_vae":
        return vae.loss_and_grads(p, stats, x, y, layers, target, draws, cfg)
    raise ValueError(f"no reference for {model_class}")


def eval_loss(model_class: str, p, stats, x, y, layers, target, draws, cfg) -> float:
    """The validation loss: the plain sum of the losses in eval mode."""
    if model_class == "DirectPred":
        return directpred.eval_loss(p, stats, x, y, layers, target, cfg)
    if model_class == "supervised_vae":
        priors = [t for kind, t in draws if kind == "normal"]
        return vae.eval_loss(p, stats, x, y, layers, target, priors, cfg)
    raise ValueError(f"no reference for {model_class}")


def noise_blocks(model_class: str, layers, target):
    """The block of each keep mask, in draw order."""
    if model_class == "DirectPred":
        return [f"enc.{ln}" for ln in layers] + [f"head.{target}"]
    return [f"head.{target}"]
