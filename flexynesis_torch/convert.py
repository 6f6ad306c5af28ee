"""Carry weights between flexynesis_tpu's Flax trees and the port's modules.

``from_flax(params, batch_stats)`` returns a ``state_dict`` for the port's
model module, or, for a tree whose every leaf has a leading trial axis K (the
JAX trial engine's stacked tree), each entry stacked on that axis, the layout
``parallel/stacked.py`` trains; ``to_flax(module)`` returns ``(params,
batch_stats)`` as nested dicts of numpy arrays, the layout flexynesis_tpu
saves and loads. The port's
submodules carry the Flax names, so both walk the tree and map its leaves:

* a Dense group ``{kernel[, bias]}`` is an ``nn.Linear`` (the kernel
  transposed: Flax kernels are ``(in, out)``, torch weights ``(out, in)``);
* a BatchNorm group ``{scale, bias}`` with batch_stats ``{mean, var}`` is an
  ``nn.BatchNorm1d`` (MLP's ``batchnorm``, the VAE stacks' ``bn_<i>``);
* a ``FusedMLP`` group keeps flat leaves: ``layer_1_kernel`` (``(in, out)``,
  as kernel B2 takes it), ``layer_1_bias``, ``bn_scale``, ``bn_bias``,
  batch_stats ``{mean, var}``, and ``layer_out``;
* any other group (``encoder_<l>``, ``hidden_layers``, an MLP) is walked
  into, and a bare array (``log_var_<var>``) is a parameter.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .ops.fused_mlp import FusedMLP


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense_from_flax(prefix: str, p: dict, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(np.swapaxes(np.asarray(p["kernel"]), -1, -2))
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _dense_to_flax(linear: nn.Linear) -> dict:
    d = {"kernel": linear.weight.detach().cpu().numpy().T.copy()}
    if linear.bias is not None:
        d["bias"] = linear.bias.detach().cpu().numpy().copy()
    return d


def _group_from_flax(prefix: str, p: dict, stats: dict, out: dict) -> None:
    if "layer_1_kernel" in p:  # FusedMLP
        for leaf in ("layer_1_kernel", "layer_1_bias", "bn_scale", "bn_bias"):
            out[f"{prefix}{leaf}"] = _t(p[leaf])
        out[f"{prefix}running_mean"] = _t(stats["mean"])
        out[f"{prefix}running_var"] = _t(stats["var"])
        _dense_from_flax(f"{prefix}layer_out", p["layer_out"], out)
    elif "kernel" in p:  # Dense
        _dense_from_flax(prefix[:-1], p, out)
    elif "scale" in p:  # BatchNorm
        out[f"{prefix}weight"] = _t(p["scale"])
        out[f"{prefix}bias"] = _t(p["bias"])
        out[f"{prefix}running_mean"] = _t(stats["mean"])
        out[f"{prefix}running_var"] = _t(stats["var"])
        out[f"{prefix}num_batches_tracked"] = torch.tensor(0)
    else:
        for name, sub in p.items():
            if isinstance(sub, dict):
                _group_from_flax(f"{prefix}{name}.", sub, stats.get(name, {}), out)
            else:  # log_var_<var>
                out[f"{prefix}{name}"] = _t(sub)


def from_flax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """state_dict of the port's module for a Flax (params, batch_stats) pair."""
    out: Dict[str, torch.Tensor] = {}
    _group_from_flax("", params, batch_stats or {}, out)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def to_flax(module: nn.Module) -> Tuple[dict, dict]:
    """(params, batch_stats) of the port's module, in flexynesis_tpu's layout."""
    params: dict = {}
    batch_stats: dict = {}
    for name, p in module.named_parameters(recurse=False):
        params[name] = _np(p)
    for name, child in module.named_children():
        if isinstance(child, FusedMLP):
            params[name] = {
                "layer_1_kernel": _np(child.layer_1_kernel),
                "layer_1_bias": _np(child.layer_1_bias),
                "bn_scale": _np(child.bn_scale),
                "bn_bias": _np(child.bn_bias),
                "layer_out": _dense_to_flax(child.layer_out),
            }
            batch_stats[name] = {
                "mean": _np(child.running_mean),
                "var": _np(child.running_var),
            }
        elif isinstance(child, nn.Linear):
            params[name] = _dense_to_flax(child)
        elif isinstance(child, nn.BatchNorm1d):
            params[name] = {"scale": _np(child.weight), "bias": _np(child.bias)}
            batch_stats[name] = {"mean": _np(child.running_mean),
                                 "var": _np(child.running_var)}
        else:
            params[name], stats = to_flax(child)
            if stats:
                batch_stats[name] = stats
    return params, batch_stats
