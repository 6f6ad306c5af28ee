"""Carry weights between flexynesis_tpu's Flax trees and the port's modules.

``from_flax(params, batch_stats)`` returns a ``state_dict`` for the port's
model module; ``to_flax(module)`` returns ``(params, batch_stats)`` as nested
dicts of numpy arrays, the layout flexynesis_tpu saves and loads. Both cover
the two block layouts:

* ``MLP``: ``layer_1/{kernel,bias}``, ``batchnorm/{scale,bias}``,
  batch_stats ``batchnorm/{mean,var}``, ``layer_out/{kernel[,bias]}``;
* ``FusedMLP``: ``layer_1_kernel``, ``layer_1_bias``, ``bn_scale``,
  ``bn_bias``, batch_stats ``{mean,var}``, ``layer_out/...``;

and, beside the blocks, ``fusion_block/{kernel,bias}`` and ``log_var_<var>``.
Flax Dense kernels are ``(in, out)`` and torch Linear weights ``(out, in)``,
so they are transposed; FusedMLP keeps ``layer_1_kernel`` as ``(in, out)``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .ops.fused_mlp import FusedMLP
from .ops.mlp import MLP


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense_from_flax(prefix: str, p: dict, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _dense_to_flax(linear: nn.Linear) -> dict:
    d = {"kernel": linear.weight.detach().cpu().numpy().T.copy()}
    if linear.bias is not None:
        d["bias"] = linear.bias.detach().cpu().numpy().copy()
    return d


def from_flax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """state_dict of the port's module for a Flax (params, batch_stats) pair."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        stats = (batch_stats or {}).get(name, {})
        if not isinstance(p, dict):  # log_var_<var>
            out[name] = _t(p)
        elif "layer_1" in p:  # MLP
            _dense_from_flax(f"{name}.layer_1", p["layer_1"], out)
            out[f"{name}.batchnorm.weight"] = _t(p["batchnorm"]["scale"])
            out[f"{name}.batchnorm.bias"] = _t(p["batchnorm"]["bias"])
            out[f"{name}.batchnorm.running_mean"] = _t(stats["batchnorm"]["mean"])
            out[f"{name}.batchnorm.running_var"] = _t(stats["batchnorm"]["var"])
            out[f"{name}.batchnorm.num_batches_tracked"] = torch.tensor(0)
            _dense_from_flax(f"{name}.layer_out", p["layer_out"], out)
        elif "layer_1_kernel" in p:  # FusedMLP
            out[f"{name}.layer_1_kernel"] = _t(p["layer_1_kernel"])
            out[f"{name}.layer_1_bias"] = _t(p["layer_1_bias"])
            out[f"{name}.bn_scale"] = _t(p["bn_scale"])
            out[f"{name}.bn_bias"] = _t(p["bn_bias"])
            out[f"{name}.running_mean"] = _t(stats["mean"])
            out[f"{name}.running_var"] = _t(stats["var"])
            _dense_from_flax(f"{name}.layer_out", p["layer_out"], out)
        elif "kernel" in p:  # Dense (fusion_block)
            _dense_from_flax(name, p, out)
        else:
            raise ValueError(f"unrecognised Flax parameter group '{name}'")
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
        if isinstance(child, MLP):
            params[name] = {
                "layer_1": _dense_to_flax(child.layer_1),
                "batchnorm": {
                    "scale": _np(child.batchnorm.weight),
                    "bias": _np(child.batchnorm.bias),
                },
                "layer_out": _dense_to_flax(child.layer_out),
            }
            batch_stats[name] = {"batchnorm": {
                "mean": _np(child.batchnorm.running_mean),
                "var": _np(child.batchnorm.running_var),
            }}
        elif isinstance(child, FusedMLP):
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
        else:
            raise TypeError(f"no Flax layout for submodule '{name}' ({type(child).__name__})")
    return params, batch_stats
