"""Between the program's tensors and the reference's.

The program names its parameters after its modules (``encoder_gex.layer_1.weight``)
and pads a mixed-architecture round to its largest widths. The reference names each
leaf by its role in the published model (``enc.gex.W1`` in the (out, in)
layout) at each trial's own widths. ``canon`` maps a name, ``trial_leaf``
cuts trial k's own leaf out of a stacked (and possibly padded) tensor, and
``trial_keep`` does the same for a recorded dropout mask. Widths come from
the trial's hyperparameters, never from the program's masks.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .work import hidden_width

_MLP = {"layer_1.weight": "W1", "layer_1.bias": "b1", "batchnorm.weight": "g",
        "batchnorm.bias": "beta", "batchnorm.running_mean": "rm",
        "batchnorm.running_var": "rv", "layer_out.weight": "W2", "layer_out.bias": "b2"}
_STACK = {"dense_0.weight": "W1", "dense_0.bias": "b1", "bn_0.weight": "g", "bn_0.bias": "beta",
          "bn_0.running_mean": "rm", "bn_0.running_var": "rv"}


def canon(name: str) -> Optional[str]:
    """The reference's name of the program's state entry ``name`` (the same
    layout), or None for a counter."""
    if name.endswith("num_batches_tracked"):
        return None
    head, _, rest = name.partition(".")
    if head.startswith("log_var_"):
        return f"logvar.{head[len('log_var_'):]}"
    if head == "fusion_block":
        return f"fusion.{'W' if rest == 'weight' else 'b'}"
    if head in ("FC_mean", "FC_log_var"):
        return f"{head}.{'W' if rest == 'weight' else 'b'}"
    for prefix, role in (("encoder_", "enc"), ("head_", "head"), ("decoder_", "dec")):
        if head.startswith(prefix):
            blk = f"{role}.{head[len(prefix):]}"
            if rest.startswith("hidden_layers."):
                return f"{blk}.{_STACK[rest[len('hidden_layers.'):]]}"
            if rest.startswith(("FC_mean.", "FC_var.", "FC_output.")):
                fc, _, leaf = rest.partition(".")
                return f"{blk}.{fc}.{'W' if leaf == 'weight' else 'b'}"
            return f"{blk}.{_MLP[rest]}"
    raise KeyError(f"no reference name for {name}")


def widths(arch: dict, input_dims: Dict[str, int]) -> dict:
    """A trial's widths: hidden per layer, latent, supervisor hidden."""
    return {"hidden": {ln: hidden_width(f, arch["hidden_dim_factor"])
                       for ln, f in input_dims.items()},
            "latent": int(arch["latent_dim"]),
            "sup": max(int(arch["supervisor_hidden_dim"]), 2)}


def _rows_of(name: str, w: dict) -> Tuple[Optional[int], Optional[int]]:
    """(rows, columns) a trial keeps of leaf ``name``; None keeps the axis whole."""
    parts = name.split(".")
    role, leaf = parts[0], parts[-1]
    lat, sup = w["latent"], w["sup"]
    if role in ("fusion", "FC_mean", "FC_log_var"):
        return lat, None      # columns are cut per layer by ``trial_leaf``
    if role == "logvar":
        return None, None
    blk = parts[1]
    if role == "enc":
        hid = w["hidden"][blk]
        if len(parts) == 4:   # the VAE encoder's FC_mean / FC_var: (latent, hidden)
            return lat, hid if leaf == "W" else None
        return {"W1": (hid, None), "W2": (lat, hid), "b2": (lat, None)}.get(leaf, (hid, None))
    if role == "dec":
        hid = w["hidden"][blk]
        if len(parts) == 4:   # FC_output: (features, hidden)
            return None, hid if leaf == "W" else None
        return {"W1": (hid, lat)}.get(leaf, (hid, None))
    # a head: W1 (sup, latent), W2 (classes, sup)
    return {"W1": (sup, lat), "W2": (None, sup), "b2": (None, None)}.get(leaf, (sup, None))


def trial_leaf(name: str, t: torch.Tensor, w: dict, layers: Sequence[str],
               latent_max: int) -> torch.Tensor:
    """Trial ``w``'s own block of one trial's (possibly padded) leaf ``t``
    (the reference's layout), as float32."""
    t = t.float()
    rows, cols = _rows_of(name, w)
    if name.split(".")[0] in ("fusion", "FC_mean", "FC_log_var") and name.endswith("W"):
        lat = w["latent"]
        t = torch.cat([t[:, i * latent_max: i * latent_max + lat] for i in range(len(layers))],
                      dim=1)
    if rows is not None:
        t = t[:rows]
    if cols is not None:
        t = t[:, :cols]
    return t.contiguous()


def trial_keep(block: str, keep: torch.Tensor, w: dict) -> torch.Tensor:
    """A trial's own columns of a recorded (B, H_max) keep mask of ``block``."""
    role, name = block.split(".", 1)
    cols = w["hidden"][name] if role == "enc" else w["sup"]
    return keep[:, :cols].float()
