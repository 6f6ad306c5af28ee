"""What DirectPred and supervised_vae share: the port's MLP blocks
(``ops/mlp.py``'s MLP, Encoder and Decoder), their leaf names, a trial's
widths and the rows and columns it keeps.

The program names its parameters after its modules (``encoder_gex.layer_1.weight``)
and pads a mixed-architecture round to its largest widths. The reference names
each leaf by its role in the published model (``enc.gex.W1`` in the (out, in)
layout) at each trial's own widths. Widths come from the trial's
hyperparameters, never from the program's masks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from portbench.adapt import Blocks
from portbench.data import to_dataset

ARCH = ("latent_dim", "hidden_dim_factor", "supervisor_hidden_dim")

_MLP = {"layer_1.weight": "W1", "layer_1.bias": "b1", "batchnorm.weight": "g",
        "batchnorm.bias": "beta", "batchnorm.running_mean": "rm",
        "batchnorm.running_var": "rv", "layer_out.weight": "W2", "layer_out.bias": "b2"}
_STACK = {"dense_0.weight": "W1", "dense_0.bias": "b1", "bn_0.weight": "g", "bn_0.bias": "beta",
          "bn_0.running_mean": "rm", "bn_0.running_var": "rv"}


def dataset(cohort, split: str, cfg: dict):
    return to_dataset(cohort, split, cfg["target"])


def arch_of(cfg: dict) -> dict:
    """The architecture a configuration fixes."""
    return {k: cfg[k] for k in ARCH}


def hidden_width(n_in: int, factor: float) -> int:
    return max(int(n_in * float(factor)), 2)


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


def rows_of(name: str, w: dict) -> Tuple[Optional[int], object]:
    """(rows, columns) a trial keeps of leaf ``name``; None keeps the axis
    whole, ``Blocks`` keeps each layer's latent block of the columns."""
    parts = name.split(".")
    role, leaf = parts[0], parts[-1]
    lat, sup = w["latent"], w["sup"]
    if role in ("fusion", "FC_mean", "FC_log_var"):
        return lat, Blocks(len(w["hidden"]), lat) if leaf == "W" else None
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


def keep_width(block: str, w: dict) -> int:
    """The columns a trial keeps of a recorded keep mask of ``block``."""
    role, name = block.split(".", 1)
    return w["hidden"][name] if role == "enc" else w["sup"]
