"""The published models' initialisation, and a padded trial's start.

flexynesis initialises every Linear layer by torch's default law, weights and
biases U(+-1/sqrt(fan_in)), unless its model class states another: a class
module's ``init_law`` names the law of each leaf (the supervised VAE's
encoder and decoder weights are Xavier-uniform, U(+-sqrt(6 / (fan_in +
fan_out))), their biases keeping the default law). BatchNorm starts at scale
1, shift 0, running mean 0 and variance 1; a loss weight (``logvar.*``) at 0.

Leaves are named as the reference names them (``enc.gex.W1`` in the
(out, in) layout, see ``directpred.py`` and ``vae.py``). A trial of a round
padded to its largest widths starts from the draw at those widths, cut to
its own and rescaled to its own widths' law: by the ratio of the two bounds.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

ONES = ("g", "rv")
ZEROS = ("beta", "rm")


def weight_of(name: str) -> str:
    """The weight whose fan-in sets the bound of leaf ``name`` (itself for a
    weight; ``b1`` -> ``W1``, ``b`` -> ``W``)."""
    head, _, leaf = name.rpartition(".")
    return f"{head}.W{leaf[1:]}" if leaf.startswith("b") and leaf != "beta" else name


def law(name: str) -> str:
    """``torch``, ``one`` or ``zero`` for leaf ``name``: the published default."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("logvar."):
        return "zero"
    if leaf in ONES:
        return "one"
    if leaf in ZEROS:
        return "zero"
    return "torch"


def bound(kind: str, weight_shape: Tuple[int, ...]) -> float:
    """The half-width of the uniform law for a weight of (out, in) shape."""
    fan_out, fan_in = weight_shape
    if kind == "xavier":
        return math.sqrt(6.0 / (fan_in + fan_out))
    return 1.0 / math.sqrt(fan_in)


def scale(name: str, kind: str, full: Tuple[int, ...], own: Tuple[int, ...]) -> float:
    """The factor that takes a draw at the ``full`` widths of ``name``'s
    weight to the law at the trial's ``own``: sqrt(fan_in_full / fan_in_own),
    or for a Xavier weight sqrt((fan_in + fan_out)_full / (fan_in + fan_out)_own)."""
    if kind in ("one", "zero"):
        return 1.0
    if kind == "xavier":
        return math.sqrt((full[0] + full[1]) / (own[0] + own[1]))
    return math.sqrt(full[1] / own[1])


def fill(u: torch.Tensor, name: str, kind: str,
         weight_shapes: Dict[str, Tuple[int, ...]]) -> torch.Tensor:
    """Leaf ``name`` from ``u``, uniform on [-1, 1): the values of its law ``kind``."""
    if kind == "one":
        return torch.ones_like(u)
    if kind == "zero":
        return torch.zeros_like(u)
    return u * bound(kind, weight_shapes[weight_of(name)])
