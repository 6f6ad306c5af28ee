"""Between the program's tensors and the reference's, for any model class.

A model class's module (``classes/<model_class>.py``) names each leaf
(``canon``), works out a trial's widths from its hyperparameters
(``widths``) and says which rows and columns of a leaf, and of a keep mask, a
trial keeps (``rows_of``, ``keep_width``). ``trial_leaf`` cuts trial k's own
leaf out of a stacked (and possibly padded) tensor by those rules, and
``trial_keep`` does the same for a recorded dropout mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Blocks(NamedTuple):
    """``rows_of``'s columns of a leaf made of ``n`` equal blocks, each cut to
    its first ``own``: the layers' concatenated latent blocks of a fusion
    weight, padded to the round's largest latent, or a flatten readout's
    per-node embeddings."""
    n: int
    own: int


def trial_leaf(model_module, name: str, t: torch.Tensor, w: dict) -> torch.Tensor:
    """Trial ``w``'s own block of one trial's (possibly padded) leaf ``t``
    (the reference's layout), as float32."""
    t = t.float()
    rows, cols = model_module.rows_of(name, w)
    if isinstance(cols, Blocks):
        t = t.reshape(t.shape[0], cols.n, -1)[..., :cols.own].reshape(t.shape[0], -1)
        cols = None
    if rows is not None:
        t = t[:rows]
    if cols is not None:
        t = t[:, :cols]
    return t.contiguous()


def trial_keep(model_module, block: str, keep: torch.Tensor, w: dict) -> torch.Tensor:
    """A trial's own embedding of a recorded keep mask of ``block``: its last
    axis ((B, H_max), or (B, N, E_max) over a graph's nodes) cut to the
    trial's width."""
    return keep[..., :model_module.keep_width(block, w)].float()
