"""Between the program's tensors and the reference's, for any model class.

A model class's module (``classes/<model_class>.py``) names each leaf
(``canon``), works out a trial's widths from its hyperparameters
(``widths``) and says which rows and columns of a leaf, and of a keep mask, a
trial keeps (``rows_of``, ``keep_width``). ``trial_leaf`` cuts trial k's own
leaf out of a stacked (and possibly padded) tensor by those rules, and
``trial_keep`` does the same for a recorded dropout mask.
"""

from __future__ import annotations

from typing import Sequence

import torch

# ``rows_of``'s columns of a leaf over the layers' concatenated latent
# blocks: each block of ``latent_max`` columns cut to the trial's latent width
PER_LAYER = "per_layer"


def trial_leaf(model_module, name: str, t: torch.Tensor, w: dict, layers: Sequence[str],
               latent_max: int) -> torch.Tensor:
    """Trial ``w``'s own block of one trial's (possibly padded) leaf ``t``
    (the reference's layout), as float32."""
    t = t.float()
    rows, cols = model_module.rows_of(name, w)
    if cols == PER_LAYER:
        lat = w["latent"]
        t = torch.cat([t[:, i * latent_max: i * latent_max + lat] for i in range(len(layers))],
                      dim=1)
        cols = None
    if rows is not None:
        t = t[:rows]
    if cols is not None:
        t = t[:, :cols]
    return t.contiguous()


def trial_keep(model_module, block: str, keep: torch.Tensor, w: dict) -> torch.Tensor:
    """A trial's own columns of a recorded (B, H_max) keep mask of ``block``."""
    return keep[:, :model_module.keep_width(block, w)].float()
