"""Shared compute blocks: the MLP blocks, the masked losses, the optimizers.

flexynesis_tpu.ops' names, imported lazily: importing a submodule loads
nothing else of the package.
"""

from __future__ import annotations

from .._lazy import lazy_exports

_NAMES = {
    "mlp": ("MLP", "Encoder", "Decoder"),
    "losses": ("masked_mse_loss", "masked_ce_loss", "cox_ph_loss", "compute_total_loss",
               "gaussian_kernel", "compute_mmd", "mmd_loss", "triplet_margin_loss"),
}
_LAZY_ATTRS, __getattr__, __dir__ = lazy_exports(__name__, _NAMES)
__all__ = sorted(_LAZY_ATTRS)
