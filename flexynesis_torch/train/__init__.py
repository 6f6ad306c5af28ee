"""Training runtime: the trainer, the HPO engine, fine-tuning.

flexynesis_tpu.train's names, imported lazily: importing a submodule such as
``train.live_plot`` loads nothing else of the package.
"""

from __future__ import annotations

from .._lazy import lazy_exports

_NAMES = {
    "trainer": ("Trainer", "EarlyStopper", "train_val_split", "kfold_indices"),
    "hpo": ("HyperparameterTuning",),
    "finetune": ("FineTuner",),
}
_LAZY_ATTRS, __getattr__, __dir__ = lazy_exports(__name__, _NAMES)
__all__ = sorted(_LAZY_ATTRS)
