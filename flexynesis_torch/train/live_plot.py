"""Live loss plotting for interactive (notebook) HPO runs.

Counterpart of ``flexynesis_tpu/train/live_plot.py``: redraws the train and
validation loss curves (the last ``window`` epochs) after each epoch, reusing
one notebook display handle. ``HyperparameterTuning(plot_losses=True)`` hands
``update(epoch, train_loss, val_loss)`` to the trainer. matplotlib is
imported at the first update.
"""

from __future__ import annotations

from typing import Optional


class LiveLossPlot:
    def __init__(self, hyperparams: Optional[dict] = None, current_step: int = 1,
                 total_steps: int = 1, window: int = 25):
        self.hyperparams = hyperparams or {}
        self.current_step = current_step
        self.total_steps = total_steps
        self.window = window
        self.train_losses: list = []
        self.val_losses: list = []
        self._handle = None
        self._fig = None

    def update(self, epoch: int, train_loss: float, val_loss: Optional[float] = None) -> None:
        from ..utils.plotting import _pyplot

        plt = _pyplot()
        self.train_losses.append(train_loss)
        if val_loss is not None:
            self.val_losses.append(val_loss)
        if self._fig is None:
            self._fig, self._ax = plt.subplots(figsize=(7, 4))
        ax = self._ax
        ax.clear()
        lo = max(len(self.train_losses) - self.window, 0)
        ax.plot(range(lo, len(self.train_losses)), self.train_losses[lo:], label="train_loss")
        if self.val_losses:
            vlo = max(len(self.val_losses) - self.window, 0)
            ax.plot(range(vlo, len(self.val_losses)), self.val_losses[vlo:], label="val_loss")
        ax.set_xlabel("epoch")
        ax.set_ylabel("loss")
        ax.legend(loc="upper right", fontsize=8)
        ax.set_title(f"HPO step {self.current_step}/{self.total_steps}  "
                     + ", ".join(f"{k}={v}" for k, v in list(self.hyperparams.items())[:4]))
        self._display()

    def _display(self) -> None:
        try:
            from IPython import display as ipd

            if self._handle is None:
                self._handle = ipd.display(self._fig, display_id=True)
            else:
                self._handle.update(self._fig)
        except Exception:
            # outside a notebook: draw into the figure only
            self._fig.canvas.draw_idle()

    def close(self) -> None:
        if self._fig is not None:
            from ..utils.plotting import _pyplot

            _pyplot().close(self._fig)
