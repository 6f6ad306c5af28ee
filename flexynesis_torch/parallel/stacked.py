"""K DirectPred trials stacked on a leading trial axis.

The port's counterpart of ``vmap(model.loss_fn)`` in the JAX trial engine
(``flexynesis_tpu/parallel/trials.py``): every parameter and running
statistic of the single-model ``DirectPredNet`` gets a leading K axis, and
slice ``[k]`` is trial k's tensor under the single model's ``state_dict``
name. The trial axis is written out, not vmapped: kernels B1 and B2 are
ctypes calls that ``torch.func.vmap`` cannot trace, the blocks update their
running statistics in place, and dropout draws from explicit generators.

* Each block runs its module's own body, ``forward_with`` of ``ops/mlp.py``
  and ``ops/fused_mlp.py``, on the stacked tensors: Linear layers become
  batched products (``torch.baddbmm``), as JAX leaves them to XLA, with an
  input shared by all trials (a batch of the same rows) broadcast; the
  unfused BatchNorm takes each trial's batch statistics from its (K, B, H)
  slice; ``FusedMLP`` blocks run kernels B1 (training) and B2 (evaluation)
  with the trial axis, one launch per block for all K trials.
* The losses and the Kendall weighting (``ops.losses.compute_total_loss``)
  are ``vmap``-ed per trial: ``loss`` returns a (K,) total, whose sum
  autograd differentiates (the trials are independent).

The model is functional: ``forward`` and ``loss`` take the parameter and
buffer dicts, so the engines can hand it float32 copies of bfloat16-stored
leaves. ``leaf_names`` lists the parameters in the JAX flatten order (sorted
Flax paths), the order the optimizer's seed mixing counts leaves in, and
``flax_layout`` gives each leaf as JAX holds it (Dense kernels (in, out),
where the port's ``nn.Linear`` weight is (out, in)).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..models.base import supervised_loss_terms
from ..ops.losses import compute_total_loss
from ..ops.mlp import linear

Tensors = Dict[str, torch.Tensor]


def flax_path(module: nn.Module, name: str) -> Tuple[Tuple[str, ...], bool]:
    """(the Flax path of parameter ``name`` of ``module``, whether its layout
    is the transpose of the Flax leaf): a Linear's ``weight`` is the Dense
    ``kernel`` transposed, a BatchNorm's ``weight`` its ``scale``."""
    *parents, leaf = name.split(".")
    owner = module.get_submodule(".".join(parents)) if parents else module
    if isinstance(owner, nn.Linear) and leaf == "weight":
        return (*parents, "kernel"), True
    if isinstance(owner, nn.BatchNorm1d) and leaf == "weight":
        return (*parents, "scale"), False
    return (*parents, leaf), False


class TrialNoise:
    """Dropout masks of K trials from one generator: drawn once and shared by
    every trial (``shared``; same-architecture rounds, whose JAX trials share
    one seed and so one key), or drawn for each trial (mixed rounds)."""

    def __init__(self, generator: torch.Generator, shared: bool):
        self.generator, self.shared = generator, shared

    def dropout(self, h: torch.Tensor, rate: float) -> torch.Tensor:
        shape = h.shape[1:] if self.shared else h.shape
        keep = torch.rand(shape, generator=self.generator,
                          device=self.generator.device) >= rate
        return h * keep.to(h.device, h.dtype) / (1.0 - rate)


class StackedDirectPred:
    """K trials of ``model``'s DirectPred architecture (``model`` is the
    template ``DirectPred``; its own weights are not used)."""

    def __init__(self, model, K: int):
        self.model = model
        self.net = model.module
        self.K = int(K)
        net = self.net
        self.blocks = ([f"encoder_{ln}" for ln in net.layer_names]
                       + [f"head_{var}" for var in net.variables])
        params = [n for n, _ in net.named_parameters()]
        paths = {n: flax_path(net, n) for n in params}
        self.leaf_names: List[str] = sorted(params, key=lambda n: paths[n][0])
        self.transposed = {n: paths[n][1] for n in params}
        self.flax_paths = {n: paths[n][0] for n in params}
        self.buffer_names = [n for n, _ in net.named_buffers()
                             if not n.endswith("num_batches_tracked")]

    # ------------------------------------------------------------------ state

    def stack(self, states: List[Tensors]) -> Tuple[Tensors, Tensors]:
        """(params, buffers) stacked from K single-model state dicts."""
        if len(states) != self.K:
            raise ValueError(f"{len(states)} states for {self.K} trials")
        params = {n: torch.stack([s[n] for s in states]) for n in self.leaf_names}
        buffers = {n: torch.stack([s[n] for s in states]) for n in self.buffer_names}
        return params, buffers

    def trial_state(self, params: Tensors, buffers: Tensors, k: int) -> Tensors:
        """Trial k's float32 ``state_dict`` for the single-model module."""
        state = {n: params[n][k].detach().float().clone() for n in self.leaf_names}
        state.update({n: buffers[n][k].detach().clone() for n in self.buffer_names})
        for n, t in self.net.state_dict().items():
            if n.endswith("num_batches_tracked"):
                state[n] = torch.zeros_like(t)
        return state

    def flax_layout(self, tensors: Tensors, names: Optional[List[str]] = None
                    ) -> List[torch.Tensor]:
        """Views of ``tensors`` in the JAX flatten order and the Flax layout."""
        return [tensors[n].mT if self.transposed[n] else tensors[n]
                for n in (names or self.leaf_names)]

    # ---------------------------------------------------------------- forward

    def _block(self, prefix: str, params: Tensors, buffers: Tensors, x: torch.Tensor,
               noise: Optional[TrialNoise], train: bool) -> torch.Tensor:
        start = len(prefix) + 1

        def own(tree: Tensors) -> Tensors:
            return {n[start:]: t for n, t in tree.items() if n.startswith(prefix + ".")}

        return getattr(self.net, prefix).forward_with(
            own(params), own(buffers), x, train, noise.dropout if train else None)

    def forward(self, params: Tensors, buffers: Tensors, x: Tensors,
                noise: Optional[TrialNoise] = None, train: bool = False) -> dict:
        """``{embeddings (K, B, L), outputs {var: (K, B, n_out)}[, log_vars
        {var: (K, 1)}]}`` for x {layer: (B, F) or (K, B, F)}. Training mode
        uses batch statistics, updates the running ones in place and draws
        dropout from ``noise``."""
        if train and noise is None:
            raise ValueError("training-mode dropout needs a TrialNoise")
        net = self.net
        embs = [self._block(f"encoder_{ln}", params, buffers, x[ln], noise, train)
                for ln in net.layer_names]
        emb = torch.cat(embs, dim=-1)
        if net.fusion_block is not None:
            emb = linear(emb, params["fusion_block.weight"], params["fusion_block.bias"])
        out = {"embeddings": emb,
               "outputs": {var: self._block(f"head_{var}", params, buffers, emb, noise, train)
                           for var in net.variables}}
        if net.use_loss_weighting:
            out["log_vars"] = {var: params[f"log_var_{var}"] for var in net.variables}
        return out

    def loss(self, params: Tensors, buffers: Tensors, batch: dict,
             noise: Optional[TrialNoise] = None, train: bool = True):
        """((K,) totals, {var: (K,) loss}) of the K trials on ``batch``
        ({x: {layer: (B, F) or (K, B, F)}, y: {var: (B,) or (K, B)}}): the
        masked supervised losses and the Kendall weighting of one trial,
        ``vmap``-ed over the K trials."""
        m = self.model
        out = self.forward(params, buffers, batch["x"], noise, train)
        y = batch["y"]
        y_dims = 0 if next(iter(y.values())).dim() == 2 else None

        def trial_loss(outputs, labels, log_vars):
            losses = supervised_loss_terms(outputs, labels, m.variables, m.variable_types,
                                           m.surv_event_var, m.surv_time_var)
            return compute_total_loss(losses, log_vars, m.use_loss_weighting), losses

        log_vars = out.get("log_vars")
        return torch.func.vmap(trial_loss, in_dims=(0, y_dims, None if log_vars is None else 0))(
            out["outputs"], y, log_vars)
