"""K trials of one architecture stacked on a leading trial axis.

The port's counterpart of ``vmap(model.loss_fn)`` in the JAX trial engine
(``flexynesis_tpu/parallel/trials.py``): every parameter and running
statistic of the single-model network gets a leading K axis, and slice
``[k]`` is trial k's tensor under the single model's ``state_dict`` name.
The trial axis is written out, not vmapped: kernels B1, B2 and B3 are ctypes
calls that ``torch.func.vmap`` cannot trace, the blocks update their running
statistics in place, and the noise comes from explicit generators.

* ``StackedDirectPred``: each block runs its module's own body,
  ``forward_with`` of ``ops/mlp.py`` and ``ops/fused_mlp.py``, on the stacked
  tensors: Linear layers become batched products (``torch.baddbmm``), as JAX
  leaves them to XLA, with an input shared by all trials (a batch of the
  same rows) broadcast; the unfused BatchNorm takes each trial's batch
  statistics from its (K, B, H) slice; ``FusedMLP`` blocks run kernels B1
  (training) and B2 (evaluation) with the trial axis, one launch per block
  for all K trials.
* ``StackedSupervisedVAE`` (for supervised_vae and CrossModalPred, whose
  network encodes the input layers and decodes the output layers) runs the
  network's own ``forward_with`` (``models/supervised_vae.py``) on the
  stacked tensors, with eps and the heads' dropout from a ``TrialNoise``.
  The MMD is computed outside the per-trial ``vmap`` below, for all K trials
  at once (``SupervisedVAE.mmd_of``): with ``fused_kernels`` one launch of
  kernel B3 per decoded layer, the prior read at a trial stride of 0 where
  the trials share their draws; a padded trial's batch carries ``_aux`` and
  takes the masked MMD. It enters the loss as the ``mmd_loss`` term, with its Kendall
  weight ``log_var_mmd_loss``.
* ``StackedTriplet`` (MultiTripletNetwork) runs DirectPred's stacked body
  on the anchor, positive and negative rows as one 3B-row batch, each
  trial's partners drawn from ``TrialNoise`` (once per distinct seed), and
  adds the (K,) triplet loss with its weight ``log_var_triplet_loss``.
* ``StackedGNN`` runs ``GNNNet.forward_with`` on the stacked tensors with
  the template's operator (or the batch's ``_adj``) broadcast to every
  trial: a dense aggregation is one (N, N) @ (N, K * B * F) product.
* The supervised losses and the Kendall weighting
  (``ops.losses.compute_total_loss``) are ``vmap``-ed per trial: ``loss``
  returns a (K,) total, whose sum autograd differentiates (the trials are
  independent).

The models are functional: ``forward`` and ``loss`` take the parameter and
buffer dicts, so the engines can hand them float32 copies of bfloat16-stored
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
from ..models.triplet_encoder import draw_partners, generator_draw, validation_generator
from ..ops.losses import N_PRIOR_SAMPLES, compute_total_loss, triplet_margin_loss
from ..ops.mlp import linear, own, standard_normal

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
    """The noise of K trials from one generator (dropout masks, the VAE's eps
    and prior draws), drawn once per distinct seed in ``seeds`` and shared by
    the trials with that seed, as JAX trials with one seed share one key:
    once for all trials in a same-architecture round (``shared``), once per
    fold in a CV round of K suggestions x k folds, once per trial in a mixed
    round. ``trials`` (a shard of a sharded round): the indices, among
    ``seeds``, of the trials this noise serves; every draw is still made for
    all of ``seeds`` and the shard takes its trials' draws, so a trial's
    noise does not depend on how the round is split."""

    def __init__(self, generator: torch.Generator, seeds, trials=None):
        self.generator = generator
        first: Dict[int, int] = {}
        groups = [first.setdefault(int(s), len(first)) for s in seeds]
        self.n_draws = len(first)
        self.shared = self.n_draws == 1
        local = groups if trials is None else [groups[int(t)] for t in trials]
        # the draw of each trial, None where trial k takes draw k
        self.index = (None if local == list(range(self.n_draws))
                      else torch.tensor(local))

    def spread(self, draws: torch.Tensor) -> torch.Tensor:
        """(K, ...) from ``n_draws`` (n_draws, ...) draws, each trial taking
        its seed's; a shared draw is left as it is."""
        if self.shared or self.index is None:
            return draws
        return draws.index_select(0, self.index.to(draws.device))

    def _shape(self, shape) -> tuple:
        return tuple(shape)[1:] if self.shared else (self.n_draws, *tuple(shape)[1:])

    def dropout(self, h: torch.Tensor, rate: float) -> torch.Tensor:
        keep = torch.rand(self._shape(h.shape), generator=self.generator,
                          device=self.generator.device) >= rate
        return h * self.spread(keep).to(h.device, h.dtype) / (1.0 - rate)

    def normal(self, shape, device) -> torch.Tensor:
        """N(0, 1) draws for a (K, ...) ``shape``: one (...) draw shared by
        the trials, or (K, ...)."""
        return self.spread(standard_normal(self._shape(shape), self.generator, device))


class _Stacked:
    """What the stacked models share: K trials of ``model``'s architecture
    (``model`` is the template; its own weights are not used), the leaf
    order, stacking, trial states, the Flax layout and the loss over the
    subclass's ``forward``."""

    def __init__(self, model, K: int):
        self.model = model
        self.net = model.module
        self.K = int(K)
        net = self.net
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

    # ------------------------------------------------------------------ loss

    def _forward_batch(self, params: Tensors, buffers: Tensors, batch: dict,
                       noise: Optional[TrialNoise], train: bool) -> dict:
        """The stacked forward on a batch (the GNN adds its operator, the
        triplet model draws its partners)."""
        return self.forward(params, buffers, batch["x"], noise, train)

    def _extra_losses(self, out: dict, batch: dict, noise: Optional[TrialNoise],
                      train: bool) -> Tensors:
        """The model's (K,) loss terms beside the supervised ones; none here."""
        return {}

    def loss(self, params: Tensors, buffers: Tensors, batch: dict,
             noise: Optional[TrialNoise] = None, train: bool = True):
        """((K,) totals, {name: (K,) loss}) of the K trials on ``batch``
        ({x: {layer: (B, F) or (K, B, F)}, y: {var: (B,) or (K, B)}[, _aux]}):
        the masked supervised losses, the model's extra terms (the VAE's
        MMD, computed for the K trials at once) and the Kendall weighting of
        one trial, ``vmap``-ed over the K trials."""
        m = self.model
        out = self._forward_batch(params, buffers, batch, noise, train)
        extra = self._extra_losses(out, batch, noise, train)
        y = batch["y"]
        y_dims = 0 if next(iter(y.values())).dim() == 2 else None

        def trial_loss(outputs, labels, log_vars, extra):
            losses = supervised_loss_terms(outputs, labels, m.variables, m.variable_types,
                                           m.surv_event_var, m.surv_time_var)
            losses.update(extra)
            return compute_total_loss(losses, log_vars, m.use_loss_weighting), losses

        log_vars = out.get("log_vars")
        return torch.func.vmap(trial_loss, in_dims=(0, y_dims, None if log_vars is None else 0, 0))(
            out["outputs"], y, log_vars, extra)


class StackedDirectPred(_Stacked):
    """K trials of ``model``'s DirectPred architecture."""

    def _block(self, prefix: str, params: Tensors, buffers: Tensors, x: torch.Tensor,
               noise: Optional[TrialNoise], train: bool) -> torch.Tensor:
        return getattr(self.net, prefix).forward_with(
            own(params, prefix), own(buffers, prefix), x, train,
            noise.dropout if train else None)

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


class StackedSupervisedVAE(_Stacked):
    """K trials of ``model``'s supervised_vae architecture."""

    def forward(self, params: Tensors, buffers: Tensors, x: Tensors,
                noise: Optional[TrialNoise] = None, train: bool = False) -> dict:
        """The network's outputs with a leading K axis (``embeddings``,
        ``outputs``, ``mean``, ``log_var``, ``x_hat``, ``log_vars``) for x
        {layer: (B, F) or (K, B, F)}. Training mode uses batch statistics,
        updates the running ones in place and draws eps and the heads'
        dropout from ``noise``."""
        if train and noise is None:
            raise ValueError("the training-mode latent needs a TrialNoise")
        return self.net.forward_with(params, buffers, x, train,
                                     noise.normal if train else None,
                                     noise.dropout if train else None)

    def _extra_losses(self, out: dict, batch: dict, noise: Optional[TrialNoise],
                      train: bool) -> Tensors:
        """{"mmd_loss": (K,)}: one prior per decoded layer, from ``noise`` in
        training, and in validation the single model's draws from a
        generator seeded with 0, shared by the trials (as JAX's key(0) is)."""
        z = out["embeddings"]
        shape = (self.K, N_PRIOR_SAMPLES, z.shape[-1])
        layers = self.model.decoded_layers
        if train:
            priors = [noise.normal(shape, z.device) for _ in layers]
        else:
            generator = torch.Generator().manual_seed(0)
            priors = [standard_normal(shape[1:], generator, z.device) for _ in layers]
        return {"mmd_loss": self.model.mmd_of(out, batch, priors)}


class StackedTriplet(StackedDirectPred):
    """K trials of ``model``'s MultiTripletNetwork architecture: each trial
    draws its partners from ``noise`` (once per distinct seed, as its
    dropout), validation from ``validation_generator()`` shared by the
    trials; anchor, positive and negative rows run as one 3B-row forward."""

    def forward(self, params: Tensors, buffers: Tensors, x: Tensors,
                noise: Optional[TrialNoise] = None, train: bool = False) -> dict:
        out = super().forward(params, buffers, x, noise, train)
        if self.net.use_loss_weighting:
            out["log_vars"] = {**out["log_vars"],
                               "triplet_loss": params["log_var_triplet_loss"]}
        return out

    def _forward_batch(self, params: Tensors, buffers: Tensors, batch: dict,
                       noise: Optional[TrialNoise], train: bool) -> dict:
        m = self.model
        anchor_idx, groups = batch["anchor_idx"], batch["anchor_group"]
        B = anchor_idx.shape[-1]
        if train:
            shape = groups.shape[-1:] if noise.shared else (noise.n_draws, B)
            gen = noise.generator

            def draw(high):
                u = torch.randint(0, high, shape, generator=gen, device=gen.device)
                return noise.spread(u.to(groups.device))
        else:
            draw = generator_draw(validation_generator(), groups.shape[-1:], groups.device)
        pos_idx, neg_idx = draw_partners(groups, m._group_table, m._group_counts, draw)
        idx3 = torch.cat(torch.broadcast_tensors(anchor_idx, pos_idx, neg_idx), dim=-1)
        x3 = {k: v.index_select(0, idx3.reshape(-1)).reshape(*idx3.shape, v.shape[-1])
              for k, v in batch["_full_x"].items()}
        out = self.forward(params, buffers, x3, noise, train)
        emb = out["embeddings"]
        out["triplet_loss"] = triplet_margin_loss(emb[..., :B, :], emb[..., B:2 * B, :],
                                                  emb[..., 2 * B:, :])
        out["outputs"] = {var: o[..., :B, :] for var, o in out["outputs"].items()}
        return out

    def _extra_losses(self, out: dict, batch: dict, noise: Optional[TrialNoise],
                      train: bool) -> Tensors:
        return {"triplet_loss": out["triplet_loss"]}


class StackedGNN(_Stacked):
    """K trials of ``model``'s GNN architecture: the network's own
    ``forward_with`` on the stacked tensors, the template's operator (or the
    batch's ``_adj``) broadcast to every trial, dropout from ``noise``."""

    def forward(self, params: Tensors, buffers: Tensors, x: Tensors,
                noise: Optional[TrialNoise] = None, train: bool = False,
                adj=None) -> dict:
        if train and noise is None:
            raise ValueError("training-mode dropout needs a TrialNoise")
        return self.net.forward_with(params, buffers, x,
                                     self.model._adj if adj is None else adj, train,
                                     noise.dropout if train else None)

    def _forward_batch(self, params: Tensors, buffers: Tensors, batch: dict,
                       noise: Optional[TrialNoise], train: bool) -> dict:
        return self.forward(params, buffers, batch["x"], noise, train, batch.get("_adj"))


STACKED = {"DirectPred": StackedDirectPred, "supervised_vae": StackedSupervisedVAE,
           "CrossModalPred": StackedSupervisedVAE, "MultiTripletNetwork": StackedTriplet,
           "GNN": StackedGNN}


def stacked_model(model, K: int) -> _Stacked:
    """The stacked class of ``model``'s class, for K trials."""
    return STACKED[model.model_name](model, K)
