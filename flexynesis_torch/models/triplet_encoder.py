"""MultiTripletNetwork: triplet-margin metric learning + supervisor heads.

Counterpart of ``flexynesis_tpu/models/triplet_encoder.py`` (reference
models/triplet_encoder.py): DirectPred's backbone (per-modality MLP encoders,
fusion, heads) with plain MLP blocks (the JAX model never passes
``fused_kernels``, so kernels B1 and B2 are not on its path), the squared-
distance triplet margin loss (``ops.losses.triplet_margin_loss``) on the
anchor, positive and negative embeddings, the supervised losses on the
anchors, and a Kendall weight ``log_var_triplet_loss``. The first target
variable must be categorical.

The sampler: the label groups are padded index tables on the model's device
(the missing-label group joins only the negative pool), and each step draws
its partners there, from the generator that draws its dropout: a positive
uniform in the anchor's group, a negative group uniform over the other
groups, a negative uniform in it (``u % count`` of a draw in [0, 2^30), as
JAX draws them with ``jax.random.randint``; the bits differ, the law is the
same). Validation draws from a CPU generator seeded with 0, where JAX uses
``key(0)``. Anchor, positive and negative rows encode as one 3B-row forward,
so BatchNorm's batch statistics span all 3B rows.

A batch is ``{anchor_idx, anchor_group, y, _full_x}``: the anchors' sample
indices and groups and labels, row-sliced by the trainers, and the whole
matrices under ``_full_x``, passed whole. Index splits and
``n_train_samples`` count anchors.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..data.dataset import TripletMultiOmicDataset
from ..ops.losses import compute_total_loss, triplet_margin_loss
from .base import BaseModel, supervised_loss_terms
from .direct_pred import DirectPredNet

PARTNER_RANGE = 1 << 30  # the draws that pick a slot in a group (u % count)


class TripletNet(DirectPredNet):
    """DirectPred's network with an extra Kendall weight for the triplet loss."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.use_loss_weighting:
            self.log_var_triplet_loss = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        if self.use_loss_weighting:
            self.log_var_triplet_loss.zero_()

    def forward(self, x: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> dict:
        out = super().forward(x, generator)
        if self.use_loss_weighting:
            out["log_vars"] = {**out["log_vars"], "triplet_loss": self.log_var_triplet_loss}
        return out


def draw_partners(anchor_group: torch.Tensor, table: torch.Tensor, counts: torch.Tensor,
                  draw: Callable[[int], torch.Tensor]):
    """(positive, negative) sample indices for anchors of ``anchor_group``
    (any shape). ``draw(high)`` returns int64 draws in [0, high) of the
    anchors' shape, in the order positive slot, negative group, negative
    slot."""
    n_groups = table.shape[0]
    pos_u = draw(PARTNER_RANGE)
    pos_idx = table[anchor_group, pos_u % counts[anchor_group]]
    g_u = draw(max(n_groups - 1, 1))
    neg_grp = torch.clamp(g_u + (g_u >= anchor_group).long(), max=n_groups - 1)
    neg_u = draw(PARTNER_RANGE)
    neg_idx = table[neg_grp, neg_u % counts[neg_grp]]
    return pos_idx, neg_idx


def generator_draw(generator: torch.Generator, shape, device):
    """A ``draw`` for ``draw_partners`` from ``generator``, moved to ``device``."""
    def draw(high: int) -> torch.Tensor:
        return torch.randint(0, high, tuple(shape), generator=generator,
                             device=generator.device).to(device)
    return draw


def validation_generator() -> torch.Generator:
    """Validation's partners come from this CPU generator, seeded with 0
    (JAX's ``key(0)``), the same numbers on every device."""
    return torch.Generator().manual_seed(0)


class MultiTripletNetwork(BaseModel):
    model_name = "MultiTripletNetwork"

    def __init__(self, config, dataset, target_variables, *args, **kwargs):
        main_var = target_variables[0]
        if dataset.variable_types[main_var] != "categorical":
            raise ValueError(
                "The first target variable must be categorical for "
                "MultiTripletNetwork (reference triplet_encoder.py:69-75)."
            )
        self.main_var = main_var
        super().__init__(config, dataset, target_variables, *args, **kwargs)
        self._build_sampler(dataset)

    def _build_module(self) -> nn.Module:
        return TripletNet(
            layer_names=self.layers,
            input_dims=self.input_dims,
            latent_dim=int(self.config["latent_dim"]),
            hidden_dim_factor=float(self.config["hidden_dim_factor"]),
            supervisor_hidden_dim=int(self.config["supervisor_hidden_dim"]),
            output_dims=dict(self.output_dims),
            use_loss_weighting=self.use_loss_weighting,
        )

    # ------------------------------------------------------------- sampler

    def _build_sampler(self, dataset) -> None:
        """Padded per-label index tables (``TripletMultiOmicDataset``'s groups:
        label order, then the missing-label group), the anchors (samples with
        a label) and their groups."""
        triplets = TripletMultiOmicDataset(dataset, self.main_var)
        groups = list(triplets.label_groups.values())
        group_of = np.full(len(triplets.labels), -1, dtype=np.int64)
        for gi, (key, idxs) in enumerate(triplets.label_groups.items()):
            if key != "missing":
                group_of[idxs] = gi
        table = np.zeros((len(groups), max(len(g) for g in groups)), dtype=np.int64)
        for gi, idxs in enumerate(groups):
            table[gi, :len(idxs)] = idxs
        self._group_table = torch.from_numpy(table).to(self.device)
        self._group_counts = torch.tensor([len(g) for g in groups], dtype=torch.int64,
                                          device=self.device)
        self._n_groups = len(groups)
        self._anchor_indices = triplets.anchor_indices
        self._anchor_groups = group_of[self._anchor_indices]

    def partners(self, anchor_group: torch.Tensor, generator: Optional[torch.Generator]):
        """(positive, negative) indices drawn for ``anchor_group``, from
        ``generator`` in training, from ``validation_generator()`` without one."""
        generator = generator if generator is not None else validation_generator()
        return draw_partners(anchor_group, self._group_table, self._group_counts,
                             generator_draw(generator, anchor_group.shape, self.device))

    # ---------------------------------------------------------- batch logic

    @classmethod
    def n_units(cls, dataset, target_variables) -> int:
        return len(TripletMultiOmicDataset(dataset, target_variables[0]))

    def n_train_samples(self, dataset=None) -> int:
        return len(self._anchor_indices)

    def make_batch(self, dataset, indices=None) -> dict:
        """Training batches over anchors: ``indices`` index the ANCHOR list
        (the reference's triplet dataset length is the anchor count)."""
        dat, ann = dataset.as_arrays()
        anchors, groups = self._anchor_indices, self._anchor_groups
        if indices is not None:
            indices = np.asarray(indices)
            anchors, groups = anchors[indices], groups[indices]
        y_vars = set(self.variables)
        if self.surv_time_var:
            y_vars.add(self.surv_time_var)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)

        return {
            "anchor_idx": torch.from_numpy(anchors.astype(np.int64)).to(self.device),
            "anchor_group": torch.from_numpy(groups.astype(np.int64)).to(self.device),
            "y": {v: put(np.asarray(ann[v])[anchors]) for v in sorted(y_vars)},
            "_full_x": {k: put(dat[k]) for k in self.layers},
        }

    def loss_fn(self, batch: dict, generator: Optional[torch.Generator] = None,
                train: bool = True, partners=None):
        """``(total, {name: loss})``: the triplet loss of the anchors and
        their drawn partners (``partners`` = (positive, negative) indices
        replaces the draw), then the supervised losses on the anchors."""
        self.module.train(train)
        anchor_idx = batch["anchor_idx"]
        B = anchor_idx.shape[0]
        pos_idx, neg_idx = (partners if partners is not None
                            else self.partners(batch["anchor_group"], generator))
        idx3 = torch.cat([anchor_idx, pos_idx, neg_idx])
        x3 = {k: v.index_select(0, idx3) for k, v in batch["_full_x"].items()}
        out = self.module(x3, generator)
        emb = out["embeddings"]
        outputs = {var: o[:B] for var, o in out["outputs"].items()}
        losses = {"triplet_loss": triplet_margin_loss(emb[:B], emb[B:2 * B], emb[2 * B:])}
        losses.update(supervised_loss_terms(
            outputs, batch["y"], self.variables, self.variable_types,
            self.surv_event_var, self.surv_time_var,
        ))
        total = compute_total_loss(losses, out.get("log_vars"), self.use_loss_weighting)
        return total, losses
