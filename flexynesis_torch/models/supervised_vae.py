"""Supervised VAE with MMD regularisation (VAE-MMD).

Counterpart of ``flexynesis_tpu/models/supervised_vae.py`` (reference
models/supervised_vae.py): one ``Encoder`` per modality (one hidden layer of
max(input_dim * hidden_dim_factor, 2)), ``FC_mean`` and ``FC_log_var`` over
the concatenated per-modality means and log-variances, the latent
``z = mean + log_var * eps`` (the reference's reparameterisation, kept as it
is), a sigmoid ``Decoder`` per modality, supervisor ``MLP`` heads on z, and
per decoded layer the loss MMD(N(0, I) prior of 200 draws, z) plus the
reconstruction MSE, averaged over the layers and weighted as ``mmd_loss``.
In eval mode eps = 0, so z = mean.

Submodules and parameters carry the Flax module's names so
``convert.from_flax`` maps one tree onto the other. With ``fused_kernels``
set the MMD runs through kernel B3 (``kernels/mmd.py``), as the JAX model
picks ``mmd_loss_pallas`` (supervised_vae.py:156-158).

Noise (eps, the heads' dropout, the prior) is drawn from the ``loss_fn``
generator. Validation passes none, and the prior then comes from a generator
seeded with 0, so the validation loss is the same function in every epoch,
as the JAX model's ``jax.random.key(0)`` makes it there.

``SupervisedVAENet.forward_with`` is the network's function on given
parameters, which may carry a leading trial axis (the stacked trials of
``parallel/stacked.py``), and ``SupervisedVAE.mmd_of`` the MMD loss of its
output against given prior draws. A batch that carries ``_aux`` (a padded
trial's ``latent_mask`` and ``latent_dim``, ``parallel/hetero.py``) takes
``masked_mmd_loss``, with ``fused_kernels`` too, as the JAX model does
(supervised_vae.py:143-156): a padded round never reaches B3.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..kernels.mmd import mmd_loss_fused
from ..ops.initializers import reset_linear_
from ..ops.losses import N_PRIOR_SAMPLES, masked_mmd_loss, mmd_loss
from ..ops.mlp import MLP, Decoder, Encoder, Tensors, dropout, linear, own, standard_normal
from .base import BaseModel


def hidden_width(dim: int, factor: float) -> int:
    return max(int(dim * factor), 2)


class SupervisedVAENet(nn.Module):
    """Encodes the layers ``layer_names`` and decodes ``decoded``, a list of
    (name, width) pairs that defaults to the encoded layers."""

    def __init__(self, layer_names: Sequence[str], input_dims: Sequence[int],
                 latent_dim: int, hidden_dim_factor: float,
                 supervisor_hidden_dim: int, output_dims: Dict[str, int],
                 use_loss_weighting: bool = True,
                 decoded: Optional[Sequence[Tuple[str, int]]] = None):
        super().__init__()
        self.layer_names = list(layer_names)
        self.decoded_names = [ln for ln, _ in decoded] if decoded else self.layer_names
        self.variables = list(output_dims)
        self.use_loss_weighting = use_loss_weighting
        for ln, d in zip(self.layer_names, input_dims):
            self.add_module(f"encoder_{ln}",
                            Encoder(d, [hidden_width(d, hidden_dim_factor)], latent_dim))
        self.FC_mean = nn.Linear(len(self.layer_names) * latent_dim, latent_dim)
        self.FC_log_var = nn.Linear(len(self.layer_names) * latent_dim, latent_dim)
        for ln, d in (decoded or zip(self.layer_names, input_dims)):
            self.add_module(f"decoder_{ln}",
                            Decoder(latent_dim, [hidden_width(d, hidden_dim_factor)], d))
        for var, n_out in output_dims.items():
            self.add_module(f"head_{var}", MLP(latent_dim, supervisor_hidden_dim, n_out))
        if use_loss_weighting:
            for var in self.variables + ["mmd_loss"]:
                self.register_parameter(f"log_var_{var}", nn.Parameter(torch.zeros(1)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for ln in self.layer_names:
            getattr(self, f"encoder_{ln}").reset_parameters(generator)
        reset_linear_(self.FC_mean, generator)
        reset_linear_(self.FC_log_var, generator)
        for ln in self.decoded_names:
            getattr(self, f"decoder_{ln}").reset_parameters(generator)
        for var in self.variables:
            getattr(self, f"head_{var}").reset_parameters(generator)
        if self.use_loss_weighting:
            for var in self.variables + ["mmd_loss"]:
                getattr(self, f"log_var_{var}").zero_()

    def encode(self, x: Dict[str, torch.Tensor],
               train: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, log_var) of the latent (supervised_vae.py:83-91 of the JAX
        package): with ``train`` the encoders use batch statistics and update
        the running ones, else the running statistics; None follows the
        module's mode."""
        return self.encode_with(dict(self.named_parameters()), dict(self.named_buffers()), x,
                                self.training if train is None else train)

    def forward(self, x: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> dict:
        """``generator`` draws eps and the heads' dropout in training mode."""
        if self.training and generator is None:
            raise ValueError("the training-mode latent needs a torch.Generator")
        return self.forward_with(
            dict(self.named_parameters()), dict(self.named_buffers()), x, self.training,
            lambda shape, device: standard_normal(shape, generator, device),
            lambda h, rate: dropout(h, rate, generator))

    def _block(self, name: str, params: Tensors, buffers: Tensors, inp, train: bool):
        return getattr(self, name).forward_with(own(params, name), own(buffers, name), inp,
                                                train)

    def encode_with(self, params: Tensors, buffers: Tensors, x: Dict[str, torch.Tensor],
                    train: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """``encode`` on ``params`` and ``buffers`` (as ``forward_with``)."""
        encoded = [self._block(f"encoder_{ln}", params, buffers, x[ln], train)
                   for ln in self.layer_names]
        mean = linear(torch.cat([m for m, _ in encoded], dim=-1), params["FC_mean.weight"],
                      params["FC_mean.bias"])
        log_var = linear(torch.cat([lv for _, lv in encoded], dim=-1),
                         params["FC_log_var.weight"], params["FC_log_var.bias"])
        return mean, log_var

    def forward_with(self, params: Tensors, buffers: Tensors, x: Dict[str, torch.Tensor],
                     train: bool, normal: Optional[Callable] = None,
                     drop: Optional[Callable] = None) -> dict:
        """The network on ``params`` and ``buffers`` named as the module's own
        (each with an optional leading trial axis). In training mode the
        blocks use batch statistics and update the running ones in place,
        ``normal(shape, device)`` draws eps and ``drop(h, rate)`` the heads'
        dropout."""
        mean, log_var = self.encode_with(params, buffers, x, train)
        z = mean + log_var * normal(log_var.shape, log_var.device) if train else mean
        out = {
            "embeddings": z,
            "outputs": {var: getattr(self, f"head_{var}").forward_with(
                own(params, f"head_{var}"), own(buffers, f"head_{var}"), z, train, drop)
                for var in self.variables},
            "mean": mean,
            "log_var": log_var,
            "x_hat": {ln: self._block(f"decoder_{ln}", params, buffers, z, train)
                      for ln in self.decoded_names},
        }
        if self.use_loss_weighting:
            out["log_vars"] = {var: params[f"log_var_{var}"]
                               for var in self.variables + ["mmd_loss"]}
        return out


class SupervisedVAE(BaseModel):
    model_name = "supervised_vae"

    @property
    def decoded_layers(self):
        """The layers whose reconstruction enters the loss."""
        return self.layers

    def _build_module(self) -> nn.Module:
        return SupervisedVAENet(
            layer_names=self.layers,
            input_dims=self.input_dims,
            latent_dim=int(self.config["latent_dim"]),
            hidden_dim_factor=float(self.config["hidden_dim_factor"]),
            supervisor_hidden_dim=int(self.config["supervisor_hidden_dim"]),
            output_dims=dict(self.output_dims),
            use_loss_weighting=self.use_loss_weighting,
        )

    def _extra_losses(self, out, batch, generator):
        """MMD against a fresh prior plus the reconstruction MSE per decoded
        layer, averaged (flexynesis_tpu supervised_vae.py:137-163)."""
        if generator is None:  # validation: the same prior in every epoch
            generator = torch.Generator().manual_seed(0)
        z = out["embeddings"]
        priors = [standard_normal((N_PRIOR_SAMPLES, z.shape[-1]), generator, z.device)
                  for _ in self.decoded_layers]
        return {"mmd_loss": self.mmd_of(out, batch, priors)}

    def mmd_of(self, out: dict, batch: dict, priors: List[torch.Tensor]) -> torch.Tensor:
        """The MMD loss of the forward output ``out`` on ``batch``, one prior
        per decoded layer, averaged over the layers; (K,) with a trial axis.
        ``batch["_aux"]`` selects ``masked_mmd_loss``, else ``fused_kernels``
        selects kernel B3."""
        z, aux = out["embeddings"], batch.get("_aux")
        if aux is not None:
            terms = [masked_mmd_loss(z, out["x_hat"][ln], batch["x"][ln], aux["latent_mask"],
                                     aux["latent_dim"], prior=p)
                     for ln, p in zip(self.decoded_layers, priors)]
        else:
            loss = mmd_loss_fused if self.config.get("fused_kernels") else mmd_loss
            terms = [loss(z, out["x_hat"][ln], batch["x"][ln], prior=p)
                     for ln, p in zip(self.decoded_layers, priors)]
        return torch.stack(terms).mean(dim=0)
