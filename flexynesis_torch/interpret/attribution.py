"""Marker discovery: IntegratedGradients and GradientShap as autograd programs.

Counterpart of ``flexynesis_tpu/interpret/attribution.py`` (reference
direct_pred.py:432-590, Captum): zero baselines, per-class attributions with
respect to every input layer, |attr| summed over the samples and divided by
their number, assembled into rows of target_variable, target_class,
target_class_label, layer, name and importance.

Where JAX ``vmap``s a gradient over the IG steps (and the GradientShap
draws), the port folds them into the row axis: the points of a batch of B
rows and S steps are one ``(S * B, F)`` input per layer, so each batch runs
one eval forward (``BaseModel._attribution_forward``) and, per class, one
``torch.autograd.grad`` with respect to the inputs only. Parameters do not
require gradients meanwhile, so no weight gradient is formed. IG uses
Gauss-Legendre nodes and weights (Captum's default); GradientShap draws one
uniform scale per sample and draw, shared across layers, with JAX's key
schedule through ``utils/prng.py``, so its draws equal the JAX package's bit
for bit. Products run in f32 (PyTorch's default keeps TF32 off), as on the
eval path. Each attribution function takes a list of classes and returns one
``{layer: (B, F)}`` attribution per class.

The GNN's forward carries its operator (``GNN._module_eval``, as JAX's
``_eval_extra_args`` passes it), and ``GNN.compute_feature_importance``
splits the (nodes x layers) attributions back per omic layer.

A DirectPred built with ``fused_kernels`` cannot be attributed: its eval
blocks are kernel B2, which has no backward, in the JAX package as here.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..models.base import num_classes_for
from ..ops.fused_mlp import FusedMLP
from ..train.space import Categorical
from ..utils import prng

METHODS = ("IntegratedGradients", "GradientShap")
# Rows per attribution batch and GradientShap's key seed. Both fix results:
# the tail batch's zero padding and GradientShap's (BATCH, 1) draw shape, as
# the JAX package has them.
BATCH = 512
SEED = 42
FUSED_REFUSAL = (
    "marker finding on a DirectPred built with fused_kernels is not supported: "
    "its eval blocks are kernel B2 (the fused Linear->BatchNorm->ReLU), which has "
    "no backward, in flexynesis_tpu as here (B2's pallas_call has no VJP, so "
    "jax.grad fails with 'Linearization failed'). Train with fused_kernels false, "
    "or pass --disable_marker_finding"
)

Tensors = Dict[str, torch.Tensor]


def check_attributable(model) -> None:
    """Raise ``NotImplementedError`` for a model whose module holds a
    ``FusedMLP`` (kernel B2 in eval mode), on every device."""
    if any(isinstance(m, FusedMLP) for m in model.module.modules()):
        raise NotImplementedError(FUSED_REFUSAL)


def check_config_attributable(model_class: str, space) -> None:
    """Raise ``NotImplementedError`` before training when the search space
    (a ``train.space.SearchSpace``, or None) fixes ``fused_kernels`` true for
    a DirectPred: ``check_attributable`` would refuse the trained model."""
    if model_class != "DirectPred" or space is None:
        return
    for dim in space.dimensions:
        if (dim.name == "fused_kernels" and isinstance(dim, Categorical)
                and all(bool(c) for c in dim.categories)):
            raise NotImplementedError(FUSED_REFUSAL)


def _gauss_legendre(n_steps: int):
    """Nodes and weights on [0, 1] (Captum's default IG quadrature)."""
    nodes, weights = np.polynomial.legendre.leggauss(n_steps)
    return (nodes + 1.0) * 0.5, weights * 0.5


def _class_grads(forward, points: Tensors, classes: Sequence[int],
                 single_output: bool) -> List[Tensors]:
    """Per class c, the gradient of sum(out[:, c]) (of sum(out) for a single
    output) with respect to ``points``, from one forward."""
    pts = {k: v.detach().requires_grad_(True) for k, v in points.items()}
    out = forward(pts)
    grads = []
    for i, c in enumerate(classes):
        scalar = out.sum() if single_output else out[:, c].sum()
        g = torch.autograd.grad(scalar, list(pts.values()),
                                retain_graph=i + 1 < len(classes))
        grads.append(dict(zip(pts, g)))
    return grads


def _fold(x: Tensors, scales: torch.Tensor) -> Tensors:
    """``scales`` (S, B or 1, 1) times each ``(B, F)`` input, as ``(S * B, F)``."""
    return {k: (scales * v.unsqueeze(0)).reshape(-1, v.shape[-1]) for k, v in x.items()}


def integrated_gradients(forward, x: Tensors, classes: Sequence[int], n_steps: int,
                         single_output: bool) -> List[Tensors]:
    """IG attributions, zero baseline, for each class of ``classes``:
    attr = x * sum_k w_k * d f(a_k * x) / dx at the Gauss-Legendre nodes a_k."""
    alphas, weights = _gauss_legendre(n_steps)
    device = next(iter(x.values())).device
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=device)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=device)
    grads = _class_grads(forward, _fold(x, alphas.view(-1, 1, 1)), classes, single_output)
    return [{k: x[k] * torch.tensordot(weights, g[k].view(n_steps, *x[k].shape), dims=1)
             for k in x} for g in grads]


def gradient_shap(forward, x: Tensors, classes: Sequence[int], n_samples: int,
                  single_output: bool, rng: np.ndarray, stdevs: float = 0.0) -> List[Tensors]:
    """GradientShap, zero baselines, for each class of ``classes``:
    attr = mean over draws of x * grad f(u * x), with one uniform u per
    (sample, draw) shared across layers. ``rng`` is a ``utils/prng`` key;
    draw s uses ``split(split(rng, n_samples)[s])[0]``, as JAX does."""
    if stdevs > 0:
        raise NotImplementedError(
            "GradientShap with input noise (stdevs > 0) is not ported to "
            "flexynesis_torch yet (ROADMAP A item 7); the CLI draws without noise"
        )
    first = next(iter(x.values()))
    n_batch = first.shape[0]
    u = np.stack([prng.uniform(prng.split(k)[0], (n_batch, 1))
                  for k in prng.split(rng, n_samples)])
    u = torch.from_numpy(u).to(first.device)
    grads = _class_grads(forward, _fold(x, u), classes, single_output)
    return [{k: (x[k] * g[k].view(n_samples, *x[k].shape)).mean(dim=0) for k in x}
            for g in grads]


@contextlib.contextmanager
def _inputs_only(module: torch.nn.Module):
    """The module's parameters need no gradient inside."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    try:
        for p, _ in flags:
            p.requires_grad_(False)
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def abs_attribution_sums(model, dataset, target_var: str,
                         method: str = "IntegratedGradients", steps_or_samples: int = 5):
    """Per-class, per-layer sum of |attributions| over all samples.

    Returns (sums, n_class, n) where sums[c][layer] is a (n_features,) tensor.
    Batches of ``BATCH`` rows; when the cohort is larger, the last batch is
    zero-padded to ``BATCH`` rows, as the JAX package pads it (zero rows add
    exactly zero), so GradientShap draws its scales at that shape."""
    if method not in METHODS:
        raise ValueError(
            f"Unsupported method '{method}'. Choose 'IntegratedGradients' or 'GradientShap'."
        )
    check_attributable(model)
    if dataset.variable_types[target_var] == "numerical":
        n_class = 1
    else:
        n_class = num_classes_for(dataset.ann[target_var])
    single, classes = n_class == 1, range(n_class)

    def forward(xs):
        return model._attribution_forward(xs, target_var)

    x_all = model.make_eval_x(dataset)
    n = len(dataset)
    sums = None
    rng = prng.key(SEED)
    with _inputs_only(model.module):
        for start in range(0, n, BATCH):
            x = {k: v[start:start + BATCH] for k, v in x_all.items()}
            rows = next(iter(x.values())).shape[0]
            if rows < BATCH and n > BATCH:
                x = {k: torch.nn.functional.pad(v, (0, 0, 0, BATCH - rows))
                     for k, v in x.items()}
            rng, sub = prng.split(rng)
            if method == "IntegratedGradients":
                attrs = integrated_gradients(forward, x, classes, int(steps_or_samples),
                                             single)
            else:
                attrs = gradient_shap(forward, x, classes, int(steps_or_samples), single,
                                      sub)
            per_class = [{k: a.abs().sum(dim=0) for k, a in attr.items()} for attr in attrs]
            sums = per_class if sums is None else [
                {k: s[k] + p[k] for k in s} for s, p in zip(sums, per_class)]
    return sums, n_class, n


def compute_feature_importance(model, dataset, target_var: str,
                               method: str = "IntegratedGradients",
                               steps_or_samples: int = 5) -> List[dict]:
    """Per-feature importance rows for one target variable, class by class
    and layer by layer, as the JAX package's table orders them."""
    sums, n_class, n = abs_attribution_sums(
        model, dataset, target_var, method=method, steps_or_samples=steps_or_samples,
    )
    rows = []
    for c in range(n_class):
        label = (dataset.label_mappings[target_var].get(c)
                 if target_var in dataset.label_mappings else "")
        for layer in model.layers:
            imp = sums[c][layer].cpu().numpy() / n
            rows += [{"target_variable": target_var, "target_class": c,
                      "target_class_label": label, "layer": layer, "name": name,
                      "importance": value}
                     for name, value in zip(dataset.features[layer], imp)]
    return rows
