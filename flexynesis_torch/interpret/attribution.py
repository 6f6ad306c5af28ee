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
for bit; with input noise (``stdevs`` > 0) the noise is drawn on the
input's device by the same generator (XLA's ErfInv, within a few ulp). A
``mesh`` splits each batch's rows over devices (``abs_attribution_sums``). Products run in f32 (PyTorch's default keeps TF32 off), as on the
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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.base import num_classes_for
from ..ops.fused_mlp import FusedMLP
from ..train.space import Categorical
from ..utils import prng

METHODS = ("IntegratedGradients", "GradientShap")
# The default rows per attribution batch and GradientShap's key seed. Both
# fix results: the tail batch's zero padding and GradientShap's (BATCH, 1)
# draw shape, as the JAX package has them.
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
                  single_output: bool, rng: np.ndarray, stdevs: float = 0.0,
                  rows: Optional[Tuple[int, int]] = None) -> List[Tensors]:
    """GradientShap, zero baselines, for each class of ``classes``:
    attr = mean over draws of x * grad f(u * (x + noise)), with one uniform u
    per (sample, draw) shared across layers and, for ``stdevs`` > 0, N(0,
    stdevs) noise per input value, added before the scale (Captum's
    ``u * (x + noise - baseline)``). ``rng`` is a ``utils/prng`` key; draw s
    splits ``split(rng, n_samples)[s]`` into (ku, kn): u from ku, layer i's
    noise (i in sorted layer order) from ``fold_in(kn, i)``, as JAX does.
    ``rows`` (start, total): ``x`` holds rows ``start`` on of a batch of
    ``total`` rows (a shard's slice), and takes that slice of the batch's
    draws."""
    first = next(iter(x.values()))
    n_batch = first.shape[0]
    start, total = rows or (0, n_batch)
    keys = [prng.split(k) for k in prng.split(rng, n_samples)]
    u = np.stack([prng.uniform(ku, (total, 1))[start:start + n_batch] for ku, _ in keys])
    u = torch.from_numpy(u).to(first.device)
    if stdevs > 0:
        points = {}
        # layer i in sorted name order: the jitted JAX program sees its input
        # dict with sorted keys
        index = {name: i for i, name in enumerate(sorted(x))}
        for name, v in x.items():
            i = index[name]
            noisy = torch.stack([v + stdevs * prng.normal(prng.fold_in(kn, i), v.shape, v.device,
                                                          row_offset=start)
                                 for _, kn in keys])
            points[name] = (noisy * u).reshape(-1, v.shape[-1])
    else:
        points = _fold(x, u)
    grads = _class_grads(forward, points, classes, single_output)
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


def _batch_attr(model, x: Tensors, target_var: str, method: str, steps_or_samples: int,
                classes, single: bool, key: np.ndarray, rows=None) -> List[Tensors]:
    """Per class, {layer: (F,)} sums of |attr| over the rows of ``x``."""
    def forward(xs):
        return model._attribution_forward(xs, target_var)

    if method == "IntegratedGradients":
        attrs = integrated_gradients(forward, x, classes, steps_or_samples, single)
    else:
        attrs = gradient_shap(forward, x, classes, steps_or_samples, single, key, rows=rows)
    return [{k: a.abs().sum(dim=0) for k, a in attr.items()} for attr in attrs]


def abs_attribution_sums(model, dataset, target_var: str,
                         method: str = "IntegratedGradients", steps_or_samples: int = 5,
                         batch_size: int = BATCH, rng_seed: int = SEED, mesh=None):
    """Per-class, per-layer sum of |attributions| over all samples.

    Returns (sums, n_class, n) where sums[c][layer] is a (n_features,) tensor.
    Batches of ``batch_size`` rows; when the cohort is larger, the last batch
    is zero-padded to ``batch_size`` rows, as the JAX package pads it (zero
    rows add exactly zero), so GradientShap draws its scales at that shape.

    ``mesh`` (``parallel/mesh.py``) splits the SAMPLE axis of each batch over
    the devices of its first axis: attributions are per-sample independent,
    so each device attributes a contiguous slice of the batch's rows with a
    copy of the model (its own device context) and the sums are added. As in
    JAX, ``batch_size`` is rounded up to a multiple of the mesh and the tail
    is zero-padded even when the cohort fits in one batch; each slice takes
    its rows of the batch's draws, so the draws are those of the unsharded
    program at that batch shape."""
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
    steps = int(steps_or_samples)
    devices = None
    if mesh is not None:
        from ..parallel.mesh import replica

        devices = mesh.axis_devices(mesh.axis_names[0])
        batch_size = -(-batch_size // len(devices)) * len(devices)
        replicas = [replica(model, d) for d in devices]

    x_all = model.make_eval_x(dataset)
    n = len(dataset)
    sums = None
    rng = prng.key(rng_seed)
    with contextlib.ExitStack() as stack:
        for m in [model] if devices is None else replicas:
            stack.enter_context(_inputs_only(m.module))
        for start in range(0, n, batch_size):
            x = {k: v[start:start + batch_size] for k, v in x_all.items()}
            rows = next(iter(x.values())).shape[0]
            if rows < batch_size and (n > batch_size or devices is not None):
                x = {k: torch.nn.functional.pad(v, (0, 0, 0, batch_size - rows))
                     for k, v in x.items()}
            rng, sub = prng.split(rng)
            if devices is None:
                per_class = _batch_attr(model, x, target_var, method, steps, classes, single,
                                        sub)
            else:
                per_class = _sharded_attr(replicas, devices, x, batch_size, target_var, method,
                                          steps, classes, single, sub, model.device)
            sums = per_class if sums is None else [
                {k: s[k] + p[k] for k in s} for s, p in zip(sums, per_class)]
    return sums, n_class, n


def _sharded_attr(replicas, devices, x: Tensors, batch_size: int, target_var: str,
                  method: str, steps: int, classes, single: bool, key: np.ndarray,
                  out_device) -> List[Tensors]:
    """One batch's per-class sums, each device attributing its contiguous
    slice of the rows; the slices' sums added on ``out_device``."""
    from ..parallel.mesh import device_context, split_rows

    total = None
    for m, d, rows in zip(replicas, devices, split_rows(batch_size, len(devices))):
        with device_context(d):
            part = _batch_attr(m, {k: v[rows].to(d) for k, v in x.items()}, target_var, method,
                               steps, classes, single, key, rows=(rows.start, batch_size))
        part = [{k: v.to(out_device) for k, v in p.items()} for p in part]
        total = part if total is None else [
            {k: s[k] + p[k] for k in s} for s, p in zip(total, part)]
    return total


def compute_feature_importance(model, dataset, target_var: str,
                               method: str = "IntegratedGradients",
                               steps_or_samples: int = 5, batch_size: int = BATCH,
                               rng_seed: int = SEED, mesh=None) -> List[dict]:
    """Per-feature importance rows for one target variable, class by class
    and layer by layer, as the JAX package's table orders them; ``mesh``
    splits the sample axis (``abs_attribution_sums``)."""
    sums, n_class, n = abs_attribution_sums(
        model, dataset, target_var, method=method, steps_or_samples=steps_or_samples,
        batch_size=batch_size, rng_seed=rng_seed, mesh=mesh,
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
