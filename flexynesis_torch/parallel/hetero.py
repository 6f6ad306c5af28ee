"""Mixed-architecture HPO trials in one stacked program (pad to the maximum).

Counterpart of ``flexynesis_tpu/parallel/hetero.py`` for DirectPred: one
template is built at the round's largest dimensions (latent, per-modality
hidden, supervisor hidden), and each trial's padded parameter regions are
zeroed and kept at zero by element masks on its gradients (before the clip
norm) and on its updates (after Adam). Zero weights, biases and BatchNorm
scale and shift keep every padded activation at exactly 0, so a padded trial
computes its small architecture's function; its initial parameters are
rescaled by sqrt(fan_in_max / fan_in_trial), so each trial starts from the
U(+-1/sqrt(fan_in)) law of its own architecture.

The masks and scales are built on the Flax parameter tree of the template
(``convert.to_flax``), as in the JAX package, and leave here as one tensor
per parameter in the JAX flatten order and the Flax layout, the lists the
trial engine's optimizer takes.

A ``fused_kernels`` template is refused, as in the JAX package: FusedMLP's
parameters (``layer_1_kernel``) are not the ``layer_1`` Dense tree the mask
builder reads, so the JAX mask builder raises ``KeyError`` there.
``supervised_vae_trial_mask`` and ``gnn_trial_mask`` are not ported yet.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..convert import to_flax
from .stacked import StackedDirectPred


def _dims_of(config: dict, input_dims: List[int]) -> dict:
    latent = int(config["latent_dim"])
    hidden = [
        max(int(d * float(config.get("hidden_dim_factor", 0))), 2)
        for d in input_dims
    ]
    sup = max(int(config["supervisor_hidden_dim"]), 2)
    return {"latent": latent, "hidden": hidden, "sup": sup}


def max_config(configs: List[dict], input_dims: List[int]) -> dict:
    """Config whose architecture dims dominate every trial in the round."""
    dims = [_dims_of(c, input_dims) for c in configs]
    out = dict(configs[0])
    out["latent_dim"] = max(d["latent"] for d in dims)
    out["supervisor_hidden_dim"] = max(d["sup"] for d in dims)
    if "hidden_dim_factor" in configs[0]:
        # hidden is derived from hidden_dim_factor: take the max factor
        out["hidden_dim_factor"] = max(
            float(c["hidden_dim_factor"]) for c in configs
        )
    if "node_embedding_dim" in configs[0]:
        out["node_embedding_dim"] = max(
            int(c["node_embedding_dim"]) for c in configs
        )
    return out


def bucket_key(model_name: str, params: dict) -> tuple:
    """Suggestions sharing this key can train as ONE padded program: the
    architecture dims pad to the group's maximum, so only the epoch and batch
    schedule (and, for the GNN, conv count, activation and readout) must
    match."""
    key = (params.get("epochs"), params.get("batch_size"))
    if model_name == "GNN":
        key += (
            params.get("num_convs"),
            params.get("activation"),
            params.get("gnn_readout", "flatten"),
        )
    return key


def _conform(m_tree, t_tree):
    """Normalize a flat mask/scale dict to exactly the template tree
    structure."""
    if isinstance(t_tree, dict):
        return {k: _conform(m_tree[k], v) for k, v in t_tree.items()}
    return m_tree


def _col_mask(n_total: int, n_active: int) -> np.ndarray:
    m = np.zeros(n_total, np.float32)
    m[:n_active] = 1.0
    return m


def _head_mask_scale(sub, L_max: int, L_t: int, S_t: int):
    """(mask, scale) for one supervisor-head MLP subtree. Head MLPs use torch
    init throughout: layer_1 kernel and bias draw U(+-1/sqrt(latent)),
    layer_out kernel AND bias U(+-1/sqrt(supervisor_hidden)), so the
    layer_out bias rescales by sqrt(S_max/S_t) like its kernel."""
    S_max = sub["layer_1"]["kernel"].shape[1]
    n_out = sub["layer_out"]["kernel"].shape[1]
    s_col = _col_mask(S_max, S_t)
    l_col = _col_mask(L_max, L_t)
    mask = {
        "layer_1": {"kernel": np.outer(l_col, s_col), "bias": s_col.copy()},
        "batchnorm": {"scale": s_col.copy(), "bias": s_col.copy()},
        "layer_out": {
            "kernel": np.broadcast_to(
                s_col[:, None], sub["layer_out"]["kernel"].shape
            ).copy(),
            **(
                {"bias": np.ones(n_out, np.float32)}
                if "bias" in sub["layer_out"]
                else {}
            ),
        },
    }
    sl = float(np.sqrt(L_max / L_t))
    ss = float(np.sqrt(S_max / S_t))
    scale = {
        "layer_1": {"kernel": sl, "bias": sl},
        "batchnorm": {"scale": 1.0, "bias": 1.0},
        "layer_out": {
            "kernel": ss,
            **({"bias": ss} if "bias" in sub["layer_out"] else {}),
        },
    }
    return mask, scale


def _refuse_fused(template_params) -> None:
    if any(isinstance(sub, dict) and "layer_1_kernel" in sub
           for sub in template_params.values()):
        raise NotImplementedError(
            "mixed-architecture trial rounds need plain MLP blocks: with "
            "fused_kernels the JAX package's mask builder "
            "(flexynesis_tpu/parallel/hetero.py::directpred_trial_mask) reads "
            "enc['layer_1']['kernel'], which FusedMLP's parameter tree "
            "(layer_1_kernel) lacks, so it raises KeyError; the port keeps "
            "that limit"
        )


def directpred_trial_mask(
    template_params,
    config: dict,
    layer_names: List[str],
    input_dims: List[int],
) -> Tuple[dict, dict]:
    """(mask, init_scale) trees for one trial against the padded template's
    Flax parameter tree: element-wise 0/1 mask arrays (padded regions frozen
    at 0) and scalars rescaling the max-dim init to the trial's own fan-in
    law."""
    _refuse_fused(template_params)
    dims = _dims_of(config, input_dims)
    tmpl_dims = {
        ln: template_params[f"encoder_{ln}"]["layer_1"]["kernel"].shape[1]
        for ln in layer_names
    }
    L_max = template_params[f"encoder_{layer_names[-1]}"]["layer_out"][
        "kernel"
    ].shape[1]
    L_t = dims["latent"]
    S_t = dims["sup"]
    n_mod = len(layer_names)

    mask = {}
    scale = {}
    for li, ln in enumerate(layer_names):
        H_max = tmpl_dims[ln]
        H_t = dims["hidden"][li]
        h_col = _col_mask(H_max, H_t)
        l_col = _col_mask(L_max, L_t)
        enc = template_params[f"encoder_{ln}"]
        mask[f"encoder_{ln}"] = {
            "layer_1": {
                "kernel": np.broadcast_to(
                    h_col, enc["layer_1"]["kernel"].shape
                ).copy(),
                "bias": h_col.copy(),
            },
            "batchnorm": {"scale": h_col.copy(), "bias": h_col.copy()},
            "layer_out": {
                "kernel": np.outer(h_col, l_col)
                if enc["layer_out"]["kernel"].shape[1] > 1
                else h_col[:, None].copy(),
                **(
                    {"bias": l_col.copy()}
                    if "bias" in enc["layer_out"]
                    else {}
                ),
            },
        }
        scale[f"encoder_{ln}"] = {
            "layer_1": {"kernel": 1.0, "bias": 1.0},  # fan_in = input dim
            "batchnorm": {"scale": 1.0, "bias": 1.0},
            "layer_out": {
                "kernel": float(np.sqrt(H_max / H_t)),
                **(
                    {"bias": float(np.sqrt(H_max / H_t))}
                    if "bias" in enc["layer_out"]
                    else {}
                ),
            },
        }

    if "fusion_block" in template_params:
        in_mask = np.concatenate([_col_mask(L_max, L_t)] * n_mod)
        out_mask = _col_mask(L_max, L_t)
        mask["fusion_block"] = {
            "kernel": np.outer(in_mask, out_mask),
            "bias": out_mask.copy(),
        }
        s = float(np.sqrt((n_mod * L_max) / (n_mod * L_t)))
        scale["fusion_block"] = {"kernel": s, "bias": s}

    for key, sub in template_params.items():
        if not key.startswith("head_"):
            continue
        mask[key], scale[key] = _head_mask_scale(sub, L_max, L_t, S_t)

    for key in template_params:
        if key.startswith("log_var_"):
            mask[key] = np.ones(1, np.float32)
            scale[key] = 1.0

    return _conform(mask, template_params), _conform(scale, template_params)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def build_padded_trials(model, configs: List[dict], seeds) -> dict:
    """Stacked per-trial initial parameters and masks for a mixed round.

    ``model`` is the template built at ``max_config`` dims. Returns
    ``params`` and ``buffers`` (T, ...) by ``state_dict`` name, the trials'
    fresh parameters (``seeds[t]``) masked and rescaled, and ``masks``, one
    (T, ...) tensor per parameter in the JAX flatten order and the Flax
    layout; all on the model's device."""
    from .trials import _init_stacked

    if model.model_name != "DirectPred":
        raise NotImplementedError(
            f"mixed-architecture rounds of {model.model_name} are not ported to "
            "flexynesis_torch yet (ROADMAP A item 1)"
        )
    template_params, _ = to_flax(model.module)
    trees = [directpred_trial_mask(template_params, cfg, model.layers, model.input_dims)
             for cfg in configs]
    stacked = StackedDirectPred(model, len(configs))
    params, buffers = _init_stacked(model, seeds, stacked)
    masks = []
    for name in stacked.leaf_names:
        path = stacked.flax_paths[name]
        m = torch.from_numpy(np.stack([np.asarray(_leaf(t[0], path), np.float32)
                                       for t in trees])).to(model.device)
        s = torch.tensor([float(_leaf(t[1], path)) for t in trees], dtype=torch.float32,
                         device=model.device)
        # padded regions start (and stay) at zero
        p = params[name]
        m_port = m.mT if stacked.transposed[name] else m
        params[name] = p * m_port * s.reshape((-1,) + (1,) * (p.dim() - 1))
        masks.append(m)
    return {"params": params, "buffers": buffers, "masks": masks}
