"""Mixed-architecture HPO trials in one stacked program (pad to the maximum).

Counterpart of ``flexynesis_tpu/parallel/hetero.py`` for the five classes
(MultiTripletNetwork pads as DirectPred, its tree being DirectPred's plus
``log_var_triplet_loss``; the GNN pads its node embedding, latent and
supervisor widths, and buckets on its structure): one template is built at the round's
largest dimensions (latent, per-modality hidden, supervisor hidden), and each
trial's padded parameter regions are zeroed and kept at zero by element masks
on its gradients (before the clip norm) and on its updates (after Adam). Zero
weights, biases and BatchNorm scale and shift keep every padded activation at
exactly 0, so a padded trial computes its small architecture's function; its
initial parameters are rescaled to its own architecture's init law:
sqrt(fan_in_max / fan_in_trial) for the torch U(+-1/sqrt(fan_in)) law, and
sqrt((fan_in_max + fan_out_max) / (fan_in_trial + fan_out_trial)) for the
VAE's Xavier-uniform kernels. A VAE trial's padded latent dims also leave its
MMD: ``build_padded_trials`` returns each trial's ``latent_mask`` and
``latent_dim`` (``aux``), which the trial engine puts in every batch as
``_aux`` for ``ops.losses.masked_mmd_loss``.

The masks and scales are built on the Flax parameter tree of the template
(``convert.to_flax``), as in the JAX package, and leave here as one tensor
per parameter in the JAX flatten order and the Flax layout, the lists the
trial engine's optimizer takes.

A ``fused_kernels`` DirectPred template is refused, as in the JAX package:
FusedMLP's parameters (``layer_1_kernel``) are not the ``layer_1`` Dense tree
the mask builder reads, so the JAX mask builder raises ``KeyError`` there. A
VAE tree has no FusedMLP (the flag selects kernel B3 for its MMD), so a fused
VAE round pads as JAX pads it, and its padded MMD is the masked plain one.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..convert import to_flax
from ..utils.profiling import host_wait
from .stacked import stacked_model


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


def supervised_vae_trial_mask(
    template_params,
    config: dict,
    layer_names: List[str],
    input_dims: List[int],
) -> Tuple[dict, dict]:
    """(mask, init_scale) trees for a supervised_vae / CrossModalPred trial.

    ``layer_names``/``input_dims`` describe the ENCODED layers (for
    CrossModalPred its ``input_layers``); decoders are found from the
    template's ``decoder_*`` keys, each decoder's trial hidden width derived
    from its own output width (CrossModalPred may decode other layers)."""
    dims = _dims_of(config, input_dims)
    factor = float(config["hidden_dim_factor"])
    L_max = template_params["FC_mean"]["kernel"].shape[1]
    H_max = {
        ln: template_params[f"encoder_{ln}"]["hidden_layers"]["dense_0"]["kernel"].shape[1]
        for ln in layer_names
    }
    L_t, S_t = dims["latent"], dims["sup"]
    n_mod = len(layer_names)
    l_col = _col_mask(L_max, L_t)
    s_l = float(np.sqrt(L_max / L_t))

    # Encoder/Decoder KERNELS are Xavier-uniform, bound sqrt(6 / (fi + fo)),
    # so they rescale by sqrt((fi_max + fo_max) / (fi_t + fo_t)); their BIASES
    # keep the torch law U(+-1/sqrt(fan_in)) and rescale by sqrt(fi_max / fi_t)
    mask, scale = {}, {}
    for li, ln in enumerate(layer_names):
        Hm, Ht = H_max[ln], dims["hidden"][li]
        in_dim = int(input_dims[li])
        h_col = _col_mask(Hm, Ht)
        enc = template_params[f"encoder_{ln}"]
        mask[f"encoder_{ln}"] = {
            "hidden_layers": {
                "dense_0": {
                    "kernel": np.broadcast_to(
                        h_col, enc["hidden_layers"]["dense_0"]["kernel"].shape
                    ).copy(),
                    "bias": h_col.copy(),
                },
                "bn_0": {"scale": h_col.copy(), "bias": h_col.copy()},
            },
            "FC_mean": {"kernel": np.outer(h_col, l_col), "bias": l_col.copy()},
            "FC_var": {"kernel": np.outer(h_col, l_col), "bias": l_col.copy()},
        }
        s_h = float(np.sqrt(Hm / Ht))  # torch bias law
        s_enc0 = float(np.sqrt((in_dim + Hm) / (in_dim + Ht)))  # xavier
        s_fc = float(np.sqrt((Hm + L_max) / (Ht + L_t)))  # xavier
        scale[f"encoder_{ln}"] = {
            "hidden_layers": {
                "dense_0": {"kernel": s_enc0, "bias": 1.0},
                "bn_0": {"scale": 1.0, "bias": 1.0},
            },
            "FC_mean": {"kernel": s_fc, "bias": s_h},
            "FC_var": {"kernel": s_fc, "bias": s_h},
        }

    for key in template_params:
        if not key.startswith("decoder_"):
            continue
        dec = template_params[key]
        F = dec["FC_output"]["kernel"].shape[1]
        Hm_dec = dec["hidden_layers"]["dense_0"]["kernel"].shape[1]
        Ht_dec = max(int(F * factor), 2)
        h_col = _col_mask(Hm_dec, Ht_dec)
        mask[key] = {
            "hidden_layers": {
                "dense_0": {"kernel": np.outer(l_col, h_col), "bias": h_col.copy()},
                "bn_0": {"scale": h_col.copy(), "bias": h_col.copy()},
            },
            "FC_output": {
                "kernel": np.broadcast_to(
                    h_col[:, None], dec["FC_output"]["kernel"].shape
                ).copy(),
                "bias": np.ones(F, np.float32),
            },
        }
        s_h_dec = float(np.sqrt(Hm_dec / Ht_dec))  # torch bias law
        s_dec0 = float(np.sqrt((L_max + Hm_dec) / (L_t + Ht_dec)))  # xavier
        s_out = float(np.sqrt((Hm_dec + F) / (Ht_dec + F)))  # xavier
        scale[key] = {
            "hidden_layers": {
                "dense_0": {"kernel": s_dec0, "bias": s_l},
                "bn_0": {"scale": 1.0, "bias": 1.0},
            },
            "FC_output": {"kernel": s_out, "bias": s_h_dec},
        }

    # the top-level FC over the concatenated per-modality latents (block rows)
    in_mask = np.concatenate([l_col] * n_mod)
    for key in ("FC_mean", "FC_log_var"):
        mask[key] = {"kernel": np.outer(in_mask, l_col), "bias": l_col.copy()}
        s = float(np.sqrt((n_mod * L_max) / (n_mod * L_t)))
        scale[key] = {"kernel": s, "bias": s}

    for key, sub in template_params.items():
        if not key.startswith("head_"):
            continue
        mask[key], scale[key] = _head_mask_scale(sub, L_max, L_t, S_t)

    for key in template_params:
        if key.startswith("log_var_"):
            mask[key] = np.ones(1, np.float32)
            scale[key] = 1.0

    return _conform(mask, template_params), _conform(scale, template_params)


def gnn_trial_mask(
    template_params,
    config: dict,
    layer_names: List[str],
    input_dims: List[int],
) -> Tuple[dict, dict]:
    """(mask, init_scale) trees for a GNN trial against the padded template.

    Pads ``node_embedding_dim`` (every conv's output channels and BatchNorm),
    ``latent_dim`` (the fc readout) and ``supervisor_hidden_dim`` (heads);
    ``num_convs``, ``activation`` and the readout are structural and bucket
    instead (``bucket_key``). Covers the four conv parameterisations
    (``ops/graph_conv.py``): GCN ``lin``, SAGE/GC ``lin_root`` + ``lin_nbr``,
    GAT ``lin`` + ``att_src`` + ``att_dst`` + ``bias``."""
    enc = template_params["encoder"]
    E_t = max(int(config["node_embedding_dim"]), 1)
    L_t = int(config["latent_dim"])
    S_t = max(int(config["supervisor_hidden_dim"]), 2)

    conv_keys = sorted((k for k in enc if k.startswith("conv_")), key=lambda s: int(s[5:]))
    first = enc[conv_keys[0]]
    lin0 = first.get("lin", first.get("lin_root"))
    E_max = lin0["kernel"].shape[1]
    fc_rows, L_max = enc["fc"]["kernel"].shape
    e_col = _col_mask(E_max, E_t)
    l_col = _col_mask(L_max, L_t)

    def conv_mask(sub, in_col):
        """Mask/scale for one DenseGraphConvLayer parameter subtree."""
        m, s = {}, {}
        for name, leaf in sub.items():
            if name in ("lin", "lin_root", "lin_nbr"):
                rows = leaf["kernel"].shape[0]
                row_col = in_col if in_col is not None else np.ones(rows, np.float32)
                fi_max, fi_t = rows, int(row_col.sum())
                if name == "lin":
                    # GCN/GAT 'lin' uses xavier_uniform: U(+-sqrt(6/(fi+fo)))
                    sc = float(np.sqrt((fi_max + E_max) / (fi_t + E_t)))
                else:
                    # SAGE/GC root/neighbour use torch U(+-1/sqrt(fan_in))
                    sc = float(np.sqrt(fi_max / fi_t))
                m[name] = {"kernel": np.outer(row_col, e_col)}
                s[name] = {"kernel": sc}
                if "bias" in leaf:
                    m[name]["bias"] = e_col.copy()
                    s[name]["bias"] = sc
            elif name in ("att_src", "att_dst"):
                m[name] = {"kernel": e_col[:, None].copy()}
                s[name] = {"kernel": float(np.sqrt((E_max + 1) / (E_t + 1)))}
            elif name == "bias":  # GAT layer-level bias
                m[name] = e_col.copy()
                s[name] = 1.0
        return m, s

    enc_mask, enc_scale = {}, {}
    for i, ck in enumerate(conv_keys):
        in_col = None if i == 0 else e_col  # conv_0 consumes raw node features
        enc_mask[ck], enc_scale[ck] = conv_mask(enc[ck], in_col)
        bk = f"bn_{i}"
        enc_mask[bk] = {"scale": e_col.copy(), "bias": e_col.copy()}
        enc_scale[bk] = {"scale": 1.0, "bias": 1.0}

    if fc_rows == E_max:  # mean-pool readout
        fc_row_mask = e_col
    else:  # flatten readout: per-node blocks of E_max channels
        fc_row_mask = np.tile(e_col, fc_rows // E_max)
    enc_mask["fc"] = {"kernel": np.outer(fc_row_mask, l_col), "bias": l_col.copy()}
    s_fc = float(np.sqrt(E_max / E_t))  # fan_in ratio (n_nodes cancels)
    enc_scale["fc"] = {"kernel": s_fc, "bias": s_fc}

    mask = {"encoder": enc_mask}
    scale = {"encoder": enc_scale}
    for key, sub in template_params.items():
        if key.startswith("head_"):
            mask[key], scale[key] = _head_mask_scale(sub, L_max, L_t, S_t)
    for key in template_params:
        if key.startswith("log_var_"):
            mask[key] = np.ones(1, np.float32)
            scale[key] = 1.0
    return _conform(mask, template_params), _conform(scale, template_params)


MASK_BUILDERS = {
    "DirectPred": directpred_trial_mask,
    "MultiTripletNetwork": directpred_trial_mask,
    "supervised_vae": supervised_vae_trial_mask,
    "CrossModalPred": supervised_vae_trial_mask,
    "GNN": gnn_trial_mask,
}


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
    layout; for the VAE classes also ``aux``, each trial's ``latent_mask``
    (T, L_max) and ``latent_dim`` (T,); all on the model's device."""
    from .trials import _init_stacked

    with host_wait():   # one readback of each of the template's leaves
        template_params, _ = to_flax(model.module)
    builder = MASK_BUILDERS[model.model_name]
    trees = [builder(template_params, cfg, model.layers, model.input_dims) for cfg in configs]
    stacked = stacked_model(model, len(configs))
    params, buffers = _init_stacked(model, seeds, stacked)
    masks = []
    for name in stacked.leaf_names:
        path = stacked.flax_paths[name]
        m = np.stack([np.asarray(_leaf(t[0], path), np.float32) for t in trees])
        s = [float(_leaf(t[1], path)) for t in trees]
        with host_wait():   # copies from pageable memory wait for the stream
            m = torch.from_numpy(m).to(model.device)
            s = torch.tensor(s, dtype=torch.float32, device=model.device)
        # padded regions start (and stay) at zero
        p = params[name]
        m_port = m.mT if stacked.transposed[name] else m
        params[name] = p * m_port * s.reshape((-1,) + (1,) * (p.dim() - 1))
        masks.append(m)
    out = {"params": params, "buffers": buffers, "masks": masks}
    if model.model_name in ("supervised_vae", "CrossModalPred"):
        # the exact small-architecture MMD needs the trial's latent mask and dim
        L_max = template_params["FC_mean"]["kernel"].shape[1]
        lat_dims = [int(c["latent_dim"]) for c in configs]
        latent_mask = np.stack([_col_mask(L_max, ld) for ld in lat_dims])
        with host_wait():
            out["aux"] = {
                "latent_mask": torch.from_numpy(latent_mask).to(model.device),
                "latent_dim": torch.tensor(lat_dims, dtype=torch.float32, device=model.device),
            }
    return out
