"""Model files and inference-mode reconstruction.

Counterpart of ``flexynesis_tpu/inference.py``. Files are interchangeable with
the JAX package in both directions:

* weights: safetensors with keys ``params/<flax path>`` and
  ``batch_stats/<flax path>`` (``convert.to_flax`` / ``from_flax`` map them
  onto the port's modules), read and written by ``utils/safetensors_io``;
* ``final_model_config.json`` with the same keys;
* artifacts: the JSON form only (``--safetensors`` in training). A joblib
  artifact holds pickled sklearn objects that the port cannot load.

``reconstruct_model`` rebuilds every class of ``models.MODEL_REGISTRY``. A
GNN's weights file also holds its interaction graph (``graph/edge_index``,
int32 (2, E)) and its config the node set (``node_names``, ``n_node_feats``)
and ``gnn_conv_type``, so inference rebuilds the node tensor without the
graph source.
"""

from __future__ import annotations

import json
from types import SimpleNamespace
from typing import Dict

import numpy as np

from .convert import from_flax, to_flax
from .data.preprocessing import encoder_categories, normalize_encoder_state
from .models import MODEL_REGISTRY
from .utils.safetensors_io import load_file, save_file

# ---------------------------------------------------------------- save side


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.ascontiguousarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def save_model(model, path: str) -> str:
    """Save the module's weights as ``params/...`` and ``batch_stats/...``;
    a GNN also embeds its interaction graph as ``graph/edge_index``."""
    params, batch_stats = to_flax(model.module)
    flat = {f"params/{k}": v for k, v in _flatten(params).items()}
    flat.update({f"batch_stats/{k}": v for k, v in _flatten(batch_stats).items()})
    if hasattr(model, "nw_dataset"):
        flat["graph/edge_index"] = np.ascontiguousarray(
            np.asarray(model.nw_dataset.edge_index, dtype=np.int32))
    save_file(flat, path)
    return path


def load_weights(path: str, flat: dict = None):
    """(params, batch_stats) as nested dicts of numpy arrays; ``flat`` is the
    file's contents where the caller has read it already."""
    flat = load_file(path) if flat is None else flat
    params = _unflatten(
        {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    )
    batch_stats = _unflatten(
        {k[len("batch_stats/"):]: v for k, v in flat.items() if k.startswith("batch_stats/")}
    )
    return params, batch_stats


def save_model_config(model, path: str) -> str:
    config = {
        "model_class": model.model_name,
        "model_module": model.__class__.__module__,
    }
    for attr in (
        "input_dims",
        "layers",
        "input_layers",
        "output_layers",
        "device_type",
        "target_variables",
        "surv_event_var",
        "surv_time_var",
        "config",
        "output_dims",
        "use_loss_weighting",
        "gnn_conv_type",
        "batch_variables",
    ):
        if hasattr(model, attr):
            config[attr] = getattr(model, attr)
    if hasattr(model, "nw_dataset"):
        config["node_names"] = list(model.nw_dataset.node_names)
        config["n_node_feats"] = int(model.nw_dataset.node_features.shape[2])
    config["num_layers"] = len(model.layers)
    config["variable_types"] = {v: model.variable_types[v] for v in model.variables}
    config.update(model.config)
    with open(path, "w") as fh:
        json.dump(config, fh, indent=2, default=str)
    return path


def build_artifacts(data_importer, data_types, target_variables, covariates=None,
                    join_key: str = "JoinKey", string_organism: int = 9606,
                    string_node_name: str = "gene_name") -> dict:
    """Preprocessing state of a training run (schema_version 1), as
    ``flexynesis_tpu/inference.py::build_artifacts`` builds it; scalers and
    encoders are already the JSON-state dicts ``write_artifacts`` writes."""
    return {
        "schema_version": 1,
        "data_types": list(data_importer.train_features) or list(data_types),
        "original_modalities": list(data_types),
        "target_variables": list(target_variables or []),
        "feature_lists": {k: list(v) for k, v in data_importer.train_features.items()},
        "transforms": data_importer.scalers or {},
        "label_encoders": data_importer.label_encoders or {},
        "covariate_vars": list(covariates or []),
        "covariate_columns": {},
        "join_key": join_key,
        "string_organism": string_organism,
        "string_node_name": string_node_name,
    }


_ARTIFACT_KEYS = (
    "schema_version",
    "data_types",
    "original_modalities",
    "target_variables",
    "covariate_vars",
    "join_key",
    "string_organism",
    "string_node_name",
)


def write_artifacts(artifacts: dict, path: str) -> str:
    """Write the preprocessing state as the JAX package's JSON artifact
    (``write_artifacts(..., as_json=True)`` there). Scalers and encoders are
    the JSON-state dicts of ``data/preprocessing``."""
    out = {k: artifacts[k] for k in _ARTIFACT_KEYS}
    if "covariate_columns" in artifacts:
        out["covariate_columns"] = {
            k: list(v) for k, v in artifacts["covariate_columns"].items()
        }
    out["feature_lists"] = {m: list(f) for m, f in artifacts["feature_lists"].items()}
    out["transforms"] = dict(artifacts["transforms"])
    out["label_encoders"] = dict(artifacts["label_encoders"])
    with open(path, "w") as fh:
        json.dump(out, fh, indent=2)
    return path


# ---------------------------------------------------------------- load side


def check_model_type(path: str) -> str:
    """Sniff magic bytes: 'safetensors' vs 'pickle' (reference inference.py:26-57)."""
    with open(path, "rb") as fh:
        head = fh.read(10)
    if len(head) >= 9:
        header_len = int.from_bytes(head[:8], "little")
        if 0 < header_len < 100_000_000 and head[8:9] == b"{":
            return "safetensors"
    if head[:2] == b"PK" or head[:1] == b"\x80":
        return "pickle"
    raise ValueError(f"Unrecognized model file format: {path}")


def load_and_sniff_artifacts(path: str) -> dict:
    """Load a JSON artifact; scalers and encoders stay JSON-state dicts."""
    with open(path, "rb") as fh:
        head = fh.read(64).lstrip()
    if not head.startswith(b"{"):
        raise ValueError(
            f"{path} is not a JSON artifact (a joblib file?). flexynesis_torch "
            "reads JSON artifacts only: re-save them from training with "
            "--safetensors."
        )
    with open(path) as fh:
        raw = json.load(fh)
    out = dict(raw)
    out["transforms"] = dict(raw.get("transforms", {}))
    out["label_encoders"] = {
        v: None if d is None else normalize_encoder_state(d)
        for v, d in raw.get("label_encoders", {}).items()
    }
    return out


def build_dataset_namespace(config: dict, artifacts: dict) -> SimpleNamespace:
    """Stand-in dataset carrying what a model's __init__ needs
    (reference inference.py:73-122)."""
    feature_lists = artifacts.get("feature_lists", {})
    variable_types = config.get("variable_types", {})
    output_dims = config.get("output_dims", {})
    ann = {}
    for var, n_out in output_dims.items():
        if variable_types.get(var) == "categorical":
            ann[var] = np.arange(n_out, dtype=np.float32)
        else:
            ann[var] = np.zeros(max(n_out, 1), dtype=np.float32)
    label_mappings = {
        var: dict(enumerate(encoder_categories(enc)))
        for var, enc in (artifacts.get("label_encoders") or {}).items()
        if enc is not None
    }
    dat = {k: np.zeros((1, len(v)), dtype=np.float32) for k, v in feature_lists.items()}
    return SimpleNamespace(
        dat=dat,
        ann=ann,
        variable_types=variable_types,
        features={k: list(v) for k, v in feature_lists.items()},
        samples=["_dummy_"],
        label_mappings=label_mappings,
    )


def reconstruct_model(weights_path: str, config_path: str, artifacts, device="auto"):
    """Rebuild a trained model from safetensors + config + artifacts on
    ``device`` ("auto"/"cuda" = the card, "cpu" on request)."""
    with open(config_path) as fh:
        config = json.load(fh)
    if isinstance(artifacts, str):
        artifacts = load_and_sniff_artifacts(artifacts)

    cls_name = config["model_class"]
    if cls_name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model class: {cls_name}")

    # gnn_readout and fused_kernels change the module; gnn_sparse only the
    # operator's form (dense and sparse compute the same function)
    hyper = {
        k: config[k]
        for k in ("latent_dim", "hidden_dim_factor", "lr", "supervisor_hidden_dim",
                  "epochs", "batch_size", "node_embedding_dim", "num_convs",
                  "activation", "gnn_readout", "gnn_sparse", "fused_kernels")
        if k in config
    }
    ds = build_dataset_namespace(config, artifacts)
    extra = {}
    flat = None
    if cls_name == "CrossModalPred":
        extra = {k: config.get(k) for k in ("input_layers", "output_layers")}
    if cls_name == "GNN":
        flat = load_file(weights_path)
        if "graph/edge_index" not in flat:
            raise ValueError("GNN weights are missing the embedded interaction graph.")
        node_names = config["node_names"]
        n_mods = int(config.get("n_node_feats", 1))
        ds.node_names = node_names
        ds.node_features = np.zeros((1, len(node_names), n_mods), np.float32)
        ds.edge_index = np.asarray(flat["graph/edge_index"], np.int32)
        ds.dat = {"all": np.zeros((1, len(node_names) * n_mods), np.float32)}
        ds.features = {"all": [f"{g}:{m}" for g in node_names for m in range(n_mods)]}
        extra = {"gnn_conv_type": config.get("gnn_conv_type", "GC")}
    model = MODEL_REGISTRY[cls_name](
        config=hyper,
        dataset=ds,
        target_variables=[
            v for v in config.get("target_variables", [])
            if v != config.get("surv_event_var")
        ],
        surv_event_var=config.get("surv_event_var"),
        surv_time_var=config.get("surv_time_var"),
        use_loss_weighting=config.get("use_loss_weighting", True),
        device_type=config.get("device_type"),
        batch_variables=config.get("batch_variables"),
        device=device,
        **extra,
    )
    params, batch_stats = load_weights(weights_path, flat)
    model.module.load_state_dict(from_flax(params, batch_stats))
    return model
