"""Default hyperparameter search spaces per model class.

A copy of ``flexynesis_tpu/config.py`` (reference config.py:6-52: the same
dimensions, ranges, priors and quantization steps), so that the port's HPO
draws the trials the JAX package draws.
"""

from __future__ import annotations

epochs = [500]


def _common_dims():
    # imported lazily: config <-> train would otherwise import-cycle
    from .train.space import Categorical, Integer, Real

    return [
        Integer(16, 128, name="latent_dim", quantize=16),
        Real(0.2, 0.5, name="hidden_dim_factor"),
        Real(0.0001, 0.01, name="lr", prior="log-uniform"),
        Integer(8, 32, name="supervisor_hidden_dim", quantize=8),
        Categorical(epochs, name="epochs"),
    ]


def get_search_space(config_name: str):
    """Fresh SearchSpace for a model class (mutable; batch_size appended by HPO)."""
    from .train.space import Categorical, Integer, Real, SearchSpace

    if config_name in ("DirectPred", "supervised_vae", "CrossModalPred",
                       "MultiTripletNetwork"):
        return SearchSpace(_common_dims())
    if config_name == "GNN":
        return SearchSpace(
            [
                Integer(16, 128, name="latent_dim", quantize=16),
                Integer(4, 32, name="node_embedding_dim", quantize=4),
                Integer(1, 4, name="num_convs"),
                Real(0.0001, 0.01, name="lr", prior="log-uniform"),
                Integer(8, 32, name="supervisor_hidden_dim", quantize=8),
                Categorical(epochs, name="epochs"),
                Categorical(["relu"], name="activation"),
            ]
        )
    raise ValueError(f"'{config_name}' not found in the default config.")


search_space_names = [
    "DirectPred",
    "supervised_vae",
    "CrossModalPred",
    "MultiTripletNetwork",
    "GNN",
]
