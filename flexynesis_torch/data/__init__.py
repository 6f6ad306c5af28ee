"""Data layer: ingestion, preprocessing, datasets, graphs.

flexynesis_tpu.data's names, imported lazily: importing a submodule such as
``data.fastcsv`` loads nothing else of the package.
"""

from __future__ import annotations

from .._lazy import lazy_exports

_NAMES = {
    "importer": ("DataImporter",),
    "dataset": ("MultiOmicDataset", "MultiOmicDatasetNW", "TripletMultiOmicDataset"),
    "feature_selection": ("filter_by_laplacian", "laplacian_score"),
    "covariates": ("create_covariate_matrix", "get_variable_types"),
}
_LAZY_ATTRS, __getattr__, __dir__ = lazy_exports(__name__, _NAMES)
__all__ = sorted(_LAZY_ATTRS)
