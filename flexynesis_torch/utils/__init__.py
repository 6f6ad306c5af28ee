"""Evaluation, survival analysis, clustering, plotting, baselines, devices.

flexynesis_tpu.utils' names, imported lazily: importing a submodule such as
``utils.csvio`` loads nothing else of the package.
"""

from __future__ import annotations

from .._lazy import lazy_exports

_NAMES = {
    "clustering": ("compute_ami_ari", "get_important_features", "get_optimal_clusters",
                   "k_means_clustering", "louvain_clustering", "print_summary_stats",
                   "scale_and_standardize_by_labels", "subset_assays_by_features"),
    "device": ("create_device_from_string", "get_device_memory_info", "get_optimal_device",
               "to_device_safe"),
    "metrics": ("bootstrap_metric", "concordance_index", "evaluate_classifier",
                "evaluate_regressor", "evaluate_survival", "evaluate_wrapper",
                "generate_bootstrap_indices", "get_predicted_labels"),
    "survival": ("CoxPH", "CoxPHFitter", "KaplanMeier", "build_cox_model",
                 "cumulative_dynamic_auc", "find_optimal_cutoff", "logrank_test",
                 "multivariate_logrank_test", "recursive_binary_split_minN", "split_by_median"),
}
_LAZY_ATTRS, __getattr__, __dir__ = lazy_exports(__name__, _NAMES)
__all__ = sorted(_LAZY_ATTRS)
