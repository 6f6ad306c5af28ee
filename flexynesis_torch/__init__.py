"""flexynesis_torch: the PyTorch/CUDA port of flexynesis_tpu for NVIDIA Hopper.

``python -m flexynesis_torch`` trains, tunes (GP search over stacked trials,
with CV, fine-tuning and a resumable search), evaluates and serves all five
deep model classes (DirectPred, supervised_vae, MultiTripletNetwork,
CrossModalPred, GNN) on CSV or HDF5 folders, with marker finding, the
classical baselines and ``--profile``; ``python -m
flexynesis_torch.csv_to_h5`` converts CSV matrices to HDF5 and ``python -m
flexynesis_torch.coexpression`` builds a co-expression graph for
``--user_graph``. The analysis surface runs after training: survival
statistics and the Cox model (``utils.survival``), clustering
(``utils.clustering``), batch correction (``utils.batch_correction``),
figures (``utils.plotting``, matplotlib imported at the first call) and
cBioPortal studies (``utils.cbioportal``). Models load and save in
flexynesis_tpu's format. The Pallas kernels of the JAX package are
hand-written CUDA kernels here (``kernels/``, ``csrc/``). Entry points run
on the CUDA card unless the caller asks for the CPU (``utils/device.py``).

Submodules and the names below import lazily, so ``python -m
flexynesis_torch --help`` stays fast.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_LAZY_SUBMODULES = {
    name: f"flexynesis_torch.{name}"
    for name in ("data", "models", "train", "ops", "parallel", "interpret", "utils",
                 "inference", "config", "kernels", "coexpression")
}

_UTILS = "flexynesis_torch.utils"
# commonly used names, re-exported lazily (flexynesis_tpu's table)
_LAZY_ATTRS = {
    "DataImporter": ("flexynesis_torch.data.importer", "DataImporter"),
    "H5DataImporter": ("flexynesis_torch.data.h5", "H5DataImporter"),
    "DataImporterInference": ("flexynesis_torch.data.inference_importer",
                              "DataImporterInference"),
    "MultiOmicDataset": ("flexynesis_torch.data.dataset", "MultiOmicDataset"),
    "MultiOmicDatasetNW": ("flexynesis_torch.data.dataset", "MultiOmicDatasetNW"),
    "TripletMultiOmicDataset": ("flexynesis_torch.data.dataset", "TripletMultiOmicDataset"),
    **{name: ("flexynesis_torch.models", name)
       for name in ("DirectPred", "SupervisedVAE", "MultiTripletNetwork", "CrossModalPred",
                    "GNN", "MODEL_REGISTRY")},
    "HyperparameterTuning": ("flexynesis_torch.train.hpo", "HyperparameterTuning"),
    "FineTuner": ("flexynesis_torch.train.finetune", "FineTuner"),
    "Trainer": ("flexynesis_torch.train.trainer", "Trainer"),
    "LiveLossPlot": ("flexynesis_torch.train.live_plot", "LiveLossPlot"),
    "evaluate_wrapper": (f"{_UTILS}.metrics", "evaluate_wrapper"),
    "get_predicted_labels": (f"{_UTILS}.metrics", "get_predicted_labels"),
    # notebook-facing analysis helpers
    "evaluate_baseline_performance": (f"{_UTILS}.baselines", "evaluate_baseline_performance"),
    "evaluate_baseline_survival_performance": (f"{_UTILS}.baselines",
                                               "evaluate_baseline_survival_performance"),
    **{name: (f"{_UTILS}.plotting", name)
       for name in ("plot_dim_reduced", "plot_kaplan_meier_curves", "plot_scatter",
                    "plot_boxplot", "plot_roc_curves", "plot_pr_curves", "plot_hazard_ratios",
                    "plot_label_concordance_heatmap")},
    **{name: (f"{_UTILS}.survival", name)
       for name in ("build_cox_model", "CoxPH", "CoxPHFitter", "KaplanMeier", "logrank_test",
                    "multivariate_logrank_test", "cumulative_dynamic_auc", "split_by_median",
                    "find_optimal_cutoff", "recursive_binary_split_minN")},
    **{name: (f"{_UTILS}.clustering", name)
       for name in ("k_means_clustering", "louvain_clustering", "get_optimal_clusters",
                    "compute_ami_ari", "get_important_features", "print_summary_stats",
                    "scale_and_standardize_by_labels", "subset_assays_by_features")},
    **{name: (f"{_UTILS}.batch_correction", name)
       for name in ("remove_batch_associated_variables", "optimal_transport_align",
                    "reciprocal_pca_mnn", "compute_correlation_loss", "compute_transport_cost",
                    "generate_synthetic_batches")},
    "CBioPortalData": (f"{_UTILS}.cbioportal", "CBioPortalData"),
    "generate_coexpression_network": ("flexynesis_torch.coexpression",
                                      "generate_coexpression_network"),
    "STRING": ("flexynesis_torch.data.graph", "STRING"),
    "read_user_graph": ("flexynesis_torch.data.graph", "read_user_graph"),
    "get_optimal_device": (f"{_UTILS}.device", "get_optimal_device"),
}


def __getattr__(name: str):
    if name in _LAZY_SUBMODULES:
        mod = importlib.import_module(_LAZY_SUBMODULES[name])
        globals()[name] = mod
        return mod
    if name in _LAZY_ATTRS:
        module_name, attr = _LAZY_ATTRS[name]
        value = getattr(importlib.import_module(module_name), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'flexynesis_torch' has no attribute '{name}'")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_SUBMODULES) | set(_LAZY_ATTRS))
