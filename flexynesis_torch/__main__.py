"""flexynesis_torch command-line interface.

The same flags and defaults as ``python -m flexynesis_tpu``, on the CUDA card
unless ``--device cpu`` is given.

* Training mode (``--data_path``, ``--model_class`` DirectPred,
  supervised_vae, MultiTripletNetwork, CrossModalPred or GNN,
  ``--data_types``, targets): imports the CSV folder and selects features
  (a GNN then builds its node tensor over ``--user_graph`` or STRING, the
  test split over the training node set), runs GP hyperparameter search (each
  round's ``--hpo_batch`` suggestions train at once on the K-stacked trial
  engine, and with ``--use_cv`` each suggestion's five folds too; then the
  best retrains on the whole training set), trains with Adam and early
  stopping, writes
  ``<prefix>.feature_logs.<layer>.csv``, ``<prefix>.embeddings_{train,test}.csv``,
  ``<prefix>.feature_importance.<method>.csv`` (marker finding, unless
  ``--disable_marker_finding``), ``<prefix>.predicted_labels.csv`` and
  ``<prefix>.stats.csv``, and saves
  ``<prefix>.final_model.safetensors``, its ``final_model_config.json`` and
  the JSON artifacts (``--safetensors``). Both this port and flexynesis_tpu
  load the saved model. CrossModalPred encodes ``--input_layers``, decodes
  ``--output_layers`` and also writes ``<prefix>.<layer>_decoded.csv``.
* Inference mode (``--pretrained_model``, ``--artifacts``,
  ``--data_path_test``) loads a model saved by either package (a GNN's node
  tensor is rebuilt over its saved node set and graph), scores the test
  cohort and writes the embeddings, the feature importances, the
  predicted labels and stats (and a CrossModalPred's decoded layers).

Marker finding on a DirectPred built with ``fused_kernels`` raises
``NotImplementedError``, as the JAX package cannot attribute one either; where
the configuration to train or load fixes ``fused_kernels``, before any work.

What is not ported yet raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .utils.device import DEVICE_CHOICES

__version__ = "0.1.0"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="flexynesis-torch model interface",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-v", "--version", action="version",
                   version=f"%(prog)s {__version__}")
    p.add_argument("--data_path", type=str,
                   help="Folder with train/test data files")
    p.add_argument(
        "--model_class", type=str,
        choices=["DirectPred", "supervised_vae", "MultiTripletNetwork",
                 "CrossModalPred", "GNN", "RandomForest", "SVM", "XGBoost",
                 "RandomSurvivalForest"],
        help="Model class to instantiate",
    )
    p.add_argument("--gnn_conv_type", type=str,
                   choices=["GC", "GCN", "SAGE", "GAT"],
                   help="Graph convolution type for GNN")
    p.add_argument("--target_variables", type=str, default=None,
                   help="clin.csv variables to predict (comma-separated)")
    p.add_argument("--covariates", type=str, default=None,
                   help="clin.csv variables used as feature covariates")
    p.add_argument("--surv_event_var", type=str, default=None,
                   help="clin.csv column with event/status indicator")
    p.add_argument("--surv_time_var", type=str, default=None,
                   help="clin.csv column with time/duration")
    p.add_argument("--config_path", type=str, default=None,
                   help="YAML hyperparameter search-space override")
    p.add_argument("--fusion_type", type=str, choices=["early", "intermediate"],
                   default="intermediate", help="How to fuse the omics layers")
    p.add_argument("--hpo_iter", type=int, default=100,
                   help="Hyperparameter optimisation iterations")
    p.add_argument("--hpo_batch", type=int, default=0,
                   help="HPO suggestions evaluated per GP round")
    p.add_argument("--hpo_pipeline", type=str, default="True",
                   choices=["True", "False"],
                   help="Pipeline the GP ask with the previous round's training")
    p.add_argument("--finetuning_samples", type=int, default=0,
                   help="Test samples used for fine-tuning (0 disables)")
    p.add_argument("--variance_threshold", type=float, default=1,
                   help="Variance percentile to drop low-variance features")
    p.add_argument("--correlation_threshold", type=float, default=0.8,
                   help="Correlation threshold for redundancy filtering")
    p.add_argument("--restrict_to_features", type=str, default=None,
                   help="File with feature list to restrict the analysis to")
    p.add_argument("--subsample", type=int, default=0,
                   help="Downsample training set to N random samples")
    p.add_argument("--features_min", type=int, default=500,
                   help="Minimum features to retain after selection")
    p.add_argument("--features_top_percentile", type=float, default=20,
                   help="Top percentile of features to retain")
    p.add_argument("--data_types", type=str,
                   help="Omic matrices to use, e.g. 'gex,cnv'")
    p.add_argument("--input_layers", type=str, default=None,
                   help="CrossModalPred input/encoded layers")
    p.add_argument("--output_layers", type=str, default=None,
                   help="CrossModalPred output/decoded layers")
    p.add_argument("--outdir", type=str, default=os.getcwd(),
                   help="Output folder")
    p.add_argument("--prefix", type=str, default="job", help="Output prefix")
    p.add_argument("--log_transform", type=str, choices=["True", "False"],
                   default="False", help="log1p-transform input matrices")
    p.add_argument("--early_stop_patience", type=int, default=10,
                   help="Epoch patience for val-loss early stopping (-1 off)")
    p.add_argument("--hpo_patience", type=int, default=20,
                   help="HPO iterations without improvement before stopping")
    p.add_argument("--val_size", type=float, default=0.2,
                   help="Validation split fraction")
    p.add_argument("--use_cv", action="store_true",
                   help="5-fold cross-validated HPO objective")
    p.add_argument("--use_loss_weighting", type=str, choices=["True", "False"],
                   default="True", help="Uncertainty-weighted loss balancing")
    p.add_argument("--evaluate_baseline_performance", action="store_true",
                   help="Also run classical-ML baselines")
    p.add_argument("--threads", type=int, default=4, help="Host CPU threads")
    p.add_argument("--num_workers", type=int, default=0,
                   help="(compat) host workers; unused")
    p.add_argument("--use_gpu", action="store_true",
                   help="DEPRECATED: use --device")
    p.add_argument("--device", type=str, choices=list(DEVICE_CHOICES),
                   default="auto",
                   help="auto/cuda = the CUDA card (raises without one); "
                        "cpu on request; tpu and mps are not supported")
    p.add_argument("--feature_importance_method", type=str,
                   choices=["IntegratedGradients", "GradientShap", "Both"],
                   default="IntegratedGradients")
    p.add_argument("--disable_marker_finding", action="store_true")
    p.add_argument("--marker_sample_cap", type=int, default=0,
                   help="Subsample the attribution cohort to this many samples")
    p.add_argument("--string_organism", type=int, default=9606,
                   help="STRING DB organism id")
    p.add_argument("--string_node_name", type=str,
                   choices=["gene_name", "gene_id"], default="gene_name")
    p.add_argument("--user_graph", type=str, default=None,
                   help="Custom GeneA/GeneB/Score network file")
    p.add_argument("--safetensors", action="store_true",
                   help="JSON artifacts instead of joblib (weights are always "
                        "safetensors)")
    p.add_argument("--pretrained_model", type=str, default=None,
                   help="Saved model for inference mode")
    p.add_argument("--artifacts", type=str, default=None,
                   help="Artifacts .json from training")
    p.add_argument("--data_path_test", type=str, default=None,
                   help="Test-only dataset folder for inference")
    p.add_argument("--join_key", type=str, default="JoinKey",
                   help="clin.csv column used to join sample IDs")
    p.add_argument("--hpo_checkpoint", type=str, default=None,
                   help="Path for preemption-safe HPO state checkpointing")
    p.add_argument("--profile", action="store_true",
                   help="Per-phase profiling")
    return p


def run_inference(args, device) -> int:
    import numpy as np

    from .data.inference_importer import DataImporterInference
    from .inference import check_model_type, load_and_sniff_artifacts, reconstruct_model
    from .interpret.attribution import check_attributable

    kind = check_model_type(args.pretrained_model)
    if kind != "safetensors":
        raise ValueError(
            "flexynesis models are safetensors parameter trees; "
            f"got a '{kind}' file."
        )
    config_path = args.pretrained_model.replace(
        ".final_model.safetensors", ".final_model_config.json"
    )
    if not os.path.exists(config_path):
        raise FileNotFoundError(
            f"Expected model config JSON next to the weights: {config_path}"
        )
    artifacts = load_and_sniff_artifacts(args.artifacts)
    model = reconstruct_model(args.pretrained_model, config_path, artifacts, device=device)
    print(f"[INFO] Reconstructed {model.model_name} from {args.pretrained_model} "
          f"on {model.device}")
    if not args.disable_marker_finding:
        check_attributable(model)
    test_dataset = DataImporterInference(args.data_path_test, artifacts).import_data()
    if model.model_name == "GNN":
        # the node tensor over the training node set, through the interaction
        # graph embedded in the saved weights
        from .data.dataset import MultiOmicDatasetNW

        nodes = list(model.nw_dataset.node_names)
        src, dst = np.asarray(model.nw_dataset.edge_index)
        edges = {"protein1": [nodes[i] for i in src], "protein2": [nodes[i] for i in dst]}
        test_dataset = MultiOmicDatasetNW(test_dataset, edges, node_names=nodes)
    _write_eval_outputs(args, model, None, test_dataset)
    return 0


def _split(s):
    return [x.strip() for x in s.split(",")] if s else None


def _build_importer(args, device):
    from .data.importer import DataImporter

    return DataImporter(
        path=args.data_path,
        data_types=_split(args.data_types),
        covariates=_split(args.covariates),
        log_transform=args.log_transform == "True",
        concatenate=args.fusion_type == "early",
        restrict_to_features=args.restrict_to_features,
        min_features=args.features_min,
        top_percentile=args.features_top_percentile,
        correlation_threshold=args.correlation_threshold,
        variance_threshold=args.variance_threshold / 100.0
        if args.variance_threshold > 0 else 0.0,
        downsample=args.subsample,
        device=device,
    )


def _load_graph(args, dataset):
    """The training set's node tensor over ``--user_graph``, or over STRING
    (``--string_organism``, ``--string_node_name``; a warm cache, or a
    download)."""
    from .data.dataset import MultiOmicDatasetNW
    from .data.graph import STRING, read_user_graph

    if args.user_graph:
        graph = read_user_graph(args.user_graph)
    else:
        graph = STRING(organism=args.string_organism, node_name=args.string_node_name).graph_df
    nw = MultiOmicDatasetNW(dataset, graph)
    nw.print_stats()
    return nw


def _save_model_files(args, model, data_importer) -> None:
    from .inference import build_artifacts, save_model, save_model_config, write_artifacts

    outdir, prefix = args.outdir, args.prefix
    weights = os.path.join(outdir, f"{prefix}.final_model.safetensors")
    save_model(model, weights)
    save_model_config(model, os.path.join(outdir, f"{prefix}.final_model_config.json"))
    print(f"[INFO] Model saved to {weights}")
    artifacts = build_artifacts(
        data_importer, _split(args.data_types) or [], _split(args.target_variables) or [],
        covariates=_split(args.covariates), join_key=args.join_key,
        string_organism=args.string_organism, string_node_name=args.string_node_name,
    )
    path = os.path.join(outdir, f"{prefix}.artifacts.json")
    write_artifacts(artifacts, path)
    print(f"[INFO] Wrote inference artifacts to {path}")


def run_training(args, device):
    """Import, select features, tune, train, evaluate and save
    (flexynesis_tpu/__main__.py:488-570). Returns the trained model, with the
    phases' host-clock seconds as its ``cli_phases``."""
    from .interpret.attribution import check_config_attributable
    from .models import MODEL_REGISTRY
    from .train.hpo import HyperparameterTuning
    from .train.space import load_and_convert_config
    from .utils.csvio import write_rows

    if not args.disable_marker_finding and args.config_path:
        check_config_attributable(
            args.model_class, load_and_convert_config(args.config_path).get(args.model_class))
    t0 = time.perf_counter()
    phases = {}
    data_importer = _build_importer(args, device)
    train_dataset, test_dataset = data_importer.import_data()
    for layer, rows in data_importer.feature_logs.items():
        write_rows(os.path.join(args.outdir, f"{args.prefix}.feature_logs.{layer}.csv"), rows)
    if args.model_class == "GNN":
        train_dataset = _load_graph(args, train_dataset)
        # the test split reuses the training node set and interaction graph
        test_dataset = type(train_dataset)(test_dataset, train_dataset.interaction_df,
                                           node_names=train_dataset.node_names)
    phases["import_and_feature_selection"] = time.perf_counter() - t0

    t = time.perf_counter()
    batch_ask = resolve_hpo_batch(args, device)
    tuner = HyperparameterTuning(
        dataset=train_dataset,
        model_class=MODEL_REGISTRY[args.model_class],
        config_name=args.model_class,
        target_variables=_split(args.target_variables) or [],
        surv_event_var=args.surv_event_var,
        surv_time_var=args.surv_time_var,
        n_iter=args.hpo_iter,
        config_path=args.config_path,
        val_size=args.val_size,
        use_cv=args.use_cv,
        use_loss_weighting=args.use_loss_weighting == "True",
        early_stop_patience=args.early_stop_patience,
        device=device,
        gnn_conv_type=args.gnn_conv_type,
        input_layers=_split(args.input_layers),
        output_layers=_split(args.output_layers),
        batch_ask=batch_ask,
        pipeline_ask=args.hpo_pipeline == "True",
    )
    model, best_params = tuner.perform_tuning(hpo_patience=args.hpo_patience)
    phases["hpo_fit"] = time.perf_counter() - t
    print(f"[INFO] Best hyperparameters: {best_params}")

    t = time.perf_counter()
    phases["marker_finding"] = _write_eval_outputs(args, model, train_dataset, test_dataset)
    phases["evaluation_outputs"] = time.perf_counter() - t - phases["marker_finding"]
    t = time.perf_counter()
    _save_model_files(args, model, data_importer)
    phases["save"] = time.perf_counter() - t
    model.cli_phases = phases
    print(f"[INFO] Total wall time: {time.perf_counter() - t0:.1f}s")
    return model


def _check_training_args(parser, args) -> None:
    """The JAX CLI's argument checks, then what the port does not run yet."""
    missing = [k for k in ("data_path", "model_class", "data_types") if not getattr(args, k)]
    if missing:
        parser.error("required in training mode: " + ", ".join(f"--{m}" for m in missing))
    deep = args.model_class in ("DirectPred", "supervised_vae", "MultiTripletNetwork",
                                "CrossModalPred", "GNN")
    if deep and not args.target_variables and not (args.surv_event_var and args.surv_time_var):
        parser.error("either --target_variables or both survival variables required")
    if (args.surv_event_var is None) != (args.surv_time_var is None):
        parser.error("--surv_event_var and --surv_time_var must be set together")
    if args.fusion_type == "early" and args.model_class in ("CrossModalPred", "GNN"):
        parser.error(f"--fusion_type early is not applicable to {args.model_class}")
    if args.model_class == "GNN" and args.covariates:
        parser.error("--covariates are not supported for GNN models")

    if not deep:
        raise NotImplementedError(
            f"--model_class {args.model_class} (classical baselines) is not ported "
            "to flexynesis_torch yet (ROADMAP item 13)"
        )
    if args.finetuning_samples > 0:
        raise NotImplementedError("fine-tuning is not ported yet (ROADMAP A.12)")
    if args.evaluate_baseline_performance:
        raise NotImplementedError(
            "--evaluate_baseline_performance is not ported yet (ROADMAP item 13)"
        )
    if args.profile:
        raise NotImplementedError("--profile is not ported yet (ROADMAP item 13)")
    if args.hpo_checkpoint:
        raise NotImplementedError(
            "--hpo_checkpoint is not ported yet (ROADMAP item 9)"
        )
    if not args.safetensors:
        raise NotImplementedError(
            "joblib artifacts hold pickled sklearn objects that flexynesis_torch "
            "does not write; pass --safetensors for JSON artifacts"
        )


def resolve_hpo_batch(args, device) -> int:
    """Suggestions per GP round (flexynesis_tpu/__main__.py:185-199):
    ``--hpo_batch 0`` (the default) trains min(16, hpo_iter) suggestions at
    once on the card and one at a time on the CPU."""
    if args.hpo_batch > 0:
        return args.hpo_batch
    batch = min(16, args.hpo_iter) if device.type == "cuda" else 1
    if batch > 1:
        print(f"[INFO] HPO trial fan-out: {batch} suggestions per GP round "
              "(stacked; --hpo_batch 1 restores sequential trials)")
    return batch


def _write_feature_importances(args, model, test_dataset) -> None:
    """Marker finding over the test cohort (flexynesis_tpu/__main__.py:345-381):
    one table per method, every variable of the model, 25 steps or draws.
    ``--marker_sample_cap`` attributes a seeded subsample; the JAX package's
    sharding of the sample axis over several devices waits for multi-GPU
    (ROADMAP A item 7)."""
    import numpy as np

    from .utils.csvio import write_rows

    from .interpret.attribution import METHODS

    methods = (METHODS if args.feature_importance_method == "Both"
               else [args.feature_importance_method])
    attr_dataset = test_dataset
    cap = args.marker_sample_cap
    if cap and len(test_dataset) > cap:
        idx = np.random.default_rng(42).choice(len(test_dataset), size=cap, replace=False)
        attr_dataset = test_dataset.subset(idx)
        print(f"[INFO] Capping marker discovery at {cap} subsampled samples")
    for method in methods:
        rows = []
        for var in model.variables:
            print(f"[INFO] Computing feature importance ({method}) for {var}")
            rows += model.compute_feature_importance(attr_dataset, var, method=method,
                                                     steps_or_samples=25)
        write_rows(os.path.join(args.outdir, f"{args.prefix}.feature_importance.{method}.csv"),
                   rows)


def _write_eval_outputs(args, model, train_dataset, test_dataset) -> float:
    """Embeddings, feature importances, predictions and stats (reference
    __main__.py:1353-1469); returns the seconds marker finding took."""
    from .utils.csvio import write_rows
    from .utils.metrics import evaluate_wrapper, get_predicted_labels

    outdir, prefix = args.outdir, args.prefix
    if train_dataset is not None:
        model.transform(train_dataset).to_csv(
            os.path.join(outdir, f"{prefix}.embeddings_train.csv")
        )
    model.transform(test_dataset).to_csv(
        os.path.join(outdir, f"{prefix}.embeddings_test.csv")
    )

    t = time.perf_counter()
    if not args.disable_marker_finding:
        _write_feature_importances(args, model, test_dataset)
    marker_s = time.perf_counter() - t

    preds_test = model.predict(test_dataset)
    rows = get_predicted_labels(preds_test, test_dataset, "test", model.model_name)
    if train_dataset is not None:
        rows += get_predicted_labels(
            model.predict(train_dataset), train_dataset, "train", model.model_name
        )
    write_rows(os.path.join(outdir, f"{prefix}.predicted_labels.csv"), rows)

    stats = evaluate_wrapper(
        model.model_name, preds_test, test_dataset,
        surv_event_var=model.surv_event_var, surv_time_var=model.surv_time_var,
    )
    write_rows(os.path.join(outdir, f"{prefix}.stats.csv"), stats)
    for r in stats:
        print(f"{r['var']:>12} {r['metric']:>14} {r['value']}")

    if model.model_name == "CrossModalPred":
        for layer, table in model.decode(test_dataset).items():
            table.to_csv(os.path.join(outdir, f"{prefix}.{layer}_decoded.csv"))
    return marker_s


def parse_args(argv=None):
    """(args, device) after the CLI's checks; the output folder exists."""
    from .utils.device import resolve_device

    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.pretrained_model:
        _check_training_args(parser, args)
    device = resolve_device(args.device)
    if args.pretrained_model and not (args.artifacts and args.data_path_test):
        parser.error(
            "inference mode needs --pretrained_model, --artifacts and --data_path_test"
        )
    if args.finetuning_samples > 0:
        raise NotImplementedError(
            "fine-tuning in inference mode is not ported yet (ROADMAP A.12)"
        )
    os.makedirs(args.outdir, exist_ok=True)
    return args, device


def main(argv=None) -> int:
    args, device = parse_args(argv)
    if args.pretrained_model:
        return run_inference(args, device)
    run_training(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
