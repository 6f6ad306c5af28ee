"""``python -m flexynesis_torch`` training and serving MultiTripletNetwork and
GNN on the CPU, against ``python -m flexynesis_tpu`` with the same flags, on a
folder whose layers share gene names (a GNN's folder) and a user graph (a
ring plus two random edges per gene):

* each class trains through the port's CLI with marker finding on and writes
  every file the JAX CLI writes, with the same table columns; the GNN's
  importance table holds one row per (class, layer, node) over JAX's node set;
* a model trained by either package serves in both inference CLIs (a GNN
  rebuilds its node tensor from the graph its weights embed), with marker
  finding: the embeddings and probabilities agree (rtol 1e-4, atol 1e-5; the
  CSV text), and so do the importance tables (rtol 1e-4, atol 1e-6);
* a GNN trains over STRING from a warm cache (the vendored fixtures under
  ``FLEXYNESIS_CACHE``) with JAX's node set;
* the K-stacked rounds through the CLI: a padded mixed round of 4 and a
  ``--use_cv`` round of 2 suggestions x 5 folds, for both classes, each
  ending with the retrain of its best configuration."""

import json
import os
import shutil

import numpy as np
import pytest

from flexynesis_tpu.__main__ import main as jax_main
from flexynesis_torch.__main__ import main
from flexynesis_torch.utils.csvio import read_matrix, read_table
from flexynesis_torch.utils.synthetic import write_synthetic_folder, write_user_graph

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CONFIGS = {
    "MultiTripletNetwork": """MultiTripletNetwork:
  - {type: Categorical, categories: [8], name: latent_dim}
  - {type: Categorical, categories: [0.3], name: hidden_dim_factor}
  - {type: Categorical, categories: [0.003], name: lr}
  - {type: Categorical, categories: [8], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [2], name: epochs}
  - {type: Categorical, categories: [16], name: batch_size}
""",
    "GNN": """GNN:
  - {type: Categorical, categories: [8], name: latent_dim}
  - {type: Categorical, categories: [4], name: node_embedding_dim}
  - {type: Categorical, categories: [2], name: num_convs}
  - {type: Categorical, categories: [0.003], name: lr}
  - {type: Categorical, categories: [8], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [2], name: epochs}
  - {type: Categorical, categories: [16], name: batch_size}
""",
}
MIXED = {
    "MultiTripletNetwork": """MultiTripletNetwork:
  - {type: Integer, low: 8, high: 16, name: latent_dim}
  - {type: Real, low: 0.2, high: 0.5, name: hidden_dim_factor}
  - {type: Real, low: 0.0001, high: 0.01, prior: log-uniform, name: lr}
  - {type: Categorical, categories: [4, 8], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [2], name: epochs}
  - {type: Categorical, categories: [16], name: batch_size}
""",
    "GNN": """GNN:
  - {type: Integer, low: 8, high: 16, name: latent_dim}
  - {type: Integer, low: 2, high: 6, name: node_embedding_dim}
  - {type: Categorical, categories: [2], name: num_convs}
  - {type: Real, low: 0.0001, high: 0.01, prior: log-uniform, name: lr}
  - {type: Categorical, categories: [4, 8], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [2], name: epochs}
  - {type: Categorical, categories: [16], name: batch_size}
""",
}
CLASSES = sorted(CONFIGS)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_cli")
    write_synthetic_folder(str(root / "data"), n_train=48, n_test=20,
                           n_features={"gex": 40, "cnv": 30}, n_classes=3, seed=7,
                           gene_names=True)
    write_user_graph(str(root / "graph.csv"), 50)
    for name, text in CONFIGS.items():
        (root / f"{name}.yaml").write_text(text)
        (root / f"{name}_mixed.yaml").write_text(MIXED[name])
    return root


def train_args(root, cls, outdir, *extra, config=None):
    graph = ["--user_graph", str(root / "graph.csv")] if cls == "GNN" else []
    return ["--data_path", str(root / "data"), "--model_class", cls, *graph,
            "--data_types", "gex,cnv", "--target_variables", "subtype",
            "--config_path", str(config or root / f"{cls}.yaml"), "--hpo_iter", "1",
            "--features_top_percentile", "50", "--features_min", "12", "--safetensors",
            "--outdir", str(outdir), "--prefix", "job", *extra]


@pytest.fixture(scope="module")
def trained(folder):
    """{class: (port's output folder, JAX package's output folder)}"""
    out = {}
    for cls in CLASSES:
        ours, theirs = folder / f"torch_{cls}", folder / f"jax_{cls}"
        assert main(train_args(folder, cls, ours, "--device", "cpu")) == 0
        assert jax_main(train_args(folder, cls, theirs, "--hpo_batch", "1")) == 0
        out[cls] = (ours, theirs)
    return out


@pytest.mark.parametrize("cls", CLASSES)
def test_writes_every_file_the_jax_cli_writes(trained, cls):
    ours, theirs = trained[cls]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for name in ("predicted_labels", "stats", "feature_importance.IntegratedGradients"):
        assert read_table(str(ours / f"job.{name}.csv"))[1] == \
            read_table(str(theirs / f"job.{name}.csv"))[1]
    samples, _, emb = read_matrix(str(ours / "job.embeddings_test.csv"))
    assert emb.shape == (20, 8) and np.isfinite(emb).all()
    _, cols, rows = read_table(str(ours / "job.feature_importance.IntegratedGradients.csv"))
    _, _, jrows = read_table(str(theirs / "job.feature_importance.IntegratedGradients.csv"))
    key = [cols.index(c) for c in ("target_class", "layer", "name")]
    assert sorted(tuple(r[i] for i in key) for r in rows) == \
        sorted(tuple(r[i] for i in key) for r in jrows)
    if cls == "GNN":
        with open(ours / "job.final_model_config.json") as a, \
                open(theirs / "job.final_model_config.json") as b:
            mine, jax_conf = json.load(a), json.load(b)
        assert_same_node_set(ours, theirs, mine, jax_conf)
        assert mine["gnn_conv_type"] == jax_conf["gnn_conv_type"] == "GC"
        assert len(rows) == len(jrows) and len(rows) % (2 * len(mine["node_names"])) == 0


def union_order(model_dir, nodes):
    """``nodes`` in the order of a run's layers and their selected features:
    the order a node set is built in. The JAX importer takes its layer order
    from a set, so it can differ between processes; the node set cannot."""
    with open(model_dir / "job.artifacts.json") as fh:
        art = json.load(fh)
    out = []
    for layer in art["data_types"]:
        out += [f for f in art["feature_lists"][layer] if f in nodes and f not in out]
    return out


def assert_same_node_set(ours, theirs, mine, jax_conf):
    assert set(mine["node_names"]) == set(jax_conf["node_names"])
    assert mine["node_names"] == union_order(ours, set(jax_conf["node_names"]))
    assert jax_conf["node_names"] == union_order(theirs, set(mine["node_names"]))


def _serve(entry, model_dir, test, outdir):
    args = ["--pretrained_model", str(model_dir / "job.final_model.safetensors"),
            "--artifacts", str(model_dir / "job.artifacts.json"),
            "--data_path_test", str(test), "--outdir", str(outdir), "--prefix", "inf"]
    assert entry(args + (["--device", "cpu"] if entry is main else [])) == 0
    samples, _, emb = read_matrix(str(outdir / "inf.embeddings_test.csv"))
    _, cols, rows = read_table(str(outdir / "inf.predicted_labels.csv"))
    prob = np.array([float(r[cols.index("probability")]) for r in rows])
    _, icols, irows = read_table(str(outdir / "inf.feature_importance.IntegratedGradients.csv"))
    names = [(r[icols.index("layer")], r[icols.index("name")]) for r in irows]
    imp = np.array([float(r[icols.index("importance")]) for r in irows])
    return samples, emb, prob, names, imp


@pytest.mark.parametrize("trained_by", ["torch", "jax"])
@pytest.mark.parametrize("cls", CLASSES)
def test_a_saved_model_serves_in_both_packages(folder, trained, cls, trained_by):
    model_dir = trained[cls][0 if trained_by == "torch" else 1]
    test = folder / "data" / "test"
    s1, e1, p1, n1, i1 = _serve(main, model_dir, test, folder / f"serve_{cls}_{trained_by}_t")
    s2, e2, p2, n2, i2 = _serve(jax_main, model_dir, test,
                                folder / f"serve_{cls}_{trained_by}_j")
    assert s1 == s2 and n1 == n2
    np.testing.assert_allclose(e1, e2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p1, p2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(i1, i2, rtol=1e-4, atol=1e-6)


def test_gnn_trains_over_a_warm_string_cache(tmp_path, monkeypatch):
    """The fixture genes (TP53, BRCA1, EGFR, MYC, KRAS, PTEN, RB1, ATM) name
    the first rows of both layers; STRING reads the cache folder, no download."""
    genes = ["TP53", "BRCA1", "EGFR", "MYC", "KRAS", "PTEN", "RB1", "ATM"]
    data = tmp_path / "data"
    write_synthetic_folder(str(data), n_train=40, n_test=16,
                           n_features={"gex": 12, "cnv": 10}, n_classes=2, seed=3,
                           gene_names=True)
    for split in ("train", "test"):
        for layer in ("gex", "cnv"):
            path = data / split / f"{layer}.csv"
            lines = path.read_text().splitlines()
            for i, g in enumerate(genes):
                lines[1 + i] = g + lines[1 + i][len(f"g{i}"):]
            path.write_text("\n".join(lines) + "\n")
    config = tmp_path / "GNN.yaml"
    config.write_text(CONFIGS["GNN"])
    confs = {}
    for name, entry, extra in (("torch", main, ["--device", "cpu"]),
                               ("jax", jax_main, ["--hpo_batch", "1"])):
        cache = tmp_path / f"cache_{name}"
        cache.mkdir()
        for kind in ("links", "aliases"):
            shutil.copy(os.path.join(FIXTURES, "string", f"9606.protein.{kind}.v12.0.txt.gz"),
                        cache / f"9606.{kind}.txt.gz")
        monkeypatch.setenv("FLEXYNESIS_CACHE", str(cache))
        args = ["--data_path", str(data), "--model_class", "GNN", "--data_types", "gex,cnv",
                "--target_variables", "subtype", "--config_path", str(config),
                "--hpo_iter", "1", "--features_top_percentile", "100", "--features_min", "12",
                "--variance_threshold", "0", "--safetensors", "--disable_marker_finding",
                "--outdir", str(tmp_path / name), "--prefix", "job", *extra]
        assert entry(args) == 0
        with open(tmp_path / name / "job.final_model_config.json") as fh:
            confs[name] = json.load(fh)
    assert_same_node_set(tmp_path / "torch", tmp_path / "jax", confs["torch"], confs["jax"])
    assert set(confs["torch"]["node_names"]) <= set(genes)
    assert len(confs["torch"]["node_names"]) >= 5


@pytest.mark.parametrize("mode", ["mixed", "cv"])
@pytest.mark.parametrize("cls", CLASSES)
def test_stacked_rounds_through_the_cli(folder, tmp_path, capsys, cls, mode):
    if mode == "mixed":
        extra = ["--hpo_iter", "4", "--hpo_batch", "4"]
        config, want = folder / f"{cls}_mixed.yaml", \
            "Training 4 mixed-architecture trials concurrently (padded, stacked)"
    else:
        extra = ["--hpo_iter", "2", "--hpo_batch", "2", "--use_cv"]
        config, want = folder / f"{cls}.yaml", \
            "Training 2 suggestions x 5 CV folds = 10 trials concurrently (stacked)"
    args = train_args(folder, cls, tmp_path / "out", "--device", "cpu",
                      "--disable_marker_finding", config=config)
    assert main([a for a in args if a not in ("--hpo_iter", "1")] + extra) == 0
    log = capsys.readouterr().out
    assert want in log and "Final full-data training with best params" in log
    assert (tmp_path / "out" / "job.final_model.safetensors").exists()
