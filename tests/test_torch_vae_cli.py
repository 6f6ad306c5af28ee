"""``python -m flexynesis_torch`` training and serving the VAE-MMD models
(supervised_vae, and CrossModalPred with a gex -> cnv translation) on the CPU:

* each class trains through the port's CLI and writes every file the JAX CLI
  writes with the same flags, CrossModalPred's decoded table included;
* a model trained by the port serves in the JAX package's inference CLI, and
  a model trained by the JAX package serves in the port's; in both cases the
  two inference CLIs give the same embeddings, probabilities and decoded
  values on the same test folder.

Tolerance for the two inference CLIs: rtol 1e-4, atol 1e-5 (f32)."""

import os

import numpy as np
import pytest

from flexynesis_tpu.__main__ import main as jax_main
from flexynesis_torch.__main__ import main
from flexynesis_torch.utils.csvio import read_matrix, read_table
from flexynesis_torch.utils.synthetic import write_synthetic_folder

CONFIG = """{model}:
  - {{type: Categorical, categories: [8], name: latent_dim}}
  - {{type: Categorical, categories: [0.3], name: hidden_dim_factor}}
  - {{type: Categorical, categories: [0.003], name: lr}}
  - {{type: Categorical, categories: [8], name: supervisor_hidden_dim}}
  - {{type: Categorical, categories: [3], name: epochs}}
  - {{type: Categorical, categories: [16], name: batch_size}}
  - {{type: Categorical, categories: [true], name: fused_kernels}}
"""
MODELS = {
    "supervised_vae": [],
    "CrossModalPred": ["--input_layers", "gex", "--output_layers", "cnv"],
}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("vae_cli")
    write_synthetic_folder(str(root / "data"), n_train=48, n_test=20,
                           n_features={"gex": 40, "cnv": 30}, n_classes=3, seed=6)
    for model in MODELS:
        (root / f"{model}.yaml").write_text(CONFIG.format(model=model))
    return root


def train_args(root, model, outdir, *extra):
    return ["--data_path", str(root / "data"), "--model_class", model, *MODELS[model],
            "--data_types", "gex,cnv", "--target_variables", "subtype",
            "--config_path", str(root / f"{model}.yaml"), "--hpo_iter", "1",
            "--features_top_percentile", "50", "--features_min", "10",
            "--safetensors", "--disable_marker_finding", "--outdir", str(outdir),
            "--prefix", "job", *extra]


@pytest.fixture(scope="module")
def trained(folder):
    """{model: (port's output folder, JAX package's output folder)}"""
    out = {}
    for model in MODELS:
        ours, theirs = folder / f"torch_{model}", folder / f"jax_{model}"
        assert main(train_args(folder, model, ours, "--device", "cpu")) == 0
        assert jax_main(train_args(folder, model, theirs, "--hpo_batch", "1")) == 0
        out[model] = (ours, theirs)
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
def test_writes_every_file_the_jax_cli_writes(trained, model):
    ours, theirs = trained[model]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for name in ("predicted_labels", "stats"):
        assert read_table(str(ours / f"job.{name}.csv"))[1] == \
            read_table(str(theirs / f"job.{name}.csv"))[1]
    samples, _, emb = read_matrix(str(ours / "job.embeddings_test.csv"))
    assert emb.shape == (20, 8) and np.isfinite(emb).all()
    if model == "CrossModalPred":
        names, cols, dec = read_matrix(str(ours / "job.cnv_decoded.csv"))
        assert names == samples
        assert cols == read_matrix(str(theirs / "job.cnv_decoded.csv"))[1]
        assert dec.shape == (20, len(cols)) and ((dec >= 0) & (dec <= 1)).all()
        assert not (ours / "job.gex_decoded.csv").exists()


def _serve(entry, model_dir, test, outdir):
    args = ["--pretrained_model", str(model_dir / "job.final_model.safetensors"),
            "--artifacts", str(model_dir / "job.artifacts.json"),
            "--data_path_test", str(test), "--outdir", str(outdir), "--prefix", "inf",
            "--disable_marker_finding"]
    assert entry(args + (["--device", "cpu"] if entry is main else [])) == 0
    samples, _, emb = read_matrix(str(outdir / "inf.embeddings_test.csv"))
    _, cols, rows = read_table(str(outdir / "inf.predicted_labels.csv"))
    prob = np.array([float(r[cols.index("probability")]) for r in rows])
    decoded = outdir / "inf.cnv_decoded.csv"
    return samples, emb, prob, read_matrix(str(decoded))[2] if decoded.exists() else None


@pytest.mark.parametrize("trained_by", ["torch", "jax"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_saved_model_serves_in_both_packages(folder, trained, model, trained_by):
    model_dir = trained[model][0 if trained_by == "torch" else 1]
    test = folder / "data" / "test"
    s1, e1, p1, d1 = _serve(main, model_dir, test, folder / f"serve_{model}_{trained_by}_t")
    s2, e2, p2, d2 = _serve(jax_main, model_dir, test, folder / f"serve_{model}_{trained_by}_j")
    assert s1 == s2
    np.testing.assert_allclose(e1, e2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p1, p2, rtol=1e-4, atol=1e-5)
    assert (d1 is None) == (d2 is None) == (model != "CrossModalPred")
    if d1 is not None:
        np.testing.assert_allclose(d1, d2, rtol=1e-4, atol=1e-5)
