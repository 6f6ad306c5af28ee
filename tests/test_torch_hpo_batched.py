"""Batched GP rounds of the port's HPO (``flexynesis_torch/train/hpo.py``) and
``--hpo_batch`` in its CLI, against the JAX package where both run:

* a batched ask of 4 gives JAX's suggestions for the same seed, and with the
  pipelined session (this round's suggestions pending) the next round's
  suggestions equal JAX's once both are told the same losses (exactly: the
  port keeps copies of the same numpy code);
* the tuner's grouping (``_bucket_by_architecture``, ``_arch_identical``,
  the template cache) follows JAX's;
* a mixed-architecture round of 4 on a tiny folder trains padded, then
  retrains the best configuration on the full set and returns that model;
* a same-architecture round (only ``lr`` free) trains stacked;
* ``--hpo_batch 4 --device cpu`` writes the output tables, ``--hpo_batch 0``
  resolves to 1 on the CPU and to min(16, hpo_iter) on the card, and
  supervised_vae with ``--hpo_batch 4`` raises ``NotImplementedError``."""

import argparse
import os

import numpy as np
import pytest
import torch

from flexynesis_tpu import config as jax_config
from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.models.direct_pred import DirectPred as JaxDirectPred
from flexynesis_tpu.train import gp as jax_gp
from flexynesis_tpu.train import space as jax_space
from flexynesis_tpu.train.hpo import HyperparameterTuning as JaxTuning
from flexynesis_torch import config
from flexynesis_torch.__main__ import main, resolve_hpo_batch
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.data.importer import DataImporter
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.models.supervised_vae import SupervisedVAE
from flexynesis_torch.train import gp, space
from flexynesis_torch.train.hpo import HyperparameterTuning
from flexynesis_torch.utils.synthetic import write_synthetic_folder


def _loss(p):
    return (np.log10(p["lr"]) + 2.5) ** 2 + (p["latent_dim"] - 64) ** 2 / 1e3 \
        + p["hidden_dim_factor"] + p["batch_size"] / 1e3


def _optimizers(n_initial):
    ours_space = config.get_search_space("DirectPred")
    theirs_space = jax_config.get_search_space("DirectPred")
    ours_space.append(space.Categorical([32, 64], name="batch_size"))
    theirs_space.append(jax_space.Categorical([32, 64], name="batch_size"))
    return (gp.BayesianOptimizer(ours_space, n_initial_points=n_initial, seed=42),
            jax_gp.BayesianOptimizer(theirs_space, n_initial_points=n_initial, seed=42))


def test_batched_ask_matches_jax():
    ours, theirs = _optimizers(10)
    a, b = ours.ask(4), theirs.ask(4)
    assert a == b and len(a) == 4


def test_pipelined_round_two_matches_jax():
    ours, theirs = _optimizers(4)
    rounds = []
    for opt in (ours, theirs):
        first = opt.ask(4)
        session = opt.ask_session(4, pending=first)
        session.work(0.0)
        for p in first:
            opt.tell(p, _loss(p))
        second = session.finish()
        for p in second:
            opt.tell(p, _loss(p))
        rounds.append((first, second, opt.ask(4)))
    assert rounds[0] == rounds[1]


def _dataset(cls, n=40):
    rng = np.random.default_rng(0)
    return cls(dat={"gex": rng.normal(size=(n, 6)).astype(np.float32)},
               ann={"y": rng.integers(0, 2, n).astype(np.float32)},
               variable_types={"y": "categorical"}, features={"gex": list("abcdef")},
               samples=[str(i) for i in range(n)], label_mappings={"y": {0: "a", 1: "b"}})


def test_grouping_follows_jax():
    ours = HyperparameterTuning(_dataset(MultiOmicDataset), DirectPred, "DirectPred", ["y"],
                                device="cpu", batch_ask=4)
    theirs = JaxTuning(_dataset(JaxDataset), JaxDirectPred, "DirectPred", ["y"], batch_ask=4)
    base = {"latent_dim": 16, "hidden_dim_factor": 0.3, "lr": 1e-3,
            "supervisor_hidden_dim": 8, "epochs": 5, "batch_size": 32}
    group = [base, dict(base, lr=5e-3), dict(base, latent_dim=32), dict(base, epochs=6),
             dict(base, batch_size=16, lr=2e-3)]
    assert ours._bucket_by_architecture(group) == theirs._bucket_by_architecture(group)
    for g in ours._bucket_by_architecture(group):
        assert ours._arch_identical(g) == theirs._arch_identical(g)
    assert ours._template_key(base) == theirs._template_key(base)
    assert ours._get_template(base) is ours._get_template(dict(base, lr=5e-3))
    assert ours._get_template(base) is not ours._get_template(dict(base, latent_dim=32))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("hpo_batched")
    write_synthetic_folder(str(root / "data"), n_train=60, n_test=20,
                           n_features={"gex": 30, "cnv": 20}, n_classes=3, seed=4)
    return root


@pytest.fixture(scope="module")
def train_ds(folder):
    imp = DataImporter(str(folder / "data"), ["gex", "cnv"], top_percentile=50,
                       min_features=10, device="cpu")
    return imp.import_data()[0]


def _tuner(train_ds, **kw):
    tuner = HyperparameterTuning(train_ds, DirectPred, "DirectPred", ["subtype"], n_iter=4,
                                 batch_ask=4, early_stop_patience=3, device="cpu", **kw)
    for d in tuner.space.dimensions:
        if d.name == "epochs":
            d.categories = [3]
        if d.name == "batch_size":
            d.categories = [16]
    return tuner


def test_mixed_round_ends_with_a_retrained_model(train_ds, capsys):
    tuner = _tuner(train_ds)
    model, best = tuner.perform_tuning()
    log = capsys.readouterr().out
    assert "Training 4 mixed-architecture trials concurrently (padded, stacked)" in log
    assert "Final full-data training with best params" in log
    assert isinstance(model, DirectPred) and model.train_result.epochs_run == best["epochs"]
    for key in ("latent_dim", "hidden_dim_factor", "supervisor_hidden_dim"):
        assert model.config[key] == best[key]
    preds = model.predict(train_ds)["subtype"]
    assert preds.shape == (len(train_ds), model.output_dims["subtype"])
    assert np.isfinite(preds).all()


def test_same_architecture_round_trains_stacked(train_ds, capsys):
    tuner = _tuner(train_ds)
    results = tuner._run_parallel_group([
        {"latent_dim": 8, "hidden_dim_factor": 0.4, "lr": lr, "supervisor_hidden_dim": 8,
         "epochs": 3, "batch_size": 16} for lr in (1e-4, 1e-3, 1e-2)])
    assert "Training 3 same-architecture trials concurrently (stacked)" in capsys.readouterr().out
    assert len(results) == 3
    for loss, epochs, model in results:
        assert np.isfinite(loss) and 1 <= epochs <= 3 and model is None


def _cli(folder, outdir, *extra):
    return ["--data_path", str(folder / "data"), "--model_class", "DirectPred",
            "--data_types", "gex,cnv", "--target_variables", "subtype", "--hpo_iter", "4",
            "--features_top_percentile", "50", "--features_min", "10", "--safetensors",
            "--disable_marker_finding", "--device", "cpu", "--outdir", str(outdir),
            "--prefix", "job", *extra]


def test_cli_batched_round_writes_the_tables(folder, tmp_path, capsys):
    cfg = tmp_path / "hpo.yaml"
    cfg.write_text("DirectPred:\n"
                   "  - {type: Integer, low: 8, high: 16, name: latent_dim}\n"
                   "  - {type: Real, low: 0.2, high: 0.5, name: hidden_dim_factor}\n"
                   "  - {type: Real, low: 0.0001, high: 0.01, prior: log-uniform, name: lr}\n"
                   "  - {type: Categorical, categories: [4, 8], name: supervisor_hidden_dim}\n"
                   "  - {type: Categorical, categories: [3], name: epochs}\n"
                   "  - {type: Categorical, categories: [16], name: batch_size}\n")
    out = tmp_path / "out"
    assert main(_cli(folder, out, "--hpo_batch", "4", "--config_path", str(cfg))) == 0
    assert "mixed-architecture trials concurrently" in capsys.readouterr().out
    for name in ("stats.csv", "predicted_labels.csv", "embeddings_train.csv",
                 "embeddings_test.csv", "final_model.safetensors", "final_model_config.json"):
        assert os.path.exists(out / f"job.{name}"), name


def _args(model_class, hpo_batch, hpo_iter=20):
    return argparse.Namespace(model_class=model_class, hpo_batch=hpo_batch, hpo_iter=hpo_iter)


def test_hpo_batch_zero_resolves_by_device(capsys):
    assert resolve_hpo_batch(_args("DirectPred", 0), torch.device("cpu")) == 1
    assert resolve_hpo_batch(_args("DirectPred", 0), torch.device("cuda")) == 16
    assert resolve_hpo_batch(_args("DirectPred", 0, hpo_iter=5), torch.device("cuda")) == 5
    assert "HPO trial fan-out: 5 suggestions per GP round" in capsys.readouterr().out
    assert resolve_hpo_batch(_args("DirectPred", 3), torch.device("cpu")) == 3
    assert resolve_hpo_batch(_args("supervised_vae", 0), torch.device("cuda")) == 1
    assert "resolves to 1 for supervised_vae" in capsys.readouterr().out


def test_vae_batched_rounds_raise(folder, tmp_path, train_ds):
    args = _cli(folder, tmp_path / "out", "--hpo_batch", "4", "--model_class",
                "supervised_vae")
    with pytest.raises(NotImplementedError, match="VAE-MMD trial engine"):
        main(args)
    with pytest.raises(NotImplementedError, match="VAE-MMD trial engine"):
        HyperparameterTuning(train_ds, SupervisedVAE, "supervised_vae", ["subtype"],
                             device="cpu", batch_ask=4)
