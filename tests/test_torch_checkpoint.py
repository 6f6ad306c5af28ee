"""Checkpoint and resume (``flexynesis_torch/train/checkpoint.py``, the
round checkpoint of ``parallel/trials.py``, ``--hpo_checkpoint`` in
``train/hpo.py`` and the CLI), after ``tests/test_checkpoint.py``,
``tests/test_trial_checkpoint.py`` and ``tests/test_cli.py`` of the JAX
package:

* a state file round-trips float32, bfloat16 (bit for bit), integer and
  generator-state tensors and its metadata, written through a temporary file;
  ``TrainCheckpointer`` keeps the newest two steps;
* ``Trainer.fit(checkpoint_dir=...)`` stopped after 8 epochs and rerun for 12
  resumes at epoch 8 and returns what an uninterrupted 12-epoch fit returns,
  bit for bit on the CPU (state, validation loss, the last losses), with and
  without a validation split;
* a ``ParallelTrials`` round killed after two chunks resumes from epoch 8 and
  equals the uninterrupted round bit for bit; a foreign round's file is
  ignored with a warning; a finished round leaves no file;
* a tuner killed in the middle of a same-architecture round resumes that
  round from its checkpoint and tells the GP the same losses, bit for bit, as
  an uninterrupted run;
* a JSON HPO state written by the JAX CLI resumes in the port's CLI, and the
  GP restored from it in either package asks the same next suggestion (the
  file is plain JSON both ways);
* the kitchen-sink CLI run (CV x batched ask x pipelined session x early
  fusion x covariates x checkpoint) resumes when rerun with a larger budget."""

import json
import os

import numpy as np
import pytest
import torch

from flexynesis_tpu.__main__ import main as jax_main
from flexynesis_tpu.train.gp import BayesianOptimizer as JaxBayesianOptimizer
from flexynesis_tpu.train.space import load_and_convert_config as jax_load_config
from flexynesis_torch.__main__ import main
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.parallel import trials
from flexynesis_torch.parallel.trials import ParallelTrials
from flexynesis_torch.train import hpo
from flexynesis_torch.train.checkpoint import TrainCheckpointer, load_state, save_state
from flexynesis_torch.train.gp import BayesianOptimizer
from flexynesis_torch.train.space import load_and_convert_config
from flexynesis_torch.train.trainer import Trainer, train_val_split
from flexynesis_torch.utils.synthetic import write_synthetic_folder

CFG = {"latent_dim": 8, "hidden_dim_factor": 0.5, "lr": 5e-3, "supervisor_hidden_dim": 8,
       "epochs": 12, "batch_size": 32}


@pytest.fixture(scope="module")
def ds():
    rng = np.random.default_rng(7)
    n, f = 96, 16
    cls = rng.integers(0, 2, n)
    return MultiOmicDataset(
        dat={"gex": (rng.normal(size=(n, f)) + 1.2 * cls[:, None]).astype(np.float32)},
        ann={"y": cls.astype(np.float32)}, variable_types={"y": "categorical"},
        features={"gex": [f"g{i}" for i in range(f)]},
        samples=[f"S{i}" for i in range(n)], label_mappings={"y": {0: "a", 1: "b"}})


# ------------------------------------------------------------- the file


def test_state_file_round_trips(tmp_path):
    gen = torch.Generator().manual_seed(3)
    tensors = {"w": torch.randn(3, 4), "h": torch.randn(5).to(torch.bfloat16),
               "n": torch.arange(6), "gen": gen.get_state()}
    path = str(tmp_path / "s.safetensors")
    save_state(path, tensors, {"epoch": 4, "best_val": float("inf")})
    got, meta = load_state(path)
    assert meta == {"epoch": 4, "best_val": float("inf")}
    assert os.listdir(tmp_path) == ["s.safetensors"]  # no temporary file left
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    restored = torch.Generator()
    restored.set_state(got["gen"])
    assert torch.equal(torch.rand(4, generator=restored), torch.rand(4, generator=gen))


def test_checkpointer_keeps_the_newest_steps(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "c"), every_n_epochs=2, max_to_keep=2)
    for epoch in range(1, 9):
        ckpt.maybe_save(epoch, {"x": torch.full((2,), float(epoch))}, {"k": epoch})
    assert ckpt.steps() == [6, 8]
    tensors, meta = ckpt.restore()
    assert meta == {"k": 8, "epoch": 8} and torch.equal(tensors["x"], torch.full((2,), 8.0))
    assert TrainCheckpointer(str(tmp_path / "empty")).restore() is None


# --------------------------------------------------------- Trainer.fit


@pytest.mark.parametrize("with_val,patience", [(True, 3), (True, -1), (False, -1)])
def test_trainer_resume_matches_uninterrupted(ds, tmp_path, with_val, patience):
    tr, va = train_val_split(len(ds), 0.2)

    def run(max_epochs, ckpt=None):
        model = DirectPred(CFG, ds, target_variables=["y"], device="cpu")
        model.init_params(0)
        trainer = Trainer(model.module, model.loss_fn, lr=0.01)
        return trainer.fit(model.make_batch(ds, tr),
                           model.make_batch(ds, va) if with_val else None,
                           n_samples=len(tr), batch_size=32, max_epochs=max_epochs,
                           early_stop_patience=patience, seed=5, checkpoint_dir=ckpt,
                           checkpoint_every=4)

    full = run(12)
    ckpt = str(tmp_path / "ckpts")
    first = run(8, ckpt)
    assert first.epochs_run == 8 and TrainCheckpointer(ckpt).steps() == [4, 8]
    resumed = run(12, ckpt)
    assert resumed.epochs_run == full.epochs_run
    key = "val_loss" if with_val else "train_loss"
    assert resumed.history[key] == full.history[key][8:]  # only epochs 8..11 ran
    assert resumed.val_loss == full.val_loss
    for n, t in full.state.items():
        assert torch.equal(resumed.state[n], t), n


# ------------------------------------------------------------ the round


def _round(ds, ckpt=None, die_after_epochs=None, lrs=(5e-3, 5e-3), max_epochs=12,
           monkeypatch=None):
    model = DirectPred(CFG, ds, target_variables=["y"], device="cpu")
    if die_after_epochs is not None:
        real, seen = trials._Round.validate, {"n": 0}

        def dying(self, batch):
            seen["n"] += 1
            if seen["n"] > die_after_epochs:
                raise KeyboardInterrupt("simulated preemption")
            return real(self, batch)

        monkeypatch.setattr(trials._Round, "validate", dying)
    try:
        return ParallelTrials(model, ds).run(
            lrs=np.asarray(lrs), seeds=np.arange(2), train_idx=np.arange(72),
            val_idx=np.arange(72, 96), batch_size=32, max_epochs=max_epochs,
            epochs_per_eval=4, checkpoint_dir=ckpt)
    finally:
        if monkeypatch is not None:
            monkeypatch.undo()


def test_round_resume_matches_uninterrupted(ds, tmp_path, capsys, monkeypatch):
    full = _round(ds)
    ckpt = str(tmp_path / "round")
    with pytest.raises(KeyboardInterrupt):  # dies in epoch 9 of 12
        _round(ds, ckpt, die_after_epochs=8, monkeypatch=monkeypatch)
    assert os.path.exists(os.path.join(ckpt, "round.safetensors"))
    resumed = _round(ds, ckpt)  # the same round: picks up at epoch 8
    assert "Resumed trial round from epoch 8" in capsys.readouterr().out
    np.testing.assert_array_equal(resumed["best_val_loss"], full["best_val_loss"])
    np.testing.assert_array_equal(resumed["best_epoch"], full["best_epoch"])
    assert resumed["epochs_run"] == 12
    for n, t in full["final_params"].items():
        assert torch.equal(resumed["final_params"][n], t), n


def test_foreign_round_starts_fresh(ds, tmp_path, capsys, monkeypatch):
    ckpt = str(tmp_path / "round")
    with pytest.raises(KeyboardInterrupt):
        _round(ds, ckpt, die_after_epochs=4, monkeypatch=monkeypatch)
    # the same shapes, another round (other lrs): the stale state is not taken
    out = _round(ds, ckpt, lrs=(1e-3, 1e-3), max_epochs=4)
    assert "not resumable" in capsys.readouterr().out
    assert out["epochs_run"] == 4 and np.all(np.isfinite(out["best_val_loss"]))


def test_completed_round_cleans_up(ds, tmp_path):
    ckpt = str(tmp_path / "round")
    _round(ds, ckpt)
    assert not os.path.exists(os.path.join(ckpt, "round.safetensors"))


# ------------------------------------------------------------ the tuner


def _space(path, lr_free=True):
    lr = ("{type: Real, low: 0.0001, high: 0.01, prior: log-uniform, name: lr}" if lr_free
          else "{type: Categorical, categories: [0.01], name: lr}")
    path.write_text(
        "DirectPred:\n"
        "  - {type: Categorical, categories: [8], name: latent_dim}\n"
        "  - {type: Categorical, categories: [0.3], name: hidden_dim_factor}\n"
        f"  - {lr}\n"
        "  - {type: Categorical, categories: [6], name: supervisor_hidden_dim}\n"
        "  - {type: Categorical, categories: [8], name: epochs}\n"
        "  - {type: Categorical, categories: [32], name: batch_size}\n")
    return str(path)


def test_tuner_resumes_a_killed_round(ds, tmp_path, capsys, monkeypatch):
    space = _space(tmp_path / "space.yaml")

    def tuner(path):
        return hpo.HyperparameterTuning(ds, DirectPred, "DirectPred", ["y"], n_iter=4,
                                        config_path=space, device="cpu", batch_ask=4,
                                        checkpoint_path=path)

    def told(path):
        with open(path) as fh:
            return json.load(fh)["optimizer"]["y"]

    full_path = str(tmp_path / "full.json")
    tuner(full_path).perform_tuning()
    path = str(tmp_path / "killed.json")
    real, seen = trials._Round.validate, {"n": 0}

    def dying(self, batch):
        seen["n"] += 1
        if seen["n"] > 6:
            raise KeyboardInterrupt("simulated preemption")
        return real(self, batch)

    monkeypatch.setattr(trials._Round, "validate", dying)
    with pytest.raises(KeyboardInterrupt):
        tuner(path).perform_tuning()
    monkeypatch.undo()
    rounds = [d for d in os.listdir(tmp_path) if d.startswith("killed.json.round-")]
    assert len(rounds) == 1 and not os.path.exists(path)  # no tell yet
    capsys.readouterr()
    tuner(path).perform_tuning()
    assert "Resumed trial round from epoch 5" in capsys.readouterr().out
    assert told(path) == told(full_path)  # every loss, bit for bit
    assert not os.path.exists(os.path.join(tmp_path, rounds[0]))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt_cli")
    write_synthetic_folder(str(path / "data"), n_train=60, n_test=30,
                           n_features={"gex": 40, "cnv": 20}, n_classes=3, seed=8)
    return path


def _cli_args(data, space, outdir, hpo_iter, state):
    return ["--data_path", data, "--model_class", "DirectPred", "--data_types", "gex",
            "--target_variables", "subtype", "--config_path", space, "--hpo_iter",
            str(hpo_iter), "--hpo_batch", "1", "--features_min", "10",
            "--hpo_checkpoint", state, "--disable_marker_finding", "--outdir", outdir,
            "--prefix", "job"]


def test_jax_hpo_state_resumes_in_the_port(folder, tmp_path, capsys):
    space = _space(tmp_path / "space.yaml")
    state = str(tmp_path / "hpo.json")
    data = str(folder / "data")
    assert jax_main(_cli_args(data, space, str(tmp_path / "jax"), 2, state)
                    + ["--device", "cpu", "--safetensors"]) == 0
    with open(state) as fh:
        saved = json.load(fh)
    assert saved["iteration"] == 2 and len(saved["optimizer"]["y"]) == 2
    # the GP restored from the file asks the same next suggestion in both
    ours = BayesianOptimizer(load_and_convert_config(space)["DirectPred"], n_initial_points=10,
                             seed=42)
    theirs = JaxBayesianOptimizer(jax_load_config(space)["DirectPred"], n_initial_points=10,
                                  seed=42)
    ours.load_state_dict(saved["optimizer"])
    theirs.load_state_dict(saved["optimizer"])
    assert ours.ask(1) == theirs.ask(1)
    capsys.readouterr()
    assert main(_cli_args(data, space, str(tmp_path / "port"), 3, state)
                + ["--device", "cpu", "--safetensors"]) == 0
    out = capsys.readouterr().out
    assert "Resuming HPO from iteration 2" in out
    assert "HPO iter 3/3" in out and "HPO iter 1/3" not in out
    with open(state) as fh:
        resumed = json.load(fh)
    assert resumed["iteration"] == 3 and resumed["optimizer"]["y"][:2] == saved["optimizer"]["y"]
    # and the port's file loads back into the JAX optimizer
    JaxBayesianOptimizer(jax_load_config(space)["DirectPred"], n_initial_points=10,
                         seed=42).load_state_dict(resumed["optimizer"])


def test_cli_kitchen_sink_with_checkpoint_resume(folder, tmp_path, capsys):
    """Fused CV x batched ask x pipelined session x early fusion x covariates
    x checkpoint runs, and a rerun with a larger budget resumes."""
    outdir = str(tmp_path / "sink")
    space = _space(tmp_path / "space.yaml", lr_free=False)
    args = ["--data_path", str(folder / "data"), "--model_class", "DirectPred",
            "--data_types", "gex,cnv", "--target_variables", "subtype",
            "--covariates", "age", "--fusion_type", "early", "--use_cv",
            "--hpo_iter", "2", "--hpo_batch", "2", "--hpo_pipeline", "True",
            "--hpo_checkpoint", os.path.join(outdir, "hpo.json"), "--config_path", space,
            "--features_min", "10", "--disable_marker_finding", "--safetensors",
            "--device", "cpu", "--outdir", outdir, "--prefix", "job"]
    assert main(args) == 0
    capsys.readouterr()
    args[args.index("--hpo_iter") + 1] = "4"  # raise the budget
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "Resuming HPO from iteration 2" in out
    assert "2 suggestions x 5 CV folds = 10 trials concurrently" in out
