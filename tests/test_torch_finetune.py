"""Fine-tuning (``flexynesis_torch/train/finetune.py``) against
``flexynesis_tpu/train/finetune.py``:

* the freeze configurations give every leaf the trainable flag JAX's
  ``_make_mask_fn`` gives its Flax leaf, for each class (exactly);
* what ``_grid_parallel`` hands to ``vmapped_grid_fit`` (lrs, seeds, fold
  tables, batch size, epochs, patience, per-trial masks) and what it makes of
  the engine's results (the winning cell and its mean stop epoch) equal
  JAX's (exactly, both engines replaced by the same stand-in);
* the grid itself, from one start state with dropout off, 40 fine-tuning
  samples (5 folds of 32 training rows, so every step is the whole fold and
  the row order drops out), float32 parameters and bfloat16 Adam moments on
  both sides: per-trial best validation losses within rtol 2e-3 / atol 1e-4
  and the per-cell means the same way, the epochs run equal, the best epochs
  equal but for at most one trial (two epochs that tie within the
  tolerance), and the chosen cell JAX's or one whose JAX mean ties JAX's
  best within the tolerance, for DirectPred and supervised_vae, fused and
  unfused (the VAE's eps and prior draws zero on both sides; the fused one
  takes B3's plain version with the trial axis). The running statistics
  of frozen encoders update in the grid, as JAX's do: the frozen cells'
  validation losses, in eval mode, agree. The
  allowance is that of the biases that only shift a batch-statistics
  BatchNorm's input: their gradient is rounding noise that Adam turns into
  steps of about lr on each side, and the running means carry part of that
  into validation. With those biases held and float32 moments on both
  sides the losses agree within 1e-4 and the best epochs are equal
  (``test_grid_matches_jax_with_f32_moments``): the moments' dtype is not
  the cause;
* the departure: JAX's ``FineTuner._fit_once`` moves a "frozen" encoder
  (``optax.masked`` passes its raw gradient through), the port's leaves it
  bit-identical and still updates its running statistics, as JAX does;
  under freeze configuration "nothing" the port's final fit matches JAX's
  (rtol 1e-4, atol 1e-5 beyond the shift allowance);
* with ``fused_kernels`` a training step of the 45-trial grid calls B1 once
  per block for all trials, with per-trial x, and a validation B2 once per
  block (the plain versions on the CPU);
* a MultiTripletNetwork fine-tunes over anchors of the fine-tuning samples
  (JAX keeps the training set's anchors: a departure);
* the sequential grid runs, and ``--finetuning_samples`` runs through the
  training and the inference CLI on the CPU."""

import flax.linen as nn_flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.models.direct_pred import DirectPred as JaxDirectPred
from flexynesis_tpu.models.supervised_vae import SupervisedVAE as JaxSupervisedVAE
from flexynesis_tpu.parallel import trials as jax_trials
from flexynesis_tpu.train import finetune as jax_finetune
from flexynesis_torch.__main__ import main
from flexynesis_torch.convert import from_flax
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.kernels import fused_linear
from flexynesis_torch.models.crossmodal_pred import CrossModalPred
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.models.supervised_vae import SupervisedVAE
from flexynesis_torch.models.triplet_encoder import MultiTripletNetwork
from flexynesis_torch.ops import fused_mlp
from flexynesis_torch.ops.fused_mlp import FusedMLP
from flexynesis_torch.ops.mlp import BN_MOMENTUM, MLP
from flexynesis_torch.parallel import stacked as stacked_mod
from flexynesis_torch.parallel import trials
from flexynesis_torch.parallel.stacked import stacked_model
from flexynesis_torch.train import finetune
from flexynesis_torch.utils.synthetic import write_synthetic_folder

N = 40  # fine-tuning samples: 5 folds of 32 training and 8 validation rows
DIMS = (("gex", 20), ("cnv", 12))


def make_arrays(seed=0, n=N):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 3, n).astype(np.float32)
    dat = {m: (rng.normal(size=(n, d)) + 0.8 * cls[:, None]).astype(np.float32)
           for m, d in DIMS}
    return dict(dat=dat, ann={"y": cls, "age": rng.normal(size=n).astype(np.float32)},
                variable_types={"y": "categorical", "age": "numerical"},
                features={m: [f"{m}{i}" for i in range(d)] for m, d in DIMS},
                samples=[f"S{i}" for i in range(n)],
                label_mappings={"y": {0: "a", 1: "b", 2: "c"}})


def cfg(**kw):
    out = {"latent_dim": 8, "hidden_dim_factor": 0.5, "lr": 1e-3,
           "supervisor_hidden_dim": 6, "epochs": 2, "batch_size": 8}
    out.update(kw)
    return out


CLASSES = {"DirectPred": (JaxDirectPred, DirectPred),
           "supervised_vae": (JaxSupervisedVAE, SupervisedVAE)}
TARGETS = ["y", "age"]


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(nn_flax.Dropout, "__call__", lambda self, x, *a, **k: x)


def _no_dropout(model):
    for m in model.module.modules():
        if isinstance(m, (MLP, FusedMLP)):
            m.dropout_rate = 0.0


def pair(name, config, arrays, seed=3):
    """(JAX model, its dataset, port model, its dataset) from the same start
    state (the JAX init, carried across by ``from_flax``), dropout off in the
    port."""
    jcls, pcls = CLASSES[name]
    jds, ds = JaxDataset(**arrays), MultiOmicDataset(**arrays)
    jmodel = jcls(config, jds, target_variables=TARGETS)
    jmodel.init_params(jds, seed)
    model = pcls(config, ds, target_variables=TARGETS, device="cpu")
    model.module.load_state_dict(from_flax(*jax.tree.map(np.asarray, (jmodel.params,
                                                                      jmodel.batch_stats))),
                                 strict=False)
    _no_dropout(model)
    return jmodel, jds, model, ds


def _zero_noise(monkeypatch):
    """eps and prior draws of zeros on both sides (the VAE's z = mean)."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: jnp.zeros(shape, dtype))
    zeros = lambda shape, generator, device: torch.zeros(shape, device=device)  # noqa: E731
    monkeypatch.setattr(stacked_mod, "standard_normal", zeros)


# ------------------------------------------------------------------- masks


@pytest.mark.parametrize("name,fused", [("DirectPred", False), ("DirectPred", True),
                                        ("supervised_vae", False), ("supervised_vae", True),
                                        ("CrossModalPred", False), ("MultiTripletNetwork", False)])
@pytest.mark.parametrize("freeze", range(3))
def test_freeze_masks_match_jax(name, fused, freeze):
    from flexynesis_tpu.models import MODEL_REGISTRY as JAX_REGISTRY

    arrays = make_arrays()
    layers = ({"input_layers": ["gex"], "output_layers": ["cnv"]}
              if name == "CrossModalPred" else {})
    config = cfg(fused_kernels=fused)
    jds, ds = JaxDataset(**arrays), MultiOmicDataset(**arrays)
    jmodel = JAX_REGISTRY[name](config, jds, target_variables=["y"], **layers)
    jmodel.init_params(jds, 0)
    want = jax_finetune._make_mask_fn(jax_finetune.FREEZE_CONFIGS[freeze])(jmodel.params)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): bool(v)
            for path, v in jax.tree_util.tree_leaves_with_path(want)}
    pcls = {"DirectPred": DirectPred, "supervised_vae": SupervisedVAE,
            "CrossModalPred": CrossModalPred, "MultiTripletNetwork": MultiTripletNetwork}[name]
    model = pcls(config, ds, target_variables=["y"], device="cpu", **layers)
    stacked = stacked_model(model, 2)
    masks = finetune.trial_masks(stacked, [finetune.FREEZE_CONFIGS[freeze]] * 2, "cpu")
    got = {"/".join(stacked.flax_paths[n]): bool(m[0].item())
           for n, m in zip(stacked.leaf_names, masks)}
    assert got == want
    assert finetune.FREEZE_CONFIGS == jax_finetune.FREEZE_CONFIGS


# ------------------------------------------------- the grid's bookkeeping


def _capture(monkeypatch, module, calls, out):
    def fake(model, dataset, **kw):
        calls.append(kw)
        return out

    monkeypatch.setattr(module, "vmapped_grid_fit", fake)


@pytest.mark.parametrize("patience", [3, -1])
def test_grid_bookkeeping_matches_jax(patience, monkeypatch):
    arrays = make_arrays()
    jmodel, jds, model, ds = pair("DirectPred", cfg(), arrays)
    T = 45
    rng = np.random.default_rng(5)
    out = {"best_val_loss": rng.random(T), "best_epoch": rng.integers(1, 9, T),
           "epochs_run": 9}
    calls = {"ours": [], "theirs": []}
    _capture(monkeypatch, trials, calls["ours"], out)
    _capture(monkeypatch, jax_trials, calls["theirs"], out)
    ours = finetune.FineTuner(model, ds, max_epochs=9, early_stop_patience=patience)
    theirs = jax_finetune.FineTuner(jmodel, jds, max_epochs=9, early_stop_patience=patience)
    assert ours._grid_parallel(N, 5) == theirs._grid_parallel(N, 5)
    (a,), (b,) = calls["ours"], calls["theirs"]
    for key in ("lrs", "seeds", "train_idx", "val_idx", "batch_size", "max_epochs",
                "early_stop_patience"):
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)
    assert a["train_idx"].shape == (T, 32) and a["batch_size"] == 32
    stacked = stacked_model(model, T)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(m)
            for path, m in jax.tree_util.tree_leaves_with_path(b["masks"])}
    for name, m in zip(stacked.leaf_names, a["masks"]):
        np.testing.assert_array_equal(m.reshape(T).numpy(),
                                      want["/".join(stacked.flax_paths[name])], err_msg=name)
    assert a.get("param_dtype", "float32") == "float32"
    assert a.get("moment_dtype", "bfloat16") == "bfloat16"
    for key in ("start_params", "start_stats"):  # the model's state, broadcast
        assert set(a[key]) >= set(stacked.leaf_names) | set(stacked.buffer_names)


# ----------------------------------------------------- the grid, trained


def _grid(monkeypatch, module, fn):
    """Run ``fn`` with ``module.vmapped_grid_fit`` recording its result."""
    real, seen = module.vmapped_grid_fit, []

    def recording(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(module, "vmapped_grid_fit", recording)
    result = fn()
    monkeypatch.setattr(module, "vmapped_grid_fit", real)
    return result, seen[0]


@pytest.mark.parametrize("name,fused", [("DirectPred", False), ("DirectPred", True),
                                        ("supervised_vae", False), ("supervised_vae", True)])
def test_grid_matches_jax(name, fused, monkeypatch, no_flax_dropout):
    """The grid as the CLI runs it (bfloat16 moments, every bias free) within
    rtol 2e-3 / atol 1e-4: the width is the shift-only biases' noise, shown
    by ``test_grid_matches_jax_with_f32_moments``, which holds those biases
    fixed under float32 moments and agrees within 1e-4."""
    if name == "supervised_vae":
        _zero_noise(monkeypatch)
    arrays = make_arrays()
    jmodel, jds, model, ds = pair(name, cfg(fused_kernels=fused), arrays)
    kw = dict(max_epochs=8, early_stop_patience=3)
    want, j_out = _grid(monkeypatch, jax_trials, lambda: jax_finetune.FineTuner(
        jmodel, jds, **kw)._grid_parallel(N, 5))
    got, p_out = _grid(monkeypatch, trials, lambda: finetune.FineTuner(
        model, ds, **kw)._grid_parallel(N, 5))
    tol = dict(rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(p_out["best_val_loss"], j_out["best_val_loss"], **tol)
    # a best epoch may differ only where two epochs tie within the tolerance:
    # the best losses agree all the same (held above)
    differ = p_out["best_epoch"] != j_out["best_epoch"]
    assert differ.sum() <= 1, (p_out["best_epoch"], j_out["best_epoch"])
    assert p_out["epochs_run"] == j_out["epochs_run"]
    # the chosen cell: JAX's, or one whose JAX mean ties JAX's best within
    # the tolerance
    cells = [(lr, f) for lr in (1e-3, 1e-4, 1e-5) for f in jax_finetune.FREEZE_CONFIGS]
    j_means = j_out["best_val_loss"].reshape(9, 5).mean(axis=1)
    chosen = cells.index((pytest.approx(got[1]), got[2]))
    np.testing.assert_allclose(j_means[chosen], want[0], **tol)
    np.testing.assert_allclose(got[0], want[0], **tol)
    if got[1:3] == want[1:3] and not differ.any():
        assert got[3] == want[3]  # the mean stop epoch


# ---------------------------------------------------- the final fit


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_jax_final_fit_moves_a_frozen_encoder():
    """The departure, on the JAX side: ``optax.masked`` passes a frozen
    leaf's raw gradient through as its update."""
    arrays = make_arrays()
    jmodel, jds, _, _ = pair("DirectPred", cfg(), arrays)
    before = _flat(jmodel.params)
    tuner = jax_finetune.FineTuner(jmodel, jds, max_epochs=2)
    _, params, _, _ = tuner._fit_once(1e-3, jax_finetune.FREEZE_CONFIGS[0], np.arange(N),
                                      None, max_epochs=2)
    after = _flat(params)
    moved = max(float(np.abs(after[k] - before[k]).max()) for k in before
                if k.startswith("encoder"))
    assert moved > 1e-3


@pytest.mark.parametrize("fused", [False, True])
def test_port_final_fit_keeps_frozen_leaves(fused):
    arrays = make_arrays()
    _, _, model, ds = pair("DirectPred", cfg(fused_kernels=fused), arrays)
    before = {n: t.clone() for n, t in model.module.state_dict().items()}
    tuner = finetune.FineTuner(model, ds, max_epochs=2)
    _, state, _ = tuner._fit_once(1e-3, finetune.FREEZE_CONFIGS[0], np.arange(N), None,
                                  max_epochs=2)
    params = dict(model.module.named_parameters())
    for n, t in state.items():
        if n.startswith("encoder") and n in params:
            assert torch.equal(t, before[n]), n  # frozen: bit-identical
    assert any(not torch.equal(state[n], before[n]) for n in state
               if n.startswith("encoder") and n.endswith("running_mean"))
    assert any(not torch.equal(state[n], before[n]) for n in params if n.startswith("head_"))
    assert all(torch.equal(model.module.state_dict()[n], before[n]) for n in before)


def _shift_atol(name: str, steps: int, lr: float) -> float:
    """The biases that only shift a batch-statistics BatchNorm's input step on
    rounding noise (``tests/test_torch_trials.py``): 2 x steps x lr, and the
    running means they shift (1 - 0.9^steps) of that."""
    if (name.endswith(("layer_1.bias", "layer_1_bias")) or name == "fusion_block.bias"
            or (name.startswith("encoder_") and name.endswith("layer_out.bias"))):
        return 2 * steps * lr
    if name.endswith("running_mean"):
        return (1 - (1 - BN_MOMENTUM) ** steps) * 2 * steps * lr
    return 0.0


@pytest.mark.parametrize("fused", [False, True])
def test_final_fit_without_freezing_matches_jax(fused, no_flax_dropout):
    arrays = make_arrays()
    jmodel, jds, model, ds = pair("DirectPred", cfg(fused_kernels=fused), arrays)
    epochs, lr = 3, 1e-3
    rows = np.arange(32)  # one batch of every row per epoch: the order drops out
    with jax.default_matmul_precision("float32"):
        _, params, stats, _ = jax_finetune.FineTuner(jmodel, jds)._fit_once(
            lr, jax_finetune.FREEZE_CONFIGS[2], rows, None, max_epochs=epochs)
    _, state, _ = finetune.FineTuner(model, ds)._fit_once(
        lr, finetune.FREEZE_CONFIGS[2], rows, None, max_epochs=epochs)
    want = from_flax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, stats))
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(state[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 + _shift_atol(name, epochs, lr),
                                   err_msg=name)


# ------------------------------------------------------- kernels' calls


def test_fused_grid_step_calls_each_block_once(monkeypatch):
    """One stacked step of the 45-trial grid: B1 once per block for all
    trials (x per trial: each fold its own rows), one validation B2 once per
    block."""
    arrays = make_arrays()
    _, _, model, ds = pair("DirectPred", cfg(fused_kernels=True), arrays)
    calls = {"b1": [], "b2": []}
    b1, b2 = fused_linear.fused_linear_bn_relu, fused_linear.fused_linear_bn_relu_eval
    monkeypatch.setattr(fused_mlp, "fused_linear_bn_relu",
                        lambda x, *a: calls["b1"].append(tuple(x.shape)) or b1(x, *a))
    monkeypatch.setattr(fused_mlp, "fused_linear_bn_relu_eval",
                        lambda x, *a: calls["b2"].append(tuple(x.shape)) or b2(x, *a))
    real_fit = trials._Round.fit
    monkeypatch.setattr(trials._Round, "fit", lambda self, *a, **kw: real_fit(
        self, *a, **dict(kw, max_epochs=1)))
    finetune.FineTuner(model, ds, max_epochs=1)._grid_parallel(N, 5)
    blocks = len(DIMS) + len(TARGETS)  # two encoders and two heads
    assert len(calls["b1"]) == blocks and len(calls["b2"]) == blocks  # one step, one val
    assert calls["b1"][0] == (45, 32, DIMS[0][1])  # per-trial x
    assert calls["b2"][0] == (45, 8, DIMS[0][1])


# ------------------------------------------------------------ the rest


def test_triplet_fine_tuning_samples_its_own_rows():
    """The port rebuilds the triplet model's anchor tables over the
    fine-tuning samples; JAX keeps the training set's (a departure: its
    anchor indices overrun the fine-tuning set, and its gathers clamp)."""
    from flexynesis_tpu.models.triplet_encoder import MultiTripletNetwork as JaxTriplet

    arrays = make_arrays()
    ds, jds = MultiOmicDataset(**arrays), JaxDataset(**arrays)
    rows = np.arange(14)
    model = MultiTripletNetwork(cfg(), ds, target_variables=["y"], device="cpu")
    model.init_params(0)
    jmodel = JaxTriplet(cfg(), jds, target_variables=["y"])
    jax_finetune.FineTuner(jmodel, jds.subset(rows))
    assert jmodel.n_train_samples(jds.subset(rows)) == N  # the training set's anchors
    tuner = finetune.FineTuner(model, ds.subset(rows), max_epochs=2)
    assert model.n_train_samples(ds.subset(rows)) == len(rows)
    tuned = tuner.run_experiments()
    assert np.isfinite(tuned.predict(ds)["y"]).all()


def test_sequential_grid_runs_and_picks_a_cell():
    arrays = make_arrays()
    _, _, model, ds = pair("DirectPred", cfg(), arrays)
    tuner = finetune.FineTuner(model, ds.subset(np.arange(12)), n_splits=3, max_epochs=3)
    tuned = tuner.run_experiments(parallel=False)
    lr, freeze, epochs = tuner.final_choice
    assert lr in tuner.learning_rates and freeze in finetune.FREEZE_CONFIGS and epochs >= 1
    assert np.isfinite(tuned.predict(ds)["y"]).all()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    path = tmp_path_factory.mktemp("finetune")
    write_synthetic_folder(str(path / "data"), n_train=80, n_test=40,
                           n_features={"gex": 60, "cnv": 30}, n_classes=3, seed=4)
    (path / "hpo.yaml").write_text(
        "DirectPred:\n"
        "  - {type: Categorical, categories: [8], name: latent_dim}\n"
        "  - {type: Categorical, categories: [0.3], name: hidden_dim_factor}\n"
        "  - {type: Categorical, categories: [0.005], name: lr}\n"
        "  - {type: Categorical, categories: [6], name: supervisor_hidden_dim}\n"
        "  - {type: Categorical, categories: [3], name: epochs}\n"
        "  - {type: Categorical, categories: [32], name: batch_size}\n"
        "  - {type: Categorical, categories: [true], name: fused_kernels}\n")
    return path


def test_cli_finetunes_in_training_and_inference(folder, tmp_path, capsys):
    out = tmp_path / "train"
    assert main(["--data_path", str(folder / "data"), "--model_class", "DirectPred",
                 "--data_types", "gex,cnv", "--target_variables", "subtype",
                 "--config_path", str(folder / "hpo.yaml"), "--hpo_iter", "1",
                 "--features_min", "10", "--safetensors", "--disable_marker_finding",
                 "--device", "cpu", "--outdir", str(out), "--prefix", "job",
                 "--finetuning_samples", "20"]) == 0
    log = capsys.readouterr().out
    assert "Fine-tuning on 20 test samples" in log
    assert "9 (lr x freeze) combos x 5 folds = 45 concurrent stacked fits" in log
    assert (out / "job.stats.csv").exists() and (out / "job.artifacts.json").exists()
    inf = tmp_path / "infer"
    assert main(["--pretrained_model", str(out / "job.final_model.safetensors"),
                 "--artifacts", str(out / "job.artifacts.json"),
                 "--data_path_test", str(folder / "data" / "test"),
                 "--disable_marker_finding", "--device", "cpu", "--outdir", str(inf),
                 "--prefix", "inf", "--finetuning_samples", "10"]) == 0
    log = capsys.readouterr().out
    assert "Final fine-tuning with" in log
    assert (inf / "inf.final_model.safetensors").exists()
    assert (inf / "inf.final_model_config.json").exists()
    assert not (inf / "inf.artifacts.json").exists()  # as JAX: weights and config only


# biases whose only effect is a constant shift of a batch-statistics
# BatchNorm's input: each block's Dense before its BatchNorm, and in
# DirectPred the encoders' outputs and the fusion layer, which reach the
# heads' BatchNorms through Dense layers only
SHIFT_ONLY = ("layer_1/bias", "layer_1_bias", "dense_0/bias", "fusion_block/bias")


def _shift_only(path: str) -> bool:
    return path.endswith(SHIFT_ONLY) or (path.startswith("encoder_")
                                         and path.endswith("layer_out/bias"))


@pytest.mark.parametrize("name,fused", [("DirectPred", False), ("DirectPred", True),
                                        ("supervised_vae", False), ("supervised_vae", True)])
def test_grid_matches_jax_with_f32_moments(name, fused, monkeypatch, no_flax_dropout):
    """``test_grid_matches_jax`` with float32 Adam moments on both sides and
    the biases that only shift a batch-statistics BatchNorm's input held at
    their start values on both sides (their update masks zero): the per-trial
    best validation losses agree within rtol/atol 1e-4 and the best epochs
    are equal. With those biases free the gaps stay as wide under float32
    moments as under bfloat16 ones, and scale with lr (DirectPred, unfused:
    up to 1.0e-3 at lr 1e-3, 1.8e-4 at 1e-4, 1.3e-5 at 1e-5): the
    allowance of ``test_grid_matches_jax`` is those biases' rounding-noise
    gradients, which Adam turns into steps of about lr, not the moments'
    dtype."""
    if name == "supervised_vae":
        _zero_noise(monkeypatch)
    names = {}

    def port_fit(*a, _real=trials.vmapped_grid_fit, **kw):
        stacked = stacked_model(a[0], 1)
        kw["masks"] = [m * 0 if _shift_only("/".join(stacked.flax_paths[n])) else m
                       for n, m in zip(stacked.leaf_names, kw["masks"])]
        names["port"] = [n for n in stacked.leaf_names
                         if _shift_only("/".join(stacked.flax_paths[n]))]
        return _real(*a, **{**kw, "moment_dtype": "float32"})

    def jax_fit(*a, _real=jax_trials.vmapped_grid_fit, **kw):
        kw["masks"] = jax.tree_util.tree_map_with_path(
            lambda path, m: m * 0 if _shift_only(
                "/".join(str(getattr(k, "key", k)) for k in path)) else m, kw["masks"])
        return _real(*a, **{**kw, "moment_dtype": "float32"})

    monkeypatch.setattr(trials, "vmapped_grid_fit", port_fit)
    monkeypatch.setattr(jax_trials, "vmapped_grid_fit", jax_fit)
    arrays = make_arrays()
    jmodel, jds, model, ds = pair(name, cfg(fused_kernels=fused), arrays)
    kw = dict(max_epochs=8, early_stop_patience=3)
    _, j_out = _grid(monkeypatch, jax_trials, lambda: jax_finetune.FineTuner(
        jmodel, jds, **kw)._grid_parallel(N, 5))
    _, p_out = _grid(monkeypatch, trials, lambda: finetune.FineTuner(
        model, ds, **kw)._grid_parallel(N, 5))
    assert len(names["port"]) >= 4  # every encoder's and head's hidden bias
    np.testing.assert_allclose(p_out["best_val_loss"], j_out["best_val_loss"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(p_out["best_epoch"], j_out["best_epoch"])
    assert p_out["epochs_run"] == j_out["epochs_run"]
