"""The port's device mesh (``flexynesis_torch/parallel/mesh.py``) and its
sharded trial rounds (``parallel/trials.py::_ShardedRound``), against the
JAX package's mesh on its 8 virtual CPU devices (``tests/conftest.py``) and
against the port's own unsharded rounds; a mesh of ``[cpu] * n`` stands in
for n devices:

* the mesh API (axis sizes, -1 inference, a mesh too large, no default
  mesh without a card) and JAX's ``_trial_mesh`` policy cases
  (``tests/test_parallel.py::TestAutoTrialMesh``) on the same 8 devices,
  for the tuner and the fine-tuner;
* ``partition_trials`` identical to JAX's over every case of
  ``tests/test_parallel.py::TestPartitionTrials`` and a grid of sizes;
* a mixed DirectPred round from JAX's padded trials (carried across), one
  full-batch step at lr 1e-5, dropout off, float32 parameters: the port's
  8-shard round equals its unsharded round bit for bit and JAX's round on
  its 8-device trial mesh within atol 1e-4 (JAX's own sharded-against-
  unsharded tolerance for this arm);
* 8-shard rounds equal the unsharded port rounds trial by trial, bit for
  bit, best epochs and epochs run included, over several epochs with
  dropout on: a fresh-initialised ``ParallelTrials`` round (SR-bf16, also
  with int8 moments), the CV fold engine of the tuner (4 suggestions x 5
  folds over a 5-device mesh), mixed supervised_vae (16 trials, two a
  shard: a shard of one VAE trial runs its MMD's products as matrix-vector
  ones and parts in the last bits) and GNN rounds (``aux`` and masks sliced
  per shard) and the fine-tuning grid (45 trials over 5 and 9 devices);
  JAX's own tests hold its sharded rounds only statistically, the port's
  split does not change a trial's arithmetic on the CPU;
* early stopping is one decision over all shards: a round whose shards'
  trials stall at different epochs stops when every trial has stalled,
  sharded as unsharded;
* a checkpointed sharded round resumes bit for bit, and an unsharded round's
  checkpoint resumes into shards (the file is the same)."""

import os

import numpy as np
import pytest
import torch

from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.models.supervised_vae import SupervisedVAE
from flexynesis_torch.parallel import hetero, mesh as mesh_mod, trials
from flexynesis_torch.parallel.distributed import partition_trials
from flexynesis_torch.parallel.mesh import (auto_trial_mesh, get_mesh, replicated,
                                            shard_leading_axis, split_rows, trial_sharding)
from flexynesis_torch.parallel.trials import ParallelTrials, vmapped_grid_fit
from torch_one_thread import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def cpus(n):
    return [CPU] * n


def make_arrays(seed=0, n=64, gex=40, cnv=20, k=3):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, k, n).astype(np.float32)
    return dict(
        dat={"gex": (rng.normal(size=(n, gex)) + cls[:, None]).astype(np.float32),
             "cnv": (rng.normal(size=(n, cnv)) + cls[:, None]).astype(np.float32)},
        ann={"subtype": cls, "age": rng.normal(size=n).astype(np.float32)},
        variable_types={"subtype": "categorical", "age": "numerical"},
        features={"gex": [f"g{i}" for i in range(gex)], "cnv": [f"c{i}" for i in range(cnv)]},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {i: f"grp{i}" for i in range(k)}},
    )


def small_cfg(**kw):
    cfg = {"latent_dim": 16, "hidden_dim_factor": 0.3, "lr": 0.01,
           "supervisor_hidden_dim": 8, "epochs": 10, "batch_size": 16}
    cfg.update(kw)
    return cfg


TARGETS = ["subtype", "age"]


@pytest.fixture(scope="module")
def ds():
    return MultiOmicDataset(**make_arrays())


def assert_same(a: dict, b: dict):
    np.testing.assert_array_equal(a["best_val_loss"], b["best_val_loss"])
    np.testing.assert_array_equal(a["best_epoch"], b["best_epoch"])
    assert a["epochs_run"] == b["epochs_run"]


# ------------------------------------------------------------------ the API


def test_mesh_api():
    m = get_mesh((("trial", -1),), devices=cpus(8))
    assert m.shape == {"trial": 8} and m.size == 8 and m.axis_names == ("trial",)
    m2 = get_mesh((("data", 2), ("model", -1)), devices=cpus(8))
    assert m2.shape == {"data": 2, "model": 4} and len(m2.axis_devices("data")) == 2
    assert get_mesh((("trial", 3),), devices=cpus(8)).size == 3
    with pytest.raises(ValueError, match="needs 9 devices"):
        get_mesh((("trial", 9),), devices=cpus(8))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_mesh()
        assert auto_trial_mesh(8) is None  # no card: no local devices
    assert [(s.start, s.stop) for s in split_rows(10, 3)] == [(0, 4), (4, 7), (7, 10)]
    t = {"a": torch.arange(8.0), "b": [torch.ones(8, 2)]}
    parts = shard_leading_axis(t, trial_sharding(m))
    assert len(parts) == 8 and torch.equal(parts[3]["a"], torch.tensor([3.0]))
    whole = shard_leading_axis(t, replicated(get_mesh((("trial", 2),), devices=cpus(2))))
    assert len(whole) == 2 and torch.equal(whole[1]["a"], t["a"])


def test_auto_trial_mesh_policy_matches_jax():
    import jax

    from flexynesis_tpu.parallel.mesh import auto_trial_mesh as jax_auto

    assert len(jax.local_devices()) == 8
    for n in (8, 40, 16, 7, 4, 45, 1):
        ours = auto_trial_mesh(n, cpus(8))
        assert (ours is None) == (jax_auto(n) is None), n
        assert ours is None or ours.size == 8
    assert auto_trial_mesh(8, cpus(1)) is None  # one device: no mesh


def _tuner(ds, **kw):
    from flexynesis_torch.train.hpo import HyperparameterTuning

    return HyperparameterTuning(ds, DirectPred, "DirectPred", target_variables=["subtype"],
                                n_iter=1, device="cpu", **kw)


def test_trial_mesh_policy_matches_jax(ds, monkeypatch):
    """tests/test_parallel.py:170-181 on 8 devices: 8 and 40 shard, 7 and 4
    do not; an explicit mesh wins where it divides."""
    monkeypatch.setattr(mesh_mod, "local_devices", lambda kind="cuda": cpus(8))
    tuner = _tuner(ds)
    assert tuner._trial_mesh(8) is not None and tuner._trial_mesh(40) is not None
    assert tuner._trial_mesh(7) is None and tuner._trial_mesh(4) is None
    explicit = get_mesh((("trial", 8),), devices=cpus(8))
    tuner = _tuner(ds, mesh=explicit)
    assert tuner._trial_mesh(16) is explicit and tuner._trial_mesh(3) is None


def test_trial_mesh_is_none_on_one_device(ds):
    assert _tuner(ds)._trial_mesh(8) is None  # the CPU is one device


# ------------------------------------------------------------ partition_trials

PARTITION_CASES = [(8, 4), (10, 3), (2, 8), (0, 5), (16, 16), (5, 1), (7, 2)]


@pytest.mark.parametrize("n,hosts", PARTITION_CASES)
def test_partition_trials_matches_jax(n, hosts):
    from flexynesis_tpu.parallel.distributed import partition_trials as jax_partition

    sugg = [{"i": i} for i in range(n)]
    for pi in range(hosts):
        assert partition_trials(sugg, pi, hosts) == jax_partition(sugg, pi, hosts)
    shards = [partition_trials(sugg, pi, hosts) for pi in range(hosts)]
    assert sorted(d["i"] for s in shards for d in s) == list(range(n))
    assert max(map(len, shards)) - min(map(len, shards)) <= 1


def test_partition_trials_edges_match_jax():
    from flexynesis_tpu.parallel.distributed import partition_trials as jax_partition

    with pytest.raises(ValueError):
        partition_trials([{"i": 0}], 5, 4)
    with pytest.raises(ValueError):
        jax_partition([{"i": 0}], 5, 4)
    sugg = [{"i": i} for i in range(3)]
    assert partition_trials(sugg) == jax_partition(sugg) == sugg  # one process
    assert partition_trials([{"i": i} for i in range(8)], 1, 4) == [{"i": 1}, {"i": 5}]


# ------------------------------------------------------------ against JAX


def test_mixed_round_step_matches_jax_mesh(monkeypatch):
    """One full-batch step of a padded DirectPred round of 8 from JAX's
    padded trials, dropout off, float32 parameters with bfloat16 moments:
    port 8-shard == port unsharded (bits), and within atol 1e-4 of JAX's
    round on its 8-device trial mesh."""
    import flax.linen as nn_flax
    import jax

    from flexynesis_torch.convert import from_flax
    from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
    from flexynesis_tpu.models.direct_pred import DirectPred as JaxDirectPred
    from flexynesis_tpu.parallel import hetero as jax_hetero
    from flexynesis_tpu.parallel.mesh import get_mesh as jax_get_mesh
    from flexynesis_tpu.parallel.trials import vmapped_grid_fit as jax_grid_fit

    monkeypatch.setattr(nn_flax.Dropout, "__call__", lambda self, x, *a, **k: x)
    arrays = make_arrays(1)
    configs = [small_cfg(), small_cfg(latent_dim=32, supervisor_hidden_dim=16, lr=0.005)] * 4
    template_cfg = hetero.max_config(configs, [40, 20])
    jds = JaxDataset(**arrays)
    jmodel = JaxDirectPred(template_cfg, jds, target_variables=TARGETS)
    jtrials = jax_hetero.build_padded_trials(jmodel, configs, np.arange(8))
    # lrs of 1e-5: the biases that only shift a BatchNorm's input get
    # rounding-noise gradients, which one Adam step turns into steps of about
    # lr of either sign; at 1e-2 they move the validation loss by 7e-3
    common = dict(lrs=np.full(8, 1e-5, np.float32), seeds=np.arange(8),
                  train_idx=np.tile(np.arange(48), (8, 1)),
                  val_idx=np.tile(np.arange(48, 64), (8, 1)), batch_size=48, max_epochs=1,
                  param_dtype="float32")
    want = jax_grid_fit(jmodel, jds, start_params=jtrials["params"],
                        start_stats=jtrials["batch_stats"], masks=jtrials["masks"],
                        mesh=jax_get_mesh((("trial", 8),)), **common)

    ds = MultiOmicDataset(**arrays)
    model = DirectPred(template_cfg, ds, target_variables=TARGETS, device="cpu")
    for m in model.module.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    state = from_flax(jax.tree.map(np.asarray, jtrials["params"]),
                      jax.tree.map(np.asarray, jtrials["batch_stats"]))
    masks = [torch.from_numpy(np.asarray(w)) for w in jax.tree.leaves(jtrials["masks"])]
    outs = [vmapped_grid_fit(model, ds, start_params=state, start_stats=state, masks=masks,
                             mesh=mesh, **common)
            for mesh in (None, get_mesh((("trial", 8),), devices=cpus(8)))]
    assert_same(outs[1], outs[0])
    np.testing.assert_allclose(outs[1]["best_val_loss"], want["best_val_loss"], atol=1e-4)


# ------------------------------------------------------------ sharded = unsharded


@pytest.mark.parametrize("moments", ["bfloat16", "int8"])
def test_parallel_trials_sharded_equals_unsharded(ds, moments):
    model = DirectPred(small_cfg(), ds, target_variables=TARGETS, device="cpu")
    lrs = np.geomspace(1e-4, 3e-2, 8)
    outs = [ParallelTrials(model, ds, mesh=mesh, moment_dtype=moments).run(
        lrs, np.full(8, 3), train_idx=np.arange(48), val_idx=np.arange(48, 64), batch_size=16,
        max_epochs=5) for mesh in (None, get_mesh((("trial", 8),), devices=cpus(8)),
                                   get_mesh((("trial", 3),), devices=cpus(3)))]
    for out in outs[1:]:
        assert_same(out, outs[0])
        for n, t in outs[0]["final_params"].items():
            assert torch.equal(out["final_params"][n], t), n
    assert len(set(np.round(outs[0]["best_val_loss"], 6))) > 1  # the lrs tell trials apart


def test_early_stop_is_one_decision_over_the_shards(ds):
    """lr 1e-7 trials keep improving by a hair, lr 0.3 trials stall early:
    the round runs until every trial has stalled, sharded as unsharded."""
    model = DirectPred(small_cfg(), ds, target_variables=TARGETS, device="cpu")
    lrs = np.array([0.3, 0.3, 0.3, 0.3, 0.05, 0.05, 0.05, 0.05])
    outs = [ParallelTrials(model, ds, mesh=mesh).run(
        lrs, np.arange(8), train_idx=np.arange(48), val_idx=np.arange(48, 64), batch_size=16,
        max_epochs=40, early_stop_patience=2)
        for mesh in (None, get_mesh((("trial", 2),), devices=cpus(2)))]
    assert_same(outs[1], outs[0])
    out = outs[0]
    stalled_at = out["best_epoch"] + 2
    assert out["epochs_run"] < 40 and out["epochs_run"] == stalled_at.max()
    # the first shard's trials (lr 0.3) stalled before the round stopped
    assert stalled_at[:4].max() < out["epochs_run"] or stalled_at[4:].max() < out["epochs_run"]


def test_cv_engine_sharded_equals_unsharded(ds):
    """4 suggestions x 5 folds = 20 trials over a 5-device mesh (the tuner's
    explicit mesh), against the unsharded program."""
    group = [dict(small_cfg(epochs=3), lr=lr) for lr in np.geomspace(1e-4, 1e-2, 4)]
    sharded = _tuner(ds, use_cv=True, mesh=get_mesh((("trial", 5),), devices=cpus(5)))
    assert sharded._trial_mesh(20) is not None
    plain = _tuner(ds, use_cv=True)
    assert sharded._run_parallel_group_cv(group) == plain._run_parallel_group_cv(group)
    mixed = [dict(g, latent_dim=8 * (i + 1)) for i, g in enumerate(group)]
    assert sharded._run_parallel_group_cv(mixed) == plain._run_parallel_group_cv(mixed)


def test_same_architecture_group_sharded_equals_unsharded(ds):
    group = [dict(small_cfg(epochs=4), lr=lr) for lr in np.geomspace(1e-4, 1e-2, 8)]
    mesh = get_mesh((("trial", 4),), devices=cpus(4))
    sharded, plain = _tuner(ds, mesh=mesh), _tuner(ds)
    assert sharded._run_parallel_group(group) == plain._run_parallel_group(group)
    # the engine is cached per architecture and mesh size
    assert list(sharded._pts) == [(sharded._template_key(group[0]), 4)]


def _mixed_vae(ds):
    # 16 trials, two per shard of 8: a shard of one VAE trial runs its MMD's
    # batched products as matrix-vector ones and parts in the last bits
    configs = [small_cfg(latent_dim=16, lr=0.01),
               small_cfg(latent_dim=32, supervisor_hidden_dim=16, lr=0.005)] * 8
    model = SupervisedVAE(hetero.max_config(configs, [40, 20]), ds, target_variables=TARGETS,
                          device="cpu")
    return model, configs


def test_mixed_vae_round_sharded_equals_unsharded(ds):
    model, configs = _mixed_vae(ds)
    padded = hetero.build_padded_trials(model, configs, np.arange(16))
    assert "aux" in padded
    common = dict(start_params=padded["params"], start_stats=padded["buffers"],
                  masks=padded["masks"], aux=padded["aux"],
                  lrs=np.asarray([c["lr"] for c in configs], np.float32), seeds=np.arange(16),
                  train_idx=np.tile(np.arange(48), (16, 1)),
                  val_idx=np.tile(np.arange(48, 64), (16, 1)), batch_size=16, max_epochs=3,
                  param_dtype="bfloat16_sr")
    outs = [vmapped_grid_fit(model, ds, mesh=mesh, **common)
            for mesh in (None, get_mesh((("trial", 8),), devices=cpus(8)))]
    assert_same(outs[1], outs[0])


def test_mixed_gnn_round_sharded_equals_unsharded():
    from flexynesis_torch.data.dataset import MultiOmicDatasetNW
    from flexynesis_torch.models.gnn import GNN

    rng = np.random.default_rng(2)
    arrays = make_arrays(2, n=40)
    arrays["features"]["cnv"] = [f"g{i}" for i in range(30, 50)]
    arrays["features"]["gex"] = [f"g{i}" for i in range(40)]
    a = list(range(50)) + list(rng.integers(0, 50, 100))
    b = [(i + 1) % 50 for i in range(50)] + list(rng.integers(0, 50, 100))
    ds = MultiOmicDatasetNW(MultiOmicDataset(**arrays),
                            {"protein1": [f"g{i}" for i in a], "protein2": [f"g{i}" for i in b]})
    base = {"latent_dim": 8, "node_embedding_dim": 6, "num_convs": 2, "lr": 1e-2,
            "supervisor_hidden_dim": 6, "epochs": 2, "batch_size": 8}
    configs = [dict(base, node_embedding_dim=4), dict(base, node_embedding_dim=8,
                                                      latent_dim=16, lr=5e-3)] * 4
    model = GNN(hetero.max_config(configs, [0]), ds, TARGETS, device="cpu",
                gnn_conv_type="GC")
    padded = hetero.build_padded_trials(model, configs, np.arange(8))
    common = dict(start_params=padded["params"], start_stats=padded["buffers"],
                  masks=padded["masks"], lrs=np.asarray([c["lr"] for c in configs], np.float32),
                  seeds=np.arange(8), train_idx=np.tile(np.arange(30), (8, 1)),
                  val_idx=np.tile(np.arange(30, 40), (8, 1)), batch_size=10, max_epochs=3,
                  param_dtype="bfloat16_sr")
    outs = [vmapped_grid_fit(model, ds, mesh=mesh, **common)
            for mesh in (None, get_mesh((("trial", 8),), devices=cpus(8)))]
    assert_same(outs[1], outs[0])


@pytest.mark.parametrize("shards", [5, 9])
def test_finetune_grid_sharded_equals_unsharded(ds, shards):
    from flexynesis_torch.train.finetune import FineTuner

    model = DirectPred(small_cfg(), ds, target_variables=TARGETS, device="cpu")
    model.init_params(4)
    start = {n: t.clone() for n, t in model.module.state_dict().items()}
    results = []
    for mesh in (None, get_mesh((("trial", shards),), devices=cpus(shards))):
        model.module.load_state_dict(start)
        tuner = FineTuner(model, ds, max_epochs=3, mesh=mesh)
        results.append(tuner._grid_parallel(len(ds), 5))
    assert results[1] == results[0]


def test_finetune_grid_takes_the_local_devices(ds, monkeypatch):
    """The fine-tuner's default policy (JAX's auto_trial_mesh): 45 trials
    split over 9 local devices, not over 8."""
    from flexynesis_torch.train.finetune import FineTuner

    seen = []
    real = trials.vmapped_grid_fit

    def spy(*a, **kw):
        seen.append(kw.get("mesh"))
        return real(*a, **kw)

    monkeypatch.setattr(trials, "vmapped_grid_fit", spy)
    model = DirectPred(small_cfg(), ds, target_variables=TARGETS, device="cpu")
    for n_dev, sharded in ((9, True), (8, False)):
        monkeypatch.setattr(mesh_mod, "local_devices", lambda kind="cuda", n=n_dev: cpus(n))
        FineTuner(model, ds, max_epochs=1)._grid_parallel(len(ds), 5)
        assert (seen[-1] is not None) == sharded


# ------------------------------------------------------------ checkpoints


def _round(ds, mesh, ckpt=None, die_after=None, monkeypatch=None):
    model = DirectPred(small_cfg(), ds, target_variables=["subtype"], device="cpu")
    if die_after is not None:
        real, seen = trials._Round.validate, {"n": 0}

        def dying(self, batch):
            seen["n"] += 1
            if seen["n"] > die_after:
                raise KeyboardInterrupt("simulated preemption")
            return real(self, batch)

        monkeypatch.setattr(trials._Round, "validate", dying)
    try:
        return ParallelTrials(model, ds, mesh=mesh).run(
            lrs=np.geomspace(1e-3, 1e-2, 4), seeds=np.arange(4), train_idx=np.arange(48),
            val_idx=np.arange(48, 64), batch_size=16, max_epochs=8, epochs_per_eval=3,
            checkpoint_dir=ckpt)
    finally:
        if monkeypatch is not None:
            monkeypatch.undo()


@pytest.mark.parametrize("writer", ["sharded", "unsharded"])
def test_checkpointed_sharded_round_resumes_bit_for_bit(ds, tmp_path, capsys, monkeypatch,
                                                        writer):
    mesh = get_mesh((("trial", 2),), devices=cpus(2))
    full = _round(ds, None)
    ckpt = str(tmp_path / "round")
    with pytest.raises(KeyboardInterrupt):  # dies in epoch 7 of 8
        if writer == "sharded":  # two shards validate per epoch
            _round(ds, mesh, ckpt, die_after=12, monkeypatch=monkeypatch)
        else:
            _round(ds, None, ckpt, die_after=6, monkeypatch=monkeypatch)
    assert os.path.exists(os.path.join(ckpt, "round.safetensors"))
    resumed = _round(ds, mesh, ckpt)
    assert "Resumed trial round from epoch 6" in capsys.readouterr().out
    assert_same(resumed, full)
    for n, t in full["final_params"].items():
        assert torch.equal(resumed["final_params"][n], t), n
    assert not os.path.exists(os.path.join(ckpt, "round.safetensors"))
