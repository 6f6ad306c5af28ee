"""The port's K-stacked trial engine (``flexynesis_torch/parallel/stacked.py``
and ``parallel/trials.py``):

* the stacked forward and loss of K = 3 trials (a categorical, a numerical
  and a survival head) equal K forwards of the single model (each trial's
  state loaded into it), fused and unfused, in
  training mode (dropout 0; batch statistics and the running-statistics
  update) and in eval mode, with the batch shared by the trials or one per
  trial: rtol 1e-5, atol 1e-6;
* three stacked training steps from a JAX K-stacked parameter tree (carried
  across by ``convert.from_flax``) equal ``vmap`` of the JAX ``loss_fn`` and
  ``trial_update_step`` (float32 parameters and moments, dropout 0, JAX
  matmul precision "float32"; the categorical and numerical heads, the Cox
  loss being held by the case above), fused and unfused: losses, parameters and
  running statistics within rtol 1e-4 (atol 1e-5), except the biases that
  only shift a batch-statistics BatchNorm's input, whose gradient is rounding
  noise that Adam turns into steps of about lr on each side: they are held
  within 2 x steps x lr, and the running means they shift within the
  running average's share of that, (1 - 0.9^steps) x 2 x steps x lr, beyond
  rtol 1e-4 (atol 1e-5);
* ``ParallelTrials.run`` learns, and its lrs tell trials apart (as
  ``tests/test_parallel.py`` holds the JAX engine);
* early stopping waits until every trial has stalled for ``patience``
  epochs, and ``best_epoch`` is at least 1;
* a step given fixed SR seeds uses them in place of the round's draw."""

import flax.linen as nn_flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.models.direct_pred import DirectPred as JaxDirectPred
from flexynesis_tpu.ops.optim import trial_optimizer as jax_trial_optimizer
from flexynesis_tpu.ops.sr_adam import trial_update_step as jax_trial_update_step
from flexynesis_tpu.parallel.trials import _init_stacked as jax_init_stacked
from flexynesis_torch.convert import from_flax
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.ops.fused_mlp import FusedMLP
from flexynesis_torch.ops.mlp import BN_MOMENTUM, MLP
from flexynesis_torch.parallel import trials as trials_mod
from flexynesis_torch.parallel.stacked import StackedDirectPred, TrialNoise
from flexynesis_torch.parallel.trials import ParallelTrials, _Round, equal_kfold_indices
from flexynesis_torch.train.trainer import train_val_split

K = 3
SURV = dict(surv_event_var="OS_STATUS", surv_time_var="OS_MONTHS")


def make_arrays(seed, n=40, dims=(("gex", 24), ("cnv", 16)), k=3, shift=0.0):
    rng = np.random.default_rng(seed)
    sub = rng.integers(0, k, n).astype(np.float32)
    dat = {m: (rng.normal(size=(n, d)) + shift * sub[:, None]).astype(np.float32)
           for m, d in dims}
    age = rng.normal(0, 1, n).astype(np.float32)
    age[5] = np.nan
    sub[[3, 11]] = np.nan
    return dict(
        dat=dat,
        ann={"subtype": sub, "age": age, "OS_MONTHS": rng.exponential(10, n).astype(np.float32),
             "OS_STATUS": (rng.random(n) < 0.6).astype(np.float32)},
        variable_types={"subtype": "categorical", "age": "numerical",
                        "OS_MONTHS": "numerical", "OS_STATUS": "numerical"},
        features={m: [f"{m}{i}" for i in range(d)] for m, d in dims},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {i: f"grp{i}" for i in range(k)}},
    )


def _cfg(fused):
    return {"latent_dim": 8, "hidden_dim_factor": 0.5, "lr": 1e-2,
            "supervisor_hidden_dim": 6, "epochs": 2, "batch_size": 8,
            "fused_kernels": fused}


def _no_dropout(model):
    for m in model.module.modules():
        if isinstance(m, (MLP, FusedMLP)):
            m.dropout_rate = 0.0


def _port_model(fused, arrays, **kw):
    kw = kw or dict(target_variables=["subtype", "age"], **SURV)
    ds = MultiOmicDataset(**arrays)
    return DirectPred(_cfg(fused), ds, device="cpu", **kw), ds


def _trial_states(model, seeds):
    states = []
    for s in seeds:
        model.init_params(s)
        states.append({n: t.clone() for n, t in model.module.state_dict().items()})
    return states


TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("per_trial_x", [False, True])
def test_stacked_forward_and_loss_equal_single_models(fused, per_trial_x):
    arrays = make_arrays(1)
    model, ds = _port_model(fused, arrays)
    _no_dropout(model)
    states = _trial_states(model, [3, 4, 5])
    stacked = StackedDirectPred(model, K)
    params, buffers = stacked.stack(states)
    rows = [np.arange(16) + (4 * k if per_trial_x else 0) for k in range(K)]
    data = model.make_batch(ds)
    if per_trial_x:
        batch = trials_mod._gather(data, torch.from_numpy(np.stack(rows)))
    else:
        batch = trials_mod._gather(data, torch.from_numpy(rows[0]))
    noise = TrialNoise(torch.Generator().manual_seed(0), shared=not per_trial_x)
    for train in (True, False):
        totals, losses = stacked.loss(params, buffers, batch, noise, train)
        assert totals.shape == (K,)
        for k in range(K):
            model.module.load_state_dict(states[k])
            single = model.make_batch(ds, rows[k])
            want_total, want_losses = model.loss_fn(single, torch.Generator(), train)
            torch.testing.assert_close(totals[k], want_total, **TOL)
            for var, loss in want_losses.items():
                torch.testing.assert_close(losses[var][k], loss, **TOL)
            if train:  # the running statistics moved as the single model's did
                states[k] = {n: t.clone() for n, t in model.module.state_dict().items()}
                for name in stacked.buffer_names:
                    torch.testing.assert_close(buffers[name][k], states[k][name], **TOL)
        out = stacked.forward(params, buffers, batch["x"], noise, False)
        for k in range(K):
            model.module.load_state_dict(states[k])
            want = model._forward_eval({n: t[k] if per_trial_x else t
                                        for n, t in batch["x"].items()})
            torch.testing.assert_close(out["embeddings"][k], want["embeddings"], **TOL)


def test_trial_state_round_trips():
    model, _ = _port_model(True, make_arrays(2))
    states = _trial_states(model, [7, 8, 9])
    stacked = StackedDirectPred(model, K)
    params, buffers = stacked.stack(states)
    for k in range(K):
        got = stacked.trial_state(params, buffers, k)
        assert set(got) == set(states[k])
        for name, t in states[k].items():
            assert torch.equal(got[name], t)
    # the leaves in the JAX flatten order, by Flax path
    paths = [stacked.flax_paths[n] for n in stacked.leaf_names]
    assert paths == sorted(paths)


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(nn_flax.Dropout, "__call__", lambda self, x, *a, **k: x)


def _shift_atol(name: str, steps: int, lr: float):
    """The bound on a bias whose only effect is a constant shift of a
    batch-statistics BatchNorm's input (the blocks' layer_1 bias, and through
    the linear fusion and head layer_1 the encoders' output bias and the
    fusion bias), 2 x steps x lr: its gradient is zero in exact arithmetic,
    so both sides step on rounding noise, which Adam scales to about lr per
    step, in directions of its own on each side. A running mean takes the
    running average's share of such a shift, (1 - 0.9^steps) of it. None for
    every other entry."""
    if (name.endswith(("layer_1.bias", "layer_1_bias")) or name == "fusion_block.bias"
            or (name.startswith("encoder_") and name.endswith("layer_out.bias"))):
        return 2 * steps * lr
    if name.endswith("running_mean"):
        return (1 - (1 - BN_MOMENTUM) ** steps) * 2 * steps * lr
    return None


@pytest.mark.parametrize("fused", [False, True])
def test_stacked_steps_match_jax_vmap(fused, no_flax_dropout):
    arrays = make_arrays(3, n=48)
    kw = dict(target_variables=["subtype", "age"])
    jax_ds = JaxDataset(**arrays)
    jax_model = JaxDirectPred(_cfg(fused), jax_ds, **kw)
    j_params, j_stats = jax_init_stacked(jax_model, [3, 4, 5])  # the JAX engine's init
    start_tree = jax.tree.map(np.asarray, (j_params, j_stats))
    lrs = np.array([1e-3, 5e-3, 2e-2], np.float32)
    tx = jax_trial_optimizer("float32")
    j_opt = jax.vmap(tx.init)(j_params)
    batches = [np.random.default_rng(s).permutation(48)[:16] for s in range(3)]

    def one(params, opt_state, stats, lr, rng, batch):
        def total(p):
            return jax_model.loss_fn(p, stats, batch, rng, True)

        (loss, (_, new_stats)), grads = jax.value_and_grad(total, has_aux=True)(params)
        params, opt_state, _ = jax_trial_update_step(params, opt_state, grads, lr, rng,
                                                     sr=False, tx=tx)
        return params, opt_state, new_stats, loss

    step = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, 0, None)))
    rngs = jax.vmap(jax.random.key)(jnp.arange(K, dtype=jnp.uint32))
    j_losses = []
    with jax.default_matmul_precision("float32"):
        for rows in batches:
            j_params, j_opt, j_stats, loss = step(j_params, j_opt, j_stats, jnp.asarray(lrs),
                                                  rngs, jax_model.make_batch(jax_ds, rows))
            j_losses.append(np.asarray(loss))

    model, ds = _port_model(fused, arrays, **kw)
    _no_dropout(model)
    start = from_flax(*jax.tree.map(lambda a: a[0], start_tree))
    stacked_state = from_flax(*start_tree)
    assert all(stacked_state[n].shape == (K, *start[n].shape) for n in start
               if not n.endswith("num_batches_tracked"))
    stacked = StackedDirectPred(model, K)
    params = {n: stacked_state[n] for n in stacked.leaf_names}
    buffers = {n: stacked_state[n] for n in stacked.buffer_names}
    trial_round = _Round(model, params, buffers, lrs=lrs, seeds=[0, 1, 2],
                         param_dtype="float32")
    data = model.make_batch(ds)
    for rows, want in zip(batches, j_losses):
        batch = trials_mod._gather(data, torch.from_numpy(rows))
        with torch.no_grad():
            totals, _ = trial_round.stacked.loss(trial_round.params32(),
                                                 {n: t.clone() for n, t in buffers.items()},
                                                 batch, trial_round.noise, True)
        np.testing.assert_allclose(totals.numpy(), want, rtol=1e-4, atol=1e-5)
        trial_round.step(batch)
    got = {**trial_round.params, **trial_round.buffers}
    want = from_flax(jax.tree.map(np.asarray, j_params), jax.tree.map(np.asarray, j_stats))
    for name, t in got.items():
        for k in range(K):
            shift = _shift_atol(name, len(batches), float(lrs[k])) or 0.0
            np.testing.assert_allclose(t[k].numpy(), want[name][k].numpy(), rtol=1e-4,
                                       atol=1e-5 + shift, err_msg=f"{name}[{k}]")


@pytest.fixture(scope="module")
def learnable():
    arrays = make_arrays(9, n=96, dims=(("gex", 20),), k=2, shift=1.5)
    arrays["ann"]["subtype"][[3, 11]] = 0.0
    ds = MultiOmicDataset(**arrays)
    model = DirectPred({"latent_dim": 8, "hidden_dim_factor": 0.5, "supervisor_hidden_dim": 8},
                       ds, target_variables=["subtype"], device="cpu")
    return model, ds


def test_parallel_trials_learn_and_lr_tells_trials_apart(learnable):
    model, ds = learnable
    tr, va = train_val_split(len(ds), 0.2)
    out = ParallelTrials(model, ds).run(lrs=np.array([1e-2, 1e-6]), seeds=np.array([0, 0]),
                                        train_idx=tr, val_idx=va, batch_size=32,
                                        max_epochs=12)
    assert out["best_val_loss"].shape == (2,) and np.all(np.isfinite(out["best_val_loss"]))
    assert out["best_val_loss"][0] < out["best_val_loss"][1]
    seq = DirectPred(model.config, ds, target_variables=["subtype"], device="cpu")
    res = seq.fit(ds, tr, va, lr=1e-2, batch_size=32, max_epochs=12)
    assert out["best_val_loss"][0] < res.history["val_loss"][0]
    assert out["epochs_run"] == 12 and np.all(out["best_epoch"] >= 1)
    assert set(out["final_params"]) == set(StackedDirectPred(model, 2).leaf_names)


def test_early_stopping_waits_for_every_trial(learnable, monkeypatch):
    model, ds = learnable
    # trial 0 improves at epochs 1-2, trial 1 at epochs 1-6; patience 2
    script = iter([[1.0, 1.0], [0.5, 0.9], [0.6, 0.8], [0.7, 0.7], [0.8, 0.6],
                   [0.9, 0.5], [1.0, 0.6], [1.1, 0.7], [1.2, 0.8]])
    monkeypatch.setattr(_Round, "step", lambda self, batch: None)
    monkeypatch.setattr(_Round, "validate",
                        lambda self, batch: torch.tensor(next(script), dtype=torch.float32))
    tr, va = train_val_split(len(ds), 0.2)
    out = ParallelTrials(model, ds).run(lrs=np.array([1e-3, 1e-3]), seeds=np.array([0, 0]),
                                        train_idx=tr, val_idx=va, batch_size=32,
                                        max_epochs=50, early_stop_patience=2)
    assert out["epochs_run"] == 8  # trial 1's second stalled epoch
    np.testing.assert_array_equal(out["best_epoch"], [2, 6])
    np.testing.assert_allclose(out["best_val_loss"], [0.5, 0.5])


def test_no_improvement_still_reports_epoch_one(learnable, monkeypatch):
    model, ds = learnable
    monkeypatch.setattr(_Round, "step", lambda self, batch: None)
    monkeypatch.setattr(_Round, "validate",
                        lambda self, batch: torch.full((2,), float("nan")))
    tr, va = train_val_split(len(ds), 0.2)
    out = ParallelTrials(model, ds).run(lrs=np.array([1e-3, 1e-3]), seeds=np.array([0, 1]),
                                        train_idx=tr, val_idx=va, batch_size=32,
                                        max_epochs=3, early_stop_patience=2)
    assert out["epochs_run"] == 2
    np.testing.assert_array_equal(out["best_epoch"], [1, 1])


def test_fixed_sr_seeds_replace_the_draw():
    model, ds = _port_model(False, make_arrays(4, n=40, dims=(("gex", 400),)),
                            target_variables=["subtype"])
    _no_dropout(model)
    params, buffers = trials_mod._init_stacked(model, [0, 0])
    batch = trials_mod._gather(model.make_batch(ds), torch.arange(32))

    def stepped(sr_seed, round_seed):
        r = _Round(model, {n: t.clone() for n, t in params.items()},
                   {n: t.clone() for n, t in buffers.items()}, lrs=[1e-2, 1e-3],
                   seeds=[round_seed] * 2)
        r.step(batch, torch.tensor([sr_seed]))
        return r.params

    a, b, c = stepped(5, 0), stepped(5, 1), stepped(6, 0)
    sr_leaves = [n for n, t in a.items() if t.dtype == torch.bfloat16]
    assert sr_leaves  # gex's layer_1 (400 x 200) is stored SR-bf16
    assert all(torch.equal(a[n], b[n]) for n in a)  # the round's own draw is not used
    assert any(not torch.equal(a[n], c[n]) for n in sr_leaves)


def test_equal_kfold_indices_match_jax():
    from flexynesis_tpu.parallel.trials import equal_kfold_indices as jax_folds

    for n, k in ((23, 5), (40, 4)):
        for a, b in zip(equal_kfold_indices(n, k, seed=3), jax_folds(n, k, seed=3)):
            np.testing.assert_array_equal(a, b)
