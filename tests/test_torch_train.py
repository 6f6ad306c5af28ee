"""The port's training half against the JAX package's, on the same numpy
inputs and the same initial weights (carried across by
flexynesis_torch.convert.from_flax):

* MLP and FusedMLP in training mode: outputs and running statistics after a
  step (MLP follows Flax BatchNorm, FusedMLP the unbiased n/(n-1) update);
* DirectPred ``loss_fn``: the per-variable losses, the total and the
  gradients of every parameter, dropout off on both sides (the JAX side's
  ``flax.linen.Dropout`` is patched to the identity, the port's blocks get
  rate 0), with categorical, numerical and survival targets;
* ClippedAdam against optax's clip_by_global_norm + adam on identical
  gradients, clipped and unclipped;
* EarlyStopper, train_val_split and kfold_indices;
* two epochs through both trainers on one permutation table.

Tolerances (f32): forward values rtol=1e-4, atol=1e-5; gradients rtol=1e-4,
atol=1e-5 times the largest gradient of the model; one optimizer step rtol=1e-5, atol=1e-7 (identical inputs);
per-epoch losses after two epochs of Adam rtol=1e-3 (Adam's first steps are
about lr in size whatever the gradient, so f32 rounding differences in tiny
gradients move parameters by up to lr)."""

import flax.linen as nn_flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.models.direct_pred import DirectPred as JaxDirectPred
from flexynesis_tpu.ops.fused_mlp import FusedMLP as JaxFusedMLP
from flexynesis_tpu.ops.mlp import MLP as JaxMLP
from flexynesis_tpu.train import trainer as jax_trainer
from flexynesis_torch.convert import from_flax
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.ops.fused_mlp import FusedMLP
from flexynesis_torch.ops.mlp import MLP
from flexynesis_torch.train import trainer as port_trainer

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(nn_flax.Dropout, "__call__", lambda self, x, *a, **k: x)


def _holder(block):
    m = nn.Module()
    m.add_module("blk", block)
    return m


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,F,hidden,out", [(16, 40, 12, 5), (7, 30, 1, 1)])
def test_block_train_step_matches_jax(fused, B, F, hidden, out):
    rng = np.random.default_rng(B + F + hidden)
    x = (rng.normal(size=(B, F)) * 2 + 0.5).astype(np.float32)
    jax_block = (JaxFusedMLP if fused else JaxMLP)(
        hidden_dim=hidden, output_dim=out, dropout_rate=0.0)
    variables = jax_block.init(jax.random.key(B), jnp.asarray(x), train=False)
    holder = _holder((FusedMLP if fused else MLP)(F, hidden, out, dropout_rate=0.0))
    holder.load_state_dict(from_flax({"blk": variables["params"]},
                                     {"blk": variables["batch_stats"]}))
    holder.train()

    stats = variables["batch_stats"]
    xt = torch.from_numpy(x)
    for step in range(2):  # two steps: the running statistics compound
        y_ref, mut = jax_block.apply(
            {"params": variables["params"], "batch_stats": stats}, jnp.asarray(x),
            train=True, rngs={"dropout": jax.random.key(step)}, mutable=["batch_stats"])
        stats = mut["batch_stats"]
        y = holder.blk(xt, torch.Generator().manual_seed(step))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **TOL)

    blk = holder.blk
    if fused:
        got = (blk.running_mean, blk.running_var)
        want = (stats["mean"], stats["var"])
    else:
        got = (blk.batchnorm.running_mean, blk.batchnorm.running_var)
        want = (stats["batchnorm"]["mean"], stats["batchnorm"]["var"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def make_arrays(seed, n=40, dims=(("gex", 24), ("cnv", 16)), k=3):
    rng = np.random.default_rng(seed)
    dat = {m: rng.normal(size=(n, d)).astype(np.float32) for m, d in dims}
    sub = rng.integers(0, k, n).astype(np.float32)
    sub[[3, 11]] = np.nan
    age = rng.normal(0, 1, n).astype(np.float32)
    age[5] = np.nan
    time = rng.exponential(10, n).astype(np.float32)
    event = (rng.random(n) < 0.6).astype(np.float32)
    return dict(
        dat=dat,
        ann={"subtype": sub, "age": age, "OS_MONTHS": time, "OS_STATUS": event},
        variable_types={"subtype": "categorical", "age": "numerical",
                        "OS_MONTHS": "numerical", "OS_STATUS": "numerical"},
        features={m: [f"{m}{i}" for i in range(d)] for m, d in dims},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {i: f"grp{i}" for i in range(k)}},
    )


def make_pair(fused, arrays, survival=True):
    cfg = {"latent_dim": 8, "hidden_dim_factor": 0.5, "lr": 1e-2,
           "supervisor_hidden_dim": 6, "epochs": 2, "batch_size": 8,
           "fused_kernels": fused}
    kw = dict(target_variables=["subtype", "age"])
    if survival:
        kw.update(surv_event_var="OS_STATUS", surv_time_var="OS_MONTHS")
    jax_ds = JaxDataset(**arrays)
    jax_model = JaxDirectPred(cfg, jax_ds, **kw)
    jax_model.init_params(jax_ds, seed=3)
    ds = MultiOmicDataset(**arrays)
    model = DirectPred(cfg, ds, device="cpu", **kw)
    model.module.load_state_dict(from_flax(jax_model.params, jax_model.batch_stats))
    for m in model.module.modules():
        if isinstance(m, (MLP, FusedMLP)):
            m.dropout_rate = 0.0
    return jax_model, jax_ds, model, ds


def _grads_by_port_name(jax_grads, jax_stats):
    return {k: v for k, v in from_flax(jax_grads, jax_stats).items()
            if "running" not in k and "num_batches" not in k}


@pytest.mark.parametrize("fused", [False, True])
def test_loss_fn_values_and_gradients_match_jax(fused, no_flax_dropout):
    arrays = make_arrays(1)
    jax_model, jax_ds, model, ds = make_pair(fused, arrays)
    idx = np.arange(16)
    jax_batch = jax_model.make_batch(jax_ds, idx)

    def jax_total(params):
        return jax_model.loss_fn(params, jax_model.batch_stats, jax_batch,
                                 jax.random.key(0), True)

    (jax_loss, (jax_losses, _)), jax_grads = jax.jit(jax.value_and_grad(
        jax_total, has_aux=True))(jax_model.params)

    total, losses = model.loss_fn(model.make_batch(ds, idx), torch.Generator(), True)
    params = dict(model.module.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)

    np.testing.assert_allclose(float(total.detach()), float(jax_loss), **TOL)
    assert set(losses) == set(jax_losses) == {"subtype", "age", "OS_STATUS"}
    for var in losses:
        np.testing.assert_allclose(float(losses[var].detach()), float(jax_losses[var]), **TOL)
    want = _grads_by_port_name(jax.tree.map(np.asarray, jax_grads), jax_model.batch_stats)
    assert set(want) == set(params)
    # the bias before a batch-statistics BatchNorm has a zero gradient in exact
    # arithmetic, so both sides hold rounding noise there: atol is normwise,
    # against the largest gradient of the model
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), rtol=1e-4,
                                   atol=1e-5 * max(scale, 1.0), err_msg=name)


def test_one_optimizer_step_matches_optax():
    rng = np.random.default_rng(4)
    shapes = [(5, 3), (3,), (1,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adam(3e-3, b1=0.9, b2=0.999, eps=1e-8))
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    adam = port_trainer.ClippedAdam(tp, lr=3e-3)
    for scale in (0.05, 3.0, 1e-6):  # unclipped, clipped, tiny
        grads = [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
        updates, state = opt.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        adam.step([torch.from_numpy(g) for g in grads])
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-7)


def test_unused_parameters_get_zero_updates():
    p = torch.ones(3)
    adam = port_trainer.ClippedAdam([p], lr=0.1)
    adam.step([None])
    torch.testing.assert_close(p, torch.ones(3))


def test_early_stopper_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.9, 0.91, 0.89, 0.89, 0.95, 0.96, 0.97]
    for patience in (-1, 0, 1, 2, 3):
        a = jax_trainer.EarlyStopper(patience)
        b = port_trainer.EarlyStopper(patience)
        assert [a.update(v) for v in losses] == [b.update(v) for v in losses]


@pytest.mark.parametrize("n,val_size", [(10, 0.2), (37, 0.33), (1, 0.5)])
def test_splits_match_jax(n, val_size):
    for a, b in zip(jax_trainer.train_val_split(n, val_size, seed=7),
                    port_trainer.train_val_split(n, val_size, seed=7)):
        np.testing.assert_array_equal(a, b)
    for (ta, va), (tb, vb) in zip(jax_trainer.kfold_indices(max(n, 5), 5, seed=3),
                                  port_trainer.kfold_indices(max(n, 5), 5, seed=3)):
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("fused", [False, True])
def test_two_epochs_match_jax_trainer(fused, no_flax_dropout):
    arrays = make_arrays(2, n=48)
    jax_model, jax_ds, model, ds = make_pair(fused, arrays, survival=False)
    train_idx, val_idx = np.arange(40), np.arange(40, 48)
    perms = [np.random.default_rng(e).permutation(40)[:40].reshape(5, 8) for e in range(2)]

    jt = jax_trainer.Trainer(jax_model.loss_fn, lr=1e-3)
    jt._build()
    params, stats = jax_model.params, jax_model.batch_stats
    opt_state = jt.optimizer.init(params)
    rng = jax.random.key(0)
    jdata = jax_model.make_batch(jax_ds, train_idx)
    jax_losses = []
    for perm in perms:
        params, opt_state, stats, rng, loss = jt._train_epoch(
            params, opt_state, stats, rng, jnp.asarray(perm), jdata)
        jax_losses.append(float(loss))
    jax_val = float(jt._val_step(params, stats, jax_model.make_batch(jax_ds, val_idx))[0])

    pt = port_trainer.Trainer(model.module, model.loss_fn, lr=1e-3)
    tdata = model.make_batch(ds, train_idx)
    gen = torch.Generator()
    losses = [float(pt.train_epoch(torch.from_numpy(p), tdata, gen)) for p in perms]
    val = float(pt.validate(model.make_batch(ds, val_idx)))

    np.testing.assert_allclose(losses, jax_losses, rtol=1e-3)
    np.testing.assert_allclose(val, jax_val, rtol=1e-3)


def test_fit_keeps_best_state_and_history():
    arrays = make_arrays(5, n=48)
    ds = MultiOmicDataset(**arrays)
    cfg = {"latent_dim": 8, "hidden_dim_factor": 0.5, "supervisor_hidden_dim": 6,
           "fused_kernels": True}
    model = DirectPred(cfg, ds, target_variables=["subtype"], device="cpu")
    res = model.fit(ds, np.arange(40), np.arange(40, 48), lr=1e-2, batch_size=8,
                    max_epochs=6, early_stop_patience=2, seed=1)
    hist = res.history
    assert res.epochs_run == len(hist["train_loss"]) == len(hist["val_loss"])
    assert res.val_loss == min(hist["val_loss"])
    # the model holds the best state: its validation loss is the best one
    trainer = port_trainer.Trainer(model.module, model.loss_fn, lr=1e-2)
    np.testing.assert_allclose(
        float(trainer.validate(model.make_batch(ds, np.arange(40, 48)))),
        res.val_loss, rtol=1e-6)
    assert not model.module.training
