"""The port's MultiTripletNetwork (flexynesis_torch/models/triplet_encoder.py,
ops/losses.py::triplet_margin_loss, TripletMultiOmicDataset, the stacked
triplet trials) against the JAX package's, on the same numpy inputs and the
same weights (carried across by flexynesis_torch.convert.from_flax):

* ``triplet_margin_loss`` and its gradient, with and without a trial axis,
  against JAX's ``_squared_triplet_loss`` (rtol 1e-5);
* the sampler's tables (label groups padded, the missing-label group last),
  anchors and their groups equal JAX's; ``TripletMultiOmicDataset`` equals
  JAX's, its numpy-seeded triplet table included;
* ``loss_fn`` at the partners JAX's ``key(0)`` draws (the port draws its own
  bits, so the loss is held at given indices): the triplet and supervised
  losses, the total and every gradient against JAX, dropout off on both
  sides (rtol 1e-4; gradients atol 1e-5 times the largest); the eval forward
  and predictions against JAX (rtol 1e-5);
* the sampler's law, over many draws: a positive lies in its anchor's group,
  a negative never does, the missing-label group is a negative, and the
  negative groups are uniform (each within 0.02 of 1 / (groups - 1));
* a stacked round of K = 3 same-seed trials (one per lr; partners and
  dropout drawn once from the shared seed) takes the steps three
  single-model ``Trainer`` steps take (rtol 1e-4, a bias that only shifts a
  batch-statistics BatchNorm within 2 x steps x lr);
* a padded mixed round: masks and init scales equal JAX's on the same
  template tree, and padded entries stay exactly zero through training;
* a first target that is not categorical raises, as in JAX.
"""

import flax.linen as nn_flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.data.dataset import TripletMultiOmicDataset as JaxTripletDataset
from flexynesis_tpu.models.triplet_encoder import MultiTripletNetwork as JaxTriplet
from flexynesis_tpu.models.triplet_encoder import _squared_triplet_loss
from flexynesis_tpu.parallel import hetero as jax_hetero
from flexynesis_torch.convert import from_flax, to_flax
from flexynesis_torch.data.dataset import MultiOmicDataset, TripletMultiOmicDataset
from flexynesis_torch.models.triplet_encoder import MultiTripletNetwork
from flexynesis_torch.ops.losses import triplet_margin_loss
from flexynesis_torch.ops.mlp import MLP
from flexynesis_torch.parallel import hetero
from flexynesis_torch.parallel.stacked import StackedTriplet
from flexynesis_torch.parallel.trials import _gather, _Round, _val_batch
from flexynesis_torch.train.trainer import Trainer

TARGETS = ["subtype", "age"]


def make_arrays(seed=0, n=48, gex=30, cnv=20, k=3):
    rng = np.random.default_rng(seed)
    sub = rng.integers(0, k, n).astype(np.float32)
    dat = {"gex": (rng.normal(size=(n, gex)) + sub[:, None]).astype(np.float32),
           "cnv": rng.normal(size=(n, cnv)).astype(np.float32)}
    sub[[2, 9]] = np.nan
    sub[17] = -1
    return dict(
        dat=dat,
        ann={"subtype": sub, "age": rng.normal(size=n).astype(np.float32)},
        variable_types={"subtype": "categorical", "age": "numerical"},
        features={"gex": [f"g{i}" for i in range(gex)], "cnv": [f"c{i}" for i in range(cnv)]},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {i: f"grp{i}" for i in range(k)}},
    )


def cfg(**kw):
    c = {"latent_dim": 8, "hidden_dim_factor": 0.5, "lr": 1e-2,
         "supervisor_hidden_dim": 6, "epochs": 2, "batch_size": 8}
    c.update(kw)
    return c


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(nn_flax.Dropout, "__call__", lambda self, x, *a, **k: x)


def _no_dropout(model):
    for m in model.module.modules():
        if isinstance(m, MLP):
            m.dropout_rate = 0.0


def make_pair(arrays, config=None):
    jax_ds = JaxDataset(**arrays)
    jax_model = JaxTriplet(config or cfg(), jax_ds, TARGETS)
    jax_model.init_params(jax_ds, seed=3)
    ds = MultiOmicDataset(**arrays)
    model = MultiTripletNetwork(config or cfg(), ds, TARGETS, device="cpu")
    model.module.load_state_dict(from_flax(jax_model.params, jax_model.batch_stats))
    return jax_model, jax_ds, model, ds


@pytest.mark.parametrize("K", [None, 3])
def test_triplet_loss_and_gradient_match_jax(K):
    rng = np.random.default_rng(K or 0)
    shape = (K, 16, 8) if K else (16, 8)
    a, p, n = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    want_fn = jax.vmap(_squared_triplet_loss) if K else _squared_triplet_loss
    want = want_fn(a, p, n)
    want_grads = jax.grad(lambda *t: want_fn(*t).sum(), argnums=(0, 1, 2))(a, p, n)
    ts = [torch.from_numpy(v).requires_grad_() for v in (a, p, n)]
    got = triplet_margin_loss(*ts)
    assert got.shape == ((K,) if K else ())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    for g, w in zip(torch.autograd.grad(got.sum(), ts), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_sampler_tables_and_dataset_match_jax():
    arrays = make_arrays()
    jax_model, jax_ds, model, ds = make_pair(arrays)
    np.testing.assert_array_equal(model._group_table.numpy(), np.asarray(jax_model._group_table))
    np.testing.assert_array_equal(model._group_counts.numpy(),
                                  np.asarray(jax_model._group_counts))
    np.testing.assert_array_equal(model._anchor_indices, jax_model._anchor_indices)
    np.testing.assert_array_equal(model._anchor_groups, jax_model._anchor_groups)
    assert model.n_train_samples(ds) == jax_model.n_train_samples(jax_ds) == 45
    idx = np.array([4, 0, 30])
    got, want = model.make_batch(ds, idx), jax_model.make_batch(jax_ds, idx)
    np.testing.assert_array_equal(got["anchor_idx"].numpy(), np.asarray(want["anchor_idx"]))
    np.testing.assert_array_equal(got["anchor_group"].numpy(),
                                  np.asarray(want["anchor_group"]))
    for v in want["y"]:
        np.testing.assert_array_equal(got["y"][v].numpy(), np.asarray(want["y"][v]))
    pt, jt = TripletMultiOmicDataset(ds, "subtype"), JaxTripletDataset(jax_ds, "subtype")
    assert len(pt) == len(jt)
    assert list(pt.label_groups) == list(jt.label_groups)
    for k in jt.label_groups:
        np.testing.assert_array_equal(pt.label_groups[k], jt.label_groups[k])
    np.testing.assert_array_equal(pt.sample_triplets(5), jt.sample_triplets(5))


def _jax_partners(jax_model, batch, rng):
    """The partner indices JAX's ``loss_fn`` draws from ``rng``."""
    _, r_pos, r_neg, r_grp = jax.random.split(rng, 4)
    agrp = batch["anchor_group"]
    B = agrp.shape[0]
    table, counts = jax_model._group_table, jax_model._group_counts
    pos = table[agrp, jax.random.randint(r_pos, (B,), 0, 1 << 30) % counts[agrp]]
    g_u = jax.random.randint(r_grp, (B,), 0, jax_model._n_groups - 1)
    neg_grp = g_u + (g_u >= agrp)
    neg = table[neg_grp, jax.random.randint(r_neg, (B,), 0, 1 << 30) % counts[neg_grp]]
    return np.array(pos), np.array(neg)


def test_loss_fn_and_eval_match_jax(no_flax_dropout):
    arrays = make_arrays(1)
    jax_model, jax_ds, model, ds = make_pair(arrays)
    _no_dropout(model)
    idx = np.arange(20)
    jbatch = jax_model.make_batch(jax_ds, idx)
    rng = jax.random.key(0)

    def jtotal(params):
        return jax_model.loss_fn(params, jax_model.batch_stats, jbatch, rng, True)

    (jloss, (jlosses, _)), jgrads = jax.value_and_grad(jtotal, has_aux=True)(jax_model.params)
    pos, neg = _jax_partners(jax_model, jbatch, rng)
    total, losses = model.loss_fn(model.make_batch(ds, idx), torch.Generator(), True,
                                  partners=(torch.from_numpy(pos), torch.from_numpy(neg)))
    np.testing.assert_allclose(float(total.detach()), float(jloss), rtol=1e-4)
    assert list(losses) == ["triplet_loss", "subtype", "age"]
    assert set(jlosses) == set(losses)
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()), float(jlosses[k]), rtol=1e-4,
                                   atol=1e-6)
    params = dict(model.module.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()))
    want = {k: v for k, v in from_flax(jax.tree.map(np.asarray, jgrads),
                                       jax_model.batch_stats).items()
            if "running" not in k and "num_batches" not in k}
    assert set(want) == set(params)
    scale = max(float(w.abs().max()) for w in want.values())
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5 * max(scale, 1.0), err_msg=name)
    # eval: embeddings and predictions over every sample (the training-mode
    # forward above updated the port's running statistics in place)
    model.module.load_state_dict(from_flax(jax_model.params, jax_model.batch_stats))
    got, jwant = model.predict(ds), jax_model.predict(jax_ds)
    for v in TARGETS:
        np.testing.assert_allclose(got[v], np.asarray(jwant[v]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(model.transform(ds).values,
                               jax_model.transform(jax_ds).to_numpy(), rtol=1e-5, atol=1e-6)


def test_partner_law():
    arrays = make_arrays(2, n=60)
    ds = MultiOmicDataset(**arrays)
    model = MultiTripletNetwork(cfg(), ds, TARGETS, device="cpu")
    n_groups = model._n_groups  # 3 labels and the missing-label group
    assert n_groups == 4
    labels = arrays["ann"]["subtype"]
    groups = torch.from_numpy(np.repeat(model._anchor_groups, 400))
    pos, neg = model.partners(groups, torch.Generator().manual_seed(1))
    group_of = np.full(len(labels), n_groups - 1)
    group_of[model._anchor_indices] = model._anchor_groups
    g, gp, gn = groups.numpy(), group_of[pos.numpy()], group_of[neg.numpy()]
    assert np.all(gp == g) and np.all(gn != g)
    for a in range(n_groups - 1):
        share = np.bincount(gn[g == a], minlength=n_groups) / np.sum(g == a)
        others = [b for b in range(n_groups) if b != a]
        np.testing.assert_allclose(share[others], 1 / (n_groups - 1), atol=0.02)
    # validation draws (no generator) repeat: a CPU generator seeded with 0
    assert all(torch.equal(a, b) for a, b in zip(model.partners(groups[:30], None),
                                                 model.partners(groups[:30], None)))


def _shift_atol(name: str, steps: int, lr: float) -> float:
    """A bias that only shifts a batch-statistics BatchNorm's input steps on
    rounding noise, about lr per step on each side; its running mean takes
    the running average's share (see tests/test_torch_trials.py)."""
    if (name.endswith("layer_1.bias") or name == "fusion_block.bias"
            or (name.startswith("encoder_") and name.endswith("layer_out.bias"))):
        return 2 * steps * lr
    if name.endswith("running_mean"):
        return (1 - 0.9 ** steps) * 2 * steps * lr
    return 0.0


def test_stacked_same_seed_round_matches_trainer_steps():
    arrays = make_arrays(3, n=60)
    ds = MultiOmicDataset(**arrays)
    model = MultiTripletNetwork(cfg(), ds, TARGETS, device="cpu")
    lrs = np.array([1e-3, 4e-3, 1e-2], np.float32)
    seed, steps = 11, 3
    model.init_params(seed)
    start = {n: t.clone() for n, t in model.module.state_dict().items()}
    stacked = StackedTriplet(model, len(lrs))
    params, buffers = stacked.stack([start] * len(lrs))
    trial_round = _Round(model, params, buffers, lrs=lrs, seeds=[seed] * len(lrs),
                         param_dtype="float32")
    data = model.make_batch(ds)
    rows = [torch.from_numpy(np.random.default_rng(s).permutation(45)[:16]) for s in range(steps)]
    for r in rows:
        trial_round.step(_gather(data, r))
    vloss = trial_round.validate(_val_batch(data, np.tile(np.arange(30, 45), (3, 1)), "cpu"))
    for k, lr in enumerate(lrs):
        model.module.load_state_dict(start)
        trainer = Trainer(model.module, model.loss_fn, lr=float(lr))
        gen = torch.Generator().manual_seed(seed)
        for r in rows:
            trainer.train_step(_gather(data, r), gen)
        want = model.module.state_dict()
        got = trial_round.stacked.trial_state(trial_round.params, trial_round.buffers, k)
        for name, t in got.items():
            if name.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-4,
                                       atol=1e-5 + _shift_atol(name, steps, float(lr)),
                                       err_msg=f"{name}[{k}]")
        # the stacked validation is the single model's on the trial's state
        model.module.load_state_dict(got)
        np.testing.assert_allclose(float(vloss[k]), float(trainer.validate(
            model.make_batch(ds, np.arange(30, 45)))), rtol=1e-5)


CONFIGS = [cfg(latent_dim=16, supervisor_hidden_dim=8),
           cfg(latent_dim=8, hidden_dim_factor=0.3, supervisor_hidden_dim=4, lr=3e-3),
           cfg(latent_dim=12, hidden_dim_factor=0.4, supervisor_hidden_dim=3, lr=2e-2)]


def test_padded_round_masks_match_jax_and_stay_zero():
    arrays = make_arrays(4)
    dims = [30, 20]
    big = hetero.max_config(CONFIGS, dims)
    jax_model = JaxTriplet(big, JaxDataset(**arrays), TARGETS)
    jax_model.init_params(JaxDataset(**arrays), seed=0)
    ds = MultiOmicDataset(**arrays)
    model = MultiTripletNetwork(big, ds, TARGETS, device="cpu")
    assert hetero.MASK_BUILDERS["MultiTripletNetwork"] is hetero.directpred_trial_mask
    tree, _ = to_flax(model.module)
    jtree = jax.tree.map(np.asarray, jax_model.params)
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    for c in CONFIGS:
        got = hetero.directpred_trial_mask(tree, c, model.layers, model.input_dims)
        want = jax_hetero.directpred_trial_mask(jtree, c, jax_model.layers,
                                                jax_model.input_dims)
        for g, w in zip(got, want):
            assert jax.tree.structure(g) == jax.tree.structure(w)
            for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    trials = hetero.build_padded_trials(model, CONFIGS, np.arange(3))
    lrs = np.array([c["lr"] for c in CONFIGS], np.float32)
    trial_round = _Round(model, dict(trials["params"]), dict(trials["buffers"]), lrs=lrs,
                         seeds=np.arange(3), masks=trials["masks"])
    data = model.make_batch(ds)
    out = trial_round.fit(data, np.tile(np.arange(36), (3, 1)),
                          _val_batch(data, np.tile(np.arange(36, 45), (3, 1)), "cpu"),
                          batch_size=12, max_epochs=2, early_stop_patience=-1)
    assert np.all(np.isfinite(out["best_val_loss"]))
    for name, m in zip(trial_round.stacked.leaf_names, trials["masks"]):
        m_port = m.mT if trial_round.stacked.transposed[name] else m
        p = trial_round.params[name].float()
        assert torch.equal(p * (1 - m_port), torch.zeros_like(p)), name


def test_first_target_must_be_categorical():
    arrays = make_arrays()
    with pytest.raises(ValueError, match="categorical"):
        MultiTripletNetwork(cfg(), MultiOmicDataset(**arrays), ["age", "subtype"],
                            device="cpu")
    with pytest.raises(ValueError, match="categorical"):
        JaxTriplet(cfg(), JaxDataset(**arrays), ["age", "subtype"])
