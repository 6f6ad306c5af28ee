"""The port's VAE-MMD models against the JAX package's, on the same numpy
inputs and the same weights (carried across by flexynesis_torch.convert):

* ``_HiddenStack``, ``Encoder`` and ``Decoder`` in eval mode, and in training
  mode for two steps (outputs and the running statistics, Flax's biased
  update);
* Xavier-uniform initialisation, the law of the JAX initializer;
* ``SupervisedVAENet`` and ``CrossModalPredNet`` in eval mode, every output,
  and the weights carried back exactly;
* ``loss_fn(train=False)``, the validation loss, with the prior drawn in the
  test exactly as JAX ``_extra_losses`` draws it
  (``jax.random.split(jax.random.key(0), n_layers)``, then
  ``jax.random.normal(k, (200, latent))``), fused_kernels on and off;
* ``loss_fn(train=True)`` with the noise handed in: the Flax net draws eps
  through ``make_rng("sample")`` and the losses draw the prior, both through
  ``jax.random.normal``, which the test replaces by a function that hands
  out fixed numpy draws; the port's draws go through ``standard_normal``
  (eps in ``models/supervised_vae.py``, the prior in ``ops/losses.py``),
  replaced the same way; dropout off on both sides. Losses, every gradient and the new running statistics
  are compared;
* the chunked eval forward concatenates every batch-axis output (x_hat too).

Tolerances (f32): forward values rtol 1e-4, atol 1e-5; gradients rtol 1e-4,
atol 1e-5 times the largest gradient of the model (a bias before a
batch-statistics BatchNorm has a zero gradient in exact arithmetic, so both
sides hold rounding noise there)."""

import flax.linen as nn_flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.models.crossmodal_pred import CrossModalPred as JaxCrossModalPred
from flexynesis_tpu.models.supervised_vae import SupervisedVAE as JaxSupervisedVAE
from flexynesis_tpu.ops import mlp as jax_mlp
from flexynesis_torch.convert import from_flax, to_flax
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.models import supervised_vae as port_vae
from flexynesis_torch.models.crossmodal_pred import CrossModalPred
from flexynesis_torch.models.supervised_vae import SupervisedVAE
from flexynesis_torch.ops import losses as port_losses
from flexynesis_torch.ops import mlp

TOL = dict(rtol=1e-4, atol=1e-5)
DIMS = (("gex", 30), ("cnv", 20), ("mut", 12))


def _holder(block):
    m = nn.Module()
    m.add_module("blk", block)
    return m


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for kk, vv in tree.items() for k, v in _flat(vv, f"{prefix}{kk}/").items()}
    return {prefix: np.asarray(tree)}


def _random_stats(rng, stats):
    return jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if np.all(np.asarray(a) == 1) else rng.normal(0, 0.3, a.shape).astype(np.float32),
        stats)


BLOCKS = {
    "hidden_stack": (lambda: jax_mlp._HiddenStack([9]),
                     lambda F: mlp._HiddenStack(F, [9])),
    "encoder": (lambda: jax_mlp.Encoder([9], 5), lambda F: mlp.Encoder(F, [9], 5)),
    "decoder": (lambda: jax_mlp.Decoder([9], 14), lambda F: mlp.Decoder(F, [9], 14)),
    "two_hidden": (lambda: jax_mlp.Encoder([11, 7], 4), lambda F: mlp.Encoder(F, [11, 7], 4)),
}


def _as_list(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_jax_in_eval_mode(kind):
    rng = np.random.default_rng(len(kind))
    x = rng.normal(size=(13, 24)).astype(np.float32)
    jax_block, port_block = BLOCKS[kind]
    flax_block = jax_block()
    variables = flax_block.init(jax.random.key(1), jnp.asarray(x), train=False)
    stats = _random_stats(rng, variables["batch_stats"])
    ref = flax_block.apply({"params": variables["params"], "batch_stats": stats},
                           jnp.asarray(x), train=False)
    holder = _holder(port_block(24))
    holder.load_state_dict(from_flax({"blk": variables["params"]}, {"blk": stats}))
    holder.eval()
    with torch.no_grad():
        out = holder.blk(torch.from_numpy(x))
    for got, want in zip(_as_list(out), _as_list(ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    params, back = to_flax(holder)
    assert _flat(params).keys() == _flat({"blk": variables["params"]}).keys()
    for key, val in _flat(back).items():
        assert np.array_equal(val, _flat({"blk": stats})[key]), key


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_jax_for_two_training_steps(kind):
    rng = np.random.default_rng(10 + len(kind))
    x = (rng.normal(size=(16, 24)) * 2 + 0.3).astype(np.float32)
    jax_block, port_block = BLOCKS[kind]
    flax_block = jax_block()
    variables = flax_block.init(jax.random.key(2), jnp.asarray(x), train=False)
    holder = _holder(port_block(24))
    holder.load_state_dict(from_flax({"blk": variables["params"]},
                                     {"blk": variables["batch_stats"]}))
    holder.train()
    stats = variables["batch_stats"]
    for step in range(2):  # the running statistics compound
        xs = x * (step + 1)
        ref, mut = flax_block.apply({"params": variables["params"], "batch_stats": stats},
                                    jnp.asarray(xs), train=True, mutable=["batch_stats"])
        stats = mut["batch_stats"]
        out = holder.blk(torch.from_numpy(xs))
        for got, want in zip(_as_list(out), _as_list(ref)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _, got_stats = to_flax(holder)
    want_stats = _flat({"blk": stats})
    for key, val in _flat(got_stats).items():
        np.testing.assert_allclose(val, want_stats[key], **TOL, err_msg=key)


def test_xavier_uniform_follows_the_jax_law():
    enc = mlp.Encoder(400, [200], 64)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    w = enc.hidden_layers.dense_0.weight.detach().numpy()
    bound = np.sqrt(6.0 / (400 + 200))
    assert w.shape == (200, 400)
    assert w.max() <= bound and w.min() >= -bound
    np.testing.assert_allclose(w.std(), bound / np.sqrt(3), rtol=0.02)
    flax_w = np.asarray(jax_mlp.xavier_uniform(jax.random.key(0), (400, 200)))
    np.testing.assert_allclose(flax_w.std(), w.std(), rtol=0.02)
    # biases keep torch's default law, U(+-1/sqrt(fan_in))
    b = enc.hidden_layers.dense_0.bias.detach().numpy()
    assert np.abs(b).max() <= 1 / np.sqrt(400)
    again = mlp.Encoder(400, [200], 64)
    again.reset_parameters(torch.Generator().manual_seed(0))
    for a, c in zip(enc.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, c)


def make_arrays(seed, n=40, dims=DIMS, k=3):
    rng = np.random.default_rng(seed)
    dat = {m: rng.uniform(0, 1, size=(n, d)).astype(np.float32) for m, d in dims}
    sub = rng.integers(0, k, n).astype(np.float32)
    sub[[2, 9]] = np.nan
    age = rng.normal(0, 1, n).astype(np.float32)
    return dict(
        dat=dat, ann={"subtype": sub, "age": age},
        variable_types={"subtype": "categorical", "age": "numerical"},
        features={m: [f"{m}{i}" for i in range(d)] for m, d in dims},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {i: f"grp{i}" for i in range(k)}},
    )


CASES = {
    "supervised_vae": (JaxSupervisedVAE, SupervisedVAE, {}),
    "crossmodal": (JaxCrossModalPred, CrossModalPred,
                   {"input_layers": ["gex", "mut"], "output_layers": ["cnv", "gex"]}),
}


def make_pair(case, fused, arrays, seed=3):
    jax_cls, port_cls, layers = CASES[case]
    cfg = {"latent_dim": 6, "hidden_dim_factor": 0.4, "lr": 1e-2,
           "supervisor_hidden_dim": 5, "epochs": 2, "batch_size": 8, "fused_kernels": fused}
    kw = dict(target_variables=["subtype", "age"], **layers)
    jax_ds = JaxDataset(**arrays)
    jax_model = jax_cls(cfg, jax_ds, **kw)
    jax_model.init_params(jax_ds, seed=seed)
    rng = np.random.default_rng(seed)
    jax_model.batch_stats = _random_stats(rng, jax_model.batch_stats)
    ds = MultiOmicDataset(**arrays)
    model = port_cls(cfg, ds, device="cpu", **kw)
    model.module.load_state_dict(from_flax(jax_model.params, jax_model.batch_stats))
    for m in model.module.modules():
        if isinstance(m, mlp.MLP):
            m.dropout_rate = 0.0
    return jax_model, jax_ds, model, ds


@pytest.mark.parametrize("case", sorted(CASES))
def test_net_matches_jax_in_eval_mode(case):
    jax_model, jax_ds, model, ds = make_pair(case, False, make_arrays(1))
    x = jax_model.make_eval_x(jax_ds)
    ref = jax_model.module.apply({"params": jax_model.params,
                                  "batch_stats": jax_model.batch_stats}, x, train=False)
    with torch.no_grad():
        model.module.eval()
        out = model.module(model.make_eval_x(ds))
    for key in ("embeddings", "mean", "log_var"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL, err_msg=key)
    assert set(out["x_hat"]) == set(ref["x_hat"]) == set(model.decoded_layers)
    for group in ("x_hat", "outputs"):
        for k in ref[group]:
            np.testing.assert_allclose(out[group][k].numpy(), np.asarray(ref[group][k]), **TOL)
    assert set(out["log_vars"]) == set(ref["log_vars"]) == {"subtype", "age", "mmd_loss"}
    # the weights carried back are the Flax trees, leaf for leaf
    params, stats = to_flax(model.module)
    for mine, theirs in ((params, jax_model.params), (stats, jax_model.batch_stats)):
        a, b = _flat(mine), _flat(theirs)
        assert a.keys() == b.keys()
        for key in a:
            assert np.array_equal(a[key], b[key]), key


def _jax_validation_priors(n_layers, latent):
    keys = jax.random.split(jax.random.key(0), n_layers)
    return [np.asarray(jax.random.normal(k, (200, latent), jnp.float32)) for k in keys]


class HandedOut:
    """Stands in for a normal sampler: hands out the given arrays in turn,
    checking each one's shape."""

    def __init__(self, arrays, wrap):
        self.arrays, self.wrap, self.i = list(arrays), wrap, 0

    def __call__(self, shape, *args, **kwargs):
        shape = tuple(shape)
        a = self.arrays[self.i]
        assert a.shape == shape, (a.shape, shape)
        self.i += 1
        return self.wrap(a)


def hand_out(monkeypatch, arrays):
    """The port's eps and prior draws become ``arrays``, in turn."""
    fake = HandedOut(arrays, lambda a: torch.from_numpy(a.copy()))
    for module in (port_vae, port_losses):
        monkeypatch.setattr(module, "standard_normal", fake)
    return fake


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_validation_loss_matches_jax(case, fused, monkeypatch):
    jax_model, jax_ds, model, ds = make_pair(case, fused, make_arrays(2))
    idx = np.arange(12, 40)
    total, (losses, _) = jax_model.loss_fn(jax_model.params, jax_model.batch_stats,
                                           jax_model.make_batch(jax_ds, idx), None, False)
    priors = _jax_validation_priors(len(model.decoded_layers), 6)
    hand_out(monkeypatch, priors)
    batch = model.make_batch(ds, idx)
    assert set(batch["x"]) == {"gex", "cnv", "mut"}  # the reconstruction targets too
    with torch.no_grad():
        got_total, got = model.loss_fn(batch, None, False)
    assert set(got) == set(losses) == {"subtype", "age", "mmd_loss"}
    for name in got:
        np.testing.assert_allclose(float(got[name]), float(losses[name]), **TOL, err_msg=name)
    np.testing.assert_allclose(float(got_total), float(total), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_validation_loss_is_the_same_every_epoch(case):
    _, _, model, ds = make_pair(case, True, make_arrays(3))
    batch = model.make_batch(ds, np.arange(20))
    with torch.no_grad():
        first = model.loss_fn(batch, None, False)[1]["mmd_loss"]
        assert float(model.loss_fn(batch, None, False)[1]["mmd_loss"]) == float(first)


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(nn_flax.Dropout, "__call__", lambda self, x, *a, **k: x)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_training_loss_and_gradients_match_jax(case, fused, monkeypatch, no_flax_dropout):
    jax_model, jax_ds, model, ds = make_pair(case, fused, make_arrays(4))
    idx = np.arange(16)
    rng = np.random.default_rng(8)
    n_dec = len(model.decoded_layers)
    draws = [rng.normal(size=(16, 6)).astype(np.float32)] + [
        rng.normal(size=(200, 6)).astype(np.float32) for _ in range(n_dec)]

    jax_batch = jax_model.make_batch(jax_ds, idx)
    monkeypatch.setattr(jax.random, "normal", _jax_normal(draws))

    def jax_total(params):
        return jax_model.loss_fn(params, jax_model.batch_stats, jax_batch, jax.random.key(0), True)

    (jax_loss, (jax_losses, jax_stats)), jax_grads = jax.value_and_grad(
        jax_total, has_aux=True)(jax_model.params)

    hand_out(monkeypatch, draws)
    total, losses = model.loss_fn(model.make_batch(ds, idx), torch.Generator(), True)
    params = dict(model.module.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)

    np.testing.assert_allclose(float(total.detach()), float(jax_loss), **TOL)
    for name in losses:
        np.testing.assert_allclose(float(losses[name].detach()), float(jax_losses[name]),
                                   **TOL, err_msg=name)
    want = {k: v for k, v in from_flax(jax.tree.map(np.asarray, jax_grads),
                                       jax_model.batch_stats).items()
            if "running" not in k and "num_batches" not in k}
    assert set(want) == set(params)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for (name, _), g in zip(params.items(), grads):
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), rtol=1e-4,
                                   atol=1e-5 * max(scale, 1.0), err_msg=name)
    # the running statistics after the step, Flax's biased update
    _, port_stats = to_flax(model.module)
    want_stats = _flat(jax_stats)
    for key, val in _flat(port_stats).items():
        np.testing.assert_allclose(val, want_stats[key], **TOL, err_msg=key)


def _jax_normal(draws):
    """jax.random.normal(key, shape, dtype) handing out ``draws`` in turn."""
    it = iter(draws)

    def normal(key, shape=(), dtype=jnp.float32):
        a = next(it)
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a, dtype)

    return normal


def test_training_latent_needs_a_generator():
    _, _, model, ds = make_pair("supervised_vae", False, make_arrays(5))
    with pytest.raises(ValueError, match="Generator"):
        model.loss_fn(model.make_batch(ds, np.arange(8)), None, True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_is_chunked_like_one_pass(case):
    _, _, model, ds = make_pair(case, True, make_arrays(6, n=23))
    whole = model._forward_eval(model.make_eval_x(ds))
    decoded = model.decode(ds) if case == "crossmodal" else None
    model.EVAL_CHUNK = 5
    chunked = model._forward_eval(model.make_eval_x(ds))
    for key in ("embeddings", "mean", "log_var"):
        torch.testing.assert_close(chunked[key], whole[key], rtol=1e-6, atol=1e-7)
    for group in ("x_hat", "outputs"):
        for k, v in whole[group].items():
            assert chunked[group][k].shape[0] == 23
            torch.testing.assert_close(chunked[group][k], v, rtol=1e-6, atol=1e-7)
    assert chunked["log_vars"]["mmd_loss"].shape == (1,)  # not concatenated
    if decoded is not None:
        for ln, table in model.decode(ds).items():
            assert table.index == decoded[ln].index and table.columns == decoded[ln].columns
            np.testing.assert_allclose(table.values, decoded[ln].values, rtol=1e-6, atol=1e-7)


def test_crossmodal_reads_its_input_layers_and_decodes_its_output_layers():
    _, _, model, ds = make_pair("crossmodal", False, make_arrays(7))
    assert model.layers == ["gex", "mut"] and model.input_dims == [30, 12]
    assert model.decoded_layers == ["cnv", "gex"]
    tables = model.decode(ds)
    assert list(tables) == ["cnv", "gex"]
    assert tables["cnv"].values.shape == (40, 20) and tables["cnv"].columns == ds.features["cnv"]
    assert ((tables["gex"].values > 0) & (tables["gex"].values < 1)).all()
