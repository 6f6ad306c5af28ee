"""The K-stacked trial engine for the VAE-MMD classes (supervised_vae and
CrossModalPred) against the JAX package:

* ``ops.losses.masked_mmd_loss`` and ``gaussian_kernel(divisor=)`` equal
  JAX's, alone and with a trial axis (JAX ``vmap``), the prior drawn from
  the same keys: rtol 1e-5, atol 1e-6;
* kernel B3's plain version with a trial axis (``mmd_term_forward`` on CPU
  tensors, the prior shared or per trial) equals K calls of
  ``mmd_term_ref``, and ``MMDTerm``'s batched closed-form backward equals
  autograd through ``compute_mmd``: rtol 1e-5, atol 1e-6 (gradients: atol
  1e-6 times the largest one);
* ``supervised_vae_trial_mask`` gives JAX's masks and init scales leaf for
  leaf for both classes, and ``build_padded_trials`` JAX's stacked masks and
  ``aux``; carried across from JAX's fresh stacked parameters, its masked
  and rescaled parameters equal JAX's (rtol 1e-6, atol 1e-7);
* a padded trial computes its small architecture exactly: eval and
  training forwards, and the masked MMD with ``_aux`` against the small
  model's MMD on the same prior draws (padded columns of the padded prior
  hold other draws): rtol 1e-5, atol 1e-6; padded latents exactly zero;
* the stacked loss of K = 3 trials equals K single-model losses (training
  mode with eps and priors handed out, eval mode with the validation
  prior), the batch shared and per trial: rtol 1e-5, atol 1e-6;
* three stacked training steps equal ``vmap`` of the JAX ``loss_fn`` and
  ``trial_update_step`` (float32 parameters and moments, dropout off, JAX
  matmul precision "float32", eps and priors handed to both sides through
  their normal samplers, lrs 1e-3, 5e-3 and 2e-2 as in
  ``tests/test_torch_trials.py``): a
  same-architecture round, fused and unfused, for both classes, and a padded
  round with element masks and ``_aux``: losses, parameters and running
  statistics within rtol 1e-4 (atol 1e-5), except the biases that only shift
  a batch-statistics BatchNorm's input: their gradient is rounding noise
  that Adam turns into steps of about lr on each side, so the heads'
  ``layer_1`` bias is held within 2 x steps x lr (DirectPred's allowance in
  ``tests/test_torch_trials.py``), a hidden stack's dense bias within 2 x lr
  for each step in which its unit's pre-activations kept one sign over the
  batch (LeakyReLU is linear there; counted per unit in the port's
  forwards, every other unit at 1e-4), and the running means they shift
  within (1 - 0.9^steps) of that. The inputs are
  centred on 0 (N(0, 1) plus a class shift), so a hidden unit's
  pre-activations rarely keep one sign over a batch. Such a bias is a shift
  only while no pre-activation crosses LeakyReLU's kink: with inputs in
  [0, 1], where most units keep one sign, a rounding-noise step of 2e-2 does
  carry some across, and the two trajectories part through no fault of
  either side;
* padded entries stay exactly zero through SR-bf16 training;
* the tuner groups VAE suggestions as JAX does (supervised_vae by
  architecture identity, CrossModalPred padded), and ``--hpo_batch 4`` runs
  a batched round of each class through the CLI on the CPU and writes every
  table."""

import os

import flax.linen as nn_flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.models.crossmodal_pred import CrossModalPred as JaxCrossModalPred
from flexynesis_tpu.models.supervised_vae import SupervisedVAE as JaxSupervisedVAE
from flexynesis_tpu.ops import losses as jax_losses
from flexynesis_tpu.ops.optim import trial_optimizer as jax_trial_optimizer
from flexynesis_tpu.ops.sr_adam import trial_update_step as jax_trial_update_step
from flexynesis_tpu.parallel import hetero as jax_hetero
from flexynesis_tpu.parallel.trials import _init_stacked as jax_init_stacked
from flexynesis_tpu.train.hpo import HyperparameterTuning as JaxTuning
from flexynesis_torch.__main__ import main
from flexynesis_torch.convert import from_flax, to_flax
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.kernels.mmd import MMDTerm, gaussian_kernel_mean, mmd_term_forward, mmd_term_ref
from flexynesis_torch.models import supervised_vae as port_vae
from flexynesis_torch.models.crossmodal_pred import CrossModalPred
from flexynesis_torch.models.supervised_vae import SupervisedVAE
from flexynesis_torch.ops import losses
from flexynesis_torch.ops.mlp import BN_MOMENTUM, MLP, _HiddenStack, linear
from flexynesis_torch.parallel import hetero
from flexynesis_torch.parallel import stacked as stacked_mod
from flexynesis_torch.parallel import trials as trials_mod
from flexynesis_torch.parallel.stacked import StackedSupervisedVAE, TrialNoise, stacked_model
from flexynesis_torch.parallel.trials import _gather, _Round, _val_batch
from flexynesis_torch.train.hpo import HyperparameterTuning
from flexynesis_torch.utils.synthetic import write_synthetic_folder

TOL = dict(rtol=1e-5, atol=1e-6)
TARGETS = ["subtype", "age"]
DIMS = (("gex", 24), ("cnv", 16))


def make_arrays(seed, n=48, k=3):
    rng = np.random.default_rng(seed)
    cls = rng.integers(0, k, n).astype(np.float32)
    dat = {m: (rng.normal(size=(n, d)) + 0.3 * cls[:, None]).astype(np.float32)
           for m, d in DIMS}
    age = rng.normal(size=n).astype(np.float32)
    age[4] = np.nan
    return dict(
        dat=dat, ann={"subtype": cls, "age": age},
        variable_types={"subtype": "categorical", "age": "numerical"},
        features={m: [f"{m}{i}" for i in range(d)] for m, d in DIMS},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {i: f"grp{i}" for i in range(k)}},
    )


# supervised_vae encodes and decodes both layers; CrossModalPred encodes both
# and decodes cnv only (the decoder-subset path of the mask builder)
CASES = {
    "supervised_vae": (JaxSupervisedVAE, SupervisedVAE, {}),
    "crossmodal": (JaxCrossModalPred, CrossModalPred,
                   {"input_layers": ["gex", "cnv"], "output_layers": ["cnv"]}),
}


def cfg(**kw):
    out = {"latent_dim": 8, "hidden_dim_factor": 0.4, "lr": 1e-2,
           "supervisor_hidden_dim": 6, "epochs": 2, "batch_size": 12}
    out.update(kw)
    return out


CONFIGS = [cfg(), cfg(latent_dim=12, supervisor_hidden_dim=9, lr=5e-3),
           cfg(latent_dim=6, hidden_dim_factor=0.6, supervisor_hidden_dim=3, lr=2e-2)]
SEEDS = np.arange(3, 6)


@pytest.fixture(scope="module")
def arrays():
    return make_arrays(5)


def port_model(case, config, arrays):
    _, cls, layers = CASES[case]
    ds = MultiOmicDataset(**arrays)
    return cls(config, ds, target_variables=TARGETS, device="cpu", **layers), ds


def jax_model(case, config, arrays):
    cls, _, layers = CASES[case]
    ds = JaxDataset(**arrays)
    return cls(config, ds, target_variables=TARGETS, **layers), ds


def _no_dropout(model):
    for m in model.module.modules():
        if isinstance(m, MLP):
            m.dropout_rate = 0.0
    return model


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(nn_flax.Dropout, "__call__", lambda self, x, *a, **k: x)


# ------------------------------------------------------------- the losses


def test_gaussian_kernel_divisor_matches_jax():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(9, 5)).astype(np.float32), rng.normal(size=(7, 5)).astype(np.float32)
    for divisor in (None, 9.0):
        want = np.asarray(jax_losses.gaussian_kernel(jnp.asarray(x), jnp.asarray(y),
                                                     divisor=divisor))
        got = losses.gaussian_kernel(torch.from_numpy(x), torch.from_numpy(y), divisor=divisor)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def _mmd_inputs(rng, K=None, B=20, L=16, F=10):
    lead = () if K is None else (K,)
    z = rng.normal(size=lead + (B, L)).astype(np.float32)
    x_hat = rng.uniform(size=lead + (B, F)).astype(np.float32)
    x = rng.uniform(size=lead + (B, F)).astype(np.float32)
    return z, x_hat, x


def test_masked_mmd_loss_matches_jax():
    rng = np.random.default_rng(1)
    z, x_hat, x = _mmd_inputs(rng)
    L, L_t = z.shape[1], 9
    z[:, L_t:] = 0.0
    mask = (np.arange(L) < L_t).astype(np.float32)
    key = jax.random.key(3)
    want = jax_losses.masked_mmd_loss(key, jnp.asarray(z), jnp.asarray(x_hat), jnp.asarray(x),
                                      jnp.asarray(mask), jnp.float32(L_t))
    prior = np.asarray(jax.random.normal(key, (200, L), jnp.float32))
    got = losses.masked_mmd_loss(*(torch.from_numpy(a) for a in (z, x_hat, x, mask)),
                                 torch.tensor(float(L_t)), prior=torch.from_numpy(prior))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    # the padded prior's columns beyond latent_dim leave the loss: the small
    # architecture's mmd_loss on the first L_t columns
    small = losses.mmd_loss(torch.from_numpy(z[:, :L_t]), torch.from_numpy(x_hat),
                            torch.from_numpy(x), prior=torch.from_numpy(prior[:, :L_t]))
    np.testing.assert_allclose(float(got), float(small), **TOL)


@pytest.mark.parametrize("shared_prior", [True, False])
def test_masked_mmd_loss_with_a_trial_axis_matches_jax_vmap(shared_prior):
    rng = np.random.default_rng(2)
    K, L = 3, 16
    z, x_hat, x = _mmd_inputs(rng, K=K, L=L)
    dims = np.array([16, 9, 4], np.float32)
    mask = (np.arange(L)[None, :] < dims[:, None]).astype(np.float32)
    z = z * mask[:, None, :]
    keys = (jnp.stack([jax.random.key(7)] * K) if shared_prior
            else jax.random.split(jax.random.key(7), K))
    want = jax.vmap(jax_losses.masked_mmd_loss)(keys, *(jnp.asarray(a) for a in
                                                        (z, x_hat, x, mask, dims)))
    priors = np.stack([np.asarray(jax.random.normal(k, (200, L), jnp.float32)) for k in keys])
    prior = torch.from_numpy(priors[0] if shared_prior else priors)
    got = losses.masked_mmd_loss(*(torch.from_numpy(a) for a in (z, x_hat, x, mask, dims)),
                                 prior=prior)
    assert got.shape == (K,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shared_prior", [True, False])
def test_plain_b3_with_a_trial_axis_equals_single_calls(shared_prior):
    g = torch.Generator().manual_seed(4)
    K, N, M, d = 3, 30, 17, 6
    x = torch.randn(*(() if shared_prior else (K,)), N, d, generator=g)
    y = torch.randn(K, M, d, generator=g) * 0.5
    before = gaussian_kernel_mean.launches
    out = mmd_term_forward(x, y)
    assert gaussian_kernel_mean.launches == before  # the plain version launches nothing
    assert out.shape == (K, 4)
    for k in range(K):
        torch.testing.assert_close(out[k], mmd_term_ref(x if shared_prior else x[k], y[k]),
                                   **TOL)
    # the batched closed-form backward against autograd through compute_mmd
    grads = []
    for fn in (lambda a, b: MMDTerm.apply(a, b), losses.compute_mmd):
        leaves = [t.clone().requires_grad_() for t in (x, y)]
        w = torch.arange(1.0, K + 1.0)  # a different weight per trial
        (fn(*leaves) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


# ---------------------------------------------------- masks and padded trials


@pytest.fixture(scope="module")
def jax_rounds(arrays):
    """{case: (JAX template at the round's largest dims, its
    build_padded_trials of CONFIGS, its fresh stacked init)}."""
    out = {}
    for case in CASES:
        model, _ = jax_model(case, hetero.max_config(CONFIGS, [24, 16]), arrays)
        out[case] = (model, jax_hetero.build_padded_trials(model, CONFIGS, SEEDS),
                     jax_init_stacked(model, SEEDS))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_trial_masks_and_scales_match_jax(case, arrays, jax_rounds):
    model, _ = port_model(case, hetero.max_config(CONFIGS, [24, 16]), arrays)
    jax_template, jax_trials, _ = jax_rounds[case]
    tree, _ = to_flax(model.module)
    jax_tree = jax.tree.map(lambda a: np.asarray(a[0]), jax_trials["params"])
    assert jax.tree.structure(tree) == jax.tree.structure(jax_tree)
    assert model.layers == jax_template.layers and model.input_dims == jax_template.input_dims
    for c in CONFIGS:
        got = hetero.supervised_vae_trial_mask(tree, c, model.layers, model.input_dims)
        want = jax_hetero.supervised_vae_trial_mask(jax_tree, c, jax_template.layers,
                                                    jax_template.input_dims)
        for g, w in zip(got, want):
            assert jax.tree.structure(g) == jax.tree.structure(w)
            for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert hetero.MASK_BUILDERS[model.model_name] is hetero.supervised_vae_trial_mask


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_padded_trials_matches_jax(case, arrays, jax_rounds, monkeypatch):
    model, _ = port_model(case, hetero.max_config(CONFIGS, [24, 16]), arrays)
    _, want, jax_init = jax_rounds[case]
    # the JAX engine's fresh stacked parameters, carried across
    init = from_flax(*jax.tree.map(np.asarray, jax_init))
    stacked = stacked_model(model, len(CONFIGS))
    monkeypatch.setattr(trials_mod, "_init_stacked", lambda m, seeds, s=None: (
        {n: init[n].clone() for n in stacked.leaf_names},
        {n: init[n].clone() for n in stacked.buffer_names}))
    got = hetero.build_padded_trials(model, CONFIGS, SEEDS)
    want_masks = jax.tree.leaves(want["masks"])
    assert len(got["masks"]) == len(want_masks) == len(stacked.leaf_names)
    for m, w in zip(got["masks"], want_masks):
        np.testing.assert_array_equal(m.numpy(), np.asarray(w))
    want_params = from_flax(jax.tree.map(np.asarray, want["params"]),
                            jax.tree.map(np.asarray, want["batch_stats"]))
    for name, t in {**got["params"], **got["buffers"]}.items():
        np.testing.assert_allclose(t.numpy(), want_params[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for key in ("latent_mask", "latent_dim"):
        np.testing.assert_array_equal(got["aux"][key].numpy(), np.asarray(want["aux"][key]))


def _embed(small_model, padded_model, config):
    """The small model's state in the padded template's layout: every leaf
    in its leading corner, FC_mean and FC_log_var block-wise per encoded
    layer, masked by the small architecture's trial mask; padded running
    variances 1."""
    small, small_stats = to_flax(small_model.module)
    big, big_stats = to_flax(padded_model.module)
    mask, _ = hetero.supervised_vae_trial_mask(big, config, padded_model.layers,
                                               padded_model.input_dims)

    def place(s, t):
        out = np.zeros_like(np.asarray(t))
        out[tuple(slice(0, d) for d in np.shape(s))] = s
        return out

    params = jax.tree.map(lambda s, t, m: place(s, t) * m, small, big, mask)
    L_s, L_m = small["FC_mean"]["kernel"].shape[1], big["FC_mean"]["kernel"].shape[1]
    for key in ("FC_mean", "FC_log_var"):
        out = np.zeros_like(big[key]["kernel"])
        for m in range(len(padded_model.layers)):
            out[m * L_m: m * L_m + L_s, :L_s] = small[key]["kernel"][m * L_s: (m + 1) * L_s]
        params[key]["kernel"] = out
    stats = jax.tree.map(place, small_stats, big_stats)
    state = from_flax(params, stats)
    for name, t in state.items():
        if name.endswith("running_var"):
            state[name] = torch.where(t == 0, torch.ones_like(t), t)
    return state


@pytest.mark.parametrize("case", sorted(CASES))
def test_padded_forward_and_masked_mmd_equal_the_small_model(case, arrays):
    small_cfg, big_cfg = cfg(), cfg(latent_dim=16, hidden_dim_factor=0.6, supervisor_hidden_dim=9)
    exact, ds = port_model(case, small_cfg, arrays)
    exact.init_params(7)
    padded, _ = port_model(case, big_cfg, arrays)
    padded.module.load_state_dict(_embed(exact, padded, small_cfg))
    x = exact.make_eval_x(ds)
    want, got = exact._forward_eval(x), padded._forward_eval(x)
    for group in ("outputs", "x_hat"):
        for k, v in want[group].items():
            torch.testing.assert_close(got[group][k], v, **TOL)
    assert torch.equal(got["embeddings"][:, 8:], torch.zeros(len(ds), 8))
    # the masked MMD with the trial's aux: the small model's MMD on the same
    # prior draws; the padded prior's extra columns hold other draws
    g = torch.Generator().manual_seed(1)
    small_priors = [torch.randn(200, 8, generator=g) for _ in exact.decoded_layers]
    padded_priors = [torch.cat([p, torch.randn(200, 8, generator=g)], dim=1)
                     for p in small_priors]
    batch = exact.make_batch(ds)
    aux = {"latent_mask": (torch.arange(16) < 8).float(), "latent_dim": torch.tensor(8.0)}
    torch.testing.assert_close(padded.mmd_of(got, {**batch, "_aux": aux}, padded_priors),
                               exact.mmd_of(want, batch, small_priors), **TOL)
    # a training-mode forward with the same eps (padded columns: other draws)
    eps = torch.randn(len(ds), 8, generator=g)
    outs = []
    for model, e in ((exact, eps), (padded, torch.cat([eps, torch.randn_like(eps)], dim=1))):
        net = model.module
        buffers = {n: t.clone() for n, t in net.named_buffers()}
        outs.append(net.forward_with(dict(net.named_parameters()), buffers, x, True,
                                     lambda shape, device, e=e: e, lambda h, rate: h))
    for group in ("outputs", "x_hat"):
        for k, v in outs[0][group].items():
            torch.testing.assert_close(outs[1][group][k], v, **TOL)
    # and inside a stacked round of two, in eval mode
    state = padded.module.state_dict()
    stacked = StackedSupervisedVAE(padded, 2)
    params, buffers = stacked.stack([state, {n: t * 0.5 for n, t in state.items()}])
    out = stacked.forward(params, buffers, x)
    for k, v in want["outputs"].items():
        torch.testing.assert_close(out["outputs"][k][0], v, **TOL)


def test_padded_entries_stay_zero_through_training(arrays):
    model, ds = port_model("supervised_vae", hetero.max_config(CONFIGS, [24, 16]), arrays)
    trials = hetero.build_padded_trials(model, CONFIGS, np.arange(3))
    lrs = np.array([c["lr"] for c in CONFIGS], np.float32)
    trial_round = _Round(model, dict(trials["params"]), dict(trials["buffers"]), lrs=lrs,
                         seeds=np.arange(3), masks=trials["masks"], aux=trials["aux"])
    data = model.make_batch(ds)
    out = trial_round.fit(data, np.tile(np.arange(36), (3, 1)),
                          _val_batch(data, np.tile(np.arange(36, 48), (3, 1)), model.device),
                          batch_size=12, max_epochs=3, early_stop_patience=-1)
    assert np.all(np.isfinite(out["best_val_loss"])) and out["epochs_run"] == 3
    for name, m in zip(trial_round.stacked.leaf_names, trials["masks"]):
        m_port = m.mT if trial_round.stacked.transposed[name] else m
        p = trial_round.params[name].float()
        assert torch.equal(p * (1 - m_port), torch.zeros_like(p)), name


# ------------------------------------------------------ the stacked model


class HandedOut:
    """Stands in for a normal sampler: hands out the given arrays in turn,
    checking each one's shape."""

    def __init__(self, arrays, wrap):
        self.arrays, self.wrap, self.i = list(arrays), wrap, 0

    def __call__(self, shape, *args, **kwargs):
        a = self.arrays[self.i]
        assert a.shape == tuple(shape), (a.shape, tuple(shape))
        self.i += 1
        return self.wrap(a)


def _draws(rng, B, L, n_dec, K=None):
    lead = () if K is None else (K,)
    return ([rng.normal(size=lead + (B, L)).astype(np.float32)]
            + [rng.normal(size=lead + (200, L)).astype(np.float32) for _ in range(n_dec)])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("per_trial", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stacked_loss_equals_single_models(case, per_trial, fused, arrays, monkeypatch):
    model, ds = port_model(case, cfg(fused_kernels=fused), arrays)
    _no_dropout(model)
    K, B = 3, 12
    states = []
    for s in (3, 4, 5):
        model.init_params(s)
        states.append({n: t.clone() for n, t in model.module.state_dict().items()})
    stacked = stacked_model(model, K)
    params, buffers = stacked.stack(states)
    rows = [np.arange(B) + (5 * k if per_trial else 0) for k in range(K)]
    data = model.make_batch(ds)
    batch = _gather(data, torch.from_numpy(np.stack(rows) if per_trial else rows[0]))
    n_dec = len(model.decoded_layers)
    draws = _draws(np.random.default_rng(9), B, 8, n_dec, K if per_trial else None)
    monkeypatch.setattr(stacked_mod, "standard_normal",
                        HandedOut(draws, lambda a: torch.from_numpy(a.copy())))
    noise = TrialNoise(torch.Generator().manual_seed(0), range(K) if per_trial else [0] * K)
    # training mode with eps and priors handed out; then eval mode, where
    # both sides draw the validation prior from a generator seeded with 0
    for train in (True, False):
        if not train:
            monkeypatch.undo()
        totals, got = stacked.loss(params, buffers, batch, noise, train)
        assert totals.shape == (K,) and set(got) == {"subtype", "age", "mmd_loss"}
        for k in range(K):
            model.module.load_state_dict(states[k])
            if train:
                mine = [d[k] if per_trial else d for d in draws]
                monkeypatch.setattr(port_vae, "standard_normal",
                                    HandedOut(mine, lambda a: torch.from_numpy(a.copy())))
            want_total, want = model.loss_fn(model.make_batch(ds, rows[k]),
                                             torch.Generator() if train else None, train)
            torch.testing.assert_close(totals[k], want_total, **TOL)
            for name, v in want.items():
                torch.testing.assert_close(got[name][k], v, **TOL)
            if train:  # the running statistics moved as the single model's did
                states[k] = {n: t.clone() for n, t in model.module.state_dict().items()}
                for name in stacked.buffer_names:
                    torch.testing.assert_close(buffers[name][k], states[k][name], **TOL)


def _shift_atol(name: str, steps: int, lr: float, one_sign: dict):
    """The allowance of an entry that only shifts a batch-statistics
    BatchNorm's input: 2 x steps x lr for the heads' layer_1 bias (Linear ->
    BatchNorm); for a hidden stack's dense bias 2 x lr for each step in which
    the unit's pre-activations kept one sign over the batch (there LeakyReLU
    is linear), per unit from ``one_sign`` ({stack: (H,) step counts}); and
    the share of it, (1 - 0.9^steps), of the running means those BatchNorms
    keep. 0 for every other entry."""
    run_share = 1 - (1 - BN_MOMENTUM) ** steps
    stack, sep, _ = name.partition(".hidden_layers.")
    if sep:
        one = 2 * lr * one_sign[stack + ".hidden_layers"].numpy()
        return (one if name.endswith("dense_0.bias")
                else run_share * one if name.endswith("bn_0.running_mean") else 0.0)
    if name.endswith("layer_1.bias"):
        return 2 * steps * lr
    if name.endswith("batchnorm.running_mean"):
        return run_share * 2 * steps * lr
    return 0.0


def _count_one_sign(monkeypatch, model):
    """Counts, per trial and hidden stack of ``model``, the training steps in
    which each unit's first pre-activations (the Linear before LeakyReLU)
    kept one sign over the batch: {stack: (K, H) counts}, filled as the
    stacked forwards run."""
    names = {id(m): n for n, m in model.module.named_modules() if isinstance(m, _HiddenStack)}
    counts = {}
    orig = _HiddenStack.forward_with

    def forward_with(stack, params, buffers, x, train):
        if train and id(stack) in names:
            with torch.no_grad():
                h = linear(x, params["dense_0.weight"], params["dense_0.bias"]) > 0
            name = names[id(stack)]
            counts[name] = counts.get(name, 0) + (h.all(-2) | (~h).all(-2)).int()
        return orig(stack, params, buffers, x, train)

    monkeypatch.setattr(_HiddenStack, "forward_with", forward_with)
    return counts


def _jax_normal(draws):
    it = iter(draws)

    def normal(key, shape=(), dtype=jnp.float32):
        a = next(it)
        assert a.shape == tuple(shape), (a.shape, shape)
        return jnp.asarray(a, dtype)

    return normal


@pytest.mark.parametrize("case,kind", [("supervised_vae", "unfused"), ("supervised_vae", "fused"),
                                       ("crossmodal", "unfused"), ("crossmodal", "fused"),
                                       ("supervised_vae", "padded"), ("crossmodal", "padded")])
def test_stacked_steps_match_jax_vmap(case, kind, arrays, monkeypatch, no_flax_dropout):
    steps, K, B = 3, 3, 12
    padded = kind == "padded"
    config = (hetero.max_config(CONFIGS, [24, 16]) if padded
              else cfg(fused_kernels=kind == "fused"))
    jmodel, jds = jax_model(case, config, arrays)
    if padded:
        trials = jax_hetero.build_padded_trials(jmodel, CONFIGS, SEEDS)
        j_params, j_stats, j_masks = trials["params"], trials["batch_stats"], trials["masks"]
        j_aux = trials["aux"]
    else:
        j_params, j_stats = jax_init_stacked(jmodel, SEEDS)
        j_masks = j_aux = None
    start = jax.tree.map(np.asarray, (j_params, j_stats))
    lrs = np.array([1e-3, 5e-3, 2e-2], np.float32)
    tx = jax_trial_optimizer("float32")
    j_opt = jax.vmap(tx.init)(j_params)
    L = int(config["latent_dim"])
    rng = np.random.default_rng(11)
    row_sets = [np.random.default_rng(s).permutation(48)[:B] for s in range(steps)]
    n_dec = len(CASES[case][2].get("output_layers", [ln for ln, _ in DIMS]))
    draws = [_draws(rng, B, L, n_dec) for _ in range(steps)]

    def one(params, opt_state, stats, lr, key, mask, aux, batch):
        if aux is not None:
            batch = {**batch, "_aux": aux}

        def total(p):
            return jmodel.loss_fn(p, stats, batch, key, True)

        (loss, (_, new_stats)), grads = jax.value_and_grad(total, has_aux=True)(params)
        params, opt_state, _ = jax_trial_update_step(params, opt_state, grads, lr, key,
                                                     sr=False, tx=tx, mask=mask)
        return params, opt_state, new_stats, loss

    keys = jax.vmap(jax.random.key)(jnp.arange(K, dtype=jnp.uint32))
    j_losses = []
    with jax.default_matmul_precision("float32"):
        for rows, d in zip(row_sets, draws):
            monkeypatch.setattr(jax.random, "normal", _jax_normal(d))
            j_params, j_opt, j_stats, loss = jax.vmap(
                one, in_axes=(0, 0, 0, 0, 0, 0 if padded else None, 0 if padded else None,
                              None))(j_params, j_opt, j_stats, jnp.asarray(lrs), keys, j_masks,
                                     j_aux, jmodel.make_batch(jds, rows))
            j_losses.append(np.asarray(loss))
    monkeypatch.undo()

    model, ds = port_model(case, config, arrays)
    _no_dropout(model)
    state = from_flax(*start)
    stacked = stacked_model(model, K)
    params = {n: state[n] for n in stacked.leaf_names}
    buffers = {n: state[n] for n in stacked.buffer_names}
    masks = aux = None
    if padded:
        masks = [torch.from_numpy(np.asarray(m)) for m in jax.tree.leaves(j_masks)]
        aux = {k: torch.from_numpy(np.asarray(v)) for k, v in j_aux.items()}
    # one seed: the noise is drawn once for the trials, as the patched JAX
    # sampler's constants are shared by the vmapped trials
    trial_round = _Round(model, params, buffers, lrs=lrs, seeds=[0] * K, masks=masks, aux=aux,
                         param_dtype="float32")
    one_sign = _count_one_sign(monkeypatch, model)
    data = model.make_batch(ds)
    for rows, d, want in zip(row_sets, draws, j_losses):
        monkeypatch.setattr(stacked_mod, "standard_normal",
                            HandedOut(d, lambda a: torch.from_numpy(a.copy())))
        got = trial_round.step(_gather(data, torch.from_numpy(rows)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    got = {**trial_round.params, **trial_round.buffers}
    want = from_flax(jax.tree.map(np.asarray, j_params), jax.tree.map(np.asarray, j_stats))
    assert len(one_sign) == 2 * len(DIMS) - (case == "crossmodal")  # encoders, decoders
    for name, t in got.items():
        for k in range(K):
            shift = _shift_atol(name, steps, float(lrs[k]),
                                {n: c[k] for n, c in one_sign.items()})
            a, b = t[k].numpy(), want[name][k].numpy()
            far = np.abs(a - b) > 1e-5 + shift + 1e-4 * np.abs(b)  # per unit where shift is
            assert not far.any(), (f"{name}[{k}]: {int(far.sum())} of {a.size} entries beyond "
                                   f"rtol 1e-4, atol 1e-5 + shift, up to "
                                   f"{np.abs(a - b)[far].max():.3e}")


# ----------------------------------------------------- the tuner and the CLI


def test_vae_grouping_follows_jax(arrays):
    base = {"latent_dim": 16, "hidden_dim_factor": 0.3, "lr": 1e-3,
            "supervisor_hidden_dim": 8, "epochs": 5, "batch_size": 32}
    group = [base, dict(base, lr=5e-3), dict(base, latent_dim=32), dict(base, epochs=6)]
    for case in CASES:
        jcls, pcls, layers = CASES[case]
        ours = HyperparameterTuning(MultiOmicDataset(**arrays), pcls, pcls.model_name, TARGETS,
                                    device="cpu", batch_ask=4, **layers)
        theirs = JaxTuning(JaxDataset(**arrays), jcls, jcls.model_name, TARGETS, batch_ask=4,
                           **layers)
        assert ours._bucket_by_architecture(group) == theirs._bucket_by_architecture(group)
    # the class SupervisedVAE is not "supervised_vae" in PADDABLE_MODELS: its
    # suggestions group by identity, CrossModalPred's pad
    assert len(ours._bucket_by_architecture(group)) == 2
    assert len(HyperparameterTuning(MultiOmicDataset(**arrays), SupervisedVAE, "supervised_vae",
                                    TARGETS, device="cpu", batch_ask=4)
               ._bucket_by_architecture(group)) == 3


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("vae_trials")
    write_synthetic_folder(str(root / "data"), n_train=60, n_test=20,
                           n_features={"gex": 30, "cnv": 20}, n_classes=3, seed=4)
    return root


MIXED = """%s:
  - {type: Integer, low: 8, high: 16, name: latent_dim}
  - {type: Real, low: 0.2, high: 0.5, name: hidden_dim_factor}
  - {type: Real, low: 0.0001, high: 0.01, prior: log-uniform, name: lr}
  - {type: Categorical, categories: [4, 8], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [2], name: epochs}
  - {type: Categorical, categories: [16], name: batch_size}
  - {type: Categorical, categories: [%s], name: fused_kernels}
"""


@pytest.mark.parametrize("model_class,extra,log", [
    ("supervised_vae", (), "same-architecture trials concurrently (stacked)"),
    ("CrossModalPred", ("--input_layers", "gex", "--output_layers", "cnv"),
     "mixed-architecture trials concurrently (padded, stacked)"),
])
def test_cli_batched_vae_round_writes_the_tables(model_class, extra, log, folder, tmp_path,
                                                 capsys):
    config = tmp_path / "hpo.yaml"
    text = MIXED % (model_class, "true")
    if model_class == "supervised_vae":  # a fixed architecture: one stacked group
        text = text.replace("{type: Integer, low: 8, high: 16, name: latent_dim}",
                            "{type: Categorical, categories: [8], name: latent_dim}")
        text = text.replace("{type: Real, low: 0.2, high: 0.5, name: hidden_dim_factor}",
                            "{type: Categorical, categories: [0.3], name: hidden_dim_factor}")
        text = text.replace("categories: [4, 8], name: supervisor_hidden_dim",
                            "categories: [8], name: supervisor_hidden_dim")
    config.write_text(text)
    out = tmp_path / "out"
    assert main(["--data_path", str(folder / "data"), "--model_class", model_class,
                 "--data_types", "gex,cnv", "--target_variables", "subtype", "--hpo_iter", "4",
                 "--hpo_batch", "4", "--features_top_percentile", "50", "--features_min", "10",
                 "--safetensors", "--disable_marker_finding", "--device", "cpu",
                 "--config_path", str(config), "--outdir", str(out), "--prefix", "job",
                 *extra]) == 0
    printed = capsys.readouterr().out
    assert f"Training 4 {log}" in printed
    assert "Final full-data training with best params" in printed
    names = ["stats.csv", "predicted_labels.csv", "embeddings_train.csv", "embeddings_test.csv",
             "final_model.safetensors", "final_model_config.json", "artifacts.json"]
    if model_class == "CrossModalPred":
        names.append("cnv_decoded.csv")
    for name in names:
        assert os.path.exists(out / f"job.{name}"), name
