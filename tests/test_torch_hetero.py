"""Mixed-architecture trials of the port (``flexynesis_torch/parallel/hetero.py``)
against ``flexynesis_tpu/parallel/hetero.py``:

* ``directpred_trial_mask`` gives JAX's masks and init scales leaf for leaf
  on the same template tree, and ``build_padded_trials`` gives JAX's stacked
  masks (one tensor per leaf in the JAX flatten order and Flax layout) and
  starts each trial from its own seed's parameters, masked and rescaled;
* the masked padded network computes exactly the small architecture's
  function (as ``tests/test_hetero_trials.py`` holds the JAX one), alone and
  as a trial of a stacked round: rtol 1e-5, atol 1e-6;
* padded entries stay exactly zero through SR-bf16 training;
* ``max_config`` and ``bucket_key`` agree with JAX;
* a ``fused_kernels`` template raises ``NotImplementedError``, where the JAX
  mask builder raises ``KeyError``."""

import jax
import numpy as np
import pytest
import torch

from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.models.direct_pred import DirectPred as JaxDirectPred
from flexynesis_tpu.parallel import hetero as jax_hetero
from flexynesis_torch.convert import from_flax, to_flax
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.parallel import hetero
from flexynesis_torch.parallel.stacked import StackedDirectPred
from flexynesis_torch.parallel.trials import _Round, _val_batch, vmapped_grid_fit


def make_arrays(seed, n=48, gex=40, cnv=20, k=3):
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


CONFIGS = [small_cfg(), small_cfg(latent_dim=32, supervisor_hidden_dim=16, lr=0.005),
           small_cfg(latent_dim=8, hidden_dim_factor=0.5, supervisor_hidden_dim=3, lr=0.02)]
TARGETS = ["subtype", "age"]


@pytest.fixture(scope="module")
def arrays():
    return make_arrays(5)


SEEDS = np.arange(3, 6)


@pytest.fixture(scope="module")
def jax_round(arrays):
    """The JAX package's template at the round's largest dims (its
    parameters are not initialised: ``build_padded_trials`` draws each
    trial's) and its ``build_padded_trials`` of CONFIGS."""
    ds = JaxDataset(**arrays)
    model = JaxDirectPred(hetero.max_config(CONFIGS, [40, 20]), ds, target_variables=TARGETS)
    return model, jax_hetero.build_padded_trials(model, CONFIGS, SEEDS)


def _port(cfg, arrays):
    ds = MultiOmicDataset(**arrays)
    return DirectPred(cfg, ds, target_variables=TARGETS, device="cpu"), ds


def test_max_config_and_bucket_key_match_jax():
    for dims in ([40, 20], [3, 1000]):
        assert hetero.max_config(CONFIGS, dims) == jax_hetero.max_config(CONFIGS, dims)
        for cfg in CONFIGS:
            assert hetero._dims_of(cfg, dims) == jax_hetero._dims_of(cfg, dims)
    for cfg in CONFIGS + [dict(CONFIGS[0], epochs=5), {"epochs": 3}]:
        assert hetero.bucket_key("DirectPred", cfg) == jax_hetero.bucket_key("DirectPred", cfg)
    gnn = {"epochs": 4, "batch_size": 16, "num_convs": 2, "activation": "relu"}
    assert hetero.bucket_key("GNN", gnn) == jax_hetero.bucket_key("GNN", gnn)


def test_trial_masks_and_scales_match_jax(arrays, jax_round):
    port_model, _ = _port(hetero.max_config(CONFIGS, [40, 20]), arrays)
    jax_model, jax_trials = jax_round
    port_tree, _ = to_flax(port_model.module)
    jax_tree = jax.tree.map(lambda a: np.asarray(a[0]), jax_trials["params"])
    assert jax.tree.structure(port_tree) == jax.tree.structure(jax_tree)
    for cfg in CONFIGS:
        got = hetero.directpred_trial_mask(port_tree, cfg, port_model.layers,
                                           port_model.input_dims)
        want = jax_hetero.directpred_trial_mask(jax_tree, cfg, jax_model.layers,
                                                jax_model.input_dims)
        for g, w in zip(got, want):
            assert jax.tree.structure(g) == jax.tree.structure(w)
            for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_build_padded_trials_matches_jax(arrays, jax_round):
    port_model, _ = _port(hetero.max_config(CONFIGS, [40, 20]), arrays)
    seeds = SEEDS
    got = hetero.build_padded_trials(port_model, CONFIGS, seeds)
    want = jax_round[1]
    stacked = StackedDirectPred(port_model, len(CONFIGS))
    want_masks = jax.tree.leaves(want["masks"])
    assert len(got["masks"]) == len(want_masks) == len(stacked.leaf_names)
    for m, w in zip(got["masks"], want_masks):
        np.testing.assert_array_equal(m.numpy(), np.asarray(w))
    # each trial starts from its seed's parameters, masked and rescaled
    tree, _ = to_flax(port_model.module)
    for t, (cfg, seed) in enumerate(zip(CONFIGS, seeds)):
        port_model.init_params(int(seed))
        fresh = {n: p.detach() for n, p in port_model.module.named_parameters()}
        mask_tree, scale_tree = hetero.directpred_trial_mask(tree, cfg, port_model.layers,
                                                             port_model.input_dims)
        for name, m in zip(stacked.leaf_names, got["masks"]):
            scale = float(hetero._leaf(scale_tree, stacked.flax_paths[name]))
            m_port = m[t].mT if stacked.transposed[name] else m[t]
            assert torch.equal(got["params"][name][t], fresh[name] * m_port * scale), name


def _embed(small_state, padded_state, n_mod=2):
    """The small architecture's state in the padded template's layout (Flax
    trees, as ``tests/test_hetero_trials.py`` places them): every leaf in its
    leading corner, the fusion kernel block-wise per modality."""
    small, small_stats = small_state
    big, big_stats = padded_state

    def place(s, t):
        out = np.zeros_like(np.asarray(t))
        out[tuple(slice(0, d) for d in np.shape(s))] = s
        return out

    params = jax.tree.map(place, small, big)
    stats = jax.tree.map(place, small_stats, big_stats)
    k_small = np.asarray(small["fusion_block"]["kernel"])
    k_big = np.asarray(big["fusion_block"]["kernel"])
    L_s, L_m = k_small.shape[1], k_big.shape[1]
    out = np.zeros_like(k_big)
    for m in range(n_mod):
        out[m * L_m: m * L_m + L_s, :L_s] = k_small[m * L_s: (m + 1) * L_s]
    params["fusion_block"]["kernel"] = out
    return params, stats


def test_masked_padded_forward_equals_exact(arrays):
    cfg_small = small_cfg()
    cfg_big = small_cfg(latent_dim=32, hidden_dim_factor=0.5, supervisor_hidden_dim=16)
    exact, ds = _port(cfg_small, arrays)
    exact.init_params(7)
    padded, _ = _port(cfg_big, arrays)
    padded.init_params(7)
    params, stats = _embed(to_flax(exact.module), to_flax(padded.module))
    state = from_flax(params, stats)
    for name, t in padded.module.state_dict().items():
        if name.endswith("running_var"):  # padded units' variance: any positive value
            state[name] = torch.where(state[name] == 0, torch.ones_like(t), state[name])
    padded.module.load_state_dict(state)
    x = exact.make_eval_x(ds)
    want = exact._forward_eval(x)
    got = padded._forward_eval(x)
    for var in TARGETS:
        torch.testing.assert_close(got["outputs"][var], want["outputs"][var],
                                   rtol=1e-5, atol=1e-6)
    assert torch.equal(got["embeddings"][:, 16:], torch.zeros(len(ds), 16))
    # the same trial inside a stacked round of two
    stacked = StackedDirectPred(padded, 2)
    other = {n: t.clone() * 0.5 for n, t in state.items()}
    p, b = stacked.stack([state, other])
    out = stacked.forward(p, b, x, None, False)
    for var in TARGETS:
        torch.testing.assert_close(out["outputs"][var][0], want["outputs"][var],
                                   rtol=1e-5, atol=1e-6)


def test_padded_entries_stay_zero_through_training(arrays):
    template_cfg = hetero.max_config(CONFIGS, [40, 20])
    model, ds = _port(template_cfg, arrays)
    trials = hetero.build_padded_trials(model, CONFIGS, np.arange(3))
    lrs = np.array([c["lr"] for c in CONFIGS], np.float32)
    out = vmapped_grid_fit(
        model, ds, start_params=trials["params"], start_stats=trials["buffers"],
        lrs=lrs, seeds=np.arange(3), train_idx=np.tile(np.arange(36), (3, 1)),
        val_idx=np.tile(np.arange(36, 48), (3, 1)), masks=trials["masks"], batch_size=12,
        max_epochs=3)
    assert np.all(np.isfinite(out["best_val_loss"])) and out["epochs_run"] == 3
    # the engine's own round, kept to read its parameters
    trial_round = _Round(model, dict(trials["params"]), dict(trials["buffers"]), lrs=lrs,
                         seeds=np.arange(3), masks=trials["masks"])
    data = model.make_batch(ds)
    trial_round.fit(data, np.tile(np.arange(36), (3, 1)),
                    _val_batch(data, np.tile(np.arange(36, 48), (3, 1)), model.device),
                    batch_size=12, max_epochs=3, early_stop_patience=-1)
    for name, m in zip(trial_round.stacked.leaf_names, trials["masks"]):
        m_port = m.mT if trial_round.stacked.transposed[name] else m
        p = trial_round.params[name].float()
        assert torch.equal(p * (1 - m_port), torch.zeros_like(p)), name


def test_fused_template_is_refused(arrays):
    cfg = dict(hetero.max_config(CONFIGS, [40, 20]), fused_kernels=True)
    model, _ = _port(cfg, arrays)
    with pytest.raises(NotImplementedError, match="fused_kernels"):
        hetero.build_padded_trials(model, CONFIGS, np.arange(3))
    # the JAX mask builder on the fused tree (the port's tree has the JAX
    # FusedMLP layout, ``convert.to_flax``)
    tree, _ = to_flax(model.module)
    with pytest.raises(KeyError, match="layer_1"):
        jax_hetero.directpred_trial_mask(tree, CONFIGS[0], model.layers, model.input_dims)
