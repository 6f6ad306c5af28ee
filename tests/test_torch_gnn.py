"""The port's GNN (flexynesis_torch/models/gnn.py, its stacked trials and
padded rounds, its saved files) against the JAX package's, on the same numpy
inputs and the same weights (carried across by convert.from_flax), over a
node tensor of two layers that share gene names and a ring-plus-random graph:

* ``gnn_sparse``: true, false and "auto" (strings case-insensitive) pick the
  dense or edge-list operator as JAX does, "auto" by SPARSE_NODE_THRESHOLD;
  anything else raises;
* ``loss_fn`` (training mode, dropout off on both sides) for the four conv
  types, dense and sparse: the loss and every gradient against JAX (rtol
  1e-4; gradients atol 1e-5 times the largest), then the eval predictions and
  embeddings against JAX (rtol 1e-4, atol 1e-5);
* marker finding: IntegratedGradients' per-node importances split back per
  omic layer equal JAX's table (rtol 1e-4, atol 1e-6);
* a GNN and a triplet model saved by either package load in the other, and
  the predictions agree (rtol 1e-5, atol 1e-6);
* a stacked round of K = 3 same-seed trials (dense and sparse; the operator
  broadcast to every trial) takes the steps three ``Trainer`` steps take
  (rtol 1e-4; a bias that only shifts a batch-statistics BatchNorm within
  2 x steps x lr);
* ``gnn_trial_mask``'s masks and init scales equal JAX's on the same
  template tree (four conv types, both readouts), ``bucket_key`` equals
  JAX's, a padded GNN trial computes its small model's function (alone and
  inside a stacked round; rtol 1e-5, atol 1e-6) and padded entries stay
  exactly zero through a padded round.
"""

import flax.linen as nn_flax
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from flexynesis_tpu import inference as jax_inference
from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.data.dataset import MultiOmicDatasetNW as JaxNW
from flexynesis_tpu.models.gnn import GNN as JaxGNN
from flexynesis_tpu.models.triplet_encoder import MultiTripletNetwork as JaxTriplet
from flexynesis_tpu.parallel import hetero as jax_hetero
from flexynesis_torch import inference
from flexynesis_torch.convert import from_flax, to_flax
from flexynesis_torch.data.dataset import MultiOmicDataset, MultiOmicDatasetNW
from flexynesis_torch.models import gnn as gnn_mod
from flexynesis_torch.models.gnn import GNN
from flexynesis_torch.models.triplet_encoder import MultiTripletNetwork
from flexynesis_torch.ops.graph_conv import FlexGCN
from flexynesis_torch.ops.mlp import MLP
from flexynesis_torch.parallel import hetero
from flexynesis_torch.parallel.stacked import StackedGNN
from flexynesis_torch.parallel.trials import _gather, _Round, _val_batch
from flexynesis_torch.train.trainer import Trainer

CONV_TYPES = ["GCN", "SAGE", "GC", "GAT"]
TARGETS = ["subtype", "age"]


def make_arrays(seed=0, n=40, k=3):
    """gex over g0..g29 and cnv over g20..g44: shared gene names."""
    rng = np.random.default_rng(seed)
    sub = rng.integers(0, k, n).astype(np.float32)
    gex = (rng.normal(size=(n, 30)) + sub[:, None]).astype(np.float32)
    cnv = rng.normal(size=(n, 25)).astype(np.float32)
    gex[rng.random(gex.shape) < 0.05] = np.nan
    sub[3] = np.nan
    return dict(
        dat={"gex": gex, "cnv": cnv},
        ann={"subtype": sub, "age": rng.normal(size=n).astype(np.float32)},
        variable_types={"subtype": "categorical", "age": "numerical"},
        features={"gex": [f"g{i}" for i in range(30)],
                  "cnv": [f"g{i}" for i in range(20, 45)]},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {i: f"grp{i}" for i in range(k)}},
    )


def make_graph(seed=0, n_genes=50):
    rng = np.random.default_rng(seed)
    a = list(range(n_genes)) + list(rng.integers(0, n_genes, 2 * n_genes))
    b = [(i + 1) % n_genes for i in range(n_genes)] + list(rng.integers(0, n_genes, 2 * n_genes))
    return {"protein1": [f"g{i}" for i in a], "protein2": [f"g{i}" for i in b]}


def cfg(**kw):
    c = {"latent_dim": 8, "node_embedding_dim": 6, "num_convs": 2, "lr": 1e-2,
         "supervisor_hidden_dim": 6, "epochs": 2, "batch_size": 8}
    c.update(kw)
    return c


def datasets(seed=0):
    arrays, graph = make_arrays(seed), make_graph(seed)
    return (JaxNW(JaxDataset(**arrays), pd.DataFrame(graph)),
            MultiOmicDatasetNW(MultiOmicDataset(**arrays), graph))


def make_pair(conv, config, seed=0):
    jax_ds, ds = datasets(seed)
    jax_model = JaxGNN(config, jax_ds, TARGETS, gnn_conv_type=conv)
    jax_model.init_params(jax_ds, seed=3)
    model = GNN(config, ds, TARGETS, device="cpu", gnn_conv_type=conv)
    model.module.load_state_dict(from_flax(jax_model.params, jax_model.batch_stats))
    return jax_model, jax_ds, model, ds


@pytest.fixture
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(nn_flax.Dropout, "__call__", lambda self, x, *a, **k: x)


def _no_dropout(model):
    for m in model.module.modules():
        if isinstance(m, (MLP, FlexGCN)):
            m.dropout_rate = 0.0


def test_sparse_choice_and_auto_threshold(monkeypatch):
    _, ds = datasets()

    def adj(value):
        return GNN(cfg(gnn_sparse=value), ds, TARGETS, device="cpu")._adj

    assert isinstance(adj("auto"), torch.Tensor) and isinstance(adj(False), torch.Tensor)
    assert isinstance(adj("false"), torch.Tensor) and isinstance(adj("AUTO"), torch.Tensor)
    assert isinstance(adj(True), dict) and isinstance(adj(" True "), dict)
    for bad in ("yes", 1, None):
        with pytest.raises(ValueError, match="gnn_sparse"):
            adj(bad)
    monkeypatch.setattr(gnn_mod, "SPARSE_NODE_THRESHOLD", len(ds.node_names))
    assert isinstance(adj("auto"), dict)


@pytest.mark.parametrize("conv", CONV_TYPES)
@pytest.mark.parametrize("sparse", [False, True])
def test_loss_fn_and_eval_match_jax(conv, sparse, no_flax_dropout):
    config = cfg(gnn_sparse=sparse)
    jax_model, jax_ds, model, ds = make_pair(conv, config)
    assert isinstance(model._adj, dict) == sparse == isinstance(jax_model._adj, dict)
    _no_dropout(model)
    idx = np.arange(24)
    jbatch = jax_model.make_batch(jax_ds, idx)

    def jtotal(params):
        return jax_model.loss_fn(params, jax_model.batch_stats, jbatch, jax.random.key(0), True)

    (jloss, (jlosses, _)), jgrads = jax.value_and_grad(jtotal, has_aux=True)(jax_model.params)
    batch = model.make_batch(ds, idx)
    assert batch["_adj"] is model._adj
    total, losses = model.loss_fn(batch, torch.Generator(), True)
    np.testing.assert_allclose(float(total.detach()), float(jloss), rtol=1e-4)
    assert set(losses) == set(jlosses)
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
    # eval (the training forward updated the port's running statistics)
    model.module.load_state_dict(from_flax(jax_model.params, jax_model.batch_stats))
    got, jwant = model.predict(ds), jax_model.predict(jax_ds)
    for v in TARGETS:
        np.testing.assert_allclose(got[v], np.asarray(jwant[v]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(model.transform(ds).values,
                               jax_model.transform(jax_ds).to_numpy(), rtol=1e-4, atol=1e-5)


def test_feature_importance_matches_jax():
    jax_model, jax_ds, model, ds = make_pair("GC", cfg())
    rows = model.compute_feature_importance(ds, "subtype", steps_or_samples=5)
    want = jax_model.compute_feature_importance(jax_ds, "subtype", steps_or_samples=5)
    # 3 labels and the missing one (a class of its own), 2 layers, every node
    assert len(rows) == len(want) == 4 * 2 * len(ds.node_names)
    for col in ("target_class", "target_class_label", "layer", "name"):
        assert [r[col] for r in rows] == list(want[col])
    np.testing.assert_allclose([r["importance"] for r in rows],
                               want["importance"].to_numpy(), rtol=1e-4, atol=1e-6)


def _artifacts(arrays):
    return {"feature_lists": dict(arrays["features"]), "label_encoders": {}}


@pytest.mark.parametrize("saved_by", ["torch", "jax"])
@pytest.mark.parametrize("cls", ["GNN", "MultiTripletNetwork"])
def test_saved_models_load_in_both_packages(cls, saved_by, tmp_path):
    arrays = make_arrays(1)
    if cls == "GNN":
        jax_ds, ds = datasets(1)
        config = cfg(gnn_readout="mean", activation="tanh", gnn_sparse="false")
        ours = GNN(config, ds, TARGETS, device="cpu", gnn_conv_type="SAGE")
        theirs = JaxGNN(config, jax_ds, TARGETS, gnn_conv_type="SAGE")
    else:
        jax_ds, ds = JaxDataset(**arrays), MultiOmicDataset(**arrays)
        config = {"latent_dim": 8, "hidden_dim_factor": 0.5, "supervisor_hidden_dim": 6,
                  "lr": 1e-2, "epochs": 1, "batch_size": 8}
        ours = MultiTripletNetwork(config, ds, TARGETS, device="cpu")
        theirs = JaxTriplet(config, jax_ds, TARGETS)
    weights, conf = str(tmp_path / "m.final_model.safetensors"), str(tmp_path / "m.json")
    if saved_by == "torch":
        ours.fit(ds, lr=1e-2, batch_size=8, max_epochs=1, seed=2)
        inference.save_model(ours, weights)
        inference.save_model_config(ours, conf)
        loaded = jax_inference.reconstruct_model(weights, conf, _artifacts(arrays))
        got, want = ours.predict(ds), loaded.predict(jax_ds)
    else:
        theirs.init_params(jax_ds, seed=4)
        jax_inference.save_model(theirs, weights)
        jax_inference.save_model_config(theirs, conf)
        loaded = inference.reconstruct_model(weights, conf, _artifacts(arrays), device="cpu")
        got, want = loaded.predict(ds), theirs.predict(jax_ds)
    assert loaded.model_name == cls
    if cls == "GNN":
        assert loaded.gnn_conv_type == "SAGE" and list(loaded.nw_dataset.node_names) == \
            list(ds.node_names)
        np.testing.assert_array_equal(np.asarray(loaded.nw_dataset.edge_index), ds.edge_index)
    for v in TARGETS:
        np.testing.assert_allclose(got[v], np.asarray(want[v]), rtol=1e-5, atol=1e-6)


def _shift_atol(name: str, steps: int, lr: float) -> float:
    """A bias before a batch-statistics BatchNorm steps on rounding noise
    (about lr per step on each side): the heads' layer_1 bias, and the conv
    biases before the node BatchNorm; its running mean takes the running
    average's share (see tests/test_torch_trials.py)."""
    if name.endswith(("layer_1.bias", "lin.bias", "lin_root.bias", "fc.bias")) or (
            name.startswith("encoder.conv_") and name.endswith(".bias")):
        return 2 * steps * lr
    if name.endswith("running_mean"):
        return (1 - 0.9 ** steps) * 2 * steps * lr
    return 0.0


@pytest.mark.parametrize("sparse", [False, True])
def test_stacked_same_seed_round_matches_trainer_steps(sparse):
    _, ds = datasets(2)
    model = GNN(cfg(gnn_sparse=sparse), ds, TARGETS, device="cpu", gnn_conv_type="GAT")
    lrs = np.array([1e-3, 4e-3, 1e-2], np.float32)
    seed, steps = 5, 3
    model.init_params(seed)
    start = {n: t.clone() for n, t in model.module.state_dict().items()}
    stacked = StackedGNN(model, len(lrs))
    params, buffers = stacked.stack([start] * len(lrs))
    trial_round = _Round(model, params, buffers, lrs=lrs, seeds=[seed] * len(lrs),
                         param_dtype="float32")
    data = model.make_batch(ds)
    rows = [torch.from_numpy(np.random.default_rng(s).permutation(30)[:12]) for s in range(steps)]
    for r in rows:
        trial_round.step(_gather(data, r))
    val_rows = np.arange(30, 40)
    vloss = trial_round.validate(_val_batch(data, np.tile(val_rows, (3, 1)), "cpu"))
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
        model.module.load_state_dict(got)
        np.testing.assert_allclose(float(vloss[k]), float(trainer.validate(
            model.make_batch(ds, val_rows))), rtol=1e-5)


CONFIGS = [cfg(latent_dim=16, node_embedding_dim=8, supervisor_hidden_dim=8),
           cfg(latent_dim=8, node_embedding_dim=4, supervisor_hidden_dim=4, lr=3e-3),
           cfg(latent_dim=12, node_embedding_dim=6, supervisor_hidden_dim=3, lr=2e-2)]


@pytest.mark.parametrize("conv", CONV_TYPES)
@pytest.mark.parametrize("readout", ["flatten", "mean"])
def test_trial_masks_and_scales_match_jax(conv, readout):
    jax_ds, ds = datasets()
    big = dict(hetero.max_config(CONFIGS, [0]), gnn_readout=readout)
    jax_model = JaxGNN(big, jax_ds, TARGETS, gnn_conv_type=conv)
    jax_model.init_params(jax_ds, seed=0)
    model = GNN(big, ds, TARGETS, device="cpu", gnn_conv_type=conv)
    tree, _ = to_flax(model.module)
    jtree = jax.tree.map(np.asarray, jax_model.params)
    assert jax.tree.structure(tree) == jax.tree.structure(jtree)
    assert hetero.MASK_BUILDERS["GNN"] is hetero.gnn_trial_mask
    for c in CONFIGS:
        got = hetero.gnn_trial_mask(tree, c, model.layers, model.input_dims)
        want = jax_hetero.gnn_trial_mask(jtree, c, jax_model.layers, jax_model.input_dims)
        for g, w in zip(got, want):
            assert jax.tree.structure(g) == jax.tree.structure(w)
            for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bucket_key_matches_jax():
    for c in CONFIGS + [cfg(num_convs=1), cfg(activation="tanh"), cfg(gnn_readout="mean"),
                        {"epochs": 3}]:
        for name in ("GNN", "DirectPred", "MultiTripletNetwork"):
            assert hetero.bucket_key(name, c) == jax_hetero.bucket_key(name, c)
    assert hetero.bucket_key("GNN", cfg(num_convs=1)) != hetero.bucket_key("GNN", cfg())


def _embed(small, padded, E_s, E_m):
    """The small GNN's Flax trees in the padded template's layout: each leaf
    in its leading corner (running variances 1 elsewhere), the flatten fc's
    kernel per node block (node m's channels at [m * E_m, m * E_m + E_s))."""
    (sp, ss), (bp, bs) = small, padded

    def place(s, t, fill=0.0):
        out = np.full_like(np.asarray(t), fill)
        out[tuple(slice(0, d) for d in np.shape(s))] = s
        return out

    params = jax.tree.map(place, sp, bp)
    stats = {k: {"mean": place(v["mean"], bs["encoder"][k]["mean"]),
                 "var": place(v["var"], bs["encoder"][k]["var"], 1.0)}
             for k, v in ss["encoder"].items()}
    stats = {"encoder": stats,
             **{k: {kk: {"mean": place(vv["mean"], bs[k][kk]["mean"]),
                         "var": place(vv["var"], bs[k][kk]["var"], 1.0)}
                     for kk, vv in v.items()}
                for k, v in ss.items() if k != "encoder"}}
    k_small = np.asarray(sp["encoder"]["fc"]["kernel"])
    k_big = np.zeros_like(np.asarray(bp["encoder"]["fc"]["kernel"]))
    for m in range(k_big.shape[0] // E_m):
        k_big[m * E_m: m * E_m + E_s, :k_small.shape[1]] = k_small[m * E_s:(m + 1) * E_s]
    params["encoder"]["fc"]["kernel"] = k_big
    return params, stats


@pytest.mark.parametrize("conv", CONV_TYPES)
def test_padded_trial_equals_its_small_model(conv):
    _, ds = datasets(3)
    small_cfg, big_cfg = CONFIGS[1], hetero.max_config(CONFIGS, [0])
    exact = GNN(small_cfg, ds, TARGETS, device="cpu", gnn_conv_type=conv)
    exact.init_params(7)
    padded = GNN(big_cfg, ds, TARGETS, device="cpu", gnn_conv_type=conv)
    padded.init_params(7)
    state = from_flax(*_embed(to_flax(exact.module), to_flax(padded.module), 4, 8))
    padded.module.load_state_dict(state)
    x = exact.make_eval_x(ds)
    want = exact._forward_eval(x)
    got = padded._forward_eval(x)
    for v in TARGETS:
        torch.testing.assert_close(got["outputs"][v], want["outputs"][v], rtol=1e-5, atol=1e-6)
    assert torch.equal(got["embeddings"][:, 8:], torch.zeros(len(ds), 8))
    stacked = StackedGNN(padded, 2)
    p, b = stacked.stack([state, {n: t.clone() * 0.5 for n, t in state.items()}])
    out = stacked.forward(p, b, x, None, False)
    for v in TARGETS:
        torch.testing.assert_close(out["outputs"][v][0], want["outputs"][v], rtol=1e-5,
                                   atol=1e-6)


def test_padded_round_keeps_padded_entries_zero():
    _, ds = datasets(4)
    model = GNN(hetero.max_config(CONFIGS, [0]), ds, TARGETS, device="cpu", gnn_conv_type="GAT")
    trials = hetero.build_padded_trials(model, CONFIGS, np.arange(3))
    lrs = np.array([c["lr"] for c in CONFIGS], np.float32)
    trial_round = _Round(model, dict(trials["params"]), dict(trials["buffers"]), lrs=lrs,
                         seeds=np.arange(3), masks=trials["masks"])
    data = model.make_batch(ds)
    out = trial_round.fit(data, np.tile(np.arange(30), (3, 1)),
                          _val_batch(data, np.tile(np.arange(30, 40), (3, 1)), "cpu"),
                          batch_size=10, max_epochs=2, early_stop_patience=-1)
    assert np.all(np.isfinite(out["best_val_loss"]))
    for name, m in zip(trial_round.stacked.leaf_names, trials["masks"]):
        m_port = m.mT if trial_round.stacked.transposed[name] else m
        p = trial_round.params[name].float()
        assert torch.equal(p * (1 - m_port), torch.zeros_like(p)), name
