"""The data axis of a single-model fit (``ops/collectives.py``,
``train/trainer.py``, ``parallel/distributed.py``) on the CPU: processes
over a gloo group, spawned with ``torch.multiprocessing`` and rendezvousing
through a ``file://`` init in ``tmp_path`` (each run has a time limit of its
own), against one process without a group and against JAX's fit on its 8
virtual CPU devices (``Trainer(mesh=get_mesh((("data", 8),)))``):

* three training steps with dropout on, two ranks against one process, for
  an unfused and a fused DirectPred (kernel B1 runs on the gathered global
  batch), a fused supervised_vae (its MMD over the gathered latent batch),
  a MultiTripletNetwork (partners drawn for the global batch, each rank
  forwarding its rows of the 3B-row batch) and a GNN (BatchNorm over rows x
  nodes, dropout drawn for the global rows): the per-step losses within rtol
  1e-5 / atol 1e-6; the first step's gradients, the parameters and running
  statistics after three steps within rtol 1e-4 / atol 1e-5, except the
  biases that only shift a batch-statistics BatchNorm's input, whose
  gradient is rounding noise that Adam turns into steps of about lr: 2 x
  steps x lr, and the running means they shift (1 - 0.9^steps) of that
  (``tests/test_torch_trials.py``'s allowance; for a GNN the biases before
  its BatchNorms, ``tests/test_torch_gnn.py``'s);
* ``model.fit(mesh=...)`` over a group of one rank equals the fit without a
  group bit for bit (every collective runs and is the identity); over two
  and three ranks (three splits a 16-row batch unevenly) it tracks it:
  validation losses within rtol 1e-3 after two epochs at lr 1e-3;
* two epochs from JAX's initial weights on one permutation table, two ranks
  against JAX's ``Trainer`` with the training rows sharded over its data
  mesh, unfused and fused (JAX runs the fused block's ``pallas_call`` on the
  whole batch and trains, so the port gathers the rows for B1): epoch and
  validation losses within rtol 1e-3 (``tests/test_torch_train.py``'s
  tolerance for two epochs through both trainers);
* the mesh policy: no data axis, or one device without a group, is the
  plain fit; a data axis of several devices without a matching group
  raises; ``initialize`` without a process count is a no-op, and
  ``partition_trials`` then returns the whole batch."""

import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.models.supervised_vae import SupervisedVAE
from flexynesis_torch.models.triplet_encoder import MultiTripletNetwork
from flexynesis_torch.ops.mlp import BN_MOMENTUM
from flexynesis_torch.parallel import distributed
from flexynesis_torch.parallel.mesh import get_mesh
from flexynesis_torch.train import trainer as port_trainer
from torch_one_thread import one_torch_thread  # noqa: F401

SPAWN_TIMEOUT = 240  # seconds for one spawned group, start-up included
STEP_CASES = [("DirectPred", False), ("DirectPred", True), ("supervised_vae", True),
              ("MultiTripletNetwork", False), ("GNN", False)]
CLASSES = {"DirectPred": DirectPred, "supervised_vae": SupervisedVAE,
           "MultiTripletNetwork": MultiTripletNetwork}
STEPS, STEP_LR, FIT_LR = 3, 1e-2, 1e-3


def make_arrays(seed=0, n=64):
    rng = np.random.default_rng(seed)
    sub = rng.integers(0, 3, n).astype(np.float32)
    return dict(
        dat={"gex": (rng.normal(size=(n, 30)) + sub[:, None]).astype(np.float32),
             "cnv": rng.normal(size=(n, 20)).astype(np.float32)},
        ann={"subtype": sub, "age": rng.normal(size=n).astype(np.float32)},
        variable_types={"subtype": "categorical", "age": "numerical"},
        features={"gex": [f"g{i}" for i in range(30)], "cnv": [f"c{i}" for i in range(20)]},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {0: "a", 1: "b", 2: "c"}},
    )


def cfg(fused):
    return {"latent_dim": 8, "hidden_dim_factor": 0.5, "lr": STEP_LR,
            "supervisor_hidden_dim": 6, "epochs": 2, "batch_size": 16, "fused_kernels": fused}


def make_model(name, fused, arrays=None):
    arrays = arrays or make_arrays()
    if name == "GNN":  # the layers over shared gene names and a ring graph
        from flexynesis_torch.data.dataset import MultiOmicDatasetNW
        from flexynesis_torch.models.gnn import GNN

        arrays["features"] = {"gex": [f"g{i}" for i in range(30)],
                              "cnv": [f"g{i}" for i in range(20, 40)]}
        graph = {"protein1": [f"g{i}" for i in range(40)],
                 "protein2": [f"g{(i + 1) % 40}" for i in range(40)]}
        ds = MultiOmicDatasetNW(MultiOmicDataset(**arrays), graph)
        config = {"latent_dim": 8, "node_embedding_dim": 6, "num_convs": 2, "lr": STEP_LR,
                  "supervisor_hidden_dim": 6, "epochs": 2, "batch_size": 16}
        return GNN(config, ds, ["subtype", "age"], device="cpu", gnn_conv_type="GC"), ds
    ds = MultiOmicDataset(**arrays)
    return CLASSES[name](cfg(fused), ds, target_variables=["subtype", "age"], device="cpu"), ds


def _state(model):
    return {n: t.detach().clone() for n, t in model.module.state_dict().items()}


def run_steps(name, fused, mesh):
    """Three steps on fixed batches from init seed 3, dropout on: (losses,
    first step's gradients by name, final state)."""
    model, ds = make_model(name, fused)
    model.init_params(3)
    tr = port_trainer.Trainer(model.module, model.loss_fn, lr=STEP_LR, mesh=mesh)
    data = model.make_batch(ds)
    gen = torch.Generator().manual_seed(5)
    losses, grads = [], None
    for s in range(STEPS):
        rows = torch.from_numpy(np.random.default_rng(s).permutation(
            model.n_train_samples(ds))[:16])
        batch = port_trainer.gather(data, rows)
        if s == 0:  # the first step's gradients, then the same step
            state, gstate = _state(model), gen.get_state()
            tr.optimizer.step = lambda g: grads_box.append(g)
            grads_box = []
            tr.train_step(batch, gen)
            grads = {n: g.clone() for n, g in zip(tr.param_names, grads_box[0])}
            del tr.optimizer.step
            model.module.load_state_dict(state)
            gen.set_state(gstate)
        losses.append(float(tr.train_step(batch, gen)))
    return losses, grads, _state(model)


def run_fit(fused, mesh):
    model, ds = make_model("DirectPred", fused)
    res = model.fit(ds, np.arange(48), np.arange(48, 64), lr=FIT_LR, batch_size=16,
                    max_epochs=2, seed=7, mesh=mesh)
    return res.history, res.state


def run_jax_epochs(start, perms, fused, arrays, mesh):
    """Two epochs from ``start`` (a state dict) on ``perms``, dropout off:
    (epoch losses, validation loss)."""
    model, ds = make_model("DirectPred", fused, arrays)
    model.module.load_state_dict(start)
    for m in model.module.modules():
        if hasattr(m, "dropout_rate"):
            m.dropout_rate = 0.0
    tr = port_trainer.Trainer(model.module, model.loss_fn, lr=1e-3, mesh=mesh)
    tdata = model.make_batch(ds, np.arange(40))
    gen = torch.Generator()
    losses = [float(tr.train_epoch(torch.from_numpy(p), tdata, gen)) for p in perms]
    return losses, float(tr.validate(model.make_batch(ds, np.arange(40, 48))))


def worker(rank, world, init, out, tasks, payload):
    """One rank: join the gloo group, run ``tasks`` with a data mesh over the
    group, rank 0 saves the results."""
    torch.set_num_threads(1)
    distributed.initialize(init, world, rank, device="cpu")
    mesh = get_mesh((("data", world),))
    results = {}
    for task in tasks:
        kind = task[0]
        if kind == "steps":
            results[task] = run_steps(task[1], task[2], mesh)
        elif kind == "fit":
            results[task] = run_fit(task[1], mesh)
        else:
            start, perms, arrays = payload[task]
            results[task] = run_jax_epochs(start, perms, task[1], arrays, mesh)
    if rank == 0:
        torch.save(results, out)
    distributed.shutdown()


def spawn(world, tmp_path, tasks, payload=None):
    """Run ``tasks`` on ``world`` gloo ranks; rank 0's results."""
    out = tmp_path / f"out{world}.pt"
    init = f"file://{tmp_path / f'init{world}'}"
    ctx = mp.start_processes(worker, args=(world, init, str(out), tasks, payload or {}),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} gloo ranks did not finish in {SPAWN_TIMEOUT} s")
    return torch.load(out)


def shift_atol(name: str, steps: int, lr: float) -> float:
    """The biases that only shift a batch-statistics BatchNorm's input step on
    rounding noise: 2 x steps x lr, and the running means they shift
    (1 - 0.9^steps) of that."""
    if (name.endswith(("layer_1.bias", "layer_1_bias")) or name == "fusion_block.bias"
            or (name.startswith("encoder_") and name.endswith("layer_out.bias"))
            or name.endswith(("lin.bias", "lin_root.bias", "fc.bias"))  # a GNN's
            or (name.startswith("encoder.conv_") and name.endswith(".bias"))):
        return 2 * steps * lr
    if name.endswith("running_mean"):
        return (1 - (1 - BN_MOMENTUM) ** steps) * 2 * steps * lr
    return 0.0


@pytest.fixture(scope="module")
def jax_cases():
    """JAX's two epochs under its 8-device data mesh, unfused and fused: the
    start state (carried across), the permutation table, JAX's losses."""
    import flax.linen as nn_flax
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from flexynesis_torch.convert import from_flax
    from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
    from flexynesis_tpu.models.direct_pred import DirectPred as JaxDirectPred
    from flexynesis_tpu.parallel.mesh import get_mesh as jax_get_mesh
    from flexynesis_tpu.train import trainer as jax_trainer

    arrays = make_arrays(2, n=48)
    perms = [np.random.default_rng(e).permutation(40).reshape(5, 8) for e in range(2)]
    mesh = jax_get_mesh((("data", 8),))
    shard = NamedSharding(mesh, P("data"))
    cases = {}
    saved = nn_flax.Dropout.__call__
    nn_flax.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        for fused in (False, True):
            jds = JaxDataset(**arrays)
            jm = JaxDirectPred(cfg(fused), jds, target_variables=["subtype", "age"])
            jm.init_params(jds, seed=3)
            start = from_flax(jm.params, jm.batch_stats)
            jt = jax_trainer.Trainer(jm.loss_fn, lr=1e-3, mesh=mesh)
            jt._build()
            params, stats = jm.params, jm.batch_stats
            opt_state = jt.optimizer.init(params)
            rng = jax.random.key(0)
            jdata = jax.tree.map(lambda a: jax.device_put(a, shard),
                                 jm.make_batch(jds, np.arange(40)))
            losses = []
            for perm in perms:
                params, opt_state, stats, rng, loss = jt._train_epoch(
                    params, opt_state, stats, rng, jnp.asarray(perm), jdata)
                losses.append(float(loss))
            val = float(jt._val_step(params, stats, jm.make_batch(jds, np.arange(40, 48)))[0])
            cases[("jax", fused)] = (start, perms, arrays, losses, val)
    finally:
        nn_flax.Dropout.__call__ = saved
    return cases


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, jax_cases):
    tasks = ([("steps", n, f) for n, f in STEP_CASES] + [("fit", False), ("fit", True)]
             + list(jax_cases))
    payload = {k: v[:3] for k, v in jax_cases.items()}
    return spawn(2, tmp_path_factory.mktemp("dp2"), tasks, payload)


@pytest.mark.parametrize("name,fused", STEP_CASES)
def test_two_rank_steps_match_one_process(two_ranks, name, fused):
    losses, grads, state = two_ranks[("steps", name, fused)]
    want_losses, want_grads, want_state = run_steps(name, fused, None)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-6)
    for n, g in want_grads.items():
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    for n, t in want_state.items():
        if t.dtype.is_floating_point:
            np.testing.assert_allclose(state[n].numpy(), t.numpy(), rtol=1e-4,
                                       atol=1e-5 + shift_atol(n, STEPS, STEP_LR), err_msg=n)


@pytest.mark.parametrize("fused", [False, True])
def test_one_rank_fit_is_the_plain_fit_bit_for_bit(tmp_path, fused):
    got = spawn(1, tmp_path, [("fit", fused)])[("fit", fused)]
    history, state = run_fit(fused, None)
    assert got[0] == history
    for n, t in state.items():
        assert torch.equal(got[1][n], t), n


@pytest.mark.parametrize("fused", [False, True])
def test_two_rank_fit_tracks_the_plain_fit(two_ranks, fused):
    history, _ = two_ranks[("fit", fused)]
    want, _ = run_fit(fused, None)
    np.testing.assert_allclose(history["val_loss"], want["val_loss"], rtol=1e-3)
    np.testing.assert_allclose(history["train_loss"], want["train_loss"], rtol=1e-3)


def test_three_ranks_split_the_batch_unevenly(tmp_path):
    history, _ = spawn(3, tmp_path, [("fit", False)])[("fit", False)]
    want, _ = run_fit(False, None)
    np.testing.assert_allclose(history["val_loss"], want["val_loss"], rtol=1e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_two_rank_epochs_match_jax_data_mesh(two_ranks, jax_cases, fused):
    losses, val = two_ranks[("jax", fused)]
    _, _, _, want_losses, want_val = jax_cases[("jax", fused)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    np.testing.assert_allclose(val, want_val, rtol=1e-3)


def test_data_mesh_policy():
    cpu = [torch.device("cpu")] * 2
    assert port_trainer.data_group(None) is None
    assert port_trainer.data_group(get_mesh((("trial", 2),), devices=cpu)) is None
    assert port_trainer.data_group(get_mesh((("data", 1),), devices=cpu)) is None
    with pytest.raises(ValueError, match="torch.distributed group of 2"):
        port_trainer.data_group(get_mesh((("data", 2),), devices=cpu))


def test_initialize_without_a_count_is_a_noop():
    summary = distributed.initialize(device="cpu")
    assert summary == {"process_index": 0, "process_count": 1, "local_devices": 1,
                       "global_devices": 1}
    assert not torch.distributed.is_initialized()
    sugg = [{"i": i} for i in range(3)]
    assert distributed.partition_trials(sugg) == sugg
    with pytest.raises(ValueError, match="tcp://"):
        distributed._init_method("env://")
    assert distributed._init_method("localhost:1234") == "tcp://localhost:1234"
    assert os.environ.get("RANK") is None
