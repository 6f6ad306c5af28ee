"""The port's DirectPred against the JAX package's: a JAX model trained for a
few epochs (so the running statistics are not trivial) has its weights
carried across by flexynesis_torch.convert; predict and transform must agree.

Covers both block layouts (fused_kernels false and true), one and two
modalities, a categorical and a numerical target.
Tolerance: rtol=1e-4, atol=1e-5 (f32, as tests/test_torch_parity.py)."""

import numpy as np
import pytest

from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.models.direct_pred import DirectPred as JaxDirectPred
from flexynesis_torch.convert import from_flax, to_flax
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.models.direct_pred import DirectPred

DIMS = {"gex": 50, "cnv": 30}


def make_arrays(seed, layers, kind, n=32, k=3):
    rng = np.random.default_rng(seed)
    dat = {m: rng.normal(size=(n, DIMS[m])).astype(np.float32) for m in layers}
    if kind == "categorical":
        y = rng.integers(0, k, n).astype(np.float32)
        mappings = {"y": {i: f"grp{i}" for i in range(k)}}
    else:
        y = rng.normal(size=n).astype(np.float32)
        mappings = {}
    return dict(
        dat=dat,
        ann={"y": y},
        variable_types={"y": kind},
        features={m: [f"{m}{i}" for i in range(DIMS[m])] for m in layers},
        samples=[f"S{i}" for i in range(n)],
        label_mappings=mappings,
    )


CASES = [
    (False, ("gex", "cnv"), "categorical"),
    (True, ("gex", "cnv"), "numerical"),
    (True, ("gex",), "categorical"),
    (False, ("cnv",), "numerical"),
]


@pytest.mark.parametrize("fused,layers,kind", CASES)
def test_predict_and_transform_match_jax(fused, layers, kind):
    arrays = make_arrays(len(layers) * 10 + fused, layers, kind)
    cfg = {"latent_dim": 16, "hidden_dim_factor": 0.4, "lr": 1e-3,
           "supervisor_hidden_dim": 8, "epochs": 2, "batch_size": 16,
           "fused_kernels": fused}
    jax_ds = JaxDataset(**arrays)
    jax_model = JaxDirectPred(cfg, jax_ds, target_variables=["y"])
    jax_model.fit(jax_ds, np.arange(24), np.arange(24, 32), lr=1e-3,
                  batch_size=16, max_epochs=2)

    ds = MultiOmicDataset(**arrays)
    model = DirectPred(cfg, ds, target_variables=["y"], device="cpu")
    assert model.output_dims == jax_model.output_dims
    model.module.load_state_dict(from_flax(jax_model.params, jax_model.batch_stats))

    ours, ref = model.predict(ds), jax_model.predict(jax_ds)
    np.testing.assert_allclose(ours["y"], ref["y"], rtol=1e-4, atol=1e-5)
    emb, emb_ref = model.transform(ds), jax_model.transform(jax_ds)
    assert emb.index == list(emb_ref.index)
    assert emb.columns == list(emb_ref.columns)
    np.testing.assert_allclose(emb.values, emb_ref.to_numpy(), rtol=1e-4, atol=1e-5)

    params, stats = to_flax(model.module)
    flat = lambda t, p="": (  # noqa: E731
        {k: v for kk, vv in t.items() for k, v in flat(vv, f"{p}{kk}/").items()}
        if isinstance(t, dict) else {p: np.asarray(t)}
    )
    for mine, theirs in ((params, jax_model.params), (stats, jax_model.batch_stats)):
        a, b = flat(mine), flat(theirs)
        assert a.keys() == b.keys()
        for key in a:
            assert np.array_equal(a[key], b[key]), key


def test_eval_forward_is_chunked_like_one_pass():
    arrays = make_arrays(5, ("gex", "cnv"), "categorical", n=23)
    ds = MultiOmicDataset(**arrays)
    cfg = {"latent_dim": 8, "hidden_dim_factor": 0.3, "supervisor_hidden_dim": 4}
    model = DirectPred(cfg, ds, target_variables=["y"], device="cpu")
    model.init_params(seed=3)
    whole = model.predict(ds)["y"]
    model.EVAL_CHUNK = 5
    np.testing.assert_allclose(model.predict(ds)["y"], whole, rtol=1e-6, atol=1e-7)
    assert model.transform(ds).values.shape == (23, 8)


def test_init_params_follow_torch_linear_law_and_seed():
    arrays = make_arrays(1, ("gex", "cnv"), "categorical")
    arrays["dat"]["gex"] = np.zeros((32, 400), np.float32)
    arrays["features"]["gex"] = [f"g{i}" for i in range(400)]
    ds = MultiOmicDataset(**arrays)
    cfg = {"latent_dim": 64, "hidden_dim_factor": 0.5, "supervisor_hidden_dim": 16,
           "fused_kernels": True}
    a = DirectPred(cfg, ds, target_variables=["y"], device="cpu")
    b = DirectPred(cfg, ds, target_variables=["y"], device="cpu")
    a.init_params(seed=0)
    b.init_params(seed=0)
    for (name, pa), pb in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        assert np.array_equal(pa.numpy(), pb.numpy()), name
    k = a.module.encoder_gex.layer_1_kernel.detach().numpy()
    bound = 1.0 / np.sqrt(400)
    assert k.shape == (400, 200)
    assert k.max() <= bound and k.min() >= -bound
    np.testing.assert_allclose(k.std(), bound / np.sqrt(3), rtol=0.05)
