"""The port's marker finding against the JAX package's, on the CPU, with the
same weights (carried across by flexynesis_torch.convert) and the same numpy
inputs:

* ``integrated_gradients`` and ``gradient_shap`` per class, for a DirectPred,
  a supervised_vae and a CrossModalPred (GradientShap draws its scales with
  the port's copy of ``jax.random``, so both sides use the same numbers),
  GradientShap also with input noise (``stdevs`` 0.1): the noise is drawn
  with the port's copy of ``jax.random.normal``, whose erfinv parts from
  XLA's by a few float32 ulp, so the same tolerance holds;
* ``compute_feature_importance`` for DirectPred (unfused), supervised_vae
  (``fused_kernels`` on: only its MMD loss differs) and CrossModalPred
  (its input layers only), every variable (a categorical one with a missing
  label, a numerical one), both methods, a cohort of one batch and one above
  512 rows (the zero-padded tail): the same rows in the same order, the same
  labels, importances within the tolerance;
* attribution forms no weight gradient and leaves ``requires_grad`` as it was;
* a fused DirectPred is refused: ``NotImplementedError`` in the port,
  ``ValueError`` in JAX, whose B2 ``pallas_call`` has no VJP;
* the sample axis split over a mesh of 8 CPU devices (``parallel/mesh.py``)
  on a cohort of 2,100 samples (above the CLI's 2,048 hook; batches of 512
  over 8 devices: 5 batches, the tail zero-padded), both methods: against
  the unsharded port run within rtol 1e-4 / atol 1e-7 (JAX's test's
  tolerance) and against JAX's run on its 8 virtual devices within the
  tolerance below; a cohort that fits one batch is zero-padded under a mesh,
  as in JAX, and still agrees with JAX and with the unpadded run.

Tolerance (f32, different summation orders): rtol 1e-4, atol 1e-6."""

import functools

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.interpret import attribution as jax_attr
from flexynesis_tpu.models.crossmodal_pred import CrossModalPred as JaxCrossModalPred
from flexynesis_tpu.models.direct_pred import DirectPred as JaxDirectPred
from flexynesis_tpu.models.supervised_vae import SupervisedVAE as JaxSupervisedVAE
from flexynesis_torch.convert import from_flax
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.interpret import attribution
from flexynesis_torch.models.crossmodal_pred import CrossModalPred
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.models.supervised_vae import SupervisedVAE
from flexynesis_torch.utils import prng
from torch_one_thread import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-6)
DIMS = (("gex", 24), ("cnv", 16), ("mut", 10))

CASES = {
    "direct_pred": (JaxDirectPred, DirectPred, {}, False),
    "supervised_vae_fused": (JaxSupervisedVAE, SupervisedVAE, {}, True),
    "crossmodal": (JaxCrossModalPred, CrossModalPred,
                   {"input_layers": ["gex", "mut"], "output_layers": ["cnv"]}, False),
}


def make_arrays(seed, n):
    rng = np.random.default_rng(seed)
    dat = {m: rng.normal(0, 1, size=(n, d)).astype(np.float32) for m, d in DIMS}
    sub = rng.integers(0, 3, n).astype(np.float32)
    sub[[1, 7]] = np.nan  # a missing label: one more class, as in the reference
    return dict(
        dat=dat,
        ann={"subtype": sub, "age": rng.normal(0, 1, n).astype(np.float32)},
        variable_types={"subtype": "categorical", "age": "numerical"},
        features={m: [f"{m}{i}" for i in range(d)] for m, d in DIMS},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {i: f"grp{i}" for i in range(3)}},
    )


def _random_stats(rng, stats):
    return jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if np.all(np.asarray(a) == 1) else rng.normal(0, 0.3, a.shape).astype(np.float32),
        stats)


@functools.lru_cache(maxsize=None)
def make_pair(case, n=40, seed=3, fused=None):
    jax_cls, port_cls, layers, case_fused = CASES[case]
    cfg = {"latent_dim": 6, "hidden_dim_factor": 0.5, "lr": 1e-2,
           "supervisor_hidden_dim": 5, "epochs": 2, "batch_size": 8,
           "fused_kernels": case_fused if fused is None else fused}
    arrays = make_arrays(seed, n)
    kw = dict(target_variables=["subtype", "age"], **layers)
    jax_ds = JaxDataset(**arrays)
    jax_model = jax_cls(cfg, jax_ds, **kw)
    jax_model.init_params(jax_ds, seed=seed)
    jax_model.batch_stats = _random_stats(np.random.default_rng(seed), jax_model.batch_stats)
    ds = MultiOmicDataset(**arrays)
    model = port_cls(cfg, ds, device="cpu", **kw)
    model.module.load_state_dict(from_flax(jax_model.params, jax_model.batch_stats))
    return jax_model, jax_ds, model, ds


def _forwards(jax_model, model, var):
    def jax_forward(xs):
        return jax_model._attribution_forward(jax_model.params, jax_model.batch_stats, xs, var)

    def port_forward(xs):
        return model._attribution_forward(xs, var)

    return jax_forward, port_forward


def _assert_layers_close(ours, theirs):
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_allclose(ours[k].detach().numpy(), np.asarray(theirs[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("var,target_class", [("subtype", 2), ("age", 0)])
def test_integrated_gradients_matches_jax(case, var, target_class):
    jax_model, jax_ds, model, ds = make_pair(case)
    jax_forward, port_forward = _forwards(jax_model, model, var)
    single = var == "age"
    x_jax = jax_model.make_eval_x(jax_ds)
    theirs = jax.jit(lambda x: jax_attr.integrated_gradients(
        jax_forward, x, target_class, 7, single))(x_jax)
    ours, = attribution.integrated_gradients(port_forward, model.make_eval_x(ds),
                                             [target_class], 7, single)
    _assert_layers_close(ours, theirs)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("var,target_class", [("subtype", 1), ("age", 0)])
@pytest.mark.parametrize("seed", [0, 42])
def test_gradient_shap_matches_jax(case, var, target_class, seed):
    jax_model, jax_ds, model, ds = make_pair(case)
    jax_forward, port_forward = _forwards(jax_model, model, var)
    single = var == "age"
    theirs = jax.jit(lambda x: jax_attr.gradient_shap(
        jax_forward, x, target_class, 6, single, jax.random.key(seed)))(
        jax_model.make_eval_x(jax_ds))
    ours, = attribution.gradient_shap(port_forward, model.make_eval_x(ds), [target_class],
                                      6, single, prng.key(seed))
    _assert_layers_close(ours, theirs)


def test_gradient_shap_noise_is_not_ported():
    """Input noise (stdevs > 0) is now ported: the port's noisy GradientShap
    equals JAX's, and the noise changes the attributions."""
    jax_model, jax_ds, model, ds = make_pair("direct_pred")
    jax_forward, port_forward = _forwards(jax_model, model, "subtype")
    x = model.make_eval_x(ds)
    theirs = jax.jit(lambda x: jax_attr.gradient_shap(
        jax_forward, x, 0, 2, False, jax.random.key(0), stdevs=0.1))(
        jax_model.make_eval_x(jax_ds))
    ours, = attribution.gradient_shap(port_forward, x, [0], 2, False, prng.key(0), stdevs=0.1)
    _assert_layers_close(ours, theirs)
    plain, = attribution.gradient_shap(port_forward, x, [0], 2, False, prng.key(0))
    assert not torch.allclose(ours["gex"], plain["gex"])


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("var,target_class", [("subtype", 1), ("age", 0)])
@pytest.mark.parametrize("stdevs", [0.1, 1.0])
def test_gradient_shap_with_noise_matches_jax(case, var, target_class, stdevs):
    jax_model, jax_ds, model, ds = make_pair(case)
    jax_forward, port_forward = _forwards(jax_model, model, var)
    single = var == "age"
    theirs = jax.jit(lambda x: jax_attr.gradient_shap(
        jax_forward, x, target_class, 4, single, jax.random.key(7), stdevs=stdevs))(
        jax_model.make_eval_x(jax_ds))
    ours, = attribution.gradient_shap(port_forward, model.make_eval_x(ds), [target_class],
                                      4, single, prng.key(7), stdevs=stdevs)
    _assert_layers_close(ours, theirs)


def test_noisy_draws_of_a_row_slice_are_the_batchs():
    """A shard's slice of a batch (``rows``) takes its rows of the batch's
    uniforms and noise: the slices' attributions are the batch's rows."""
    _, _, model, ds = make_pair("direct_pred")
    _, port_forward = _forwards(None, model, "subtype")
    x = model.make_eval_x(ds)
    whole, = attribution.gradient_shap(port_forward, x, [1], 3, False, prng.key(5), stdevs=0.1)
    for sl in (slice(0, 16), slice(16, 40)):
        part, = attribution.gradient_shap(port_forward, {k: v[sl] for k, v in x.items()}, [1],
                                          3, False, prng.key(5), stdevs=0.1,
                                          rows=(sl.start, 40))
        for k in x:
            np.testing.assert_allclose(part[k].numpy(), whole[k][sl].numpy(), rtol=1e-5,
                                       atol=1e-7)


def assert_tables_match(ours_rows, theirs: pd.DataFrame):
    ours = pd.DataFrame(ours_rows)
    assert list(ours.columns) == list(theirs.columns)
    assert len(ours) == len(theirs) > 0
    for col in ("target_variable", "target_class", "layer", "name"):
        assert ours[col].tolist() == theirs[col].tolist(), col
    assert ours["target_class_label"].fillna("").tolist() == \
        theirs["target_class_label"].fillna("").tolist()
    np.testing.assert_allclose(ours["importance"].to_numpy(np.float64),
                               theirs["importance"].to_numpy(np.float64), **TOL)
    assert (ours["importance"] > 0).any()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", ["IntegratedGradients", "GradientShap"])
@pytest.mark.parametrize("n", [40, 530])
def test_compute_feature_importance_matches_jax(case, method, n):
    jax_model, jax_ds, model, ds = make_pair(case, n=n)
    for var in ("subtype", "age"):
        theirs = jax_model.compute_feature_importance(jax_ds, var, method=method,
                                                      steps_or_samples=5)
        ours = model.compute_feature_importance(ds, var, method=method, steps_or_samples=5)
        assert model.feature_importances[var] is ours
        assert_tables_match(ours, theirs)
        n_class = 1 if var == "age" else 4  # three labels and the missing one
        assert len(ours) == n_class * sum(len(ds.features[k]) for k in model.layers)
    assert set(pd.DataFrame(ours)["layer"]) == set(model.layers)


def test_attribution_forms_no_weight_gradient():
    _, _, model, ds = make_pair.__wrapped__("direct_pred")
    params = list(model.module.parameters())
    params[0].requires_grad_(False)
    model.compute_feature_importance(ds, "subtype", steps_or_samples=3)
    assert all(p.grad is None for p in params)
    assert not params[0].requires_grad and all(p.requires_grad for p in params[1:])


def test_fused_direct_pred_is_refused_as_jax_fails():
    jax_model, jax_ds, model, ds = make_pair("direct_pred", fused=True)
    with pytest.raises(ValueError, match="Linearization failed"):
        jax_model.compute_feature_importance(jax_ds, "subtype", steps_or_samples=2)
    with pytest.raises(NotImplementedError, match="fused_kernels"):
        model.compute_feature_importance(ds, "subtype", steps_or_samples=2)


MESH8 = [torch.device("cpu")] * 8
SHARD_TOL = dict(rtol=1e-4, atol=1e-7)  # JAX's own sharded-attribution tolerance


@functools.lru_cache(maxsize=None)
def _big_pair():
    return make_pair("direct_pred", n=2100, seed=11)


@pytest.mark.parametrize("method", ["IntegratedGradients", "GradientShap"])
def test_sharded_attribution_matches_unsharded_and_jax(method):
    from flexynesis_tpu.parallel.mesh import get_mesh as jax_get_mesh
    from flexynesis_torch.parallel.mesh import get_mesh

    jax_model, jax_ds, model, ds = _big_pair()
    mesh = get_mesh((("data", 8),), devices=MESH8)
    sharded = model.compute_feature_importance(ds, "subtype", method=method,
                                               steps_or_samples=3, mesh=mesh)
    single = model.compute_feature_importance(ds, "subtype", method=method,
                                              steps_or_samples=3)
    np.testing.assert_allclose(pd.DataFrame(sharded)["importance"].to_numpy(np.float64),
                               pd.DataFrame(single)["importance"].to_numpy(np.float64),
                               **SHARD_TOL)
    theirs = jax_model.compute_feature_importance(
        jax_ds, "subtype", method=method, steps_or_samples=3,
        mesh=jax_get_mesh((("data", len(jax.devices())),)))
    assert_tables_match(sharded, theirs)


def test_sharded_small_cohort_pads_as_jax():
    """A cohort that fits one batch is zero-padded to the batch under a mesh
    (JAX's rule), so GradientShap's draws are those of the padded batch."""
    from flexynesis_tpu.parallel.mesh import get_mesh as jax_get_mesh
    from flexynesis_torch.parallel.mesh import get_mesh

    jax_model, jax_ds, model, ds = make_pair("direct_pred")
    mesh = get_mesh((("data", 8),), devices=MESH8)
    ours = model.compute_feature_importance(ds, "subtype", method="GradientShap",
                                            steps_or_samples=3, batch_size=60, mesh=mesh)
    theirs = jax_model.compute_feature_importance(
        jax_ds, "subtype", method="GradientShap", steps_or_samples=3, batch_size=60,
        mesh=jax_get_mesh((("data", len(jax.devices())),)))
    assert_tables_match(ours, theirs)
    # the partitionable threefry counts over the flat shape, so the padded
    # batch's first 40 draws are the unpadded batch's: the results agree
    unpadded = model.compute_feature_importance(ds, "subtype", method="GradientShap",
                                                steps_or_samples=3, batch_size=60)
    np.testing.assert_allclose(pd.DataFrame(ours)["importance"].to_numpy(np.float64),
                               pd.DataFrame(unpadded)["importance"].to_numpy(np.float64),
                               **SHARD_TOL)
