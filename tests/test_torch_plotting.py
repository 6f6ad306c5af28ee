"""The port's figures against flexynesis_tpu.utils.plotting: each renders
(matplotlib, Agg) and draws JAX's data. KM step arrays and the hazard-ratio
bars are equal (the same host arithmetic); PCA scatter offsets within 1e-8
up to each component's sign (sklearn's PCA against the port's full SVD);
ROC and PR curve arrays within 1e-10. The concordance heatmap is drawn with
imshow, not seaborn: its numbers equal the crosstab's (a recorded
departure of look only). t-SNE: the port's exact t-SNE keeps neighbourhoods
as well as sklearn's Barnes-Hut run in JAX, trustworthiness (5 neighbours)
within 0.05. ``LiveLossPlot`` records the trainer's history through
``HyperparameterTuning(plot_losses=True)``."""

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from flexynesis_torch.utils import plotting as pp  # noqa: E402
from flexynesis_torch.utils.csvio import Table  # noqa: E402
from flexynesis_tpu.utils import plotting as jp  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: E402,F401

CURVE_TOL = 1e-10


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _lines(fig):
    return [ln.get_xydata() for ln in fig.axes[0].lines]


def test_kaplan_meier_curves():
    rng = np.random.default_rng(0)
    t = np.ceil(rng.exponential(10, 90))
    e = (rng.random(90) < 0.7).astype(float)
    g = np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, 90)]
    g[4] = np.nan
    want, got = jp.plot_kaplan_meier_curves(t, e, g), pp.plot_kaplan_meier_curves(t, e, g)
    assert len(_lines(got)) == len(_lines(want)) == 4
    for a, b in zip(_lines(got), _lines(want)):
        np.testing.assert_array_equal(a, b)
    assert got.axes[0].get_title() == want.axes[0].get_title()
    assert [t.get_text() for t in got.axes[0].get_legend().get_texts()] == \
        [t.get_text() for t in want.axes[0].get_legend().get_texts()]


def test_pca_scatter_offsets_up_to_sign():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(60, 8)) @ rng.normal(size=(8, 8))
    y = rng.integers(0, 3, 60)
    want, got = jp.plot_dim_reduced(X, y, method="pca"), pp.plot_dim_reduced(X, y, method="pca")
    ow = [c.get_offsets() for c in want.axes[0].collections]
    og = [c.get_offsets() for c in got.axes[0].collections]
    assert len(og) == len(ow) == 3
    sign = np.sign(ow[0][0] / og[0][0])
    for a, b in zip(og, ow):
        np.testing.assert_allclose(a * sign, b, rtol=1e-8, atol=1e-10)
    assert got.axes[0].get_xlabel() == "PC1"


def test_tsne_trustworthiness_near_jax():
    from sklearn.manifold import trustworthiness

    rng = np.random.default_rng(2)
    centers = rng.normal(scale=5, size=(4, 10))
    y = rng.integers(0, 4, 80)
    X = centers[y] + rng.normal(size=(80, 10))
    want = jp.plot_dim_reduced(X, y, method="tsne")
    with pytest.warns(UserWarning, match="falling back to t-SNE"):
        got = pp.plot_dim_reduced(X, y, method="umap", device="cpu")

    def embedding(fig):
        pts = np.zeros((80, 2))
        for lb, coll in zip(pd.unique(pd.Series(y)), fig.axes[0].collections):
            pts[y == lb] = coll.get_offsets()
        return pts

    tw_want = trustworthiness(X, embedding(want), n_neighbors=5)
    tw_got = trustworthiness(X, embedding(got), n_neighbors=5)
    assert abs(tw_got - tw_want) <= 0.05, (tw_got, tw_want)
    assert tw_got > 0.8


@pytest.mark.parametrize("n_classes", [2, 3])
def test_roc_and_pr_curves(n_classes):
    rng = np.random.default_rng(3)
    y = rng.integers(0, n_classes, 70)
    probs = rng.dirichlet(np.ones(n_classes), size=70)
    probs[:10] = np.round(probs[:10], 1)  # tied scores
    probs /= probs.sum(1, keepdims=True)
    for fn in ("plot_roc_curves", "plot_pr_curves"):
        a, b = _lines(getattr(pp, fn)(y, probs)), _lines(getattr(jp, fn)(y, probs))
        assert len(a) == len(b)
        for u, v in zip(a, b):
            np.testing.assert_allclose(u, v, rtol=CURVE_TOL, atol=CURVE_TOL)


def test_hazard_ratio_bars():
    from flexynesis_torch.utils.survival import CoxPH as PortCox
    from flexynesis_tpu.utils.survival import CoxPH as JaxCox

    rng = np.random.default_rng(4)
    x = rng.normal(size=100)
    df = pd.DataFrame({"x": x, "z": rng.normal(size=100), "w": rng.normal(size=100),
                       "time": rng.exponential(np.exp(-x)), "event": np.ones(100)})
    import jax

    with jax.enable_x64(True):
        jm = JaxCox().fit(df, "time", "event")
    pm = PortCox(device="cpu").fit(Table([str(i) for i in df.index], list(df.columns),
                                         df.to_numpy()), "time", "event")
    a, b = pp.plot_hazard_ratios(pm), jp.plot_hazard_ratios(jm)
    np.testing.assert_allclose(_lines(a)[0], _lines(b)[0], rtol=1e-6)
    assert [t.get_text() for t in a.axes[0].get_yticklabels()] == \
        [t.get_text() for t in b.axes[0].get_yticklabels()]


def test_other_figures_render_and_heatmap_numbers():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 3, 40)
    X = rng.normal(size=(40, 4))
    for fig in (pp.plot_scatter(rng.normal(size=30), rng.normal(size=30)),
                pp.plot_boxplot(y.astype(str), X[:, 0]),
                pp.plot_dim_reduced(X, X[:, 1], method="pca", color_type="numerical")):
        assert fig.axes
    labels2 = (y + rng.integers(0, 2, 40)) % 3
    fig = pp.plot_label_concordance_heatmap(y, labels2)
    want = pd.crosstab(pd.Series(y), pd.Series(labels2), normalize="index")
    np.testing.assert_allclose(fig.axes[0].images[0].get_array(), want.values, rtol=1e-12)
    texts = [t.get_text() for t in fig.axes[0].texts]
    assert texts == [f"{v:.2f}" for v in want.values.ravel()]


def test_matplotlib_missing_raises_naming_it(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_mpl(name, *args, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError, match="matplotlib"):
        pp.plot_scatter([1.0, 2.0, 3.0], [1.0, 2.5, 2.9])


LOSS_PARAMS = {"latent_dim": 4, "hidden_dim_factor": 0.5, "lr": 0.01,
               "supervisor_hidden_dim": 4, "epochs": 3, "batch_size": 16}


def _recording_tuner(monkeypatch, use_cv=False):
    """A ``plot_losses=True`` tuner of a small DirectPred, and the list that
    every ``LiveLossPlot`` it builds joins."""
    from flexynesis_torch.data.dataset import MultiOmicDataset
    from flexynesis_torch.models import DirectPred
    from flexynesis_torch.train import hpo, live_plot

    plots = []

    class Recording(live_plot.LiveLossPlot):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            plots.append(self)

    monkeypatch.setattr(live_plot, "LiveLossPlot", Recording)
    rng = np.random.default_rng(6)
    ds = MultiOmicDataset(dat={"gex": rng.normal(size=(40, 12)).astype(np.float32)},
                          ann={"y": rng.integers(0, 2, 40).astype(np.float32)},
                          variable_types={"y": "categorical"},
                          features={"gex": [f"g{i}" for i in range(12)]},
                          samples=[f"s{i}" for i in range(40)])
    tuner = hpo.HyperparameterTuning(ds, DirectPred, "DirectPred", ["y"], n_iter=1,
                                     plot_losses=True, use_cv=use_cv, device="cpu")
    return tuner, plots


def test_live_loss_plot_records_the_history(monkeypatch):
    tuner, plots = _recording_tuner(monkeypatch)
    _, _, model = tuner.objective(LOSS_PARAMS)
    (plot,) = plots
    assert plot.train_losses == model.train_result.history["train_loss"]
    assert plot.val_losses == model.train_result.history["val_loss"]
    assert len(plot.val_losses) == 3 and plot._fig is not None
    plot.close()


@pytest.mark.parametrize("path", ["cv_objective", "batched_round", "batched_cv_round"])
def test_live_loss_plot_in_stacked_rounds(monkeypatch, path):
    """A stacked round plots each trial (each CV fold of each suggestion):
    every plot holds one training and one validation loss per epoch, and a
    suggestion's score is the mean of its plots' least validation losses."""
    tuner, plots = _recording_tuner(monkeypatch, use_cv=path != "batched_round")
    group = [LOSS_PARAMS, {**LOSS_PARAMS, "lr": 0.003}]
    if path == "cv_objective":
        group = group[:1]
        results = [tuner.objective(LOSS_PARAMS)]
    elif path == "batched_round":
        results = tuner._run_parallel_group(group)
    else:
        results = tuner._run_parallel_group_cv(group)
    per = len(plots) // len(group)
    assert per == (1 if path == "batched_round" else tuner.n_splits)
    for i, (loss, _, _) in enumerate(results):
        mine = plots[i * per:(i + 1) * per]
        assert all(p.hyperparams == group[i] for p in mine)
        assert all(len(p.train_losses) == len(p.val_losses) == 3 for p in mine)
        assert np.isfinite([p.train_losses for p in mine]).all()
        assert loss == np.mean([min(p.val_losses) for p in mine])
    for plot in plots:
        plot.close()
