"""The port's clustering helpers against flexynesis_tpu.utils.clustering
(sklearn and networkx underneath).

Held: KMeans labels equal to sklearn's ``KMeans(n_init="auto",
random_state=42)`` with the inertia within 1e-8 relative (float64 sums in
another order); ``get_optimal_clusters`` picks the same k with silhouettes
within 1e-8; Louvain partitions equal to networkx's (seed 42) on the kNN and
the threshold graph; AMI and ARI within 1e-10."""

import numpy as np
import pytest

from flexynesis_torch.utils import clustering as pc
from flexynesis_tpu.utils import clustering as jc
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL = 1e-8
AMI_TOL = 1e-10


def _blobs(seed, n=120, d=5, k=4, spread=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(k, d))
    lab = rng.integers(0, k, n)
    return centers[lab] + spread * rng.normal(size=(n, d)), lab


@pytest.mark.parametrize("seed,k", [(0, 3), (1, 5), (2, 8)])
def test_kmeans_equals_sklearn(seed, k):
    X, _ = _blobs(seed, spread=2.0)
    want_labels, want = jc.k_means_clustering(X, k)
    got_labels, got = pc.k_means_clustering(X, k, device="cpu")
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=RTOL)
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_, rtol=1e-10,
                               atol=1e-12)
    assert got.n_iter_ == want.n_iter_


def test_kmeans_float32_input_stays_float32():
    X, _ = _blobs(3)
    X32 = X.astype(np.float32)
    want_labels, want = jc.k_means_clustering(X32, 4)
    got_labels, got = pc.k_means_clustering(X32, 4, device="cpu")
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_allclose(got.inertia_, want.inertia_, rtol=1e-5)


def test_optimal_clusters_and_silhouette():
    X, _ = _blobs(4, k=3)
    wl, wk, wdf = jc.get_optimal_clusters(X, 2, 7)
    gl, gk, gtab = pc.get_optimal_clusters(X, 2, 7, device="cpu")
    assert gk == wk
    np.testing.assert_array_equal(gl, wl)
    assert gtab.columns == list(wdf.columns)
    np.testing.assert_array_equal(gtab.column("k"), wdf["k"].values)
    np.testing.assert_allclose(gtab.column("silhouette_score"), wdf["silhouette_score"].values,
                               rtol=RTOL)


@pytest.mark.parametrize("kw", [{"k": 10}, {"k": 4}, {"threshold": 3.0}])
def test_louvain_equals_networkx(kw):
    X, _ = _blobs(5, n=90, spread=1.5)
    wl, wg, wp = jc.louvain_clustering(X, **kw)
    gl, gg, gp = pc.louvain_clustering(X, device="cpu", **kw)
    assert gg.number_of_edges() == wg.number_of_edges()
    assert {(u, v) for u, v, _ in gg.edges()} == set(wg.edges())
    np.testing.assert_array_equal(gl, wl)
    assert gp == wp
    assert len(set(wp.values())) > 1


def test_modularity_equals_networkx():
    import networkx as nx

    X, _ = _blobs(6, n=40)
    _, wg, wp = jc.louvain_clustering(X, k=5)
    _, gg, gp = pc.louvain_clustering(X, k=5, device="cpu")
    comms = [{u for u, c in wp.items() if c == ci} for ci in sorted(set(wp.values()))]
    assert pc.modularity(gg, comms) == nx.community.modularity(wg, comms, weight="weight")


@pytest.mark.parametrize("seed", [0, 1])
def test_ami_ari(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, 150).astype(float)
    b = np.where(rng.random(150) < 0.6, a, rng.integers(0, 5, 150)).astype(object)
    a[:5] = np.nan
    b[7] = None
    want = jc.compute_ami_ari(a, b)
    got = pc.compute_ami_ari(a, b)
    np.testing.assert_allclose(got["ami"], want["ami"], rtol=AMI_TOL)
    np.testing.assert_allclose(got["ari"], want["ari"], rtol=AMI_TOL)
    assert pc.compute_ami_ari([1, 1, 2], [3, 3, 4]) == jc.compute_ami_ari([1, 1, 2], [3, 3, 4])


def test_scale_by_labels_and_summaries(capsys):
    X, lab = _blobs(7)
    np.testing.assert_allclose(pc.scale_and_standardize_by_labels(X, lab),
                               jc.scale_and_standardize_by_labels(X, lab), rtol=1e-12)

    class Model:
        feature_importances = {"y": [
            {"target_class": c, "name": f"f{i}", "importance": float(v)}
            for i, (c, v) in enumerate(zip([0, 1] * 10, np.random.default_rng(0).random(20)))]}

    import pandas as pd

    jm = Model()
    jm.feature_importances = {"y": pd.DataFrame(Model.feature_importances["y"])}
    want = jc.get_important_features(jm, "y", top=3).to_dict("records")
    assert pc.get_important_features(Model(), "y", top=3) == want
    with pytest.raises(ValueError, match="No feature importances"):
        pc.get_important_features(Model(), "z")


def test_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    X, _ = _blobs(0, n=20)
    for call in (lambda: pc.k_means_clustering(X, 3), lambda: pc.louvain_clustering(X, k=3),
                 lambda: pc.get_optimal_clusters(X, 2, 3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
