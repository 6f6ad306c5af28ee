"""The port's graph layer (flexynesis_torch/ops/graph_conv.py, data/graph.py,
MultiOmicDatasetNW) against the JAX package's, on the same numpy inputs and
the same weights (carried across by flexynesis_torch.convert.from_flax):

* ``build_operator`` and ``build_sparse_operator`` for every conv type equal
  JAX's arrays exactly, duplicate edges, explicit self-edges, isolated nodes
  and padding included;
* ``DenseGraphConvLayer`` forward and parameter gradients for the four conv
  types, dense and sparse, against JAX (rtol/atol 1e-5; gradients atol 1e-5
  times the largest gradient);
* ``FlexGCN`` in training mode (batch statistics over batch x nodes, dropout
  off on both sides) and eval mode, for the four conv types x dense/sparse x
  both readouts: outputs, running statistics and gradients against JAX at
  the same tolerances, and the port's sparse path against its dense path;
* the graph readers: ``read_user_graph`` on files with other column names,
  separators, a score column or none gives JAX's columns; the STRING loader
  over the vendored fixtures (a warm cache) gives JAX's edges, and again
  from the port's own cache file;
* ``MultiOmicDatasetNW``: node names, node tensor (nanmedian fill), edge
  index, flattened view and subset equal JAX's exactly.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from flexynesis_tpu.data import graph as jax_graph
from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.data.dataset import MultiOmicDatasetNW as JaxNW
from flexynesis_tpu.ops import graph_conv as jgc
from flexynesis_torch.convert import from_flax
from flexynesis_torch.data import graph as port_graph
from flexynesis_torch.data.dataset import MultiOmicDataset, MultiOmicDatasetNW
from flexynesis_torch.ops import graph_conv as pgc

CONV_TYPES = ["GCN", "SAGE", "GC", "GAT"]
TOL = dict(rtol=1e-5, atol=1e-5)
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def random_graph(n_nodes=50, n_edges=200, seed=0):
    """Random edges with an isolated last node, duplicates and a self-edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes - 1, n_edges)
    dst = rng.integers(0, n_nodes - 1, n_edges)
    src = np.concatenate([src, src[:5], [3]])
    dst = np.concatenate([dst, dst[:5], [3]])
    return np.stack([src, dst])


@pytest.mark.parametrize("conv_type", CONV_TYPES)
@pytest.mark.parametrize("pad", [64, 512])
def test_operators_equal_jax(conv_type, pad):
    n = 50
    ei = random_graph(n)
    np.testing.assert_array_equal(pgc.build_operator(ei, n, conv_type),
                                  jgc.build_operator(ei, n, conv_type))
    got = pgc.build_sparse_operator(ei, n, conv_type, pad_multiple=pad)
    want = jgc.build_sparse_operator(ei, n, conv_type, pad_multiple=pad)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["w"]) % pad == 0 and np.all(np.diff(got["dst"]) >= 0)


def test_operator_corner_cases():
    """GAT adds self-loops (an isolated node attends to itself), GCN doubles
    an explicit self-edge, padded edges carry w = 0 at the last node."""
    n = 6
    ei = np.array([[0, 0, 0, 2], [1, 1, 1, 2]])
    gat = pgc.build_operator(ei, n, "GAT")
    assert np.all(np.diag(gat) == 1.0) and gat[1, 0] == 1.0
    gcn_sp = pgc.build_sparse_operator(ei, n, "GCN", pad_multiple=16)
    recon = np.zeros((n, n), np.float32)
    np.add.at(recon, (gcn_sp["dst"], gcn_sp["src"]), gcn_sp["w"])
    np.testing.assert_allclose(recon, pgc.build_operator(ei, n, "GCN"), atol=1e-7)
    e = int(np.count_nonzero(gcn_sp["w"]))
    assert np.all(gcn_sp["dst"][e:] == n - 1) and np.all(gcn_sp["w"][e:] == 0)


def _operators(ei, n, conv_type):
    dense = pgc.build_operator(ei, n, conv_type)
    sparse = pgc.build_sparse_operator(ei, n, conv_type, pad_multiple=64)
    return {"dense": (jnp.asarray(dense), pgc.operator_to(dense, "cpu")),
            "sparse": (jax.tree.map(jnp.asarray, sparse), pgc.operator_to(sparse, "cpu"))}


def _grad_check(port_named, jax_grads, jax_stats=None):
    want = {k: v for k, v in from_flax(jax.tree.map(np.asarray, jax_grads),
                                       jax_stats or {}).items()
            if "running" not in k and "num_batches" not in k}
    assert set(want) == set(port_named)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, g in port_named.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5 * max(scale, 1.0), err_msg=name)


@pytest.mark.parametrize("conv_type", CONV_TYPES)
@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_conv_layer_matches_jax(conv_type, form):
    n, b, f, out = 50, 4, 3, 8
    ei = random_graph(n, seed=3)
    jadj, padj = _operators(ei, n, conv_type)[form]
    x = np.random.default_rng(3).normal(size=(b, n, f)).astype(np.float32)
    jlayer = jgc.DenseGraphConvLayer(out_dim=out, conv_type=conv_type)
    jparams = jlayer.init(jax.random.key(4), jnp.asarray(x), jadj)["params"]
    if conv_type == "GAT":  # a nonzero bias, so its gradient path is live
        jparams = {**jparams, "bias": jnp.linspace(-0.3, 0.3, out)}

    def jloss(p):
        return jnp.sum(jnp.square(jlayer.apply({"params": p}, jnp.asarray(x), jadj)))

    jy = jlayer.apply({"params": jparams}, jnp.asarray(x), jadj)
    jgrads = jax.grad(jloss)(jparams)

    layer = pgc.DenseGraphConvLayer(f, out, conv_type)
    layer.load_state_dict(from_flax(jparams, {}))
    params = dict(layer.named_parameters())
    y = layer.forward_with(params, torch.from_numpy(x), padj)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    grads = torch.autograd.grad(y.square().sum(), list(params.values()))
    _grad_check(dict(zip(params, grads)), jgrads)


def _flexgcn_pair(conv_type, readout, n, f, seed=5):
    jnet = jgc.FlexGCN(n_nodes=n, node_embedding_dim=8, output_dim=6, num_convs=2,
                       conv_type=conv_type, readout=readout, dropout_rate=0.0)
    x0 = jnp.zeros((2, n, f), jnp.float32)
    variables = jnet.init(jax.random.key(seed), x0, jnp.eye(n), train=False)
    net = pgc.FlexGCN(n, f, 8, 6, num_convs=2, conv_type=conv_type, readout=readout,
                      dropout_rate=0.0)
    net.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    return jnet, variables, net


@pytest.mark.parametrize("conv_type", CONV_TYPES)
@pytest.mark.parametrize("readout", ["flatten", "mean"])
def test_flexgcn_train_and_eval_match_jax(conv_type, readout):
    """Training mode (batch statistics over batch x nodes, the running ones
    updated 0.9/0.1 with the biased variance) and eval mode, dense and
    sparse, against JAX; the port's sparse path equals its dense path."""
    n, b, f = 40, 5, 2
    ei = random_graph(n, n_edges=120, seed=9)
    ops = _operators(ei, n, conv_type)
    x = np.random.default_rng(1).normal(size=(b, n, f)).astype(np.float32)
    jnet, variables, _ = _flexgcn_pair(conv_type, readout, n, f)
    port_out = {}
    for form, (jadj, padj) in ops.items():
        def jloss(p):
            y, mut = jnet.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), jadj, train=True, mutable=["batch_stats"])
            return jnp.sum(jnp.square(y)), (y, mut["batch_stats"])

        (_, (jy, jstats)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            variables["params"])
        jeval = jnet.apply(variables, jnp.asarray(x), jadj, train=False)

        _, _, net = _flexgcn_pair(conv_type, readout, n, f)
        params = dict(net.named_parameters())
        buffers = dict(net.named_buffers())
        y = net.forward_with(params, buffers, torch.from_numpy(x), padj, True,
                             lambda h, rate: h)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
        grads = torch.autograd.grad(y.square().sum(), list(params.values()))
        _grad_check(dict(zip(params, grads)), jgrads, jstats)
        for i in range(2):
            np.testing.assert_allclose(buffers[f"bn_{i}.running_mean"].numpy(),
                                       np.asarray(jstats[f"bn_{i}"]["mean"]), **TOL)
            np.testing.assert_allclose(buffers[f"bn_{i}.running_var"].numpy(),
                                       np.asarray(jstats[f"bn_{i}"]["var"]), **TOL)
        _, _, net = _flexgcn_pair(conv_type, readout, n, f)
        with torch.no_grad():
            ye = net.forward_with(dict(net.named_parameters()), dict(net.named_buffers()),
                                  torch.from_numpy(x), padj, False, None)
        np.testing.assert_allclose(ye.numpy(), np.asarray(jeval), **TOL)
        port_out[form] = (y.detach(), ye, [g.detach() for g in grads])
    np.testing.assert_allclose(port_out["sparse"][0], port_out["dense"][0], **TOL)
    np.testing.assert_allclose(port_out["sparse"][1], port_out["dense"][1], **TOL)
    for gs, gd in zip(port_out["sparse"][2], port_out["dense"][2]):
        np.testing.assert_allclose(gs, gd, rtol=1e-5,
                                   atol=1e-5 * max(float(gd.abs().max()), 1.0))


# ---------------------------------------------------------------- readers


def _edges_of(df_or_cols):
    return (list(df_or_cols["protein1"]), list(df_or_cols["protein2"]))


@pytest.mark.parametrize("header,sep,rows", [
    (["GeneA", "GeneB", "Score"], ",", [("TP53", "MDM2", "0.9"), ("BRCA1", "BRCA2", "0.5"),
                                        ("EGFR", "KRAS", "bad")]),
    (["source", "target"], "\t", [("TP53", "MDM2"), ("A", "B"), ("B", "C")]),
    (["protein_1", "partner", "weight"], ";", [("X1", "X2", "3"), ("X2", "X3", "NA")]),
    (["node1", "node2", "combined_score", "extra"], "|",
     [("g1", "g2", "700", "z"), ("g2", "g3", "400", "y")]),
    (["from", "to", "conf"], " ", [("1", "2", "0.1"), ("2", "3", "0.2")]),
])
def test_read_user_graph_matches_jax(tmp_path, header, sep, rows):
    path = tmp_path / "graph.txt"
    path.write_text("\n".join(sep.join(r) for r in [header, *rows]) + "\n")
    want = jax_graph.read_user_graph(str(path))
    got = port_graph.read_user_graph(str(path))
    assert _edges_of(got) == _edges_of(want)
    np.testing.assert_array_equal(got["weight"], want["weight"].to_numpy(np.float64))


@pytest.fixture()
def string_cache(tmp_path):
    """A warm cache: the fixture files where the loaders' fetch would put
    downloads, so nothing touches the network."""
    for kind in ("links", "aliases"):
        shutil.copy(os.path.join(FIXTURES, "string", f"9606.protein.{kind}.v12.0.txt.gz"),
                    tmp_path / f"9606.{kind}.txt.gz")
    return tmp_path


@pytest.mark.parametrize("node_name", ["gene_name", "gene_id", "protein_id"])
def test_string_matches_jax(string_cache, node_name, tmp_path_factory):
    jax_root = tmp_path_factory.mktemp("jax_cache")
    for f in os.listdir(string_cache):
        shutil.copy(string_cache / f, jax_root / f)
    want = jax_graph.STRING(root=str(jax_root), node_name=node_name).graph_df
    got = port_graph.STRING(root=str(string_cache), node_name=node_name).graph_df
    assert _edges_of(got) == _edges_of(want)
    np.testing.assert_array_equal(got["combined_score"], want["combined_score"].to_numpy())
    # the second load reads the port's own cache file
    cached = port_graph.STRING(root=str(string_cache), node_name=node_name).graph_df
    assert _edges_of(cached) == _edges_of(want)
    links = os.path.join(FIXTURES, "string", "9606.protein.links.v12.0.txt.gz")
    for k in (1, 2, 5):
        w = jax_graph.read_stringdb_links(links, 400, k)
        g = port_graph.read_stringdb_links(links, 400, k)
        assert _edges_of(g) == _edges_of(w)
    aliases = os.path.join(FIXTURES, "string", "9606.protein.aliases.v12.0.txt.gz")
    assert (port_graph.read_stringdb_aliases(aliases, "gene_name")
            == jax_graph.read_stringdb_aliases(aliases, "gene_name"))


# ---------------------------------------------------------------- NW dataset


def nw_arrays(seed=0, n=12):
    """gex over genes g0..g29, cnv over g20..g44 (shared names, as users'
    GNN folders have them), NaN cells, a gene column all NaN in gex."""
    rng = np.random.default_rng(seed)
    gex = rng.normal(size=(n, 30)).astype(np.float32)
    cnv = rng.normal(size=(n, 25)).astype(np.float32)
    gex[rng.random(gex.shape) < 0.1] = np.nan
    gex[:, 4] = np.nan
    return dict(
        dat={"gex": gex, "cnv": cnv},
        ann={"subtype": rng.integers(0, 3, n).astype(np.float32)},
        variable_types={"subtype": "categorical"},
        features={"gex": [f"g{i}" for i in range(30)],
                  "cnv": [f"g{i}" for i in range(20, 45)]},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {0: "a", 1: "b", 2: "c"}},
    )


def nw_graph(seed=0):
    rng = np.random.default_rng(seed)
    genes = [f"g{i}" for i in range(50)] + ["notinomics"]
    a = rng.choice(genes, 80)
    b = rng.choice(genes, 80)
    return {"protein1": list(a), "protein2": list(b)}


def test_nw_dataset_matches_jax():
    arrays = nw_arrays()
    graph = nw_graph()
    want = JaxNW(JaxDataset(**arrays), pd.DataFrame(graph))
    got = MultiOmicDatasetNW(MultiOmicDataset(**arrays), graph)
    assert got.node_names == want.node_names
    np.testing.assert_array_equal(got.node_features, want.node_features)
    np.testing.assert_array_equal(got.edge_index, want.edge_index)
    np.testing.assert_array_equal(got.dat["all"], want.dat["all"])
    assert got.features == want.features and len(got) == len(want)
    idx = np.array([5, 1, 7])
    gs, ws = got.subset(idx), want.subset(idx)
    np.testing.assert_array_equal(gs.dat["all"], ws.dat["all"])
    assert gs.samples == ws.samples
    np.testing.assert_array_equal(gs.ann["subtype"], ws.ann["subtype"])
    # a pinned node set (the test split reusing the train nodes)
    pinned = MultiOmicDatasetNW(MultiOmicDataset(**nw_arrays(1)), graph,
                                node_names=got.node_names)
    jpinned = JaxNW(JaxDataset(**nw_arrays(1)), pd.DataFrame(graph),
                    node_names=want.node_names)
    np.testing.assert_array_equal(pinned.node_features, jpinned.node_features)
    np.testing.assert_array_equal(pinned.edge_index, jpinned.edge_index)
