"""A class module for the port's GNN (early fusion), for the harness's tests
only: ``test_bench_gnn.py`` copies it into a temporary ``classes/`` as
``GNN.py``.

It gives what a graph class gives the harness: the cohort as a
``MultiOmicDatasetNW`` (every layer over the same gene names, an edge list
made from the configuration's ``network_seed``), node masks of (B, N, E) at
each site's own rate (0.2 after each convolution, ``ops/graph_conv.py``, and
the configuration's dropout in the head), a flatten readout whose columns
are one block of E a node, and products counted from the dataset's graph.
Its ``train_loss_and_grads`` and ``eval_loss`` stand in for a plain GCN: they
run the port's own ``GNNNet.forward_with`` on the reference's leaves, GC
convolution, multiplying in exactly the keep masks they are handed.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.adapt import Blocks
from portbench.classes import _mlp
from portbench.data import to_dataset
from portbench.reference import directpred
from portbench.reference.init import law as init_law  # noqa: F401  (torch's law everywhere)

ARCH = ("latent_dim", "node_embedding_dim", "num_convs", "supervisor_hidden_dim")
CONV_DROPOUT = 0.2     # FlexGCN's dropout after each convolution
_LEAF = {"weight": "g", "bias": "beta", "running_mean": "rm", "running_var": "rv"}


def network(cfg: dict) -> Tuple[list, dict]:
    """(gene names, the interaction table): each gene joined to the next
    (a ring, so every gene is a node) and to ``extra_edges`` partners drawn
    from ``network_seed``."""
    n = len(_genes(cfg))
    rng = np.random.default_rng(int(cfg["network_seed"]))
    src = np.concatenate([np.arange(n), rng.integers(0, n, int(cfg["extra_edges"]))])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.integers(0, n, int(cfg["extra_edges"]))])
    genes = _genes(cfg)
    return genes, {"protein1": [genes[i] for i in src], "protein2": [genes[i] for i in dst]}


def _genes(cfg: dict) -> list:
    sizes = set(int(f) for f in cfg["features"].values())
    if len(sizes) != 1:
        raise ValueError("every layer is over the same genes")
    return [f"G{j}" for j in range(sizes.pop())]


def dataset(cohort, split: str, cfg: dict):
    from flexynesis_torch.data.dataset import MultiOmicDatasetNW

    genes, table = network(cfg)
    base = to_dataset(cohort, split, cfg["target"])
    base.features = {layer: list(genes) for layer in base.features}
    return MultiOmicDatasetNW(base, table, node_names=genes)


def arch_of(cfg: dict) -> dict:
    return {k: cfg[k] for k in ARCH}


def widths(arch: dict, input_dims: dict) -> dict:
    return {"E": int(arch["node_embedding_dim"]), "latent": int(arch["latent_dim"]),
            "sup": max(int(arch["supervisor_hidden_dim"]), 2),
            "nodes": next(iter(input_dims.values())), "convs": int(arch["num_convs"])}


def canon(name: str) -> Optional[str]:
    """``encoder.conv_<i>.lin_root.weight`` -> ``enc.conv_<i>.root.W``,
    ``encoder.bn_<i>.weight`` -> ``enc.bn_<i>.g``, ``encoder.fc.bias`` ->
    ``enc.fc.b``; heads and loss weights as the MLP classes name them."""
    if name.endswith("num_batches_tracked"):
        return None
    if not name.startswith("encoder."):
        return _mlp.canon(name)
    parts = name.split(".")[1:]
    leaf = parts[-1]
    if parts[0].startswith("bn_"):
        return f"enc.{parts[0]}.{_LEAF[leaf]}"
    w = "W" if leaf == "weight" else "b"
    if parts[0] == "fc":
        return f"enc.fc.{w}"
    return f"enc.{parts[0]}.{parts[1][len('lin_'):]}.{w}"


def rows_of(name: str, w: dict):
    parts = name.split(".")
    role, leaf = parts[0], parts[-1]
    E, lat, sup = w["E"], w["latent"], w["sup"]
    if role == "logvar":
        return None, None
    if role == "head":
        return {"W1": (sup, lat), "W2": (None, sup), "b2": (None, None)}.get(leaf, (sup, None))
    if parts[1] == "fc":
        return (lat, Blocks(w["nodes"], E)) if leaf == "W" else (lat, None)
    first = parts[1] == "conv_0"
    return (E, None if first else E) if leaf == "W" else (E, None)


def keep_width(block: str, w: dict) -> int:
    return w["sup"] if block.startswith("head.") else w["E"]


def matmul_shapes(arch: dict, input_dims: Sequence[int], n_classes: int,
                  dataset=None) -> list:
    """Per sample, as (in, out) pairs whose product is the multiply-adds:
    each GC convolution's root and neighbour products over the nodes, its
    aggregation by the graph's edges (one a distinct edge and feature), the
    flatten readout and the head."""
    if dataset is None:
        raise TypeError("a graph's products are counted from the dataset's edges")
    n = len(dataset.node_names)
    src, dst = np.asarray(dataset.edge_index)
    edges = len(np.unique(dst.astype(np.int64) * n + src))
    E, lat = int(arch["node_embedding_dim"]), int(arch["latent_dim"])
    sup = max(int(arch["supervisor_hidden_dim"]), 2)
    shapes, f = [], len(input_dims)
    for _ in range(int(arch["num_convs"])):
        shapes += [(n * f, E), (n * f, E), (edges, f)]
        f = E
    return shapes + [(n * E, lat), (lat, sup), (sup, n_classes)]


def noise_sites() -> list:
    """The single model's dropout: ``models/gnn.py`` binds its own name."""
    from flexynesis_torch.models import gnn

    return [(gnn, "dropout", "keep")]


def noise_blocks(layers, target, cfg, w) -> list:
    """(block, rate) in draw order: each of the trial's convolutions' node
    masks, then the head's."""
    convs = [(f"enc.conv_{i}", CONV_DROPOUT) for i in range(w["convs"])]
    return convs + [(f"head.{target}", float(cfg["dropout"]))]


def _convs(p) -> int:
    """The convolutions of the trial whose leaves are ``p``."""
    return sum(1 for n in p if n.startswith("enc.bn_") and n.endswith(".g"))


def _net(p, target, cfg):
    """The port's network at the widths and depth of ``p`` (structure only,
    on the meta device) and the program's names of the reference's leaves."""
    from flexynesis_torch.models.gnn import GNNNet

    with torch.device("meta"):
        net = GNNNet(n_nodes=len(_genes(cfg)), n_node_feats=len(cfg["features"]),
                     node_embedding_dim=p["enc.bn_0.g"].shape[0],
                     latent_dim=p["enc.fc.W"].shape[0], num_convs=_convs(p),
                     conv_type="GC", activation="relu", readout="flatten",
                     supervisor_hidden_dim=p[f"head.{target}.W1"].shape[0],
                     output_dims={target: p[f"head.{target}.W2"].shape[0]})
    names = {canon(n): n for n in net.state_dict() if canon(n) is not None}
    return net, names


def _logits(p, stats, x, layers, target, keeps, cfg):
    """The target's logits; in training (``keeps`` given) ``stats`` takes the
    moved running statistics."""
    from flexynesis_torch.ops.graph_conv import build_operator

    net, names = _net(p, target, cfg)
    train = keeps is not None
    nodes = torch.stack([x[ln] for ln in layers], dim=-1)
    dtype = nodes.dtype
    genes, table = network(cfg)
    pos = {g: i for i, g in enumerate(genes)}
    edges = np.array([[pos[g] for g in table["protein1"]], [pos[g] for g in table["protein2"]]])
    adj = torch.as_tensor(build_operator(edges, len(genes), "GC"), dtype=dtype,
                          device=nodes.device)
    params = {names[n]: t for n, t in p.items()}
    buffers = {names[n]: t.clone() for n, t in stats.items()}
    rates = [r for _, r in noise_blocks(layers, target, cfg, {"convs": _convs(p)})]
    masks = iter(zip(keeps or [], rates))

    def drop(h, rate):
        keep, own_rate = next(masks)
        return h * keep / (1.0 - own_rate)

    out = net.forward_with(params, buffers, {"all": nodes.reshape(nodes.shape[0], -1)}, adj,
                           train, drop if train else None)
    if train:
        stats.update({n: buffers[names[n]] for n in stats})
    return out["outputs"][target]


def train_loss_and_grads(p, stats, x, y, layers, target, draws, cfg):
    keeps = [t for kind, t in draws if kind == "keep"]
    leaves = {n: t.detach().clone().requires_grad_(True) for n, t in p.items()}
    logits = _logits(leaves, stats, x, layers, target, keeps, cfg)
    total = directpred.total_loss({target: directpred.cross_entropy(logits, y)}, leaves)
    grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
    return float(total.detach()), {n: torch.zeros_like(t) if g is None else g
                                   for (n, t), g in zip(leaves.items(), grads)}


@torch.no_grad()
def eval_loss(p, stats, x, y, layers, target, draws, cfg) -> float:
    return float(directpred.cross_entropy(
        _logits(p, dict(stats), x, layers, target, None, cfg), y))


@torch.no_grad()
def eval_forward(p, stats, x, layers, target, cfg):
    return _logits(p, dict(stats), x, layers, target, None, cfg)
