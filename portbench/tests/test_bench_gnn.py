"""A graph class fits the tuning harness by a class module alone: a tiny GNN
tuning cell, built in memory from ``vae_tune_fixed``'s cell with a class
module for the port's GNN in a temporary ``classes/`` (``gnn_stand_in.py``),
runs whole on the CPU and is ``correct`` in a same-architecture round, whose
node masks (B, N, E) the trials share, and in a two-architecture round
(node embeddings of 4 and 8), whose masks (D, B, N, E_max) carry a draw
axis and are cut to each trial's own E."""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path

import pytest
import torch

from conftest import shrink

from portbench import core
from portbench.traffic import tune

SEED = 2 ** 32 + 22
SPACE = """GNN:
  - {{type: Categorical, categories: [8], name: latent_dim}}
  - {{type: Categorical, categories: {embedding}, name: node_embedding_dim}}
  - {{type: Categorical, categories: [2], name: num_convs}}
  - {{type: Real, low: 0.0001, high: 0.01, prior: log-uniform, name: lr}}
  - {{type: Categorical, categories: [8], name: supervisor_hidden_dim}}
  - {{type: Categorical, categories: [2], name: epochs}}
  - {{type: Categorical, categories: [16], name: batch_size}}
  - {{type: Categorical, categories: [relu], name: activation}}
"""


def gnn_cell(tmp_path, monkeypatch, embedding):
    """``vae_tune_fixed``'s cell at a tiny size with the GNN's configuration,
    space and class module: 12 genes in both layers, K = 4 trials."""
    cell = shrink(core.load_cell("vae_tune_fixed"), tmp_path)
    classes = tmp_path / "classes"
    classes.mkdir()
    shutil.copy(Path(__file__).with_name("gnn_stand_in.py"), classes / "GNN.py")
    monkeypatch.setattr(core, "CLASSES", classes)
    cfg = dict(cell.config, model_class="GNN", features={"gex": 12, "cnv": 12},
               latent_dim=8, node_embedding_dim=max(embedding), num_convs=2,
               supervisor_hidden_dim=8, network_seed=7, extra_edges=12)
    space = tmp_path / "gnn.space.yaml"
    space.write_text(SPACE.format(embedding=list(embedding)))
    # tuner seed 41: the first round's four suggestions mix both embeddings
    return dataclasses.replace(cell, config=cfg, traffic=dict(cell.traffic, tuner_seed=41),
                               space_path=space, model_module=core.model_module("GNN"))


@pytest.mark.parametrize("embedding,per_draw", [((8,), False), ((4, 8), True)],
                         ids=["shared", "two_architectures"])
def test_gnn_cell_is_correct(tmp_path, monkeypatch, embedding, per_draw):
    runs = []

    class Kept(tune.Tune):
        def __init__(self, ctx):
            super().__init__(ctx)
            runs.append(self)
    monkeypatch.setattr(core, "traffic_class", lambda kind: Kept)
    cell = gnn_cell(tmp_path, monkeypatch, embedding)
    result, checks = core.run_cell(cell, SEED, 0.2, False, torch.device("cpu"))
    assert result["correct"], {c.name: (c.value, c.limit) for c in checks}
    rec = runs[0].round_rec
    assert sorted({a["node_embedding_dim"] for a in rec.arch}) == list(embedding)
    # each convolution's node mask and the head's, with a draw axis where
    # the trials do not share one seed; a batch of 16 rows over 12 genes
    assert (len(set(rec.seeds)) > 1) == per_draw
    keeps = [t.shape for kind, t in rec.noise[0] if kind == "keep"]
    lead = (len(set(rec.seeds)),) if per_draw else ()
    assert keeps == [(*lead, 16, 12, 8)] * 2 + [(*lead, 16, 8)]
    assert result["window"]["flops"] > 0


def test_gnn_products_follow_the_graph(tmp_path, monkeypatch):
    """The work of a graph class is counted from its dataset: the aggregation
    by the distinct edges of the graph that ``dataset`` built."""
    cell = gnn_cell(tmp_path, monkeypatch, (8,))
    mm, cfg = cell.model_module, cell.config
    from portbench.data import make_cohort

    ds = mm.dataset(make_cohort(cfg, SEED, torch.device("cpu")), "train", cfg)
    arch = mm.arch_of(cfg)
    shapes = mm.matmul_shapes(arch, [12, 12], 4, dataset=ds)
    edges = len({(int(s), int(d)) for s, d in ds.edge_index.T})
    assert (edges, 2) in shapes and (edges, 8) in shapes
    with pytest.raises(TypeError, match="edges"):
        mm.matmul_shapes(arch, [12, 12], 4)
