"""Trial k's noise from the draws a captured step recorded (``Tune._keeps``),
on synthetic draws: for the MLP classes' (B, H) and (D, B, H) shapes the
rule that read the draw axis from the rank, kept here as the oracle; a
graph's node masks, shared (B, N, E_max) and per draw (D, B, N, E_max), cut
to each trial's (B, N, E_k); and each block, as many as the trial's
convolutions, thresholded at its own rate."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

import gnn_stand_in as gnn
from portbench import core
from portbench.traffic.tune import Tune

B, D, P = 6, 3, 5
TARGET = "subtype"
DIMS = {"gex": 20, "cnv": 10}
CFG = {"target": TARGET, "dropout": 0.1}


def harness(mm, layers):
    run = Tune.__new__(Tune)
    run.mm, run.layers, run.cfg = mm, layers, CFG
    return run


def oracle(mm, seeds, draws, k, w, stacked):
    """The rule that read the draw axis from the rank: a 3-dimensional draw
    of a stacked step is per draw; every keep mask thresholded at the
    configuration's dropout and cut on axis 1."""
    rate = float(CFG["dropout"])
    blocks = iter(block for block, _ in mm.noise_blocks(list(DIMS), TARGET, CFG, w))
    first = {}
    draw = [first.setdefault(int(s), len(first)) for s in seeds][k]
    out = []
    for kind, t in draws:
        if stacked and t.dim() == 3:
            t = t[draw]
        if kind == "keep":
            t = (t >= rate)[:, :mm.keep_width(next(blocks), w)].float()
        out.append((kind, t.float()))
    return out


def _mlp_draws(model_class, per_draw, gen, w_max):
    """The draws of one step of ``model_class`` in the order its model makes
    them, each (kind, shape)."""
    lead = (D,) if per_draw else ()
    lat, sup = w_max["latent"], w_max["sup"]
    if model_class == "DirectPred":
        shapes = [("keep", (B, w_max["hidden"][ln])) for ln in DIMS] + [("keep", (B, sup))]
    else:   # eps, the head's dropout, one prior a decoded layer
        shapes = [("normal", (B, lat)), ("keep", (B, sup))] + [("normal", (P, lat))] * len(DIMS)
    return [(kind, (torch.rand if kind == "keep" else torch.randn)(
        (*lead, *shape), generator=gen)) for kind, shape in shapes]


ARCHS = [{"latent_dim": lat, "hidden_dim_factor": fac, "supervisor_hidden_dim": sup}
         for lat, fac, sup in ((8, 0.5, 4), (4, 0.3, 8), (8, 0.2, 2), (6, 0.5, 8))]
# (model class, what was captured, per draw): a round's step with its noise
# shared by the trials or drawn per seed, a validation's priors (shared by
# the trials, in a round of one seed or of several), the retrain's step
MLP_CASES = [(mc, what, per_draw) for mc in ("DirectPred", "supervised_vae")
             for what, per_draw in (("round", False), ("round", True), ("validation", False),
                                    ("validation", True), ("retrain", False))
             if (mc, what) != ("DirectPred", "validation")]   # which draws nothing


@pytest.mark.parametrize("model_class,what,per_draw", MLP_CASES,
                         ids=lambda v: str(v) if not isinstance(v, bool) else
                         ("per_draw" if v else "shared"))
def test_mlp_draws_as_before(model_class, what, per_draw):
    mm = core.model_module(model_class)
    run = harness(mm, list(DIMS))
    gen = torch.Generator().manual_seed(22)
    stacked = what != "retrain"
    archs = ARCHS if per_draw else [ARCHS[0]] * len(ARCHS)
    widths = [mm.widths(a, DIMS) for a in archs]
    w_max = {"hidden": {ln: max(w["hidden"][ln] for w in widths) for ln in DIMS},
             "latent": max(w["latent"] for w in widths), "sup": max(w["sup"] for w in widths)}
    draws = _mlp_draws(model_class, per_draw and what == "round", gen, w_max)
    if what == "validation":
        draws = [(kind, t) for kind, t in draws if kind == "normal"][1:]
    seeds = [3, 3, 4, 5] if per_draw else [3] * 4
    rec = SimpleNamespace(seeds=seeds)
    for k, w in enumerate(widths if stacked else widths[:1]):
        got = run._keeps(rec, draws, k, w, what == "round")
        want = oracle(mm, seeds, draws, k, w, stacked)
        assert [kind for kind, _ in got] == [kind for kind, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("per_draw", [False, True], ids=["shared", "per_draw"])
def test_node_masks_cut_to_each_trial(per_draw):
    """Trials that share a seed share a draw; trial k's mask is (B, N, E_k)
    of its draw, at the convolutions' rate."""
    N, e_max, sup = 7, 8, 4
    embeddings = [4, 8, 4, 8] if per_draw else [e_max] * 4
    seeds = [5, 5, 6, 7] if per_draw else [5] * 4
    lead = (D,) if per_draw else ()
    gen = torch.Generator().manual_seed(23)
    u = [torch.rand((*lead, B, N, e_max), generator=gen) for _ in range(2)]
    head = torch.rand((*lead, B, sup), generator=gen)
    recorded = [("keep", t) for t in (*u, head)]
    run = harness(gnn, list(DIMS))
    rec = SimpleNamespace(seeds=seeds)
    draw_of = [0, 0, 1, 2] if per_draw else [None] * 4
    for k, e in enumerate(embeddings):
        w = {"E": e, "latent": 8, "sup": sup, "nodes": N, "convs": 2}
        got = [t for _, t in run._keeps(rec, recorded, k, w, True)]
        own = [t if draw_of[k] is None else t[draw_of[k]] for t in (*u, head)]
        assert [t.shape for t in got] == [(B, N, e), (B, N, e), (B, sup)]
        for mask, t in zip(got[:2], own[:2]):
            assert torch.equal(mask, (t[..., :e] >= gnn.CONV_DROPOUT).float())
        assert torch.equal(got[2], (own[2] >= CFG["dropout"]).float())


@pytest.mark.parametrize("per_draw", [False, True], ids=["shared", "per_draw"])
@pytest.mark.parametrize("convs", [1, 2], ids=["one_conv", "two_convs"])
def test_each_block_at_its_own_rate(per_draw, convs):
    """Uniforms of 0.15 everywhere: dropped under each of the trial's
    convolutions' 0.2, kept under the head's 0.1, in one step."""
    lead = (D,) if per_draw else ()
    recorded = [("keep", torch.full((*lead, B, 3, 4), 0.15)) for _ in range(convs)]
    recorded.append(("keep", torch.full((*lead, B, 2), 0.15)))
    run = harness(gnn, list(DIMS))
    w = {"E": 4, "latent": 8, "sup": 2, "nodes": 3, "convs": convs}
    seeds = [1, 2, 3] if per_draw else [1] * 3
    masks = [t for _, t in run._keeps(SimpleNamespace(seeds=seeds), recorded, 1, w, True)]
    assert [m.shape for m in masks] == [(B, 3, 4)] * convs + [(B, 2)]
    assert [float(m.max()) for m in masks[:convs]] == [0.0] * convs
    assert float(masks[convs].min()) == 1.0
