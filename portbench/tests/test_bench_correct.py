"""The comparison that decides ``correct``, driven through a whole run on the
CPU at a small size (the look for a card skipped): the program agrees with
the plain reference within the cells' limits, and each fault that a cell
can have, planted in the timed path underneath, makes ``correct`` false."""

from __future__ import annotations

import pytest
import torch

from portbench import core

CELLS = [w["name"] for w in core.manifest()["workloads"]]
TUNE = [c for c in CELLS if core.load_cell(c).traffic["kind"] == "tune"]
MARKERS = [c for c in CELLS if core.load_cell(c).traffic["kind"] == "markers"]
SEED = 2 ** 32 + 12345


def run(cell):
    result, checks = core.run_cell(cell, SEED, 0.2, False, torch.device("cpu"))
    return result, {c.name: c for c in checks}


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference(tiny_cell, name):
    result, checks = run(tiny_cell(name))
    assert result["correct"], {n: (c.value, c.limit) for n, c in checks.items()}


def _stale(monkeypatch):
    """A step that returns its state unchanged."""
    from flexynesis_torch.parallel import trials
    from flexynesis_torch.train import trainer

    monkeypatch.setattr(trials, "trial_update_step",
                        lambda params, state, grads, lr, seed, **kw: (list(params), state))
    monkeypatch.setattr(trainer.ClippedAdam, "step", lambda self, grads: None)


def _half(monkeypatch):
    """Half of every batch left out, the mean taken over the rest."""
    from flexynesis_torch.parallel import trials
    from flexynesis_torch.train import trainer

    for mod, name in ((trials, "_gather"), (trainer, "gather")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda data, rows, orig=orig:
                            orig(data, rows[..., : rows.shape[-1] // 2]))


def _altered(monkeypatch):
    """One trial's validation loss altered where it is produced."""
    from flexynesis_torch.parallel import trials

    orig = trials._Round.validate

    def validate(self, batch):
        out = orig(self, batch).clone()
        out[0] = out[0] * 1.01
        return out
    monkeypatch.setattr(trials._Round, "validate", validate)


def _scaled_start(monkeypatch):
    """A start the program works out wrong: one leaf of every trial scaled."""
    from flexynesis_torch.parallel import trials

    orig = trials._init_stacked

    def init(model, seeds, stacked=None):
        params, buffers = orig(model, seeds, stacked)
        largest = max(params, key=lambda n: params[n].numel())
        return {**params, largest: params[largest] * 1.5}, buffers
    monkeypatch.setattr(trials, "_init_stacked", init)


def _keep_rate(monkeypatch):
    """Dropout at twice the rate the model states."""
    from flexynesis_torch.models import supervised_vae
    from flexynesis_torch.ops import mlp
    from flexynesis_torch.parallel import stacked

    orig = stacked.TrialNoise.dropout
    monkeypatch.setattr(stacked.TrialNoise, "dropout",
                        lambda self, h, rate: orig(self, h, 2 * rate))
    for mod in (mlp, supervised_vae):
        monkeypatch.setattr(mod, "dropout", lambda x, rate, generator, orig=mod.dropout:
                            orig(x, 2 * rate, generator))


def _half_cohort(monkeypatch):
    """Half of the cohort attributed, the mean taken over it."""
    from flexynesis_torch.interpret import attribution

    orig = attribution.abs_attribution_sums

    def sums(model, dataset, *a, **kw):
        half = dataset.subset(range(len(dataset) // 2))
        return orig(model, half, *a, **kw)
    monkeypatch.setattr(attribution, "abs_attribution_sums", sums)


def _altered_importance(monkeypatch):
    """One importance altered where it is produced (doubled)."""
    from flexynesis_torch.interpret import attribution

    orig = attribution.compute_feature_importance

    def rows(*a, **kw):
        out = orig(*a, **kw)
        out[5] = dict(out[5], importance=out[5]["importance"] * 2.0)
        return out
    monkeypatch.setattr(attribution, "compute_feature_importance", rows)


FAULTS = ([(n, f) for n in TUNE for f in (_stale, _half, _altered, _scaled_start, _keep_rate)]
          + [(n, f) for n in MARKERS for f in (_half_cohort, _altered_importance)])


@pytest.mark.parametrize("name,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(tiny_cell, monkeypatch, name, fault):
    cell = tiny_cell(name)
    fault(monkeypatch)
    result, checks = run(cell)
    assert not result["correct"]
