"""Shared fixtures of the benchmark's own tests (``python -m pytest portbench``).

``tiny_cell`` shrinks a cell of ``BENCHMARK.json`` to a size the CPU runs in
seconds (the same files, fewer rows, features, trials and epochs); ``card``
skips a test without a CUDA card, deciding when the test runs.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def shrink(cell, tmp_path):
    from portbench import core  # noqa: F401  (the path above first)

    cfg = dict(cell.config, n_train=160, n_test=40, features={"gex": 40, "cnv": 20},
               hpo_iter=8, epochs=2, batch_size=16)
    traffic = dict(cell.traffic)
    space_path = cell.space_path
    if traffic["kind"] == "tune":
        traffic["trials_per_round"] = 4
        space = (cell.space_path.read_text().replace("[10]", "[2]").replace("[5]", "[2]")
                 .replace("[64], name: batch_size", "[16], name: batch_size")
                 .replace("[64], name: latent_dim", "[8], name: latent_dim"))
        space_path = tmp_path / f"{cell.name}.space.yaml"
        space_path.write_text(space)
    else:
        traffic["profiled_passes"] = 2
    return dataclasses.replace(cell, config=cfg, traffic=traffic, space_path=space_path)


@pytest.fixture
def tiny_cell(tmp_path):
    from portbench import core

    def make(name):
        return shrink(core.load_cell(name), tmp_path)
    return make


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda", 0)
