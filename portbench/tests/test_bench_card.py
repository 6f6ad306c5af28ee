"""On the card: each cell's control (the plain reference computed with TF32
products, in the program's place) fails at least one of the cell's limits,
at the cell's own size, while the program passes them on the same seed.

    python -m pytest portbench -m card      # on a machine with the card
"""

from __future__ import annotations

import pytest

from portbench import core
from portbench.trace import Tracer

CELLS = [w["name"] for w in core.manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(card, name):
    cell = core.load_cell(name)
    core.set_precision(cell.config)
    ctx = core.Context(cell.config, cell.traffic, Tracer(False), card, 2 ** 31 + 99,
                       cell.space_path, cell.model_module)
    run = core.traffic_class(cell.traffic["kind"])(ctx)
    try:
        run.setup()
        run.window(0.0)
    finally:
        run.close()
    ref = run.readings(control=False)
    program = run.gaps(run.program_readings(), ref)
    control = run.gaps(run.readings(control=True, seed_shift=1), ref)
    limits = cell.limits
    assert all(program[n] <= limits[n] for n in limits), program
    assert any(control[n] > limits[n] for n in limits if n in control), control
