"""Share of the trial engine's stacked steps whose SR-bf16 Adam update went
through the hand-written kernel (``flexynesis_torch/kernels/sr_adam.py``):
the program's ``optim.fused`` counter over its ``engine.steps`` counter.
From the profiled job; nothing where the program records no spans or has no
such kernel."""

import importlib.util


def read(run):
    try:
        from flexynesis_torch.utils.profiling import recorded
    except ImportError:
        return None
    if importlib.util.find_spec("flexynesis_torch.kernels.sr_adam") is None:
        return None
    spans, counters = recorded()
    steps = counters.get("engine.steps", 0)
    if not steps:
        return None
    return counters.get("optim.fused", 0) / steps
