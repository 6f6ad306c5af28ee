"""Milliseconds of host issue per stacked step in the trial engine's
optimizer: the total of the program's ``optim.update`` spans (the SR-bf16
Adam update and the copy back into the stacked parameters) over its
``engine.steps`` counter. Host clock, no synchronisation. From the profiled
job; nothing where the program records no spans."""


def read(run):
    try:
        from flexynesis_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans, counters = recorded()
    steps = counters.get("engine.steps", 0)
    if not steps:
        return None
    total = sum(t1 - t0 for name, _, t0, t1 in spans if name == "optim.update" and t1 is not None)
    return total / 1e6 / steps
