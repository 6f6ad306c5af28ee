"""Milliseconds of host issue per stacked step of the trial engine: the
self time of the program's ``engine.step`` spans (each ``rnd.train_step``
of a round, less its children: the optimizer's ``optim.update`` and any
``host.wait``) over its ``engine.steps`` counter. The spans never
synchronise, so this is the host's time to issue a step, not the card's.
From the profiled job; nothing where the program records no spans."""


def read(run):
    try:
        from flexynesis_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans, counters = recorded()
    steps = counters.get("engine.steps", 0)
    if not steps:
        return None
    mine = {i for i, s in enumerate(spans) if s[0] == "engine.step" and s[3] is not None}
    total = sum(spans[i][3] - spans[i][2] for i in mine)
    children = sum(t1 - t0 for _, parent, t0, t1 in spans if parent in mine and t1 is not None)
    return (total - children) / 1e6 / steps
