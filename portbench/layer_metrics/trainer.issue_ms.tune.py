"""Milliseconds of host issue per step of the final retrain (``Trainer``):
the self time of the program's ``trainer.step`` spans over its
``trainer.steps`` counter. Host clock, no synchronisation. From the
profiled job; nothing where the program records no spans."""


def read(run):
    try:
        from flexynesis_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans, counters = recorded()
    steps = counters.get("trainer.steps", 0)
    if not steps:
        return None
    mine = {i for i, s in enumerate(spans) if s[0] == "trainer.step" and s[3] is not None}
    total = sum(spans[i][3] - spans[i][2] for i in mine)
    children = sum(t1 - t0 for _, parent, t0, t1 in spans if parent in mine and t1 is not None)
    return (total - children) / 1e6 / steps
