"""Seconds per tuning job that the host spent blocked on the card: the
total of the program's ``host.wait`` spans (readbacks, copies from pageable
memory) over its ``tuner.jobs`` counter. From the profiled job; nothing
where the program records no spans."""


def read(run):
    try:
        from flexynesis_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans, counters = recorded()
    jobs = counters.get("tuner.jobs", 0)
    if not jobs:
        return None
    total = sum(t1 - t0 for name, _, t0, t1 in spans if name == "host.wait" and t1 is not None)
    return total / 1e9 / jobs
