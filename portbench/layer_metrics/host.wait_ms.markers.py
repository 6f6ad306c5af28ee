"""Milliseconds per marker-finding pass that the host spent blocked on the
card: the total of the program's ``host.wait`` spans (the copies of the
cohort and of the IG nodes to the card, the readbacks of the sums) over its
``attribution.passes`` counter. From the profiled passes; nothing where the
program records no spans."""


def read(run):
    try:
        from flexynesis_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans, counters = recorded()
    passes = counters.get("attribution.passes", 0)
    if not passes:
        return None
    total = sum(t1 - t0 for name, _, t0, t1 in spans if name == "host.wait" and t1 is not None)
    return total / 1e6 / passes
