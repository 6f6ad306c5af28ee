"""Milliseconds per marker-finding pass that the host spends building the
row table: the self time of the program's ``attribution.table`` spans (one
row per class and feature, less the ``host.wait`` readbacks of the sums)
over its ``attribution.passes`` counter. From the profiled passes; nothing
where the program records no spans."""


def read(run):
    try:
        from flexynesis_torch.utils.profiling import recorded
    except ImportError:
        return None
    spans, counters = recorded()
    passes = counters.get("attribution.passes", 0)
    if not passes:
        return None
    mine = {i for i, s in enumerate(spans) if s[0] == "attribution.table" and s[3] is not None}
    total = sum(spans[i][3] - spans[i][2] for i in mine)
    children = sum(t1 - t0 for _, parent, t0, t1 in spans if parent in mine and t1 is not None)
    return (total - children) / 1e6 / passes
