"""Milliseconds per step of the final full-data retrain (``Trainer``): the
retrain's time over its steps. Host clock, synchronised at both ends."""


def read(run):
    steps = run.counters.get("retrain_steps", 0)
    if not steps:
        return None
    return 1e3 * run.span_total("retrain") / steps
