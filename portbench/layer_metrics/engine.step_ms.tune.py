"""Milliseconds per stacked step of the trial engine: the time of all its
rounds (validation and pipelined asks inside them included) over all their
stacked steps. Host clock, rounds synchronised at both ends."""


def read(run):
    steps = run.counters.get("stacked_steps", 0)
    if not steps:
        return None
    return 1e3 * run.span_total("round") / steps
