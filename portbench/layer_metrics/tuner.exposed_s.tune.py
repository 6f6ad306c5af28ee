"""Seconds per tuning job outside the trial engine's rounds and the retrain:
GP asks the rounds did not hide, bucketing, templates, the tuner's own
bookkeeping. Host clock, spans synchronised at both ends, from the window."""


def read(run):
    jobs = run.counters.get("jobs", 0)
    if not jobs:
        return None
    outside = run.span_total("job") - run.span_total("round") - run.span_total("retrain")
    return outside / jobs
