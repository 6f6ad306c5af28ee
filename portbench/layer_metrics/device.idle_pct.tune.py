"""The share of the profiled tuning job in which no operation ran on the
card: 100 x (1 - busy / window), busy from the union of the profiler's
device intervals."""


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
