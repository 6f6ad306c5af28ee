"""Marker finding's FLOPs over the window's seconds, against the card's dense
TF32 peak (``work.py``): per pass, the forward of every IG point and one
input gradient per class. From the traced run's window, before the profiler
starts."""

from portbench import work


def read(run):
    return work.mfu_pct(run.counters.get("flops", 0), run.window["seconds"])
