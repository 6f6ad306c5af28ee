"""The whole tuning job's model FLOPs over the window's seconds, against the
card's dense TF32 peak (``work.py``): forward plus backward of every trial
step at its own unpadded architecture, every validation forward and the
retrain's steps. From the traced run's window, before the profiler starts."""

from portbench import work


def read(run):
    return work.mfu_pct(run.counters.get("flops", 0), run.window["seconds"])
