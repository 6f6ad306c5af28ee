"""Kernel B3 (the Gaussian-kernel MMD) against its roofline: the least time
of every B3 call of the profiled job (``work.py``; a prior shared by the
trials read once) over the profiler's device time of B3's CUDA function.
Nothing when B3 did not run."""

NAMES = ("gaussian_kernel_mean_kernel",)


def read(run):
    from portbench import work

    return work.share_pct(run.least.get("b3", 0.0), run.kernel_seconds(NAMES))
