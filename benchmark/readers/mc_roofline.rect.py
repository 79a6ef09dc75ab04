"""mc_roofline.rect (%): the fused rectangle Monte Carlo kernel's share of
its roofline: the least time for the window's useful samples (the frozen
per-sample count of `roofline.counts`) over the kernel's summed device
time."""

from benchmark.roofline import counts

KERNEL = "mc_counts_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    c = ctx.counters
    return counts.roofline_percent(c["samples_used"] * counts.rect_ops_per_sample(),
                                   c["rows"] * counts.row_bytes(0),
                                   ctx.trace.kernel_seconds(KERNEL))
