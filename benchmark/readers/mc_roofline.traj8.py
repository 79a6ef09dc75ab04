"""mc_roofline.traj8 (%): the fused trajectory k-gon Monte Carlo kernel's
(kernel 14's) share of its roofline: the least time for the window's
useful samples (the frozen per-sample count of `roofline.window` at the
configuration's k against its robot) over the kernel's summed device
time."""

from benchmark.gen import rows
from benchmark.roofline import counts, window

KERNEL = "mc_moving_poly_counts_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    cfg, c = ctx.cell.config, ctx.counters
    robot = rows.robot_vertices(cfg)
    ops = window.window_ops_per_sample(cfg["k"], window.distinct_axes(robot), len(robot))
    return counts.roofline_percent(c["samples_used"] * ops,
                                   c["rows"] * window.window_row_bytes(cfg["k"]),
                                   ctx.trace.kernel_seconds(KERNEL))
