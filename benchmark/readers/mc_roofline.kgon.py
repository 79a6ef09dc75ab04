"""mc_roofline.kgon (%): the fused k-gon Monte Carlo kernel's share of its
roofline: the least time for the window's useful samples (the frozen
per-sample count of `roofline.counts` at the configuration's k against its
robot) over the kernel's summed device time."""

import numpy as np

from benchmark.gen import rows
from benchmark.roofline import counts

KERNEL = "mc_poly_counts_kernel"


def _axes(verts: np.ndarray) -> int:
    """Distinct edge directions of a polygon (parallel edges share one)."""
    e = np.roll(verts, -1, axis=0) - verts
    ang = np.round(np.mod(np.arctan2(e[:, 1], e[:, 0]), np.pi), 9)
    return len(set(ang.tolist()))


def read(ctx):
    if ctx.trace is None:
        return None
    cfg, c = ctx.cell.config, ctx.counters
    robot = rows.robot_vertices(cfg)
    ops = counts.kgon_ops_per_sample(cfg["k"], _axes(robot), len(robot))
    return counts.roofline_percent(c["samples_used"] * ops,
                                   c["rows"] * counts.row_bytes(cfg["k"]),
                                   ctx.trace.kernel_seconds(KERNEL))
