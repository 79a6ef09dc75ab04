"""Frozen counts of one trajectory sample: a k-gon obstacle under pose
noise against a robot that translates over [0, t_max], by the exact
first-contact window on each separating axis. The conventions are
`roofline.counts`' (a fused multiply-add 2, a compare 1, a division 1, a
normal ``counts.NORMAL_OPS``, random bits uncounted), and like those counts
these count the work the label needs, whatever implements it.
"""

from __future__ import annotations

import numpy as np

from benchmark.roofline import counts

MOTION_FLOATS = 3  # velocity x, y and t_max of a row


def distinct_axes(verts: np.ndarray) -> int:
    """Distinct edge directions of a polygon (parallel edges share one)."""
    e = np.roll(verts, -1, axis=0) - verts
    ang = np.round(np.mod(np.arctan2(e[:, 1], e[:, 0]), np.pi), 9)
    return len(set(ang.tolist()))


def axis_window_ops() -> int:
    """One axis's window once its two intervals are placed: the two window
    ends (a subtraction and a division each, 4), their min and max (2),
    and the running max of the starts and min of the ends (2)."""
    return 4 + 2 + 2


def window_test_ops(k: int, robot_axes: int, k2: int) -> int:
    """One sample of a k-gon obstacle under pose noise against a robot of
    ``k2`` vertices with ``robot_axes`` distinct edge directions that
    translates by a fixed displacement over the horizon:

    - scale the three normals: 3; cosine and sine of dtheta: 2
    - the translation in the obstacle's frame, u1 and u2: 2 x 3
    - per robot axis: kernel 7's projections (the k obstacle vertices as
      cos P1 + sin P2, 3 each; the translation's projection, 3; min and
      max, 2 (k - 1)), the two shifted ends (2) and the axis's window; the
      motion's speed on a robot axis is the same for every sample of a row
      and is not counted
    - per obstacle edge normal: the same with the k2 robot vertices, and
      the motion's speed on the turned normal, cos a + sin b of two
      numbers of the row (3)
    - the hit: start <= end, start <= 1, end >= 0 (3)
    """
    per_robot_axis = 3 * k + 3 + 2 * (k - 1) + 2 + axis_window_ops()
    per_normal = 3 * k2 + 3 + 2 * (k2 - 1) + 2 + 3 + axis_window_ops()
    return 3 + 2 + 2 * 3 + robot_axes * per_robot_axis + k * per_normal + 3


def window_ops_per_sample(k: int, robot_axes: int, k2: int) -> int:
    return counts.POSE_NORMALS * counts.NORMAL_OPS + window_test_ops(k, robot_axes, k2)


def window_row_bytes(k: int) -> int:
    """`counts.row_bytes` and the row's motion in (3 floats)."""
    return counts.row_bytes(k) + 4 * MOTION_FLOATS
