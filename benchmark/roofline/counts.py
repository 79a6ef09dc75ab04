"""Frozen counts of the work one Monte Carlo sample needs, in FP32
operations (a fused multiply-add is 2, as the peak counts it; a sine, a
cosine, a compare each 1; an absolute value 0, an operand modifier on the
card). They count the work the labels need, whatever implements it, so a
kernel's roofline share moves only when its time does.

A normal costs a fixed ``NORMAL_OPS`` whatever method draws it: the
cheaper of the two the port has, a Box-Muller pair's 8 counted operations
and its log, square root, sine and cosine, over its two normals. The
random bits themselves are integer work and are not counted.
"""

from __future__ import annotations

import json
from pathlib import Path

NORMAL_OPS = 6
POSE_NORMALS = 3  # dx, dy, dtheta: the configurations have no shape noise


def rect_test_ops() -> int:
    """One sample of two rectangles, the obstacle under pose noise, by the
    separating-axis test in the robot's frame (the plain reference's
    arithmetic for 4-gons with parallel edges, utils.cu:159-184 done on the
    four distinct axes):

    - scale the three normals by their sigmas: 3
    - relative angle theta - dtheta: 1; its cosine and sine: 2
    - the obstacle centre relative to the robot, px - dx, py - dy: 2
    - that offset in the robot's frame, u and v: 2 x 3
    - the robot's two axes: |u| > hx + a|c| + b|s|, the same for v: 2 x 5
    - the obstacle's two axes: the offset turned by the relative angle
      (3) and the reach (4) and compare (1): 2 x 8
    """
    return 3 + 1 + 2 + 2 + 2 * 3 + 2 * 5 + 2 * 8


def kgon_test_ops(k: int, robot_axes: int, k2: int) -> int:
    """One sample of a k-gon obstacle under pose noise against a placed
    robot of ``k2`` vertices with ``robot_axes`` distinct edge directions:

    - scale the three normals: 3; cosine and sine of dtheta: 2
    - the translation in the obstacle's frame, u1 and u2: 2 x 3
    - per robot axis: the k obstacle vertices projected under the rotation
      as cos P1 + sin P2 (3 each), the translation's projection (3), min
      and max (2 (k - 1)), the two shifted ends and two compares (4)
    - per obstacle edge normal: the same with the k2 robot vertices
    """
    return (3 + 2 + 2 * 3 + robot_axes * (3 * k + 3 + 2 * (k - 1) + 4)
            + k * (3 * k2 + 3 + 2 * (k2 - 1) + 4))


def rect_ops_per_sample() -> int:
    return POSE_NORMALS * NORMAL_OPS + rect_test_ops()


def kgon_ops_per_sample(k: int, robot_axes: int, k2: int) -> int:
    return POSE_NORMALS * NORMAL_OPS + kgon_test_ops(k, robot_axes, k2)


def row_bytes(k: int) -> int:
    """Bytes a labeled row needs moved once: its configuration in (position
    2, angle 1, sigmas 3, and the obstacle: 2 extents or k vertices) and
    its label out (cp and the sample count, 4 bytes each)."""
    obstacle = 2 if k == 0 else 2 * k
    return 4 * (2 + 1 + 3 + obstacle) + 8


def peaks() -> dict:
    with open(Path(__file__).with_name("peaks.json")) as f:
        return json.load(f)


def roofline_percent(ops: float, nbytes: float, kernel_s: float) -> float | None:
    """100 x the least time the card could take for the work over the
    kernel's time; None when the kernel did not run."""
    if kernel_s <= 0:
        return None
    p = peaks()
    least = max(ops / p["fp32_flop_per_s"], nbytes / p["hbm_bytes_per_s"])
    return 100.0 * least / kernel_s
