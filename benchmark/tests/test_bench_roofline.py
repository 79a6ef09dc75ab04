"""The frozen per-sample counts against a count by hand."""

from __future__ import annotations

import numpy as np

from benchmark.gen import rows
from benchmark.roofline import counts


def test_rect_count_by_hand():
    # sigma scaling 3, relative angle 1, cos and sin 2, offset 2, u and v 6,
    # the robot's two axes 2 x (2 mul + 2 add + compare), the obstacle's
    # two 2 x (turn 3 + reach 4 + compare)
    assert counts.rect_test_ops() == 3 + 1 + 2 + 2 + 6 + 10 + 16 == 40
    assert counts.rect_ops_per_sample() == 3 * 6 + 40 == 58


def test_kgon_count_by_hand():
    k, k2, axes = 8, 4, 2
    per_robot_axis = 3 * k + 3 + 2 * (k - 1) + 4       # 45
    per_obstacle_normal = 3 * k2 + 3 + 2 * (k2 - 1) + 4  # 25
    assert per_robot_axis == 45 and per_obstacle_normal == 25
    assert counts.kgon_test_ops(k, axes, k2) == 11 + 2 * 45 + 8 * 25 == 301
    assert counts.kgon_ops_per_sample(k, axes, k2) == 319


def test_robot_rectangle_has_two_axes():
    import importlib.util

    from benchmark.core import spec

    path = spec.HERE / "readers" / "mc_roofline.kgon.py"
    s = importlib.util.spec_from_file_location("kgon_reader", path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    assert m._axes(rows.robot_vertices({"robot_width": 4.07, "robot_height": 1.74})) == 2
    octagon = np.stack([np.cos(np.arange(8) * np.pi / 4),
                        np.sin(np.arange(8) * np.pi / 4)], -1)
    assert m._axes(octagon) == 4


def test_roofline_percent():
    assert counts.roofline_percent(67e12, 0, 2.0) == 50.0
    assert counts.roofline_percent(0, 3.35e12, 1.0) == 100.0
    assert counts.roofline_percent(1.0, 1.0, 0.0) is None
    assert counts.row_bytes(0) == 4 * 8 + 8 and counts.row_bytes(8) == 4 * 22 + 8
