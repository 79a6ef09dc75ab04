"""Labels of a robot that translates, judged against its swept region:
`reference.exact.swept_robot` against a closed form, a sampler that steps
the motion in time and the static probability at zero motion; a robot per
row in `core.compare`; a labeler that leaves the motion out seen as not
correct; the control's rows taken from the cell's entry."""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest
import torch
from scipy.stats import norm

from benchmark import control
from benchmark.core import compare, spec
from benchmark.gen import rows
from benchmark.reference import exact, labeler
from benchmark.tests.conftest import tiny

ROBOT = exact.rect_vertices(4.07, 1.74)
SEED = 2**31 + 77


def _motion(seed: int, count: int):
    """The port's trajectory draws: velocity U(-2, 2)^2 in the obstacle
    frame and t_max U(0.5, 3)."""
    g = rows.generator(seed, "motion", "cpu")
    velocity = torch.rand((count, 2), generator=g) * 4.0 - 2.0
    t_max = torch.rand(count, generator=g) * 2.5 + 0.5
    return velocity.numpy(), t_max.numpy()


def _kgon_rows(seed: int, count: int) -> dict:
    cfg = dict(spec.resolve("kgon8.polylabel").config, rows_per_file=count)
    return rows.kgon_file(cfg, seed, 0, "cpu")


def _cdf_band(x, half, s):
    return norm.cdf((x + half) / s) - norm.cdf((x - half) / s)


def test_swept_rectangle_is_closed_form():
    # An unrotated robot (or one turned by pi / 2), dtheta ~ N(0, 1e-9^2) and
    # a motion along x: the overlap region is the rectangle widened by |v t|
    # along x and centred half way along the motion.
    rng = np.random.default_rng(4)
    n = 8
    pos = rng.uniform(-5, 5, (n, 2))
    w, h = rng.uniform(0.1, 5, n), rng.uniform(0.1, 5, n)
    sd = np.stack([rng.uniform(0.1, 0.5, n), rng.uniform(0.1, 0.5, n),
                   np.full(n, 1e-9)], 1)
    theta = np.where(np.arange(n) % 2 == 0, 0.0, np.pi / 2)
    vx, t_max = rng.uniform(-2, 2, n), rng.uniform(0.5, 3, n)
    velocity = np.stack([vx, np.zeros(n)], 1)
    d = exact.displacement(theta, velocity, t_max)
    p = exact.collision_probability(pos, theta, exact.swept_robot(ROBOT, d),
                                    exact.rect_vertices(w, h), sd)
    move = vx * t_max
    robot_x = np.where(theta == 0, 4.07, 1.74)
    robot_y = np.where(theta == 0, 1.74, 4.07)
    want = (_cdf_band(pos[:, 0] + move / 2, (robot_x + np.abs(move) + w) / 2, sd[:, 0])
            * _cdf_band(pos[:, 1], (robot_y + h) / 2, sd[:, 1]))
    np.testing.assert_allclose(p, want, rtol=1e-7, atol=1e-12)


def _normals(v):
    e = np.roll(v, -1, axis=-2) - v
    return np.stack([e[..., 1], -e[..., 0]], -1)


def _stepped_mc(pos, theta, obstacle, sd, move, n, instants, rng):
    """P(hit) of a robot at ``pos`` turned by ``theta`` whose centre moves by
    ``move`` (obstacle frame), over ``n`` pose draws of the obstacle held
    fixed during the motion, the robot tested at ``instants`` evenly spaced
    times by the separating-axis test."""
    z = rng.standard_normal((n, 3)) * sd
    c, s = np.cos(z[:, 2])[:, None], np.sin(z[:, 2])[:, None]
    moved = np.stack([c * obstacle[:, 0] - s * obstacle[:, 1] + z[:, :1],
                      s * obstacle[:, 0] + c * obstacle[:, 1] + z[:, 1:2]], -1)
    cr, sr = np.cos(theta), np.sin(theta)
    placed = np.stack([cr * ROBOT[:, 0] - sr * ROBOT[:, 1] + pos[0],
                       sr * ROBOT[:, 0] + cr * ROBOT[:, 1] + pos[1]], -1)
    axes = np.concatenate([np.broadcast_to(_normals(placed), (n, 4, 2)),
                           _normals(moved)], axis=1)
    robot_proj = axes @ placed.T                                  # (n, A, 4)
    obstacle_proj = (axes[:, :, None, :] * moved[:, None, :, :]).sum(-1)
    rate = axes @ move                                            # (n, A)
    r_lo, r_hi = robot_proj.min(-1), robot_proj.max(-1)
    o_lo, o_hi = obstacle_proj.min(-1), obstacle_proj.max(-1)
    hit = np.zeros(n, bool)
    for t in np.linspace(0.0, 1.0, instants):
        shift = t * rate
        hit |= ((r_hi + shift >= o_lo) & (o_hi >= r_lo + shift)).all(-1)
    return hit.mean()


def test_swept_probability_against_a_stepped_sampler():
    count = 64
    f = _kgon_rows(SEED, count)
    velocity, t_max = _motion(SEED, count)
    args = [f[k].astype(np.float64) for k in ("position", "pose_theta")]
    obstacle, sd = f["obstacle_verts"].astype(np.float64), f["std_dev"].astype(np.float64)
    static = exact.collision_probability(*args, ROBOT, obstacle, sd)
    d = exact.displacement(f["pose_theta"], velocity, t_max)
    swept = exact.collision_probability(*args, exact.swept_robot(ROBOT, d), obstacle, sd)
    rows_ = np.flatnonzero((np.abs(swept - static) > 0.02) & (swept > 0.02)
                           & (swept < 0.98))[:6]
    assert len(rows_) == 6
    n = 20_000
    zs = []
    for i in rows_:
        m = _stepped_mc(args[0][i], args[1][i], obstacle[i], sd[i],
                        velocity[i].astype(np.float64) * float(t_max[i]), n, 257,
                        np.random.default_rng(int(i)))
        zs.append((m - swept[i]) / np.sqrt(swept[i] * (1 - swept[i]) / n))
    assert np.max(np.abs(zs)) < 4, zs


def test_zero_displacement_is_the_static_probability():
    # At d = 0 exactly the two zero-length edges add no panel edge, so the
    # sum is the static one to rounding. At a d near 0 they do, and the
    # quadrature's panel sensitivity (about 1e-6, PERF.md) is all that
    # separates the two: the swept probability is continuous as d -> 0.
    count = 128
    f = _kgon_rows(SEED + 1, count)
    args = (f["position"], f["pose_theta"])
    static = exact.collision_probability(*args, ROBOT, f["obstacle_verts"], f["std_dev"])
    still = exact.swept_robot(ROBOT, np.zeros((count, 2)))
    assert still.shape == (count, 6, 2)
    got = exact.collision_probability(*args, still, f["obstacle_verts"], f["std_dev"])
    assert ((static > 1e-6) & (static < 1 - 1e-6)).sum() > 20
    assert np.max(np.abs(got - static)) <= 1e-12
    d = np.random.default_rng(7).standard_normal((count, 2))
    d *= 1e-9 / np.linalg.norm(d, axis=1, keepdims=True)
    near = exact.collision_probability(*args, exact.swept_robot(ROBOT, d),
                                       f["obstacle_verts"], f["std_dev"])
    assert np.max(np.abs(near - static)) <= 2e-6


def test_a_robot_per_row_of_the_fixed_robot_gives_the_same_numbers():
    count = 96
    f = _kgon_rows(SEED + 2, count)
    rng = np.random.default_rng(6)
    n = rng.integers(1_000, 100_000, count)
    cp = (rng.integers(0, n + 1) / n).astype(np.float32)
    geometry = lambda idx: (f["position"][idx], f["pose_theta"][idx],  # noqa: E731
                            f["obstacle_verts"][idx], f["std_dev"][idx])
    common = dict(cp=cp, n=n, converged=np.ones(count, bool), rows_bad=0,
                  geometry=geometry)
    cfg = spec.resolve("kgon8.polylabel").config
    fixed = compare.compare(compare.Labeled(robot_verts=f["robot_verts"], **common),
                            cfg, 5, 64, 8)
    per_row = np.repeat(f["robot_verts"][None], count, axis=0)
    by_row = compare.compare(compare.Labeled(robot_verts=per_row, **common),
                             cfg, 5, 64, 8)
    assert fixed == by_row
    assert fixed["z2_mean"] > 0


def test_labels_that_leave_the_motion_out_are_not_correct():
    cell = tiny("kgon8.polylabel")
    cfg, count = cell.config, 256
    f = _kgon_rows(SEED + 3, count)
    velocity, t_max = _motion(SEED + 3, count)
    swept = exact.swept_robot(f["robot_verts"],
                              exact.displacement(f["pose_theta"], velocity, t_max))
    geometry = lambda idx: (f["position"][idx], f["pose_theta"][idx],  # noqa: E731
                            f["obstacle_verts"][idx], f["std_dev"][idx])
    limits = cell.workload["limits"]

    def judged(robot):
        cp, n, done = labeler.label(
            f["position"], f["pose_theta"], robot, f["obstacle_verts"], f["std_dev"],
            seed=11, accuracy_bins=cfg["accuracy_bins"],
            bin_accuracy=cfg["bin_accuracy"], max_samples=cfg["max_samples"],
            device="cpu")
        lab = compare.Labeled(cp=cp, n=n, converged=done, rows_bad=0,
                              robot_verts=swept, geometry=geometry)
        return compare.verdict(compare.compare(lab, cfg, SEED, count, 8), limits)

    ok, checks = judged(swept.astype(np.float32))
    assert ok, checks
    ok, checks = judged(f["robot_verts"])
    assert not ok, checks


def test_control_takes_the_entrys_rows(monkeypatch):
    count = 12
    f = _kgon_rows(SEED + 4, count)
    swept = exact.swept_robot(f["robot_verts"], np.full((count, 2), 0.5)
                              ).astype(np.float32)
    own = (f["position"], f["pose_theta"], swept, f["obstacle_verts"], f["std_dev"])
    asked = []

    def control_rows(cell, seed, n, device):
        asked.append((cell.name, seed, n, device))
        return own

    stub = types.ModuleType("benchmark.entries._swept_stub")
    stub.control_rows = control_rows
    monkeypatch.setitem(sys.modules, stub.__name__, stub)
    cell = tiny("kgon8.polylabel")
    cell.traffic = {"entry": "_swept_stub"}
    cell.workload.update(sample_rows=count, top_rows=2)
    assert control.inputs(cell, 9, count, "cpu") is own
    assert asked == [(cell.name, 9, count, "cpu")]

    seen = {}

    def label(position, robot_theta, robot_verts, *args, **kwargs):
        seen["labeler"] = robot_verts
        return (np.zeros(count, np.float32), np.full(count, 1_000),
                np.ones(count, bool))

    def judge(lab, *args):
        seen["lab"] = lab
        return {}

    monkeypatch.setattr(labeler, "label", label)
    monkeypatch.setattr(compare, "compare", judge)
    control.measure(cell, 9, "float32", "cpu")
    assert seen["labeler"] is swept
    assert seen["lab"].robot_verts is swept


@pytest.mark.parametrize("name", ["rect_ref.generate", "kgon8.polylabel"])
def test_the_entries_control_rows_give_the_configurations_robot(name):
    cell = tiny(name)
    got = control.inputs(cell, 3, 16, "cpu")
    assert len(got) == 5 and np.array_equal(got[2], rows.robot_vertices(cell.config))
    assert all(len(a) == 16 for a in got[:2] + got[3:])
