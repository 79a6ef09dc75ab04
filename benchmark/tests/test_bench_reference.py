"""The plain reference: the exact probabilities against a closed case and
a seeded sampler, the stopping rule against hand values, the labeler's
labels against the exact probabilities."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy.stats import norm

from benchmark.core import compare
from benchmark.reference import exact, labeler, stopping

ROBOT = exact.rect_vertices(4.07, 1.74)


def test_axis_aligned_case_is_closed_form():
    # dtheta ~ N(0, 1e-9^2) and an unrotated robot: the overlap region is the
    # rectangle |dx - px| <= (4.07 + w) / 2, |dy - py| <= (1.74 + h) / 2.
    rng = np.random.default_rng(3)
    n = 6
    pos = rng.uniform(-5, 5, (n, 2))
    w, h = rng.uniform(0.1, 5, n), rng.uniform(0.1, 5, n)
    sd = np.stack([rng.uniform(0.1, 0.5, n), rng.uniform(0.1, 0.5, n),
                   np.full(n, 1e-9)], 1)
    p = exact.collision_probability(pos, np.zeros(n), ROBOT, exact.rect_vertices(w, h), sd)
    half_w, half_h = (4.07 + w) / 2, (1.74 + h) / 2
    want = ((norm.cdf((pos[:, 0] + half_w) / sd[:, 0]) - norm.cdf((pos[:, 0] - half_w) / sd[:, 0]))
            * (norm.cdf((pos[:, 1] + half_h) / sd[:, 1]) - norm.cdf((pos[:, 1] - half_h) / sd[:, 1])))
    np.testing.assert_allclose(p, want, rtol=1e-7, atol=1e-12)


def test_gaussian_mass_of_half_plane_and_far_polygon():
    big = 1e4
    half = np.array([[0.5, -big], [big, -big], [big, big], [0.5, big]])  # x >= 0.5
    assert exact.polygon_gaussian_mass(half) == pytest.approx(norm.sf(0.5), rel=1e-9)
    around = np.array([[-big, -big], [big, -big], [big, big], [-big, big]])
    assert exact.polygon_gaussian_mass(around) == pytest.approx(1.0, abs=1e-12)
    far = np.array([[20.0, 0.0], [21.0, 0.0], [21.0, 1.0], [20.0, 1.0]])
    assert exact.polygon_gaussian_mass(far) == pytest.approx(0.0, abs=1e-30)


def test_minkowski_sum_of_squares():
    sq = exact.rect_vertices(2.0, 2.0)
    got = exact.minkowski_sum(sq, sq)
    # the 4 corners of the 4 x 4 square, each edge split in two
    corners = {tuple(v) for v in np.round(got, 12)}
    assert corners == {(-2, -2), (0, -2), (2, -2), (2, 0), (2, 2), (0, 2), (-2, 2), (-2, 0)}


def _sat_mc(pos, theta, robot, obstacle, sd, n, rng):
    z = rng.standard_normal((n, 3)) * sd
    c, s = np.cos(z[:, 2])[:, None], np.sin(z[:, 2])[:, None]
    moved = np.stack([c * obstacle[:, 0] - s * obstacle[:, 1] + z[:, :1],
                      s * obstacle[:, 0] + c * obstacle[:, 1] + z[:, 1:2]], -1)
    cr, sr = np.cos(theta), np.sin(theta)
    placed = np.stack([cr * robot[:, 0] - sr * robot[:, 1] + pos[0],
                       sr * robot[:, 0] + cr * robot[:, 1] + pos[1]], -1)
    sep = np.zeros(n, bool)
    for poly in (np.broadcast_to(placed, moved.shape[:1] + placed.shape), moved):
        e = np.roll(poly, -1, axis=-2) - poly
        for i in range(poly.shape[-2]):
            a = np.stack([e[:, i, 1], -e[:, i, 0]], -1)
            pr = placed @ a.T  # (K2, n)
            po = np.einsum("nkd,nd->nk", moved, a)
            sep |= (pr.max(0) < po.min(1)) | (po.max(1) < pr.min(0))
    return 1.0 - sep.mean()


@pytest.mark.parametrize("k", [4, 8])
def test_against_a_sampler(k):
    rng = np.random.default_rng(10 + k)
    zs = []
    for _ in range(4):
        if k == 4:
            obstacle = exact.rect_vertices(rng.uniform(0.1, 5), rng.uniform(0.1, 5))
        else:
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            ab = rng.uniform(0.5, 2.5, 2)
            obstacle = np.stack([np.cos(ang) * ab[0], np.sin(ang) * ab[1]], -1)
        theta = rng.uniform(0, 2 * np.pi)
        sd = np.sqrt(rng.uniform(0.02, 0.3, 3))
        a, d = rng.uniform(0, 2 * np.pi), rng.uniform(2.5, 4.5)
        pos = np.array([d * np.cos(a), d * np.sin(a)])
        p = exact.collision_probability(pos[None], [theta], ROBOT, obstacle[None], sd[None])[0]
        n = 400_000
        m = _sat_mc(pos, theta, ROBOT, obstacle, sd, n, rng)
        zs.append((m - p) / np.sqrt(max(p * (1 - p), 1e-12) / n))
    assert np.max(np.abs(zs)) < 4.5, zs


def test_stopping_rule_by_hand():
    # Wald: 1.96 / n * sqrt(k - k^2 / n); rule of three ln(40) / n at k = 0
    assert stopping.slack(10_000, 5_000) == pytest.approx(1.96 / 1e4 * np.sqrt(2500))
    assert stopping.slack(1000, 0) == pytest.approx(np.log(40) / 1000)
    bins, acc = [0.0, 0.01, 0.1, 1.0], [1e-4, 1e-3, 1e-2]
    assert stopping.meets_rule(37_000, 0, bins, acc)       # 9.97e-5 <= 1e-4
    assert not stopping.meets_rule(36_000, 0, bins, acc)   # 1.02e-4
    assert stopping.meets_rule(10_000, 5_000, bins, acc)   # 9.8e-3 <= 1e-2
    assert not stopping.meets_rule(9_000, 4_500, bins, acc)
    # the bin of 0.01 is the last that holds it: [0.01, 0.1], 1e-3
    assert stopping.bin_accuracy(0.01, bins, acc) == 1e-3


def test_labeler_labels_agree_with_exact():
    rng = np.random.default_rng(5)
    n = 48
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, 8)), axis=1)
    ab = rng.uniform(0.5, 2.5, (n, 1, 2))
    obstacle = np.stack([np.cos(ang), np.sin(ang)], -1) * ab
    theta = rng.uniform(0, 2 * np.pi, n)
    sd = np.sqrt(rng.uniform(0, 0.3, (n, 3)))
    a, d = rng.uniform(0, 2 * np.pi, n), rng.uniform(2.5, 4.0, n)
    pos = np.stack([d * np.cos(a), d * np.sin(a)], 1)
    bins, acc = [0.0, 0.01, 0.1, 1.0], [0.003, 0.01, 0.03]
    cp, used, done = labeler.label(pos, theta, ROBOT, obstacle, sd, seed=1,
                                   accuracy_bins=bins, bin_accuracy=acc,
                                   max_samples=100_000, device="cpu")
    p = exact.collision_probability(pos, theta, ROBOT, obstacle, sd)
    miss, z2 = compare.label_stats(cp, used, p, bins, acc)
    assert done.all() and miss < 0.15 and z2 < 3.0
    k = np.round(cp.astype(np.float64) * used)
    assert stopping.meets_rule(used, k, bins, acc).all()


def test_labeler_precision_is_the_geometry_dtype():
    pos = np.array([[3.0, 0.5]], np.float32)
    args = (pos, np.array([0.3], np.float32), ROBOT, exact.rect_vertices([2.0], [1.0]),
            np.array([[0.3, 0.3, 0.2]], np.float32))
    kw = dict(seed=2, accuracy_bins=[0.0, 1.0], bin_accuracy=[0.05], max_samples=20_000,
              device="cpu")
    a = labeler.label(*args, dtype=torch.float32, **kw)
    b = labeler.label(*args, dtype=torch.bfloat16, **kw)
    assert a[1][0] > 0 and b[1][0] > 0
