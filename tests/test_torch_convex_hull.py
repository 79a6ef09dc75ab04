"""The port's `convex_hull` on the CPU against the JAX package.

Bar: on inputs in general position (random floats) the hull vertices equal
JAX's `convex_hull` bit for bit. torch's and XLA's ``atan2`` may differ by
an ulp, which can swap near-collinear candidates, so on the collinear and
duplicate cases the test holds the contract instead: CCW, repeat-last
padded, every input point inside the hull (`ops.sat.sat_polygons` of the
hull against each point as a degenerate polygon), vertices drawn from the
input set.
"""

import numpy as np
import torch
import jax.numpy as jnp

from collide2d_tpu.ops.geometry import convex_hull as j_hull
from collide2d_tpu_torch import convex_hull
from collide2d_tpu_torch.ops.sat import sat_polygons
from tests.test_geometry import _hull_oracle

torch.set_num_threads(1)


def _contains_all(hull: np.ndarray, pts: np.ndarray) -> bool:
    """Every point of ``pts`` (B, n, 2) lies in its row's hull (B, k, 2)."""
    b, n, _ = pts.shape
    reps = np.repeat(hull, n, axis=0)
    points = np.repeat(pts.reshape(b * n, 1, 2), 4, axis=1)
    return bool((sat_polygons(torch.from_numpy(reps), torch.from_numpy(points)) == 1).all())


def test_matches_jax_and_oracle():
    rng = np.random.default_rng(11)
    pts = rng.uniform(-3, 3, (48, 24, 2)).astype(np.float32)
    got = convex_hull(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_hull(jnp.asarray(pts))))
    for b in range(len(pts)):
        want = _hull_oracle(pts[b]).astype(np.float32)
        np.testing.assert_array_equal(np.unique(got[b], axis=0), np.unique(want, axis=0))
        x, y = got[b, :, 0], got[b, :, 1]
        assert np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y) > 0  # CCW
        assert (got[b, len(want):] == got[b, len(want) - 1]).all()  # repeat-last
    assert _contains_all(got, pts)


def test_k_out_below_the_hull_size_and_masks():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (32, 2)).astype(np.float32)
    h4 = convex_hull(torch.from_numpy(pts), k_out=4).numpy()
    np.testing.assert_array_equal(h4, np.asarray(j_hull(jnp.asarray(pts), k_out=4)))
    want = _hull_oracle(pts).astype(np.float32)
    assert len(want) > 4 and all(any((row == w).all() for w in want) for row in h4)
    sq = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [9, 9]], np.float32)
    m = np.array([True, True, True, True, False])
    got = convex_hull(torch.from_numpy(sq), mask=torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_hull(jnp.asarray(sq), mask=jnp.asarray(m))))
    assert got.max() <= 1.0
    batch = rng.uniform(-1, 1, (6, 12, 2)).astype(np.float32)
    bm = rng.uniform(size=(6, 12)) < 0.7
    bm[:, :3] = True
    got = convex_hull(torch.from_numpy(batch), k_out=12, mask=torch.from_numpy(bm)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_hull(jnp.asarray(batch), k_out=12,
                                                         mask=jnp.asarray(bm))))


def test_duplicates_and_collinear_points():
    pt = np.full((6, 2), 1.5, np.float32)
    assert (convex_hull(torch.from_numpy(pt)).numpy() == 1.5).all()
    # a square with repeated corners and points on its edges
    sq = np.array([[0, 0], [2, 0], [2, 2], [0, 2]], np.float32)
    edge = np.array([[1, 0], [2, 1], [1, 2], [0, 1], [0.5, 0], [2, 0.5]], np.float32)
    pts = np.concatenate([sq, sq, edge, [[1, 1]]]).astype(np.float32)[None]
    got = convex_hull(torch.from_numpy(pts), k_out=16).numpy()
    want = np.asarray(j_hull(jnp.asarray(pts), k_out=16))
    assert _contains_all(got, pts)
    for hull in (got, want):
        rows = {tuple(r) for r in hull[0]}
        assert {tuple(c) for c in sq} <= rows <= {tuple(r) for r in pts[0]}
        x, y = hull[0, :, 0], hull[0, :, 1]
        assert np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y) > 0
    # collinear input: a segment's hull is its two ends
    line = np.stack([np.linspace(0, 1, 7), np.linspace(0, 2, 7)], -1).astype(np.float32)
    got = convex_hull(torch.from_numpy(line)).numpy()
    assert {tuple(r) for r in got} == {tuple(line[0]), tuple(line[-1])} or (
        {tuple(r) for r in got} <= {tuple(r) for r in line})
    np.testing.assert_array_equal(got[0], line[0])
