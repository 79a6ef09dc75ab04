"""Trajectory counts for convex k-gons (`mc.moving.counts_chunk_moving_polygons`)
on the CPU, against the JAX package's `collide2d_tpu.mc.moving`.

- At zero motion the counts are bitwise the port's static k-gon chunk.
- On pinned threefry keys: translation-only counts equal JAX's except for
  at most 1 sample in 1e5; rotating counts (screened or the pure loop)
  differ by at most 2 per row and 1e-3 of all samples, and the stage-A
  masks on at most 1e-3 of lanes (the CPU's cos/sin ulp, as in
  tests/test_torch_moving.py).
- Chunking the configuration axis of the screen changes nothing.
- Screened counts are at least the pure loop's per row.
- Deterministic translations and a pure rotation give the analytic cp.
"""

import jax
import numpy as np
import pytest
import torch

from collide2d_tpu.mc import moving as jmoving
from collide2d_tpu_torch.mc import moving, prng
from collide2d_tpu_torch.mc.estimator import PolygonConfigs, _counts_chunk

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ROBOT = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87],
                  [-2.035, 0.87]], np.float32)


def _rows(seed, n, k=6, rotating=True):
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, k)), axis=-1)
    verts = np.stack([np.cos(ang), np.sin(ang)], -1) * rng.uniform(0.5, 3.0, (n, 1, 2))
    omega = rng.uniform(-0.5, 0.5, n) if rotating else np.zeros(n)
    return tuple(np.asarray(a, np.float32) for a in (
        rng.uniform(-4, 4, (n, 2)), rng.uniform(0, 7, n), verts,
        rng.uniform(0, 0.3, (n, 3)), rng.uniform(-2, 2, (n, 2)), omega,
        rng.uniform(0.5, 3, n)))


def _keys(n, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    words = np.asarray(jax.random.key_data(keys)).astype(np.int64)
    return keys, (torch.from_numpy(words[:, 0]), torch.from_numpy(words[:, 1]))


def test_constructors_match_jax():
    rows = _rows(1, 9)
    want = jmoving.moving_polygon_configs(*rows)
    for got in (moving.moving_polygon_configs(*rows),
                moving.moving_polygon_configs_from_numpy(want, "cpu")):
        for name in want._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
    with pytest.raises(ValueError, match="obstacle_verts"):
        moving.moving_polygon_configs(rows[0], 0.0, rows[2][:4], rows[3], 0.0)


def test_zero_motion_is_bitwise_the_static_chunk():
    pos, th, verts, sd, _, _, _ = _rows(2, 64)
    cfgs = moving.moving_polygon_configs(pos, th, verts, sd, 0.0, 0.0, 1.0)
    static = PolygonConfigs(*(torch.from_numpy(a) for a in (pos, th, verts, sd)))
    _, keys = _keys(64, 3)
    robot = torch.from_numpy(ROBOT)
    want = _counts_chunk(keys, static, robot, 128, False)
    for ca_iters in (0, 48):
        assert torch.equal(moving.counts_chunk_moving_polygons(
            keys, cfgs, robot, 128, ca_iters=ca_iters), want)
    assert 0 < int(want.sum()) < 64 * 128


def test_translation_counts_match_jax():
    n, s = 96, 128
    rows = _rows(4, n, rotating=False)
    jkeys, keys = _keys(n, 4)
    want = np.asarray(jmoving.counts_chunk_moving_polygons(
        jkeys, jmoving.moving_polygon_configs(*rows), ROBOT, s, ca_iters=0))
    got = moving.counts_chunk_moving_polygons(
        keys, moving.moving_polygon_configs(*rows), ROBOT, s, ca_iters=0).numpy()
    assert np.abs(got - want).sum() <= max(1, n * s // 100_000)
    assert 0 < want.sum() < n * s


@pytest.mark.parametrize("ca_screen", [True, False])
def test_rotating_counts_and_masks_match_jax(ca_screen):
    n, s = 32, 32
    rows = _rows(5, n)
    jkeys, keys = _keys(n, 5)
    jc, tc = jmoving.moving_polygon_configs(*rows), moving.moving_polygon_configs(*rows)
    if ca_screen:
        want, jmasks = jmoving.counts_chunk_moving_polygons(
            jkeys, jc, ROBOT, s, return_screen_masks=True)
        got, masks = moving.counts_chunk_moving_polygons(
            keys, tc, ROBOT, s, return_screen_masks=True)
        for a, b in zip(masks, jmasks):
            assert int((a.numpy() != np.asarray(b)).sum()) <= 1e-3 * n * s
    else:
        want = jmoving.counts_chunk_moving_polygons(jkeys, jc, ROBOT, s, ca_screen=False)
        got = moving.counts_chunk_moving_polygons(keys, tc, ROBOT, s, ca_screen=False)
    diff = np.abs(got.numpy() - np.asarray(want))
    assert diff.max() <= 2 and diff.sum() <= 1e-3 * n * s
    assert 0 < got.sum() < n * s


def test_screen_chunks_and_refinement(monkeypatch):
    n, s = 40, 32
    _, keys = _keys(n, 6)
    cfgs = moving.moving_polygon_configs(*_rows(6, n))
    whole, masks = moving.counts_chunk_moving_polygons(keys, cfgs, ROBOT, s,
                                                       return_screen_masks=True)
    # 7 rows a chunk: 6 chunks, the last one short
    monkeypatch.setattr(moving, "POLY_SCREEN_ELEMS", 7 * 6 * 4 * s)
    chunked, cmasks = moving.counts_chunk_moving_polygons(keys, cfgs, ROBOT, s,
                                                          return_screen_masks=True)
    assert torch.equal(whole, chunked)
    assert all(torch.equal(a, b) for a, b in zip(masks, cmasks))
    pure = moving.counts_chunk_moving_polygons(keys, cfgs, ROBOT, s, ca_screen=False)
    assert bool((whole >= pure).all()) and int(whole.sum()) > 0


def test_deterministic_motion_analytic():
    # approaching hits, receding misses, a short horizon misses, an initial
    # overlap hits at t = 0
    tri = np.array([[[-1.0, -1.0], [1.0, -1.0], [0.0, 1.0]]] * 4, np.float32)
    cfgs = moving.moving_polygon_configs(
        position=np.array([[8.0, 0.0], [8.0, 0.0], [8.0, 0.0], [0.3, 0.0]], np.float32),
        pose_theta=0.0, obstacle_verts=tri, std_dev=np.zeros(3, np.float32),
        velocity=np.array([[-1.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 0.0]],
                          np.float32),
        omega=0.0, t_max=np.array([10.0, 10.0, 2.0, 1.0], np.float32))
    cp = moving.trajectory_collision_probability(prng.PRNGKey(0), cfgs, ROBOT, 256)
    np.testing.assert_array_equal(cp.numpy(), [1.0, 0.0, 0.0, 1.0])


def test_pure_rotation_analytic():
    # the bar rotating in place: a counterclockwise quarter turn sweeps a
    # corner under the off-axis triangle, the clockwise one never reaches it
    tri = np.array([[[1.3, 1.3], [2.0, 1.3], [1.3, 2.1]]] * 2, np.float32)
    cfgs = moving.moving_polygon_configs(
        position=np.zeros((2, 2), np.float32), pose_theta=0.0, obstacle_verts=tri,
        std_dev=np.zeros(3, np.float32), velocity=np.zeros(2, np.float32),
        omega=np.array([np.pi / 2, -np.pi / 2], np.float32), t_max=1.0)
    cp = moving.trajectory_collision_probability(prng.PRNGKey(0), cfgs, ROBOT, 128,
                                                 ca_iters=96)
    np.testing.assert_array_equal(cp.numpy(), [1.0, 0.0])
