"""Trajectory counts for rectangles (`mc.moving.counts_chunk_moving`) on the
CPU, against the JAX package's `collide2d_tpu.mc.moving`.

- `moving_configs` and `moving_configs_from_numpy` give JAX's rows.
- At zero motion and tol 0 the counts are bitwise the port's static
  `_counts_chunk` (the window degenerates to the static test).
- On pinned threefry keys: translation-only counts equal JAX's except for
  at most 1 sample in 1e5 (draws within an ulp of a boundary); rotating
  counts, screened or not, differ by at most 2 per row and 1e-3 of all
  samples, and the stage-A masks on at most 1e-3 of lanes (torch's and
  XLA's cos/sin differ by an ulp on the CPU, which can move a lane near a
  screen boundary or a graze near tol; a wiring fault moves samples
  wholesale).
- Stage C's gather of every ambiguous row at once gives JAX's chunked
  `_row_chunks` hits on the same inputs.
- Screened counts are at least the pure advancement loop's per row.
- A deterministic motion gives the analytic cp in {0, 1}.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collide2d_tpu.mc import moving as jmoving
from collide2d_tpu_torch.mc import moving, prng
from collide2d_tpu_torch.mc.estimator import Configs, _counts_chunk

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ROBOT = np.array([4.07, 1.74], np.float32)


def _rows(seed, n, rotating=True):
    rng = np.random.default_rng(seed)
    omega = rng.uniform(-0.5, 0.5, n) if rotating else np.zeros(n)
    return tuple(np.asarray(a, np.float32) for a in (
        rng.uniform(-6, 6, (n, 2)), rng.uniform(0, 2 * np.pi, n),
        rng.uniform(0.5, 5, (n, 2)), rng.uniform(0, 0.3, (n, 5)),
        rng.uniform(-2, 2, (n, 2)), omega, rng.uniform(0.5, 3, n)))


def _keys(n, seed=0):
    """The same per-row keys for both packages: JAX keys and their words."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    words = np.asarray(jax.random.key_data(keys)).astype(np.int64)
    return keys, (torch.from_numpy(words[:, 0]), torch.from_numpy(words[:, 1]))


def test_constructors_match_jax():
    rng = np.random.default_rng(1)
    pos = rng.uniform(-3, 3, (7, 2)).astype(np.float32)
    args = (pos, 0.25, np.array([2.0, 1.5], np.float32),
            np.array([0.1, 0.1, 0.05, 0.0, 0.0], np.float32),
            rng.uniform(-1, 1, (7, 2)).astype(np.float32), 0.0,
            rng.uniform(0.5, 2, 7).astype(np.float32))
    want = jmoving.moving_configs(*args)
    got = moving.moving_configs(*args)
    again = moving.moving_configs_from_numpy(want, "cpu")
    assert got._fields == want._fields and got.num == 7
    for name in want._fields:
        for t in (got, again):
            a = getattr(t, name)
            assert a.dtype == torch.float32 and a.is_contiguous()
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want, name)))


def test_zero_motion_is_bitwise_the_static_chunk():
    pos, th, wh, sd, _, _, _ = _rows(2, 64)
    cfgs = moving.moving_configs(pos, th, wh, sd, 0.0, 0.0, 1.0)
    static = Configs(*(torch.from_numpy(a) for a in (pos, th, wh, sd)))
    _, keys = _keys(64, 3)
    robot = torch.from_numpy(ROBOT)
    want = _counts_chunk(keys, static, robot, 128, False)
    for ca_iters in (0, 48):
        got = moving.counts_chunk_moving(keys, cfgs, robot, 128, ca_iters=ca_iters,
                                         tol=0.0)
        assert torch.equal(got, want)
    assert 0 < int(want.sum()) < 64 * 128


def test_translation_counts_match_jax():
    n, s = 128, 128
    rows = _rows(4, n, rotating=False)
    jkeys, keys = _keys(n, 4)
    want = np.asarray(jmoving.counts_chunk_moving(jkeys, jmoving.moving_configs(*rows),
                                                  ROBOT, s, ca_iters=0))
    got = moving.counts_chunk_moving(keys, moving.moving_configs(*rows), ROBOT, s,
                                     ca_iters=0).numpy()
    assert np.abs(got - want).sum() <= max(1, n * s // 100_000)
    assert 0 < want.sum() < n * s


@pytest.mark.parametrize("ca_screen", [True, False])
def test_rotating_counts_and_masks_match_jax(ca_screen):
    n, s = 96, 64
    rows = _rows(5, n)
    jkeys, keys = _keys(n, 5)
    jc, tc = jmoving.moving_configs(*rows), moving.moving_configs(*rows)
    if ca_screen:
        want, jmasks = jmoving.counts_chunk_moving(jkeys, jc, ROBOT, s,
                                                   return_screen_masks=True)
        got, masks = moving.counts_chunk_moving(keys, tc, ROBOT, s,
                                                return_screen_masks=True)
        for a, b in zip(masks, jmasks):
            assert a.shape == (n, s)
            assert int((a.numpy() != np.asarray(b)).sum()) <= 1e-3 * n * s
        assert 0 < float(masks[2].float().mean()) < 0.25  # most lanes decided
    else:
        want = jmoving.counts_chunk_moving(jkeys, jc, ROBOT, s, ca_screen=False)
        got = moving.counts_chunk_moving(keys, tc, ROBOT, s, ca_screen=False)
    diff = np.abs(got.numpy() - np.asarray(want))
    assert diff.max() <= 2 and diff.sum() <= 1e-3 * n * s
    assert 0 < got.sum() < n * s


def test_gathered_advancement_matches_jax_row_chunks():
    # identical stage inputs to both cascades: JAX walks the ambiguous rows
    # in C/16-row chunks of a while_loop, the port gathers them at once
    n, s = 64, 32
    rng = np.random.default_rng(6)
    f = lambda *shape, lo, hi: rng.uniform(lo, hi, shape).astype(np.float32)  # noqa: E731
    lane = dict(ox=f(n, s, lo=-2, hi=2), oy=f(n, s, lo=-2, hi=2))
    phi = f(n, s, lo=-0.5, hi=0.5)
    lane.update(c2=np.cos(phi), s2=np.sin(phi), hx2=f(n, s, lo=0.3, hi=2.5),
                hy2=f(n, s, lo=0.3, hi=2.5))
    cfg = dict(px=f(n, 1, lo=-5, hi=5), py=f(n, 1, lo=-5, hi=5),
               vx=f(n, 1, lo=-3, hi=3), vy=f(n, 1, lo=-3, hi=3),
               th0=f(n, 1, lo=0, hi=6), w=f(n, 1, lo=-1, hi=1),
               hx1=np.full((n, 1), 2.035, np.float32),
               hy1=np.full((n, 1), 0.87, np.float32))
    cfg["w"][::5] = 0.0
    r_rob = np.full((n, 1), np.float32(0.5 * np.hypot(4.07, 1.74)), np.float32)
    bound = np.broadcast_to(np.hypot(cfg["vx"], cfg["vy"]) + np.abs(cfg["w"]) * r_rob,
                            (n, s)).astype(np.float32)
    rotating = cfg["w"] != 0
    hit0 = np.zeros((n, s), bool)
    order = ("ox", "oy", "c2", "s2", "hx2", "hy2", "px", "py", "vx", "vy", "th0", "w",
             "hx1", "hy1")
    vals = {**lane, **cfg}
    want, wmasks = jmoving._screened_rotating_hits(
        *(jnp.asarray(vals[k]) for k in order), jnp.asarray(r_rob), jnp.asarray(bound),
        jnp.asarray(rotating), jnp.asarray(hit0), 48, 1e-4)
    got, masks = moving._screened_rotating_hits(
        *(torch.from_numpy(np.ascontiguousarray(vals[k])) for k in order),
        torch.from_numpy(r_rob), torch.from_numpy(bound), torch.from_numpy(rotating),
        torch.from_numpy(hit0), 48, 1e-4)
    amb = np.asarray(wmasks[2])
    assert amb.any(axis=1).sum() > n // 16  # several of JAX's chunks
    rot = np.broadcast_to(rotating, (n, s))
    differ = (got.numpy() != np.asarray(want)) & rot
    assert differ.sum() <= max(2, 1e-3 * n * s)
    assert (masks[2].numpy() != amb).sum() <= 1e-3 * n * s


def test_screened_counts_refine_the_pure_loop():
    n, s = 128, 64
    _, keys = _keys(n, 7)
    cfgs = moving.moving_configs(*_rows(7, n))
    pure = moving.counts_chunk_moving(keys, cfgs, ROBOT, s, ca_screen=False)
    screened = moving.counts_chunk_moving(keys, cfgs, ROBOT, s)
    assert bool((screened >= pure).all()) and int(screened.sum()) > 0
    with pytest.raises(ValueError, match="return_screen_masks"):
        moving.counts_chunk_moving(keys, cfgs, ROBOT, s, ca_screen=False,
                                   return_screen_masks=True)
    with pytest.raises(ValueError, match="screen_impl"):
        moving.counts_chunk_moving(keys, cfgs, ROBOT, s, screen_impl="pallas")


def test_deterministic_motion_analytic():
    # zero noise: every sample alike, cp in {0, 1} by whether the motion
    # reaches the obstacle (head-on gap 8 - 4.07/2 - 1 = 4.965)
    cfgs = moving.moving_configs(
        position=np.array([[8.0, 0.0], [8.0, 0.0], [8.0, 6.0], [0.5, 0.0]], np.float32),
        pose_theta=0.0, obstacle_wh=np.array([2.0, 2.0], np.float32),
        std_dev=np.zeros(5, np.float32),
        velocity=np.array([[-1.0, 0.0], [-1.0, 0.0], [-1.0, 0.0], [1.0, 0.0]],
                          np.float32),
        omega=0.0, t_max=np.array([6.0, 4.0, 6.0, 1.0], np.float32))
    cp = moving.trajectory_collision_probability(prng.PRNGKey(0), cfgs, ROBOT, 256,
                                                 ca_iters=128)
    np.testing.assert_array_equal(cp.numpy(), [1.0, 0.0, 0.0, 1.0])
    # a rotating robot parked beside the obstacle sweeps into it
    spin = cfgs._replace(position=torch.tensor([[0.0, 2.6]] * 4),
                         velocity=torch.zeros(4, 2),
                         omega=torch.tensor([np.pi / 2, 0.0, np.pi / 2, 0.0]),
                         t_max=torch.ones(4))
    cp = moving.trajectory_collision_probability(prng.PRNGKey(0), spin, ROBOT, 64)
    np.testing.assert_array_equal(cp.numpy(), [1.0, 0.0, 1.0, 0.0])
