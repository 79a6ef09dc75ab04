"""The port's time-of-impact path on the CPU against the JAX package.

- `ops.toi` against `collide2d_tpu.ops.toi`: the exact translation windows
  (rectangles and k-gons) and the conservative-advancement loop. Hit/miss
  equal and times within 1e-5 (the same formulas; torch's cos/sin and
  XLA's may place a box an ulp apart, which moves a time by far less).
- Kernel 12's plain version against `rect_toi_pallas` in interpret mode
  on the same inputs (tests/test_toi.py:113-142's bar): hit/miss equal,
  t within 1e-5 where both hit; its steps count.
- The model's `time_of_impact` against the JAX model, with the head-on
  case of tests/test_toi.py:145-158, the kernel routing (CPU tensors never
  launch; inputs that require grad raise).

The CUDA kernel itself cannot run here: tests/test_torch_gpu.py holds it
against this plain version and skips without a card.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from collide2d_tpu.models import collision_model as jm
from collide2d_tpu.ops import toi as jt
from collide2d_tpu.ops import toi_pallas as jtp
from collide2d_tpu_torch.models import collision_model as tm
from collide2d_tpu_torch.ops import sat as tsat
from collide2d_tpu_torch.ops import toi as tt
from collide2d_tpu_torch.ops import toi_cuda as ttc

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ATOL = 1e-5


def _t(*a):
    return [torch.from_numpy(np.array(x, np.float32)) for x in a]


def _j(*a):
    return [jnp.asarray(x) for x in a]


def assert_times_agree(got, want, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    hit = np.isfinite(want)
    np.testing.assert_allclose(got[hit], want[hit], rtol=0, atol=atol)
    assert hit.any() and (~hit).any()


def moving_boxes(n, seed, rotating=True):
    """The JAX test's moving pairs (tests/test_toi.py:113-142): box 2 at
    radius ~3-7 heading for box 1 (every 4th away), box 1 turning at 0.25
    when ``rotating``; every 5th pair does not rotate at all."""
    rng = np.random.default_rng(seed)
    c1 = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    c2 = (rng.uniform(3, 5, (n, 2)) * rng.choice([-1, 1], (n, 2))).astype(np.float32)
    e1 = rng.uniform(0.5, 3, (n, 2)).astype(np.float32)
    e2 = rng.uniform(0.5, 3, (n, 2)).astype(np.float32)
    t1 = rng.uniform(0, 7, n).astype(np.float32)
    v2 = -c2 / np.linalg.norm(c2, axis=1, keepdims=True)
    v2[3::4] *= -1.0
    w1 = np.full(n, 0.25 if rotating else 0.0, np.float32)
    w2 = rng.uniform(-1, 1, n).astype(np.float32) if rotating else np.zeros(n, np.float32)
    w1[::5] = 0.0
    w2[::5] = 0.0
    return (c1, e1, t1, np.zeros((n, 2), np.float32), w1,
            c2, e2, np.zeros(n, np.float32), v2.astype(np.float32), w2)


def test_rect_translation_toi_vs_jax():
    c1, e1, t1, _, _, c2, e2, t2, v2, _ = moving_boxes(256, 1)
    e1[::7] *= -1.0  # negative extents rectify through abs()
    kw = dict(t_max=4.0)
    want = jax.jit(functools.partial(jt.rect_translation_toi, **kw))(
        *_j(c1, e1, t1, c2, e2, t2, v2))
    assert_times_agree(tt.rect_translation_toi(*_t(c1, e1, t1, c2, e2, t2, v2), **kw),
                       want)
    # at v = 0 the window is the static box test
    c = np.zeros_like(v2)
    hit = np.isfinite(tt.rect_translation_toi(*_t(c1, e1, t1, c2 * 0.3, e2, t2, c)).numpy())
    np.testing.assert_array_equal(hit.astype(np.int32), tsat.obb_collide(
        *_t(c1, e1, t1, c2 * 0.3, e2, t2)).numpy())


def test_rect_time_of_impact_vs_jax():
    args = moving_boxes(128, 2)
    kw = dict(t_max=8.0, iters=48, tol=1e-4)
    want = jax.jit(functools.partial(jt.rect_time_of_impact, **kw))(*_j(*args))
    assert_times_agree(tt.rect_time_of_impact(*_t(*args), **kw), want)


def test_polygon_time_of_impact_and_parts_vs_jax():
    rng = np.random.default_rng(3)
    n, k1, k2 = 256, 5, 8
    ang = np.sort(rng.uniform(0, 2 * np.pi, (2, n, 8)), axis=-1)
    ab = rng.uniform(0.3, 2.0, (2, n, 1, 2))
    shift = rng.uniform(-4, 4, (2, n, 1, 2))
    p = (np.stack([np.cos(ang), np.sin(ang)], -1) * ab + shift).astype(np.float32)
    p1, p2 = p[0][:, :k1].copy(), p[1]
    v = (-shift[1, :, 0] + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    m1 = np.arange(k1)[None] < rng.integers(3, k1 + 1, (n, 1))
    kw = dict(t_max=2.0)
    want = jax.jit(functools.partial(jt.polygon_time_of_impact, **kw))(
        *_j(p1, p2, v), mask1=jnp.asarray(m1))
    got = tt.polygon_time_of_impact(*_t(p1, p2, v), mask1=torch.from_numpy(m1), **kw)
    assert_times_agree(got, want)
    # the window at v = 0 is bitwise the static SAT label
    lo, hi = tt.polygon_translation_toi_parts(*_t(p1, p2), torch.zeros((n, 2)))
    np.testing.assert_array_equal((lo <= hi).numpy().astype(np.int32),
                                  tsat.sat_polygons(*_t(p1, p2)).numpy())
    # the window ends scale as 1/|axis . v|: relative to their size, and
    # where they are within reach of the horizon
    for g, w in zip(tt.polygon_translation_toi_parts(*_t(p1, p2, v)),
                    jax.jit(jt.polygon_translation_toi_parts)(*_j(p1, p2, v))):
        g, w = g.numpy(), np.asarray(w)
        near = np.abs(w) < 50.0
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
        np.testing.assert_allclose(g[near], w[near], rtol=1e-4, atol=ATOL)


def test_kernel12_plain_vs_pallas_interpret():
    c1, e1, t1, v1, w1, c2, e2, t2, v2, w2 = moving_boxes(100, 7)
    kw = dict(t_max=8.0, iters=128, tol=1e-4)
    want = jtp.rect_toi_pallas(*_j(c1, e1, t1, v1, w1, c2, e2), 0.0,
                               *_j(v2, w2), block=8, interpret=True, **kw)
    got = ttc.rect_toi_cuda(*_t(c1, e1, t1, v1, w1, c2, e2), 0.0, *_t(v2, w2),
                            block=8, **kw)
    assert got.shape == (100,) and got.dtype == torch.float32
    assert_times_agree(got, want)
    # the packers agree bitwise
    pad = lambda a: np.concatenate([a, np.zeros((4,) + a.shape[1:], a.dtype)])  # noqa: E731
    np.testing.assert_array_equal(
        ttc.pack_moving_obbs(*_t(*map(pad, (c2, e2, t2, v2, w2)))).numpy(),
        np.asarray(jtp.pack_moving_obbs(*_j(*map(pad, (c2, e2, t2, v2, w2))))))


def test_kernel12_plain_steps_and_translation_lanes():
    args = moving_boxes(256, 8)
    b1 = ttc.pack_moving_obbs(*_t(*args[:5]))
    b2 = ttc.pack_moving_obbs(*_t(*args[5:]))
    kw = dict(t_max=8.0, iters=64, tol=1e-4)
    t, steps = ttc.moving_obb_toi_plain(b1, b2, return_steps=True, **kw)
    assert t.shape == steps.shape == (8, 32) and steps.dtype == torch.int32
    t, steps = t.reshape(-1).numpy(), steps.reshape(-1).numpy()
    still = np.arange(256) % 5 == 0
    assert (steps[still] == 0).all() and (steps[~still] > 0).all()
    assert steps.max() <= 64
    np.testing.assert_array_equal(t, ttc.moving_obb_toi_plain(b1, b2, **kw).reshape(-1))
    # the translation lanes are the exact window
    want = tt.rect_translation_toi(*_t(args[0], args[1], args[2], args[5], args[6],
                                       args[7], args[8]), t_max=8.0).numpy()
    np.testing.assert_allclose(t[still], want[still], rtol=0, atol=ATOL)


MODEL_TOI = dict(t_max=8.0, iters=48, tol=1e-4)


@functools.cache
def jax_model_toi():
    """`example_configs` rows moving at unit speed (every 4th away from the
    obstacle, every 3rd not rotating) and the JAX model's ``jnp`` times on
    them, computed once: ((rows, velocity, omega), times)."""
    t = tm.example_configs(256, seed=9, device="cpu")  # the JAX example's threefry draws
    vel = -t.position / t.position.norm(dim=-1, keepdim=True)
    vel[1::4] *= -1.0
    omega = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, 256)
                             .astype(np.float32))
    omega[::3] = 0.0
    want = jax.jit(functools.partial(jm.CollisionProbabilityModel().time_of_impact,
                                     impl="jnp", **MODEL_TOI))(
        *_j(t.position.numpy(), t.pose_theta.numpy(), t.obstacle_wh.numpy(),
            vel.numpy(), omega.numpy()))
    return (t, vel, omega), want


@pytest.mark.parametrize("impl", ["torch", "auto"])
def test_model_time_of_impact_head_on_and_vs_jax(impl):
    model = tm.CollisionProbabilityModel()  # robot 4.07 x 1.74
    pos, th, vel = _t([[6.0, 0.0], [0.0, 0.0]], [0.0, 0.0], [[-1.0, 0.0], [1.0, 0.0]])
    toi = model.time_of_impact(pos, th, torch.tensor([2.0, 1.0]), vel, t_max=10.0,
                               impl=impl).numpy()
    # head-on gap: 6 - 4.07/2 - 2/2 = 2.965; overlapping starts at 0
    np.testing.assert_allclose(toi[0], 6.0 - 4.07 / 2 - 1.0, atol=1e-3)
    assert toi[1] == 0.0

    (t, vel, omega), want = jax_model_toi()
    got = model.time_of_impact(t.position, t.pose_theta, t.obstacle_wh, vel, omega,
                               impl=impl, **MODEL_TOI)
    assert_times_agree(got, want)


def test_cpu_tensors_never_launch_and_grad_raises():
    ttc.reset_launches()
    t = tm.example_configs(64, seed=10, device="cpu")
    model = tm.CollisionProbabilityModel()
    vel = -t.position
    model.time_of_impact(t.position, t.pose_theta, t.obstacle_wh, vel, 0.5, impl="cuda",
                         iters=8)
    assert ttc.LAUNCHES == 0
    with pytest.raises(ValueError, match="impl='torch'"):
        model.time_of_impact(t.position, t.pose_theta, t.obstacle_wh,
                             vel.clone().requires_grad_(True), impl="auto")
    box = ttc.pack_moving_obbs(torch.zeros((8192, 2)), torch.ones((8192, 2)), 0.0,
                               torch.zeros((8192, 2)), 0.0)
    with pytest.raises(ValueError, match="iters"):
        ttc.moving_obb_toi_cuda_t(box, box, iters=-1)
    with pytest.raises(ValueError, match="multiple of block"):
        ttc.moving_obb_toi_cuda_t(box[:, :, :8], box[:, :, :8])
    with pytest.raises(ValueError, match="N % 8"):
        ttc.pack_moving_obbs(torch.zeros((12, 2)), torch.ones((12, 2)), 0.0,
                             torch.zeros((12, 2)), 0.0)
    with pytest.raises(ValueError, match="impl"):
        model.time_of_impact(t.position, t.pose_theta, t.obstacle_wh, vel, impl="pallas")
