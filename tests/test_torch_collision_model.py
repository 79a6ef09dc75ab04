"""`CollisionProbabilityModel` and the broad phase against the JAX package.

Tolerance: bitwise labels and probabilities. `collide` is held against
the JAX model's ``jnp`` path and against the Pallas kernels in interpret
mode on JAX's own vertices; inputs are `example_configs`, whose threefry
draws the port reproduces bit for bit, and torch's CPU cos/sin round as
XLA's do on these inputs (tests/test_torch_geometry_sat.py). The Monte
Carlo entry points use the threefry impl, the JAX ``jnp`` streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collide2d_tpu.mc import estimator as jest
from collide2d_tpu.models import collision_model as jm
from collide2d_tpu.ops import broad_phase as jbp
from collide2d_tpu.ops import geometry as jgeo
from collide2d_tpu.ops import sat_pallas as jsp
from collide2d_tpu.utils.benchmarks import _sparse_scene_configs
from collide2d_tpu_torch.mc.estimator import (
    AdaptiveConfig,
    collision_probability,
    configs_from_numpy,
)
from collide2d_tpu_torch.models import collision_model as tm
from collide2d_tpu_torch.ops import broad_phase as tbp
from collide2d_tpu_torch.ops import sat_cuda

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

N = 4096
ROBOT = (4.07, 1.74)


@pytest.fixture(scope="module")
def configs():
    return jm.example_configs(N, seed=3), tm.example_configs(N, seed=3, device="cpu")


def _key(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))


def test_example_configs_match_jax(configs):
    jc, tc = configs
    for a, b in zip(jc, tc):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_example_builders_default_to_the_card():
    # Whether there is a card is decided here, at run time: the builders
    # draw on it by default, and without one they raise rather than fall
    # back to the host.
    if torch.cuda.is_available():
        assert tm.example_configs(4).position.device.type == "cuda"
        assert tm.example_polygon_configs(4).obstacle_verts.device.type == "cuda"
    else:
        for build in (tm.example_configs, tm.example_polygon_configs):
            with pytest.raises(RuntimeError, match="pass device='cpu'"):
                build(4)
    # device="cpu" gives the JAX example's rows (k-gon vertices within a
    # cos/sin ulp of the JAX ones, scaled by semi-axes below 3)
    jc, tc = jm.example_configs(64, seed=5), tm.example_configs(64, seed=5, device="cpu")
    for a, b in zip(jc, tc):
        assert b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jp = jm.example_polygon_configs(64, k=7, seed=5)
    tp = tm.example_polygon_configs(64, k=7, seed=5, device="cpu")
    for name in ("position", "pose_theta", "std_dev"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    np.testing.assert_allclose(tp.obstacle_verts.numpy(), np.asarray(jp.obstacle_verts),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", ["auto", "cuda", "torch"])
@pytest.mark.parametrize("method,precision", [("vertex", "f32"),
                                              ("vertex", "bf16"),
                                              ("obb", "f32")])
def test_collide_matches_jax_model(configs, method, precision, impl):
    jc, tc = configs
    want = np.asarray(jm.CollisionProbabilityModel(ROBOT).collide(
        jc.position, jc.pose_theta, jc.obstacle_wh, precision=precision,
        impl="jnp", method=method))
    got = tm.CollisionProbabilityModel(ROBOT).collide(
        tc.position, tc.pose_theta, tc.obstacle_wh, precision=precision,
        impl=impl, method=method)
    assert got.dtype == torch.int32 and got.shape == (N,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < want.mean() < 0.95


@pytest.mark.parametrize("method,precision", [("vertex", "f32"),
                                              ("vertex", "bf16"),
                                              ("obb", "f32")])
def test_collide_matches_pallas_interpret(configs, method, precision):
    # The JAX model reaches the Pallas kernels only on a TPU: run them in
    # interpret mode on the JAX model's own inputs.
    jc, tc = configs
    robot_wh = jnp.broadcast_to(jnp.asarray(ROBOT, jnp.float32), jc.position.shape)
    if method == "obb":
        zeros = jnp.zeros_like(jc.position)
        want = jsp.obb_collide_pallas(
            jc.position, robot_wh, jc.pose_theta, zeros, jc.obstacle_wh,
            jnp.zeros_like(jc.pose_theta), block=128, interpret=True)
    else:
        robot = jgeo.rects_from_params(jc.position, robot_wh, jc.pose_theta)
        obstacle = jgeo.rects_from_params(jnp.zeros_like(jc.position),
                                          jc.obstacle_wh,
                                          jnp.zeros_like(jc.pose_theta))
        want = jsp.sat_rects_pallas(robot, obstacle, block=128, interpret=True,
                                    precision=precision)
    got = tm.CollisionProbabilityModel(ROBOT).collide(
        tc.position, tc.pose_theta, tc.obstacle_wh, precision=precision,
        method=method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_collide_rejects_bad_arguments(configs):
    _, tc = configs
    model = tm.CollisionProbabilityModel()
    args = (tc.position[:8], tc.pose_theta[:8], tc.obstacle_wh[:8])
    with pytest.raises(ValueError, match="precision"):
        model.collide(*args, precision="f16")
    with pytest.raises(ValueError, match="method"):
        model.collide(*args, method="gjk")
    with pytest.raises(ValueError, match="f32' only"):
        model.collide(*args, method="obb", precision="bf16")
    with pytest.raises(ValueError, match="impl"):
        model.collide(*args, impl="pallas")


def test_collide_on_cpu_never_launches(configs):
    _, tc = configs
    sat_cuda.reset_launches()
    model = tm.CollisionProbabilityModel()
    for method in ("vertex", "obb"):
        model.collide(tc.position, tc.pose_theta, tc.obstacle_wh, method=method)
    assert sat_cuda.LAUNCHES == dict.fromkeys(sat_cuda.LAUNCHES, 0)


@pytest.fixture(scope="module")
def sparse():
    c = _sparse_scene_configs(512, box=20.0, seed=11)
    return c, configs_from_numpy(c, "cpu")


def test_forward_matches_jax(configs):
    jc, tc = configs
    key = jax.random.PRNGKey(4)
    jcfg = type(jc)(*(a[:64] for a in jc))
    tcfg = type(tc)(*(a[:64] for a in tc))
    want = np.asarray(jm.CollisionProbabilityModel(ROBOT).forward(key, jcfg, 1024))
    got = tm.CollisionProbabilityModel(ROBOT).forward(_key(4), tcfg, 1024)
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_pruned_matches_jax(sparse):
    jc, tc = sparse
    want = np.asarray(jest.collision_probability_pruned(
        jax.random.PRNGKey(4), jc, jnp.asarray(ROBOT, jnp.float32), 1024,
        impl="jnp"))
    got = tm.CollisionProbabilityModel(ROBOT).forward_pruned(
        _key(4), tc, 1024, impl="threefry")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > 5


def test_forward_pruned_kernel_path_equals_unpruned(sparse):
    # The kernel's counts are keyed by uid, so candidate rows sampled in
    # the pruned bucket equal the unpruned run's; pruned rows are 0.
    _, tc = sparse
    pruned = tm.CollisionProbabilityModel(ROBOT).forward_pruned(
        _key(5), tc, 2048, impl="cuda")
    full = collision_probability(_key(5), tc, ROBOT, 2048, impl="cuda").numpy()
    mask = tbp.possible_collision_mask(tc, ROBOT, 6.0).numpy()
    assert 0 < mask.sum() < len(mask)
    np.testing.assert_array_equal(pruned[mask], full[mask])
    assert (pruned[~mask] == 0).all() and (full[~mask] == 0).all()


def test_label_matches_jax(configs):
    jc, tc = configs
    kw = dict(max_samples=4000, initial_batch=1000, initial_phase_samples=2000,
              later_batch=2000, bin_accuracy=(0.02, 0.02, 0.05), min_active=16)
    jcfg = type(jc)(*(a[:96] for a in jc))
    tcfg = type(tc)(*(a[:96] for a in tc))
    want = jm.CollisionProbabilityModel(ROBOT).label(
        jax.random.PRNGKey(6), jcfg, jest.AdaptiveConfig(impl="jnp", **kw))
    got = tm.CollisionProbabilityModel(ROBOT).label(
        _key(6), tcfg, AdaptiveConfig(impl="threefry", **kw))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("sigma", [0.0, 3.0, 6.0])
def test_possible_collision_mask_matches_jax(sparse, sigma):
    jc, tc = sparse
    want = np.asarray(jbp.possible_collision_mask(jc, jnp.asarray(ROBOT), sigma))
    got = tbp.possible_collision_mask(tc, torch.tensor(ROBOT), sigma)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(want)


def test_aabb_overlap_and_bucket_for_match_jax():
    rng = np.random.default_rng(8)
    lo1, lo2 = rng.integers(-4, 4, (2, 256, 2)).astype(np.float32)
    hi1 = lo1 + rng.integers(0, 3, (256, 2))
    hi2 = lo2 + rng.integers(0, 3, (256, 2))
    want = np.asarray(jbp.aabb_overlap(lo1, hi1, lo2, hi2))
    got = tbp.aabb_overlap(*(torch.from_numpy(np.asarray(a, np.float32))
                             for a in (lo1, hi1, lo2, hi2)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1  # touching boxes included
    for count, n in [(0, 10_000), (1000, 10_000), (1025, 10_000), (5000, 4096)]:
        assert tbp.bucket_for(count, n) == jbp.bucket_for(count, n)
        assert tbp.bucket_for(count, n, 64) == jbp.bucket_for(count, n, 64)
