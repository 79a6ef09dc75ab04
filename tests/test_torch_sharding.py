"""The port's `parallel` package and its sharded rounds, on the CPU.

Counterparts of tests/test_sharding.py, one for each of its tests (named
in each docstring), on meshes of repeated ``torch.device("cpu")`` entries
(a repeated device is a logical shard). The JAX side, where a test holds
the port to it, runs on the 8-device CPU mesh of tests/conftest.py.

- Threefry rounds and adaptive runs under config, sample and 2-D meshes
  are bitwise the port's unsharded runs, and on the pinned seeds their
  counts and labels equal the JAX package's sharded ones.
- The fused kernels' plain versions (kernels 1, 7, 13, 14) under a mesh
  are bitwise their unsharded counts, with uneven config blocks and
  uneven 64-sample granule splits (and a sub-granule tail).
- The query layer on the mesh's row blocks concatenates to the whole
  batch's outputs (bitwise where JAX's test is, else within its bars).
- The driver under a mesh: 'auto' keeps the kernel, a checkpoint written
  under a mesh resumes bitwise with or without it, and the pipeline's
  batches are byte-identical with a mesh.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from collide2d_tpu.mc import estimator as jest
from collide2d_tpu import parallel as jpar
from collide2d_tpu_torch.mc import estimator as est
from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.driver import AdaptiveRun
from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities as acp
from collide2d_tpu_torch.mc.estimator import AdaptiveConfig, Configs, mc_round
from collide2d_tpu_torch.mc.moving import moving_configs, moving_polygon_configs
from collide2d_tpu_torch.models.collision_model import example_polygon_configs
from collide2d_tpu_torch.ops import (
    mc_cuda,
    mc_moving_polygon_cuda,
    mc_polygon_cuda,
    mc_toi_cuda,
)
from collide2d_tpu_torch.parallel import (
    global_mesh,
    make_mesh,
    process_batch_range,
    sample_sharded_probability,
    shard_configs,
    sharded_mc_round,
)
from collide2d_tpu_torch.parallel.sharding import config_blocks
from tests.conftest import cpu_devices, random_configs

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

CPU = torch.device("cpu")
ROBOT = (4.07, 1.74)
ROBOT_4GON = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87],
                       [-2.035, 0.87]], np.float32)


def _mesh(n=8, sample_axis=None):
    return make_mesh([CPU] * n, sample_axis=sample_axis)


@pytest.fixture(scope="module")
def jdevices():
    devs = cpu_devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return devs


def _both(rng, c):
    """The same random rectangle batch for JAX and for the port."""
    j = random_configs(rng, c)
    return j, Configs(*(torch.as_tensor(np.array(a)) for a in j))


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _uids(c):
    return torch.arange(c, dtype=torch.int32)


def test_config_dp_bitwise_matches_unsharded(rng, jdevices, monkeypatch):
    """test_sharding.py:32: a config-axis mesh is a no-op on values."""
    c = 64
    jc, tc = _both(rng, c)
    base = mc_round(prng.PRNGKey(0), _uids(c), tc, ROBOT, 0, n_batch=512)
    calls = []
    real = est._threefry_counts
    monkeypatch.setattr(est, "_threefry_counts",
                        lambda key, uids, cfgs, *a, **k: calls.append(cfgs.num)
                        or real(key, uids, cfgs, *a, **k))
    got = mc_round(prng.PRNGKey(0), _uids(c), tc, ROBOT, 0, n_batch=512,
                   mesh=_mesh(8))
    assert calls == [8] * 8  # actually ran as 8 blocks of 8 rows
    assert got.dtype == torch.int32 and torch.equal(got, base)
    # the JAX package's sharded round on the same seed
    jmesh = jpar.make_mesh(jdevices)
    juids = jax.device_put(jnp.arange(c, dtype=jnp.int32),
                           NamedSharding(jmesh, P("config")))
    want = jest.mc_round(_jkey(0), juids, jpar.shard_configs(jc, jmesh),
                         jnp.asarray(ROBOT, jnp.float32), jnp.int32(0), n_batch=512)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_2d_mesh_round_bitwise(rng, jdevices):
    """test_sharding.py:49: a (config 4, sample 2) round is bitwise the
    unsharded round at the same step size."""
    c = 64
    jc, tc = _both(rng, c)
    mesh = _mesh(8, sample_axis=2)
    assert mesh.shape == {"config": 4, "sample": 2}
    got = sharded_mc_round(prng.PRNGKey(1), _uids(c), tc, ROBOT, 0, n_batch=512,
                           step_samples=128, mesh=mesh)
    base = mc_round(prng.PRNGKey(1), _uids(c), tc, ROBOT, 0, n_batch=512,
                    step_samples=128)
    assert torch.equal(got, base)
    jmesh = jpar.make_mesh(jdevices, sample_axis=2)
    want = jpar.sharded_mc_round(
        _jkey(1), jnp.arange(c, dtype=jnp.int32), jpar.shard_configs(jc, jmesh),
        jnp.asarray(ROBOT, jnp.float32), jnp.int32(0), n_batch=512,
        step_samples=128, mesh=jmesh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="multiple of sample_axis"):
        sharded_mc_round(prng.PRNGKey(1), _uids(c), tc, ROBOT, 0, n_batch=384,
                         step_samples=128, mesh=mesh)


def test_sample_sharding_bitwise_matches_single_device(rng, jdevices):
    """test_sharding.py:76: a pure sample-axis mesh is a no-op on values."""
    c = 16
    jc, tc = _both(rng, c)
    got = sample_sharded_probability(prng.PRNGKey(3), tc, ROBOT, 1024,
                                     _mesh(8, sample_axis=8))
    base = mc_round(prng.PRNGKey(3), _uids(c), tc, ROBOT, 0, n_batch=1024,
                    step_samples=128)
    np.testing.assert_array_equal(got.numpy() * 1024, base.numpy().astype(np.float32))
    want = jpar.sample_sharded_probability(
        _jkey(3), jc, jnp.asarray(ROBOT, jnp.float32), 1024,
        jpar.make_mesh(jdevices, sample_axis=8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="multiple of the sample-axis"):
        sample_sharded_probability(prng.PRNGKey(3), tc, ROBOT, 1020,
                                   _mesh(8, sample_axis=8))


def test_make_mesh_validation(jdevices):
    """test_sharding.py:95, held to JAX's make_mesh: a sample axis that does
    not divide the device count raises ValueError; with no card and no
    explicit devices make_mesh raises instead of falling back to the CPU."""
    with pytest.raises(ValueError):
        jpar.make_mesh(jdevices, sample_axis=3)
    with pytest.raises(ValueError, match="does not divide"):
        _mesh(8, sample_axis=3)
    assert jpar.make_mesh(jdevices, sample_axis=4).shape == dict(
        _mesh(8, sample_axis=4).shape)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def _adaptive_both(rng, c, jcfg_kw, seed, mesh_kw):
    """(port unsharded, port under the mesh, JAX under its mesh) labels."""
    jc, tc = _both(rng, c)
    key = prng.PRNGKey(seed)
    cfg = AdaptiveConfig(**jcfg_kw, impl="threefry")
    base = acp(key, tc, ROBOT, cfg)
    got = acp(key, tc, ROBOT, cfg, mesh=_mesh(8, **mesh_kw))
    jmesh = jpar.make_mesh(cpu_devices(), **mesh_kw)
    want = jest.adaptive_collision_probabilities(
        _jkey(seed), jc, jnp.asarray(ROBOT, jnp.float32),
        jest.AdaptiveConfig(**jcfg_kw, impl="jnp"), mesh=jmesh)
    return base, got, want


def _assert_labels_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_adaptive_sample_sharded_bitwise_matches_unsharded(rng, jdevices):
    """test_sharding.py:100: the adaptive driver over a (1, 8) mesh."""
    base, got, want = _adaptive_both(
        rng, 48, dict(max_samples=8192, fixed_batch=1024, step_samples=128,
                      bin_accuracy=(0.002, 0.002, 0.005), min_active=8),
        11, dict(sample_axis=8))
    _assert_labels_equal(got, base)
    _assert_labels_equal(got, want)


def test_adaptive_2d_mesh_bitwise_matches_unsharded(rng, jdevices):
    """test_sharding.py:122: the adaptive driver over a (4, 2) mesh."""
    base, got, want = _adaptive_both(
        rng, 64, dict(max_samples=4096, fixed_batch=512, step_samples=128,
                      bin_accuracy=(0.002, 0.002, 0.005), min_active=8),
        13, dict(sample_axis=2))
    _assert_labels_equal(got, base)
    _assert_labels_equal(got, want)


def test_adaptive_cuda_with_sample_mesh_accepted(rng):
    """test_sharding.py:142 (``impl='pallas'`` with a sample axis): the
    driver keeps the fused kernel under a sample mesh with no warning, the
    scheduler sees the axes and the ops carry the mesh; 'auto' resolves to
    the kernel under a mesh too (the port's streams make it bitwise)."""
    _, tc = _both(rng, 16)
    mesh = _mesh(8, sample_axis=8)
    for impl in ("cuda", "auto"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            run = AdaptiveRun(prng.PRNGKey(17), tc, ROBOT, AdaptiveConfig(
                impl=impl, max_samples=2048, fixed_batch=512,
                bin_accuracy=(0.002, 0.002, 0.005), min_active=8), mesh=mesh)
        assert run.scheduler.impl == "cuda"
        assert run.ops.mesh is mesh
        assert (run.scheduler.n_sample, run.scheduler.n_shards) == (8, 1)


@pytest.mark.parametrize("n_dev,sample_axis", [(16, 16), (6, 3)])
def test_threefry_plan_serves_every_sample_axis(rng, n_dev, sample_axis):
    """The default threefry plan does not depend on the sample axis: a
    4,096-sample round of 8 steps over a 16-way or a 3-way axis keeps its
    plan (no warning) and round-robins the steps, so the labels are the
    unsharded run's bit for bit. (JAX's plan falls back to a shard-specific
    one there, estimator.py:225-240, because its shard_map needs equal
    steps a shard.)"""
    _, tc = _both(rng, 12)
    cfg = AdaptiveConfig(impl="threefry", max_samples=8192, fixed_batch=4096,
                         bin_accuracy=(0.002, 0.002, 0.005), min_active=8)
    nb, step = est._plan_round(cfg, 0, sample_axis, "threefry")
    assert (nb, step) == est._plan_round(cfg, 0, 1, "threefry") == (4096, 512)
    assert (nb // step) % sample_axis
    key = prng.PRNGKey(23)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = acp(key, tc, ROBOT, cfg, mesh=_mesh(n_dev, sample_axis=sample_axis))
    _assert_labels_equal(got, acp(key, tc, ROBOT, cfg))


def _kernel1_inputs(rng, c, shape_noise=True):
    jc = random_configs(rng, c, shape_sigma=0.4 if shape_noise else 0.0)
    return Configs(*(torch.as_tensor(np.array(a)) for a in jc))


@pytest.mark.parametrize("n", [12 * 64, 12 * 64 + 17])
def test_cuda_sample_axis_step_split_exact(rng, n):
    """test_sharding.py:192: kernel 1 (its plain version) over 8 sample
    shards: 12 granules split 2,2,2,2,1,1,1,1 (and a 17-sample tail on the
    last shard) give exactly the unsharded counts, bit for bit."""
    cfgs = _kernel1_inputs(rng, 40)
    ranges = est._granule_ranges(n, 8)
    assert [cnt for _, cnt in ranges][:4] == [128] * 4
    assert sum(cnt for _, cnt in ranges) == n
    assert all(o == sum(c for _, c in ranges[:j]) for j, (o, _) in enumerate(ranges))
    key = prng.PRNGKey(5)
    base = mc_cuda.mc_round_cuda(key, _uids(40), cfgs, ROBOT, 3, n_batch=n)
    got = est._cuda_sharded_counts(key, _uids(40), cfgs, ROBOT, 3, n_batch=n,
                                   mesh=_mesh(8, sample_axis=8))
    assert torch.equal(got, base) and int(base.max()) > 0


def test_cuda_sample_axis_step_split_polygons():
    """test_sharding.py:225: the same exact split for kernel 7 (11 granules
    over 8 shards)."""
    cfgs = example_polygon_configs(24, k=6, seed=9, device="cpu")
    key = prng.PRNGKey(5)
    n = 11 * 64
    base = mc_polygon_cuda.mc_round_polygons_cuda(key, _uids(24), cfgs, ROBOT_4GON,
                                                  0, n_batch=n)
    got = est._cuda_sharded_counts(key, _uids(24), cfgs, ROBOT_4GON, 0, n_batch=n,
                                   mesh=_mesh(8, sample_axis=8))
    assert torch.equal(got, base) and int(base.max()) > 0


@pytest.mark.parametrize("shape_noise", [False, True])
def test_cuda_sharded_counts_smoke(rng, shape_noise):
    """test_sharding.py:259: kernel 1 over a config-axis mesh whose axis
    does not divide the rows (61 over 8 blocks) and over a (2, 2) mesh:
    the counts of every row, bitwise the unsharded launch."""
    cfgs = _kernel1_inputs(rng, 61, shape_noise)
    key = prng.PRNGKey(5)
    base = mc_cuda.mc_round_cuda(key, _uids(61), cfgs, ROBOT, 0, n_batch=256,
                                 shape_noise=shape_noise)
    for mesh in (_mesh(8), _mesh(4, sample_axis=2)):
        got = mc_round(key, _uids(61), cfgs, ROBOT, 0, n_batch=256, impl="cuda",
                       shape_noise=shape_noise, mesh=mesh)
        assert got.shape == (61,) and torch.equal(got, base)
    assert int(base.max()) > 0


def test_cuda_sharded_counts_polygons_smoke():
    """test_sharding.py:283: kernel 7 over 8 config blocks and a (2, 2)
    mesh, bitwise the unsharded launch."""
    cfgs = example_polygon_configs(30, k=6, seed=9, device="cpu")
    key = prng.PRNGKey(5)
    base = mc_polygon_cuda.mc_round_polygons_cuda(key, _uids(30), cfgs, ROBOT_4GON,
                                                  2, n_batch=192)
    for mesh in (_mesh(8), _mesh(4, sample_axis=2)):
        got = mc_round(key, _uids(30), cfgs, ROBOT_4GON, 2, n_batch=192,
                       impl="cuda", mesh=mesh)
        assert torch.equal(got, base)
    assert int(base.max()) > 0


def test_cuda_sharded_counts_moving_polygons_smoke():
    """test_sharding.py:312: kernel 14 (translation-only k-gons) over 8
    config blocks and a (2, 2) mesh, bitwise the unsharded launch."""
    static = example_polygon_configs(30, k=6, seed=9, device="cpu")
    r = np.random.default_rng(3)
    cfgs = moving_polygon_configs(
        static.position, static.pose_theta, static.obstacle_verts, static.std_dev,
        r.uniform(-2, 2, (30, 2)).astype(np.float32), 0.0,
        r.uniform(0.5, 3, 30).astype(np.float32))
    key = prng.PRNGKey(5)
    base = mc_moving_polygon_cuda.mc_round_moving_polygons_cuda(
        key, _uids(30), cfgs, ROBOT_4GON, 1, n_batch=192)
    for mesh in (_mesh(8), _mesh(4, sample_axis=2)):
        got = mc_round(key, _uids(30), cfgs, ROBOT_4GON, 1, n_batch=192,
                       impl="cuda", ca_iters=0, mesh=mesh)
        assert torch.equal(got, base)
    assert int(base.max()) > 0


def test_cuda_sharded_counts_moving_rects_smoke(rng):
    """Kernel 13 (translation-only rectangles, its exact window) over 8
    config blocks and an uneven (2, 3) granule split, bitwise the
    unsharded launch."""
    c = 30
    cfgs = moving_configs(
        rng.uniform(-4, 4, (c, 2)).astype(np.float32),
        rng.uniform(0, 7, c).astype(np.float32),
        rng.uniform(0.5, 4, (c, 2)).astype(np.float32),
        rng.uniform(0, 0.3, (c, 5)).astype(np.float32),
        rng.uniform(-1, 1, (c, 2)).astype(np.float32), 0.0, 2.0)
    key = prng.PRNGKey(9)
    base = mc_toi_cuda.mc_round_moving_cuda(key, _uids(c), cfgs, ROBOT, 4,
                                            n_batch=320, ca_iters=0)
    for mesh in (_mesh(8), _mesh(6, sample_axis=3)):
        got = mc_round(key, _uids(c), cfgs, ROBOT, 4, n_batch=320, impl="cuda",
                       ca_iters=0, mesh=mesh)
        assert torch.equal(got, base)
    assert int(base.max()) > 0


def test_adaptive_sharded_bitwise_matches_unsharded(rng, jdevices):
    """test_sharding.py:353: the adaptive driver over an (8, 1) mesh on the
    threefry path (the JAX package's sharded run too) and on the kernel's
    plain version under a (2, 2) mesh."""
    kw = dict(max_samples=8000, initial_batch=1000, initial_phase_samples=2000,
              later_batch=2000, bin_accuracy=(0.002, 0.002, 0.005), min_active=16)
    base, got, want = _adaptive_both(rng, 64, kw, 21, {})
    _assert_labels_equal(got, base)
    _assert_labels_equal(got, want)
    _, tc = _both(rng, 64)
    cfg = AdaptiveConfig(**kw, impl="cuda")
    _assert_labels_equal(acp(prng.PRNGKey(21), tc, ROBOT, cfg,
                             mesh=_mesh(4, sample_axis=2)),
                         acp(prng.PRNGKey(21), tc, ROBOT, cfg))


def test_process_batch_range_partition():
    """test_sharding.py:375, held to JAX's process_batch_range: the union
    over processes is the global range, disjoint and ordered."""
    for num_batches, n_proc, start in [(100, 8, 0), (7, 3, 5), (3, 8, 0)]:
        seen = []
        for pid in range(n_proc):
            r = process_batch_range(num_batches, start, process_id=pid,
                                    num_processes=n_proc)
            assert r == jpar.process_batch_range(num_batches, start, process_id=pid,
                                                 num_processes=n_proc)
            seen.extend(r)
        assert seen == list(range(start, start + num_batches))
    with pytest.raises(ValueError, match="out of range"):
        process_batch_range(10, process_id=4, num_processes=4)
    # without a process group: rank 0 of 1
    assert process_batch_range(5, 2) == range(2, 7)


def test_global_mesh_single_process(jdevices):
    """test_sharding.py:393 (test_global_mesh_single_host), held to JAX's
    global_mesh: in one process it is make_mesh over the local devices,
    and the sample axis must divide the per-process device count."""
    mesh = global_mesh(sample_axis=2, devices=[CPU] * 8)
    jmesh = jpar.global_mesh(sample_axis=2, devices=jdevices)
    assert mesh.shape == dict(jmesh.shape) == {"config": 4, "sample": 2}
    assert not mesh.spans_processes and mesh.is_local(3, 1)
    with pytest.raises(ValueError, match="ICI"):
        jpar.global_mesh(sample_axis=16, devices=jdevices)
    with pytest.raises(ValueError, match="per-process device count"):
        global_mesh(sample_axis=16, devices=[CPU] * 8)


def _blocks(mesh, n, *arrays):
    """Each array's rows, cut into the mesh's config blocks."""
    return [[a[lo:hi] for a in arrays] for lo, hi in config_blocks(n, mesh)]


def test_toi_and_distance_shard_over_config_axis(rng):
    """test_sharding.py:405: signed distance and time of impact on the
    mesh's row blocks concatenate to the whole batch's outputs (within
    JAX's bars: distances to f32 rounding, hit/miss exactly, times 1e-5)."""
    from collide2d_tpu_torch.ops.distance import rect_signed_distance
    from collide2d_tpu_torch.ops.toi import rect_time_of_impact

    n = 64
    t = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
    c1, c2 = t(rng.uniform(-1, 1, (n, 2))), t(rng.uniform(2, 5, (n, 2)))
    e1, e2 = t(rng.uniform(0.5, 3, (n, 2))), t(rng.uniform(0.5, 3, (n, 2)))
    th, v2, w = t(rng.uniform(0, 7, n)), t(rng.uniform(-1, 1, (n, 2))), t(rng.uniform(-1, 1, n))

    def dist(c1, e1, th, c2, e2):
        return rect_signed_distance(c1, e1, th, c2, e2, th)

    def toi(c1, e1, th, c2, e2, v2, w):
        return rect_time_of_impact(c1, e1, th, torch.zeros_like(c1), w, c2, e2, th,
                                   v2, -w, t_max=6.0, iters=64)

    mesh = _mesh(8)
    args = (c1, e1, th, c2, e2)
    got = torch.cat([dist(*b) for b in _blocks(mesh, n, *args)])
    np.testing.assert_allclose(got.numpy(), dist(*args).numpy(), atol=2e-6, rtol=1e-6)
    args = (c1, e1, th, c2, e2, v2, w)
    got_t = torch.cat([toi(*b) for b in _blocks(mesh, n, *args)]).numpy()
    want_t = toi(*args).numpy()
    np.testing.assert_array_equal(np.isfinite(got_t), np.isfinite(want_t))
    m = np.isfinite(want_t)
    np.testing.assert_allclose(got_t[m], want_t[m], atol=1e-5)
    assert m.any()


def test_moving_sample_axis_bitwise(rng, jdevices):
    """test_sharding.py:461: rotating MovingConfigs through the sample-axis
    step round-robin (the threefry cascade) are bitwise the unsharded
    counts, and equal the JAX package's sharded counts."""
    from collide2d_tpu.mc.moving import moving_configs as jmoving_configs

    c = 32
    fields = (rng.uniform(-4, 4, (c, 2)).astype(np.float32),
              rng.uniform(0, 7, c).astype(np.float32),
              rng.uniform(0.5, 4, (c, 2)).astype(np.float32),
              rng.uniform(0, 0.3, (c, 5)).astype(np.float32),
              rng.uniform(-1, 1, (c, 2)).astype(np.float32),
              rng.uniform(-0.5, 0.5, c).astype(np.float32))
    cfgs = moving_configs(*fields, 2.0)
    key = prng.PRNGKey(9)
    base = mc_round(key, _uids(c), cfgs, ROBOT, 0, n_batch=512, step_samples=64)
    got = est._sample_sharded_counts(key, _uids(c), cfgs, ROBOT, 0, 8,
                                     step_samples=64, use_vertices=False,
                                     mesh=_mesh(4, sample_axis=4))
    assert torch.equal(got, base)
    jmesh = jpar.make_mesh(jdevices, sample_axis=4)
    jcfgs = jmoving_configs(*fields, 2.0)
    want = jest._sample_sharded_counts(
        _jkey(9), jnp.arange(c, dtype=jnp.int32), jpar.shard_configs(jcfgs, jmesh),
        jnp.asarray(ROBOT, jnp.float32), jnp.int32(0), jnp.int32(8),
        step_samples=64, use_vertices=False, mesh=jmesh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_query_layer_config_dp_bitwise(rng):
    """test_sharding.py:491: manifolds, raycasts and hulls on the mesh's
    row blocks concatenate to the whole batch's outputs bit for bit."""
    from collide2d_tpu_torch.ops.geometry import convex_hull
    from collide2d_tpu_torch.ops.manifold import polygon_contact_manifold
    from collide2d_tpu_torch.ops.raycast import polygon_raycast
    from tests.test_distance import _random_pair_batch

    p1, p2 = (torch.as_tensor(np.asarray(a)) for a in _random_pair_batch(rng, n=96))
    o = torch.as_tensor(rng.uniform(-6, 6, (96, 2)).astype(np.float32))
    d = torch.as_tensor(rng.uniform(-1, 1, (96, 2)).astype(np.float32))
    pts = torch.as_tensor(rng.uniform(-2, 2, (96, 12, 2)).astype(np.float32))
    mesh = _mesh(8)
    cat = lambda outs: [torch.cat(x) for x in zip(*outs)]  # noqa: E731
    for got, want in [
        (cat([polygon_contact_manifold(*b) for b in _blocks(mesh, 96, p1, p2)]),
         polygon_contact_manifold(p1, p2)),
        (cat([polygon_raycast(*b) for b in _blocks(mesh, 96, o, d, p1)]),
         polygon_raycast(o, d, p1)),
        ([torch.cat([convex_hull(*b) for b in _blocks(mesh, 96, pts)])],
         [convex_hull(pts)]),
    ]:
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_shard_configs_keeps_every_class(rng):
    """`shard_configs` splits any configuration class into contiguous
    blocks of that class (uneven rows: the first blocks one row longer)."""
    _, rects = _both(rng, 10)
    polys = example_polygon_configs(10, k=5, seed=2, device="cpu")
    movers = moving_configs(rects.position, rects.pose_theta, rects.obstacle_wh,
                            rects.std_dev, 0.5, 0.1, 1.0)
    mpolys = moving_polygon_configs(polys.position, polys.pose_theta,
                                    polys.obstacle_verts, polys.std_dev, 0.5)
    mesh = _mesh(8, sample_axis=2)  # 4 config blocks
    assert config_blocks(10, mesh) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    for cfgs in (rects, polys, movers, mpolys):
        blocks = shard_configs(cfgs, mesh)
        assert [b.num for b in blocks] == [3, 3, 2, 2]
        assert all(type(b) is type(cfgs) for b in blocks)
        for f, a in zip(cfgs._fields, cfgs):
            assert torch.equal(torch.cat([getattr(b, f) for b in blocks]), a)


@pytest.mark.parametrize("impl", ["threefry", "cuda"])
def test_mesh_checkpoint_resumes_bitwise(rng, tmp_path, impl):
    """A checkpoint written under a (2, 2) mesh resumes bitwise, with the
    mesh and without it (and an unsharded run's file under the mesh)."""
    from tests.test_torch_checkpoint import TIGHT, Stop, _bomb

    _, tc = _both(rng, 40)
    cfg = AdaptiveConfig(**TIGHT, impl=impl)
    key = prng.PRNGKey(31)
    base = acp(key, tc, ROBOT, cfg)
    mesh = _mesh(4, sample_axis=2)
    for write_mesh, read_mesh in ((mesh, mesh), (mesh, None), (None, mesh)):
        ckpt = tmp_path / "c.npz"
        with pytest.raises(Stop):
            acp(key, tc, ROBOT, cfg, progress=_bomb(), checkpoint_path=str(ckpt),
                checkpoint_every=1, mesh=write_mesh)
        assert ckpt.exists()
        with np.load(ckpt) as z:
            saved_n = int(z["n_samples"])
        seen = []
        got = acp(key, tc, ROBOT, cfg, checkpoint_path=str(ckpt), checkpoint_every=1,
                  mesh=read_mesh, progress=lambda **kw: seen.append(kw["n_samples"]))
        assert seen[0] > saved_n  # resumed, not restarted
        _assert_labels_equal(got, base)
        assert not ckpt.exists()


@pytest.mark.parametrize("impl", ["threefry", "cuda"])
def test_generate_under_a_mesh_is_byte_identical(tmp_path, impl):
    """`generate` with an explicit (2, 2) mesh (and with --data_parallel on
    the one CPU device, no mesh) writes the bytes of the unsharded run."""
    from collide2d_tpu_torch.data.pipeline import GenerateConfig, generate_dataset

    kw = dict(num_batches=2, batch_size=96, num_poses=8, num_variances=8, seed=7,
              max_samples=4000, verbose=False, impl=impl, device="cpu")
    generate_dataset(GenerateConfig(data_dir=str(tmp_path / "a"), **kw))
    generate_dataset(GenerateConfig(data_dir=str(tmp_path / "b"),
                                    mesh=_mesh(4, sample_axis=2), **kw))
    generate_dataset(GenerateConfig(data_dir=str(tmp_path / "c"),
                                    data_parallel=True, **kw))
    for d in ("b", "c"):
        for i in range(2):
            assert ((tmp_path / d / f"{i}.npy").read_bytes()
                    == (tmp_path / "a" / f"{i}.npy").read_bytes())
