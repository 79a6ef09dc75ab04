"""The fused k-gon Monte Carlo kernel's plain version and the threefry
k-gon path on the CPU, against the JAX package.

(a) `dedup_robot_axes` equals the JAX function, padded and degenerate
    robots included.
(b) `pack_polygon_mc_params` equals the JAX tables transposed: the rows
    that do not depend on the placed robot bitwise; the others within
    1e-5 absolute, since both place the robot with their own cos/sin (an
    ulp apart), and a table entry is a sum of two products of coordinates
    of magnitude < 10.
(c) Fed the TPU kernel's test draws (the `_TEST_UNIFORM_FN` stub) and the
    JAX tables, the plain version returns exactly the counts of
    `mc_poly_counts_pallas(..., interpret=True)`, with every robot axis
    and with the deduplicated subset.
(d) Philox counts are a pure function of (seed, uid, sample index):
    invariant under permutation, compaction and an offset split.
(e) The threefry path (`_counts_chunk_polygons` via
    `collision_probability`) gives the JAX ``jnp`` path's counts on pinned
    seeds; a count may differ only for a draw within an ulp of a
    separation boundary, so at most 1 sample in 10^5 may differ.
(f) Statistically, the Philox path agrees with the threefry path: per-row
    pooled z-scores with mean z^2 in [0.6, 1.5] and max |z| < 6, rows
    where both estimates are 0 or both 1 skipped.
(g) Kernels 7 and 14 build one library per shape: the hashed library path
    differs per (K, K2, K2A) and is stable, and each wrapper loads the
    library of the shape it is called with (no nvcc needed).

(h) ``normal_method="box_muller"``: the plain version equals the TPU
    kernel's Box-Muller draws in interpret mode on the stub, and a
    Box-Muller build of kernels 7 and 14 is a library of its own.

The CUDA kernel itself cannot run here: tests/test_torch_gpu.py holds it
against this plain version and skips without a card.
"""

import ctypes

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import collide2d_tpu.ops.mc_pallas as mcp
import collide2d_tpu.ops.mc_polygon_pallas as jmp
from collide2d_tpu.mc.estimator import collision_probability as j_collision_probability
from collide2d_tpu.models import collision_model as jm
from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.estimator import (
    collision_probability,
    polygon_configs_from_numpy,
)
from collide2d_tpu_torch.models import collision_model as tm
from collide2d_tpu_torch.ops import mc_moving_polygon_cuda as tmmp
from collide2d_tpu_torch.ops import mc_polygon_cuda as tmp
from collide2d_tpu_torch.utils import cuda_build
from tests.conftest import deterministic_uniform_stub

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ROBOT = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87],
                  [-2.035, 0.87]], np.float32)
HEXAGON = np.stack([np.cos(np.arange(6) * np.pi / 3),
                    np.sin(np.arange(6) * np.pi / 3)], -1).astype(np.float32)
TRIANGLE = np.array([[0, 0], [2, 0], [0.5, 1.5]], np.float32)


@pytest.fixture(scope="module")
def batch():
    b = jm.example_polygon_configs(n=128, k=6, seed=3)
    return b, polygon_configs_from_numpy(b, "cpu")


@pytest.mark.parametrize("robot", [
    ROBOT, np.concatenate([ROBOT, ROBOT[-1:], ROBOT[-1:]]), HEXAGON, TRIANGLE,
    np.zeros((4, 2), np.float32), np.array([[1, 1]] * 3 + [[2, 1]], np.float32),
], ids=["rect", "rect-padded", "hexagon", "triangle", "point", "segment"])
def test_dedup_robot_axes_matches_jax(robot):
    assert tmp.dedup_robot_axes(robot) == jmp.dedup_robot_axes(robot)


def test_dedup_keeps_half_the_rectangle_axes():
    assert tmp.dedup_robot_axes(ROBOT) == (0, 1)
    assert tmp.dedup_robot_axes(np.zeros((4, 2), np.float32)) == ()


@pytest.mark.parametrize("dedup", [False, True])
def test_pack_polygon_mc_params_matches_jax(batch, dedup):
    b, t = batch
    a_keep = jmp.dedup_robot_axes(ROBOT) if dedup else None
    want = np.asarray(jmp.pack_polygon_mc_params(b, jnp.asarray(ROBOT), a_keep)).T
    got = tmp.pack_polygon_mc_params(t, ROBOT, a_keep)
    k2a = 2 if dedup else 4
    assert got.shape == want.shape == (128, tmp._num_rows(6, 4, k2a))
    assert got.is_contiguous() and got.dtype == torch.float32
    o = tmp._offsets(6, 4, k2a)
    # sigmas and the obstacle's own normals and intervals: no cos/sin
    exact = list(range(3)) + list(range(o["nx"], o["p1"]))
    np.testing.assert_array_equal(got.numpy()[:, exact], want[:, exact])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dedup", [False, True])
def test_plain_equals_tpu_kernel_on_stub_draws(monkeypatch, batch, dedup):
    b, _ = batch
    c, sub, k, k2 = jmp.LANE_CONFIGS, 16, 6, 4
    a_keep = jmp.dedup_robot_axes(ROBOT) if dedup else None
    k2a = k2 if a_keep is None else len(a_keep)
    params_j = jmp.pack_polygon_mc_params(b, jnp.asarray(ROBOT), a_keep)
    monkeypatch.setattr(mcp, "_TEST_UNIFORM_FN", deterministic_uniform_stub())
    want = np.asarray(jmp.mc_poly_counts_pallas(
        jnp.asarray([1, 2], jnp.int32), params_j, jnp.int32(1), sub=sub,
        k=k, k2=k2, k2_axes=k2a, interpret=True))
    # Replay the stub outside the kernel: call 2d+h is draw d (dx, dy,
    # theta) of half h, shaped (sub/2, C); the kernel's two halves are two
    # samples per row.
    stub = deterministic_uniform_stub()
    calls = [np.asarray(stub((sub // 2, c))) for _ in range(6)]
    u = np.zeros((c, sub, 3), np.float32)
    for d in range(3):
        u[:, : sub // 2, d] = calls[2 * d].T
        u[:, sub // 2:, d] = calls[2 * d + 1].T
    params = torch.from_numpy(np.ascontiguousarray(np.asarray(params_j).T))
    got = tmp.mc_poly_counts_plain(params, torch.arange(c, dtype=torch.int32),
                                   (1, 2), sub, k=k, k2=k2, k2a=k2a,
                                   uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < c * sub  # both outcomes present


@pytest.mark.parametrize("dedup", [False, True])
def test_plain_box_muller_equals_tpu_kernel_on_stub_draws(monkeypatch, batch, dedup):
    """`normal_method="box_muller"`: the stub's calls 2d and 2d + 1 are pair
    d's u1 and u2, the first half of the samples taking r cos a and the
    second r sin a (`mc_cuda.uniform_normals`)."""
    b, _ = batch
    c, sub, k, k2 = jmp.LANE_CONFIGS, 16, 6, 4
    a_keep = jmp.dedup_robot_axes(ROBOT) if dedup else None
    k2a = k2 if a_keep is None else len(a_keep)
    params_j = jmp.pack_polygon_mc_params(b, jnp.asarray(ROBOT), a_keep)
    monkeypatch.setattr(mcp, "_TEST_UNIFORM_FN", deterministic_uniform_stub())
    want = np.asarray(jmp.mc_poly_counts_pallas(
        jnp.asarray([1, 2], jnp.int32), params_j, jnp.int32(1), sub=sub,
        k=k, k2=k2, k2_axes=k2a, interpret=True, normal_method="box_muller"))
    stub = deterministic_uniform_stub()
    calls = [np.asarray(stub((sub // 2, c))) for _ in range(6)]
    u = np.zeros((c, sub, 3), np.float32)
    for d in range(3):
        u[:, : sub // 2, d] = calls[2 * d].T
        u[:, sub // 2:, d] = calls[2 * d + 1].T
    params = torch.from_numpy(np.ascontiguousarray(np.asarray(params_j).T))
    got = tmp.mc_poly_counts_plain(params, torch.arange(c, dtype=torch.int32),
                                   (1, 2), sub, k=k, k2=k2, k2a=k2a,
                                   normal_method="box_muller",
                                   uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < c * sub


def test_fully_degenerate_robot_has_no_robot_axes(batch):
    _, t = batch
    robot = np.zeros((4, 2), np.float32)
    params = tmp.pack_polygon_mc_params(t, robot, ())
    assert params.shape == (128, tmp._num_rows(6, 4, 0))
    uids = torch.arange(128, dtype=torch.int32)
    got = tmp.mc_poly_counts(params, uids, (3, 4), 256, k=6, k2=4, k2a=0)
    # a point robot at each position: the counts are those of the point
    # inside the noisy obstacle, which the full axis set agrees with
    full = tmp.mc_poly_counts(tmp.pack_polygon_mc_params(t, robot), uids, (3, 4),
                              256, k=6, k2=4, k2a=4)
    np.testing.assert_array_equal(got.numpy(), full.numpy())


@pytest.fixture(scope="module")
def philox_case(batch):
    _, t = batch
    params = tmp.pack_polygon_mc_params(t, ROBOT, (0, 1))
    uids = torch.from_numpy(np.random.default_rng(2).permutation(1000)[:128]
                            .astype(np.int32))
    seed = (0x12345678, 0x9ABCDEF0)
    counts = tmp.mc_poly_counts_plain(params, uids, seed, 1500, k=6, k2=4, k2a=2)
    return params, uids, seed, counts


def test_counts_invariant_under_permutation_and_compaction(philox_case):
    params, uids, seed, counts = philox_case
    keep = torch.from_numpy(np.random.default_rng(3).permutation(128)[:50])
    sub = tmp.mc_poly_counts_plain(params[keep].contiguous(), uids[keep].contiguous(),
                                   seed, 1500, k=6, k2=4, k2a=2)
    np.testing.assert_array_equal(sub.numpy(), counts[keep].numpy())


def test_counts_invariant_under_offset_split(philox_case):
    params, uids, seed, counts = philox_case
    first = tmp.mc_poly_counts_plain(params, uids, seed, 600, k=6, k2=4, k2a=2)
    second = tmp.mc_poly_counts_plain(params, uids, seed, 900, offset=600,
                                      k=6, k2=4, k2a=2)
    np.testing.assert_array_equal((first + second).numpy(), counts.numpy())
    small = tmp.mc_poly_counts_plain(params, uids, seed, 1500, k=6, k2=4, k2a=2,
                                     max_elems=999)
    np.testing.assert_array_equal(small.numpy(), counts.numpy())
    other = tmp.mc_poly_counts_plain(params, uids, (seed[0], seed[1] ^ 1), 1500,
                                     k=6, k2=4, k2a=2)
    assert (other != counts).any()


def test_wrapper_routes_cpu_to_plain_and_validates(philox_case):
    params, uids, seed, counts = philox_case
    tmp.reset_launches()
    got = tmp.mc_poly_counts(params, uids, seed, 1500, k=6, k2=4, k2a=2)
    np.testing.assert_array_equal(got.numpy(), counts.numpy())
    assert tmp.LAUNCHES == 0  # the plain version is not a launch
    with pytest.raises(ValueError, match="float32"):
        tmp.mc_poly_counts(params.double(), uids, seed, 10, k=6, k2=4, k2a=2)
    with pytest.raises(ValueError, match=r"\(C, 144\)"):
        tmp.mc_poly_counts(params, uids, seed, 10, k=6, k2=4, k2a=4)
    with pytest.raises(ValueError, match="K2A"):
        tmp.mc_poly_counts(params, uids, seed, 10, k=6, k2=4, k2a=5)
    with pytest.raises(ValueError, match="uids"):
        tmp.mc_poly_counts(params, uids.long(), seed, 10, k=6, k2=4, k2a=2)
    with pytest.raises(ValueError, match="contiguous"):
        tmp.mc_poly_counts(params.t().contiguous().t(), uids, seed, 10, k=6, k2=4,
                           k2a=2)
    with pytest.raises(ValueError, match="unsupported device"):
        tmp.mc_poly_counts(params.to("meta"), uids.to("meta"), seed, 10, k=6,
                           k2=4, k2a=2)


@pytest.mark.parametrize("seed,k,n", [(5, 5, 2048), (6, 8, 1000)])
def test_threefry_counts_match_jax_jnp(seed, k, n):
    b = jm.example_polygon_configs(n=64, k=k, seed=seed)
    want = np.asarray(j_collision_probability(
        jax.random.PRNGKey(seed), b, jnp.asarray(ROBOT), n, impl="jnp")) * n
    got = collision_probability(prng.PRNGKey(seed), polygon_configs_from_numpy(b, "cpu"),
                                ROBOT, n).numpy() * n
    assert np.abs(np.rint(got) - np.rint(want)).sum() <= 1e-5 * b.num * n
    assert 0 < want.sum() < b.num * n


def test_plain_philox_agrees_with_threefry_statistically():
    c, n = 128, 8192
    b = tm.example_polygon_configs(n=c, k=6, seed=9, device="cpu")
    p_fry = collision_probability(prng.PRNGKey(21), b, ROBOT, n).numpy()
    p_phx = collision_probability(prng.PRNGKey(77), b, ROBOT, n,
                                  impl="cuda").numpy()
    a, d = p_fry.astype(np.float64), p_phx.astype(np.float64)
    both = ((a == 0) & (d == 0)) | ((a == 1) & (d == 1))
    a, d = a[~both], d[~both]
    pbar = (a + d) / 2
    z = (a - d) / np.sqrt(pbar * (1 - pbar) * 2 / n)
    print(f"{a.size} rows compared: mean z^2 {np.mean(z * z):.3f}, "
          f"max |z| {np.abs(z).max():.2f}")
    assert a.size >= 30
    assert 0.6 <= np.mean(z * z) <= 1.5
    assert np.abs(z).max() < 6


SHAPES = [(8, 4, 2), (6, 4, 2), (8, 4, 4), (20, 4, 2), (5, 4, 0), (6, 6, 3)]


@pytest.mark.parametrize("source", ["mc_polygon_kernel", "mc_moving_polygon_kernel"])
def test_library_path_is_one_per_shape_and_stable(source):
    paths = [cuda_build.library_path(source, tmp.shape_defines(*s)) for s in SHAPES]
    assert len(set(paths)) == len(SHAPES)
    assert paths == [cuda_build.library_path(source, tmp.shape_defines(*s))
                     for s in SHAPES]
    assert all(p.name.startswith(f"lib{source}-") and p.parent == cuda_build.BUILD_DIR
               for p in paths)
    assert cuda_build.define_flags(tmp.shape_defines(8, 4, 2)) == [
        "-DMC_POLY_K=8", "-DMC_POLY_K2=4", "-DMC_POLY_K2A=2"]
    # a source built without defines keeps the name it had before defines
    assert cuda_build.library_path("mc_kernel") == cuda_build.library_path("mc_kernel", ())


@pytest.mark.parametrize("module,fn", [(tmp, "mc_poly"), (tmmp, "mc_moving_poly")])
def test_box_muller_is_a_library_of_its_own(monkeypatch, module, fn):
    """A Box-Muller build adds ``-DMC_BOX_MULLER=1`` to the shape's defines:
    another hashed library, and the erf_inv build keeps its path."""
    from types import SimpleNamespace

    from collide2d_tpu_torch.ops import mc_cuda

    source = module._KERNEL
    erfinv = cuda_build.library_path(source, tmp.shape_defines(8, 4, 2))
    box = cuda_build.library_path(
        source, tmp.shape_defines(8, 4, 2) + mc_cuda.normal_defines("box_muller"))
    assert box != erfinv and mc_cuda.normal_defines("erfinv") == ()
    assert cuda_build.define_flags(mc_cuda.normal_defines("box_muller")) == [
        "-DMC_BOX_MULLER=1"]
    assert cuda_build.library_path("mc_kernel", mc_cuda.normal_defines("box_muller")) \
        != cuda_build.library_path("mc_kernel")
    seen = []

    def load(name, defines=()):
        seen.append((name, defines))
        return SimpleNamespace(**{f"{fn}_counts_launch": SimpleNamespace(),
                                  f"{fn}_max_samples_per_round": SimpleNamespace()})

    monkeypatch.setattr(cuda_build, "load", load)
    module._kernel_lib(8, 4, 2, "box_muller")
    assert seen == [(source, tmp.shape_defines(8, 4, 2) + (("MC_BOX_MULLER", 1),))]
    with pytest.raises(ValueError, match="normal_method"):
        module._kernel_lib(8, 4, 2, "polar")


@pytest.mark.parametrize("module,fn", [(tmp, "mc_poly"), (tmmp, "mc_moving_poly")])
def test_wrapper_loads_the_library_of_its_shape(monkeypatch, module, fn):
    from types import SimpleNamespace

    seen = []

    def load(name, defines=()):
        seen.append((name, defines))
        return SimpleNamespace(**{f"{fn}_counts_launch": SimpleNamespace(),
                                  f"{fn}_max_samples_per_round": SimpleNamespace()})

    monkeypatch.setattr(cuda_build, "load", load)
    lib = module._kernel_lib(20, 6, 3)
    assert seen == [(module._KERNEL, tmp.shape_defines(20, 6, 3))]
    assert getattr(lib, f"{fn}_counts_launch").restype is ctypes.c_int
