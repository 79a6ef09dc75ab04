"""The CUDA kernels on the card; every test skips without one.

The file imports no JAX (the machine with the card has none), so it runs
there without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerance of the Monte Carlo kernels (rectangles and k-gons) against
their plain versions: the two share the Philox stream, the 23-bit codes,
the erf_inv polynomial and the separation test, but round ``sincosf``,
``log1pf`` and contracted multiply-adds their own way, which can flip
only a sample within an ulp of touching: the counts may differ by at most
1e-5 of all samples. The Box-Muller builds of kernels 1, 7 and 14 are held
to the same bar (their ``logf`` and ``sincosf`` against torch's). The SAT
kernels (rectangles, boxes and k-gons) round every operation as their plain
versions do: labels bitwise, counts exact.
The bars of the geometry-query kernels stand above their tests below.
Kernel 16 (the streaming-bandwidth probe) adds in another order than its
plain version: within 1e-5 x (sum|r1| * s + sum|r2|), and bitwise equal
to itself from launch to launch.
"""

import ctypes

import numpy as np
import pytest
import torch

from collide2d_tpu_torch import cli
from collide2d_tpu_torch.mc.estimator import configs_from_numpy
from collide2d_tpu_torch.models.collision_model import (
    CollisionProbabilityModel,
    PolygonCollisionProbabilityModel,
    example_polygon_configs,
)
from collide2d_tpu_torch.ops import (
    distance_cuda,
    manifold_cuda,
    mc_cuda,
    mc_polygon_cuda,
    polygon_cuda,
    sat_cuda,
    stream_cuda,
    toi_cuda,
)
from collide2d_tpu_torch.utils import cuda_build

pytestmark = pytest.mark.gpu

ROBOT = (4.07, 1.74)
SEED = (0x01234567, 0x89ABCDEF)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(cuda, c, shape_noise, seed=5):
    rng = np.random.default_rng(seed)
    sd = rng.uniform(0, 0.4, (c, 5)).astype(np.float32)
    if not shape_noise:
        sd[:, 3:] = 0.0
    cfg = (rng.uniform(-6, 6, (c, 2)), rng.uniform(0, 2 * np.pi, c),
           rng.uniform(0.5, 5, (c, 2)), sd)
    params = mc_cuda.pack_mc_params(configs_from_numpy(cfg, cuda), ROBOT)
    uids = torch.from_numpy(rng.permutation(4 * c)[:c].astype(np.int32)).to(cuda)
    return params, uids


@pytest.mark.parametrize("shape_noise", [False, True])
def test_kernel_matches_plain(cuda, shape_noise):
    c, n = 2048, 8192
    params, uids = _case(cuda, c, shape_noise)
    before = mc_cuda.LAUNCHES
    got = mc_cuda.mc_counts(params, uids, SEED, n, shape_noise=shape_noise)
    want = mc_cuda.mc_counts_plain(params, uids, SEED, n, shape_noise=shape_noise)
    torch.cuda.synchronize()
    assert mc_cuda.LAUNCHES == before + 1
    assert 0 < int(want.sum()) < c * n
    assert int((got - want).abs().sum()) <= 1e-5 * c * n


# S samples a thread at once (4 in kernel 1, 2 in kernel 13): n = 4,097
# leaves a block of one sample and a batch mostly past the end, n = 1 a
# single sample; offsets near 2^32 put a block across the high index word
# (the 64-bit instantiation) or next to it.
ODD_SAMPLES = [(4097, 0), (1, 0), (4097, (1 << 32) - 1000), (3000, (1 << 32) + 5)]


@pytest.mark.parametrize("shape_noise", [False, True])
@pytest.mark.parametrize("n,offset", ODD_SAMPLES)
def test_kernel_matches_plain_at_odd_sizes_and_offsets(cuda, n, offset, shape_noise):
    c = 512
    params, uids = _case(cuda, c, shape_noise, seed=8)
    before = mc_cuda.LAUNCHES
    got = mc_cuda.mc_counts(params, uids, SEED, n, offset=offset, shape_noise=shape_noise)
    want = mc_cuda.mc_counts_plain(params, uids, SEED, n, offset=offset,
                                   shape_noise=shape_noise)
    torch.cuda.synchronize()
    assert mc_cuda.LAUNCHES == before + 1
    assert 0 < int(want.sum()) < c * n
    assert int((got - want).abs().sum()) <= 1e-5 * c * n
    # a split at the first sample of the second high word gives the same sums
    cut = min(n - 1, max(1, (1 << 32) - offset)) if offset else n // 2
    if 0 < cut < n:
        first = mc_cuda.mc_counts(params, uids, SEED, cut, offset=offset,
                                  shape_noise=shape_noise)
        second = mc_cuda.mc_counts(params, uids, SEED, n - cut, offset=offset + cut,
                                   shape_noise=shape_noise)
        assert torch.equal(first + second, got)


@pytest.mark.parametrize("shape_noise", [False, True])
@pytest.mark.parametrize("n,offset", [(8192, 0), (3000, (1 << 32) + 5)])
def test_box_muller_kernel_matches_plain(cuda, shape_noise, n, offset):
    """Kernel 1's Box-Muller build (its own library) against its plain
    version, at the erf_inv build's bar; it counts in its own counter."""
    c = 2048
    params, uids = _case(cuda, c, shape_noise, seed=9)
    before, bm_before = mc_cuda.LAUNCHES, mc_cuda.BOX_MULLER_LAUNCHES
    kw = dict(offset=offset, shape_noise=shape_noise, normal_method="box_muller")
    got = mc_cuda.mc_counts(params, uids, SEED, n, **kw)
    want = mc_cuda.mc_counts_plain(params, uids, SEED, n, **kw)
    torch.cuda.synchronize()
    assert (mc_cuda.LAUNCHES, mc_cuda.BOX_MULLER_LAUNCHES) == (before, bm_before + 1)
    assert 0 < int(want.sum()) < c * n
    assert int((got - want).abs().sum()) <= 1e-5 * c * n
    erfinv = mc_cuda.mc_counts(params, uids, SEED, n, offset=offset,
                               shape_noise=shape_noise)
    assert not torch.equal(erfinv, got)  # the other build, another stream


def test_kernel_counts_invariant_under_split_and_compaction(cuda):
    c, n, cut = 1000, 10_000, 4096 + 77
    params, uids = _case(cuda, c, shape_noise=True, seed=6)
    whole = mc_cuda.mc_counts(params, uids, SEED, n)
    first = mc_cuda.mc_counts(params, uids, SEED, cut)
    second = mc_cuda.mc_counts(params, uids, SEED, n - cut, offset=cut)
    assert torch.equal(first + second, whole)
    keep = torch.randperm(c, generator=torch.Generator().manual_seed(1))[:300].to(cuda)
    sub = mc_cuda.mc_counts(params[keep].contiguous(), uids[keep].contiguous(), SEED, n)
    assert torch.equal(sub, whole[keep])


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    params, uids = _case(cuda, 64, shape_noise=False)
    before = mc_cuda.LAUNCHES
    with pytest.raises(ValueError, match="float32"):
        mc_cuda.mc_counts(params.double(), uids, SEED, 10)
    with pytest.raises(ValueError, match="contiguous"):
        mc_cuda.mc_counts(params.t().contiguous().t(), uids, SEED, 10)
    with pytest.raises(ValueError, match="uids on"):
        mc_cuda.mc_counts(params, uids.cpu(), SEED, 10)
    with pytest.raises(ValueError, match="exceeds"):
        mc_cuda.mc_counts(params, uids, SEED, 1 << 40)
    assert mc_cuda.LAUNCHES == before


def _sat_inputs(cuda, n, seed=7):
    """Packed vertex and box batches of ``n`` pairs (positions in
    [-6, 6]^2, extents in [0.1, 5], angles in [0, 2 pi))."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, lo, hi: torch.from_numpy(  # noqa: E731
        rng.uniform(lo, hi, shape).astype(np.float32)).to(cuda)
    c1, c2 = f32(n, 2, lo=-6, hi=6), f32(n, 2, lo=-6, hi=6)
    e1, e2 = f32(n, 2, lo=0.1, hi=5), f32(n, 2, lo=0.1, hi=5)
    t1, t2 = f32(n, lo=0, hi=2 * np.pi), f32(n, lo=0, hi=2 * np.pi)
    from collide2d_tpu_torch.ops.geometry import rects_from_params

    r1, r2 = rects_from_params(c1, e1, t1), rects_from_params(c2, e2, t2)
    return r1, r2, sat_cuda.pack_obbs(c1, e1, t1), sat_cuda.pack_obbs(c2, e2, t2)


@pytest.mark.parametrize("shift", [0.0, 0.37])
@pytest.mark.parametrize("kind", ["f32", "bf16", "obb"])
def test_sat_kernels_match_plain(cuda, kind, shift):
    n = 8 * 1024 * 3
    r1, r2, b1, b2 = _sat_inputs(cuda, n)
    if kind == "obb":
        a, b = b1, b2
        label, count = sat_cuda.obb_collide_cuda_t, sat_cuda.obb_count_cuda_t
        plain, names = sat_cuda.obb_collide_plain, ("obb_label", "obb_count")
    else:
        pack = sat_cuda.pack_rects_bf16 if kind == "bf16" else sat_cuda.pack_rects
        a, b = pack(r1), pack(r2)
        label, count = sat_cuda.sat_rects_cuda_t, sat_cuda.sat_count_cuda_t
        plain, names = sat_cuda.sat_collide_plain, ("sat_label", "sat_count")
    before = dict(sat_cuda.LAUNCHES)
    got = label(a, b, shift)
    total = count(a, b, shift)
    want = plain(a, b, shift)
    torch.cuda.synchronize()
    assert sat_cuda.LAUNCHES[names[0]] == before[names[0]] + 1
    assert sat_cuda.LAUNCHES[names[1]] == before[names[1]] + 1
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert torch.equal(got, want.reshape(-1).to(torch.float32))
    assert total.dim() == 0 and int(total) == int(want.sum())
    assert 0 < int(want.sum()) < n


def test_model_collide_launches_the_kernels(cuda):
    rng = np.random.default_rng(9)
    n = 5000  # padded to the alignment and sliced back
    pos = torch.from_numpy(rng.uniform(-6, 6, (n, 2)).astype(np.float32)).to(cuda)
    th = torch.from_numpy(rng.uniform(0, 2 * np.pi, n).astype(np.float32)).to(cuda)
    wh = torch.from_numpy(rng.uniform(0.1, 5, (n, 2)).astype(np.float32)).to(cuda)
    model = CollisionProbabilityModel()
    sat_cuda.reset_launches()
    for method, precision in (("vertex", "f32"), ("vertex", "bf16"), ("obb", "f32")):
        got = model.collide(pos, th, wh, method=method, precision=precision)
        want = model.collide(pos.cpu(), th.cpu(), wh.cpu(), method=method,
                             precision=precision, impl="torch")
        assert got.device.type == "cuda" and got.dtype == torch.int32
        # cos/sin of the card and the CPU may differ by an ulp, which can
        # flip only a pair within an ulp of touching.
        assert int((got.cpu() != want).sum()) <= 2
    assert sat_cuda.LAUNCHES == {"sat_label": 2, "sat_count": 0,
                                 "obb_label": 1, "obb_count": 0}


def test_sat_call_raises_when_the_build_fails(cuda, monkeypatch):
    def broken(name):
        raise RuntimeError(f"nvcc failed (1) for {name}.cu")

    r1, r2, _, _ = _sat_inputs(cuda, 8 * 1024)
    monkeypatch.setattr(cuda_build, "load", broken)
    before = dict(sat_cuda.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sat_cuda.sat_rects_cuda_t(sat_cuda.pack_rects(r1), sat_cuda.pack_rects(r2))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        CollisionProbabilityModel().collide(r1[:, 0], r1[:, 0, 0], r2[:, 2],
                                            method="obb")
    assert sat_cuda.LAUNCHES == before


ROBOT_4GON = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87],
                       [-2.035, 0.87]], np.float32)


def _polygons(rng, n, k, cuda, spread=3.0):
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, k)), axis=-1)
    ab = rng.uniform(0.3, 2.5, (n, 1, 2))
    shift = rng.uniform(-spread, spread, (n, 1, 2))
    p = np.stack([np.cos(ang), np.sin(ang)], -1) * ab + shift
    return torch.from_numpy(p.astype(np.float32)).to(cuda)


@pytest.mark.parametrize("k1,k2,bf16", [
    (4, 4, False), (6, 6, False), (8, 8, False), (16, 16, False), (4, 8, False),
    (3, 5, False), (8, 8, True), (6, 12, True)])
def test_polygon_kernel_matches_plain(cuda, k1, k2, bf16):
    n = 1 << 20
    rng = np.random.default_rng(k1 * 17 + k2)
    pack = polygon_cuda.pack_polygons_bf16 if bf16 else polygon_cuda.pack_polygons
    a, b = pack(_polygons(rng, n, k1, cuda)), pack(_polygons(rng, n, k2, cuda))
    before = polygon_cuda.LAUNCHES
    got = polygon_cuda.sat_polygons_cuda_t(a, b, k1=k1, k2=k2)
    want = polygon_cuda.sat_polygons_plain(a, b, k1, k2).reshape(-1).float()
    torch.cuda.synchronize()
    assert polygon_cuda.LAUNCHES == before + 1
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < n


# Above 16 vertices kernels 6, 9 and 10 loop over the true K in their one
# library: all three bitwise their plain versions as below 16 (9's pads to
# the next power of two, which the kernel's point distances to a polygon's
# last vertex reproduce).
@pytest.mark.parametrize("k1,k2", [(17, 4), (4, 17), (4, 20), (20, 20), (4, 32),
                                   (32, 32)])
def test_polygon_kernels_take_k_above_16(cuda, k1, k2):
    n = 1 << 16
    rng = np.random.default_rng(k1 * 101 + k2)
    p1, p2 = _polygons(rng, n, k1, cuda), _polygons(rng, n, k2, cuda)
    a, b = polygon_cuda.pack_polygons(p1), polygon_cuda.pack_polygons(p2)
    before = (polygon_cuda.LAUNCHES, distance_cuda.LAUNCHES["polygon_distance"],
              manifold_cuda.LAUNCHES)
    label = polygon_cuda.sat_polygons_cuda_t(a, b, k1=k1, k2=k2)
    label_bf16 = polygon_cuda.sat_polygons_cuda_t(a.bfloat16(), b.bfloat16(), k1=k1, k2=k2)
    dist = distance_cuda.polygon_distance_cuda_t(a, b, k1=k1, k2=k2)
    man = manifold_cuda.polygon_manifold_cuda_t(a, b, k1=k1, k2=k2, margin=0.05)
    torch.cuda.synchronize()
    assert (polygon_cuda.LAUNCHES, distance_cuda.LAUNCHES["polygon_distance"],
            manifold_cuda.LAUNCHES) == (before[0] + 2, before[1] + 1, before[2] + 1)
    assert torch.equal(label, polygon_cuda.sat_polygons_plain(a, b, k1, k2).reshape(-1).float())
    assert torch.equal(label_bf16, polygon_cuda.sat_polygons_plain(
        a.bfloat16(), b.bfloat16(), k1, k2).reshape(-1).float())
    assert torch.equal(dist, distance_cuda.polygon_distance_plain(a, b, k1, k2).reshape(-1))
    assert torch.equal(dist <= 0, label > 0)
    differ, err = _manifold_agreement(
        man, manifold_cuda.polygon_manifold_plain(a, b, k1, k2, 0.05))
    assert differ <= 1e-5 * n and err <= 2e-5
    assert 0 < float(label.mean()) < 1
    # the drop-in the models call pads N and takes the same library
    assert torch.equal(polygon_cuda.sat_polygons_cuda(p1[:1000], p2[:1000]),
                       label[:1000].to(torch.int32))


# Above 16 vertices kernels 6, 9 and 10 loop over the true K (one library
# for every K): a block stages its pairs in shared memory (128, 64 or 32
# pairs, `polygon_cuda.tile_pairs`), or the body reads device memory where
# no 32-pair tile fits; bitwise their plain versions on each route, on
# points and segments, and on planes that start off 16 bytes (the plain
# copy) or end inside a block; kernel 9's counting build counts its passes
# on each route (the pairs through the segment tests: those that do not
# overlap).
@pytest.mark.parametrize("k1,k2", [(1, 20), (2, 17), (20, 24), (64, 64), (4, 460),
                                   (4, 1000)])
def test_big_k_kernels_on_each_tile(cuda, k1, k2):
    n = 4096
    rng = np.random.default_rng(k1 * 7 + k2)
    a = polygon_cuda.pack_polygons(_polygons(rng, n, k1, cuda))
    b = polygon_cuda.pack_polygons(_polygons(rng, n, k2, cuda))
    label = polygon_cuda.sat_polygons_cuda_t(a, b, k1=k1, k2=k2)
    label16 = polygon_cuda.sat_polygons_cuda_t(a.bfloat16(), b.bfloat16(), k1=k1, k2=k2)
    man = manifold_cuda.polygon_manifold_cuda_t(a, b, k1=k1, k2=k2, margin=0.1)
    dist = distance_cuda.polygon_distance_cuda_t(a, b, k1=k1, k2=k2)
    counted, undecided, separated = distance_cuda.polygon_distance_passes(a, b, k1=k1, k2=k2)
    torch.cuda.synchronize()
    assert torch.equal(label, polygon_cuda.sat_polygons_plain(a, b, k1, k2).reshape(-1).float())
    assert torch.equal(label16, polygon_cuda.sat_polygons_plain(
        a.bfloat16(), b.bfloat16(), k1, k2).reshape(-1).float())
    assert torch.equal(man, manifold_cuda.polygon_manifold_plain(a, b, k1, k2, 0.1))
    want = distance_cuda.polygon_distance_plain(a, b, k1, k2).reshape(-1)
    assert torch.equal(dist, want) and torch.equal(counted, want)
    overlap = int((want < 0).sum())
    assert separated == n - overlap and overlap <= undecided <= n
    assert polygon_cuda.tile_pairs(4, 460) == 32 and polygon_cuda.tile_pairs(4, 1000) == 0


def test_big_k_kernels_on_unaligned_and_ragged_planes(cuda):
    n, k1, k2 = 4096, 4, 20
    rng = np.random.default_rng(17)
    a = polygon_cuda.pack_polygons(_polygons(rng, n, k1, cuda))
    b = polygon_cuda.pack_polygons(_polygons(rng, n, k2, cuda))
    # contiguous planes 4 bytes past an allocation
    shifted = []
    for x in (a, b):
        base = torch.empty(x.numel() + 1, device=cuda)
        base[1:] = x.reshape(-1)
        shifted.append(base[1:].view(x.shape))
    assert shifted[0].data_ptr() % 16
    got = polygon_cuda.sat_polygons_cuda_t(*shifted, k1=k1, k2=k2)
    assert torch.equal(got, polygon_cuda.sat_polygons_plain(a, b, k1, k2).reshape(-1).float())
    man = manifold_cuda.polygon_manifold_cuda_t(*shifted, k1=k1, k2=k2)
    assert torch.equal(man, manifold_cuda.polygon_manifold_plain(a, b, k1, k2))
    dist = distance_cuda.polygon_distance_cuda_t(*shifted, k1=k1, k2=k2)
    assert torch.equal(dist, distance_cuda.polygon_distance_plain(a, b, k1, k2).reshape(-1))
    # 3 columns (24 pairs): one block, past the last pair
    a3, b3 = a[:, :, :3].contiguous(), b[:, :, :3].contiguous()
    man3 = manifold_cuda.polygon_manifold_cuda_t(a3, b3, k1=k1, k2=k2, block=1)
    dist3 = distance_cuda.polygon_distance_cuda_t(a3, b3, k1=k1, k2=k2, block=1)
    torch.cuda.synchronize()
    assert torch.equal(man3, manifold_cuda.polygon_manifold_plain(a3, b3, k1, k2))
    assert torch.equal(dist3, distance_cuda.polygon_distance_plain(a3, b3, k1, k2).reshape(-1))


def test_polygon_models_launch_the_kernel(cuda):
    configs = example_polygon_configs(5000, k=7, seed=3, device=cuda)
    model = PolygonCollisionProbabilityModel(ROBOT_4GON)
    polygon_cuda.reset_launches()
    want = model.collide(configs, impl="torch")
    for bp in (False, True, "prune"):
        assert torch.equal(model.collide(configs, broad_phase=bp), want)
    robot = model._placed_robot(configs)
    got = CollisionProbabilityModel().collide_polygons(robot, configs.obstacle_verts)
    assert torch.equal(got, want) and got.device.type == "cuda"
    assert polygon_cuda.LAUNCHES == 4


# Kernels 7 and 14 build one library per shape (K, K2, K2A): the shapes
# below cover K from 3 to 20 (past 16, the other k-gon kernels' largest
# bucket), a rectangle robot with 2 kept axes (deduplicated) and all 4, a
# hexagon robot with 3 and all 6, and a degenerate robot with none.
HEXAGON = np.stack([np.cos(np.arange(6) * np.pi / 3),
                    np.sin(np.arange(6) * np.pi / 3)], -1).astype(np.float32)
MC_POLY_SHAPES = {  # id: (k, robot, kept robot axes)
    "k3": (3, ROBOT_4GON, (0, 1)), "k5": (5, ROBOT_4GON, (0, 1)),
    "k6": (6, ROBOT_4GON, (0, 1)), "k8": (8, ROBOT_4GON, (0, 1)),
    "k16": (16, ROBOT_4GON, (0, 1)), "k20": (20, ROBOT_4GON, (0, 1)),
    "k6-4axes": (6, ROBOT_4GON, (0, 1, 2, 3)), "k8-4axes": (8, ROBOT_4GON, (0, 1, 2, 3)),
    "k6-hexagon": (6, HEXAGON, (0, 1, 2)), "k5-hexagon-6axes": (5, HEXAGON, tuple(range(6))),
    "k5-no-axes": (5, ROBOT_4GON, ()),
}


@pytest.fixture(scope="module")
def mc_poly_libraries():
    """Build kernels 7 and 14 for every shape of MC_POLY_SHAPES at once, one
    nvcc each (the tests would otherwise build them one after another)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from concurrent.futures import ThreadPoolExecutor

    jobs = [(name, mc_polygon_cuda.shape_defines(k, len(robot), len(a_keep)))
            for k, robot, a_keep in MC_POLY_SHAPES.values()
            for name in ("mc_polygon_kernel", "mc_moving_polygon_kernel")]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: cuda_build.build(*job), jobs))


@pytest.mark.parametrize("shape", list(MC_POLY_SHAPES))
def test_mc_polygon_kernel_matches_plain(cuda, mc_poly_libraries, shape):
    k, robot, a_keep = MC_POLY_SHAPES[shape]
    c, n = 2048, 8192
    configs = example_polygon_configs(c, k=k, seed=4, device=cuda)
    params = mc_polygon_cuda.pack_polygon_mc_params(configs, robot, a_keep)
    uids = torch.from_numpy(np.random.default_rng(5).permutation(4 * c)[:c]
                            .astype(np.int32)).to(cuda)
    dims = dict(k=k, k2=len(robot), k2a=len(a_keep))
    before = mc_polygon_cuda.LAUNCHES
    got = mc_polygon_cuda.mc_poly_counts(params, uids, SEED, n, **dims)
    want = mc_polygon_cuda.mc_poly_counts_plain(params, uids, SEED, n,
                                                max_elems=1 << 20, **dims)
    torch.cuda.synchronize()
    assert mc_polygon_cuda.LAUNCHES == before + 1
    assert 0 < int(want.sum()) < c * n
    assert int((got - want).abs().sum()) <= 1e-5 * c * n


@pytest.mark.parametrize("kernel", ["7", "14"])
@pytest.mark.parametrize("shape", ["k8", "k20", "k6-hexagon"])
def test_mc_polygon_counts_invariant_under_split_and_compaction(
        cuda, mc_poly_libraries, shape, kernel):
    from collide2d_tpu_torch.ops import mc_moving_polygon_cuda as mmp

    k, robot, a_keep = MC_POLY_SHAPES[shape]
    c, n, cut = 1000, 10_000, 4096 + 77  # ragged chunks and batches
    _, moving = _moving_polygons(cuda, c, 6, k=k)
    if kernel == "7":
        fn = mc_polygon_cuda.mc_poly_counts
        params = mc_polygon_cuda.pack_polygon_mc_params(moving, robot, a_keep)
    else:
        fn = mmp.mc_moving_poly_counts
        params = mmp.pack_moving_polygon_mc_params(moving, robot, a_keep)
    uids = torch.arange(c, dtype=torch.int32, device=cuda)
    dims = dict(k=k, k2=len(robot), k2a=len(a_keep))
    whole = fn(params, uids, SEED, n, **dims)
    first = fn(params, uids, SEED, cut, **dims)
    second = fn(params, uids, SEED, n - cut, offset=cut, **dims)
    assert torch.equal(first + second, whole)
    keep = torch.randperm(c, generator=torch.Generator().manual_seed(1))[:300].to(cuda)
    sub = fn(params[keep].contiguous(), uids[keep].contiguous(), SEED, n, **dims)
    assert torch.equal(sub, whole[keep])
    assert 0 < int(whole.sum()) < c * n


@pytest.mark.parametrize("kernel", ["7", "14"])
def test_mc_polygon_counts_across_the_high_index_word(cuda, mc_poly_libraries, kernel):
    """A launch across 2^32 (64-bit indices) equals its two halves, one on
    each side (32-bit indices), and the plain version."""
    from collide2d_tpu_torch.ops import mc_moving_polygon_cuda as mmp

    k, robot, a_keep = MC_POLY_SHAPES["k8"]
    c, n, base, cut = 512, 5000, (1 << 32) - 3000, 3000
    _, moving = _moving_polygons(cuda, c, 7, k=k)
    if kernel == "7":
        fn, plain = mc_polygon_cuda.mc_poly_counts, mc_polygon_cuda.mc_poly_counts_plain
        params = mc_polygon_cuda.pack_polygon_mc_params(moving, robot, a_keep)
    else:
        fn, plain = mmp.mc_moving_poly_counts, mmp.mc_moving_poly_counts_plain
        params = mmp.pack_moving_polygon_mc_params(moving, robot, a_keep)
    uids = torch.arange(c, dtype=torch.int32, device=cuda)
    dims = dict(k=k, k2=len(robot), k2a=len(a_keep))
    whole = fn(params, uids, SEED, n, offset=base, **dims)
    first = fn(params, uids, SEED, cut, offset=base, **dims)
    second = fn(params, uids, SEED, n - cut, offset=base + cut, **dims)
    want = plain(params, uids, SEED, n, offset=base, max_elems=1 << 20, **dims)
    torch.cuda.synchronize()
    assert torch.equal(first + second, whole)
    assert 0 < int(want.sum()) < c * n
    assert int((whole - want).abs().sum()) <= 1e-5 * c * n


def test_polylabel_on_cuda(cuda, tmp_path):
    b = example_polygon_configs(2000, k=8, seed=7, device="cpu")
    np.savez(tmp_path / "in.npz", robot_verts=ROBOT_4GON,
             position=(b.position * 0.6).numpy(), pose_theta=b.pose_theta.numpy(),
             obstacle_verts=b.obstacle_verts.numpy(), std_dev=b.std_dev.numpy())
    mc_polygon_cuda.reset_launches()
    assert cli.main(["polylabel", "--device", "cuda", "--data_in",
                     str(tmp_path / "in.npz"), "--data_out",
                     str(tmp_path / "out.npz"), "--seed", "3"]) == 0
    assert mc_polygon_cuda.LAUNCHES > 0
    with np.load(tmp_path / "out.npz") as d:
        cp, n_used, done = d["cp"], d["n_samples"], d["converged"]
    assert cp.shape == (2000,) and np.isfinite(cp).all()
    assert (cp >= 0).all() and (cp <= 1).all() and 0 < cp.mean() < 1
    assert (n_used > 0).all() and done.mean() > 0.5


# ---- the geometry-query kernels (8, 9, 10, 12) --------------------------
# Kernels 8, 9 and 10 round every operation as their plain versions do
# (__fmul_rn/__fadd_rn, IEEE sqrt and division): their values are held to
# 2e-5 (the JAX tests' bar), their signs exactly, and kernel 10's counts
# may differ on at most 1e-5 of pairs (a face separation within an ulp of
# another). Kernel 12 evaluates its angles with sincosf where the plain
# version has torch's cos/sin: hit/miss may differ on at most 1e-4 of
# pairs (lanes whose d(t) lies within rounding of tol), t within 1e-5
# where both hit.


def _boxes(cuda, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda lo, hi, *s: torch.from_numpy(  # noqa: E731
        rng.uniform(lo, hi, s).astype(np.float32)).to(cuda)
    return f(-6, 6, n, 2), f(0.1, 5, n, 2), f(0, 2 * np.pi, n)


@pytest.mark.parametrize("shift", [0.0, 0.37])
def test_obb_distance_kernel_matches_plain(cuda, shift):
    n = 1 << 20
    a = sat_cuda.pack_obbs(*_boxes(cuda, n, 20))
    b = sat_cuda.pack_obbs(*_boxes(cuda, n, 21))
    before = dict(distance_cuda.LAUNCHES)
    got = distance_cuda.obb_distance_cuda_t(a, b, shift)
    want = distance_cuda.obb_distance_plain(a, b, shift).reshape(-1)
    label = sat_cuda.obb_collide_cuda_t(a, b, shift)
    torch.cuda.synchronize()
    assert distance_cuda.LAUNCHES["obb_distance"] == before["obb_distance"] + 1
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert float((got - want).abs().max()) <= 2e-5
    assert torch.equal(got <= 0, label > 0)
    assert 0 < float(label.mean()) < 1


@pytest.mark.parametrize("k1,k2", [(8, 8), (4, 8), (3, 5), (16, 16), (6, 12)])
def test_polygon_distance_kernel_matches_plain(cuda, k1, k2):
    n = 1 << 18
    rng = np.random.default_rng(k1 * 31 + k2)
    a = polygon_cuda.pack_polygons(_polygons(rng, n, k1, cuda))
    b = polygon_cuda.pack_polygons(_polygons(rng, n, k2, cuda))
    before = distance_cuda.LAUNCHES["polygon_distance"]
    got = distance_cuda.polygon_distance_cuda_t(a, b, k1=k1, k2=k2)
    want = distance_cuda.polygon_distance_plain(a, b, k1, k2).reshape(-1)
    label = polygon_cuda.sat_polygons_cuda_t(a, b, k1=k1, k2=k2)
    torch.cuda.synchronize()
    assert distance_cuda.LAUNCHES["polygon_distance"] == before + 1
    assert float((got - want).abs().max()) <= 2e-5
    assert torch.equal(got <= 0, label > 0)
    assert 0 < float(label.mean()) < 1


def _manifold_agreement(got, want):
    """(count mismatches, largest value difference where counts agree)."""
    from collide2d_tpu_torch.ops.manifold_cuda import unpack_manifold

    n = got.shape[1] * got.shape[2]
    g, w = unpack_manifold(got, n), unpack_manifold(want, n)
    same = g[0] == w[0]
    valid = (torch.arange(2, device=got.device)[None] < w[0][:, None]) & same[:, None]
    live = (w[0] > 0) & same
    diffs = ((g[1] - w[1]).abs().amax(-1)[valid], (g[2] - w[2]).abs()[valid],
             (g[3] - w[3]).abs().amax(-1)[live])
    return int((~same).sum()), max((float(d.max()) for d in diffs if d.numel()),
                                   default=0.0)


@pytest.mark.parametrize("k1,k2,margin", [(8, 8, 0.0), (8, 8, 0.1), (4, 8, 0.0),
                                          (5, 16, 0.05)])
def test_polygon_manifold_kernel_matches_plain(cuda, k1, k2, margin):
    n = 1 << 18
    rng = np.random.default_rng(k1 * 13 + k2)
    a = polygon_cuda.pack_polygons(_polygons(rng, n, k1, cuda))
    b = polygon_cuda.pack_polygons(_polygons(rng, n, k2, cuda))
    before = manifold_cuda.LAUNCHES
    got = manifold_cuda.polygon_manifold_cuda_t(a, b, k1=k1, k2=k2, margin=margin)
    want = manifold_cuda.polygon_manifold_plain(a, b, k1, k2, margin)
    torch.cuda.synchronize()
    assert manifold_cuda.LAUNCHES == before + 1
    assert got.shape == (9, 8, n // 8)
    differ, err = _manifold_agreement(got, want)
    assert differ <= 1e-5 * n and err <= 2e-5
    assert 0 < int((want[0] > 0).sum()) < n


def test_moving_obb_toi_kernel_matches_plain(cuda):
    n = 1 << 16
    rng = np.random.default_rng(22)
    f = lambda lo, hi, *s: torch.from_numpy(  # noqa: E731
        rng.uniform(lo, hi, s).astype(np.float32)).to(cuda)
    c2 = f(3, 6, n, 2) * torch.where(f(0, 1, n, 2) < 0.5, -1.0, 1.0)
    v2 = -c2 / c2.norm(dim=-1, keepdim=True)
    w1, w2 = f(-1, 1, n), f(-1, 1, n)
    w1[::4] = 0.0
    w2[::4] = 0.0  # every 4th pair translates only: the exact window
    b1 = toi_cuda.pack_moving_obbs(torch.zeros_like(c2), f(0.5, 3, n, 2), f(0, 7, n),
                                   torch.zeros_like(c2), w1)
    b2 = toi_cuda.pack_moving_obbs(c2, f(0.5, 3, n, 2), f(0, 7, n), v2, w2)
    kw = dict(t_max=8.0, iters=64, tol=1e-4)
    before = toi_cuda.LAUNCHES
    got = toi_cuda.moving_obb_toi_cuda_t(b1, b2, **kw)
    want = toi_cuda.moving_obb_toi_plain(b1, b2, **kw).reshape(-1)
    torch.cuda.synchronize()
    assert toi_cuda.LAUNCHES == before + 1
    hit_g, hit_w = torch.isfinite(got), torch.isfinite(want)
    assert int((hit_g != hit_w).sum()) <= 1e-4 * n
    both = hit_g & hit_w
    assert float((got[both] - want[both]).abs().max()) <= 1e-5
    assert 0 < int(hit_w.sum()) < n


def _toi_batch(cuda, m, seed, *, translating=0.25, spread=(3.0, 6.0)):
    """8m moving box pairs as phase 14 draws them: box 1 at the origin, box
    2 at U(spread)^2 in a random quadrant heading for it at unit speed,
    angular rates U(-1, 1), the first `translating` share of the pairs with
    both rates 0."""
    rng = np.random.default_rng(seed)
    n = 8 * m
    f = lambda lo, hi, *s: torch.from_numpy(  # noqa: E731
        rng.uniform(lo, hi, s).astype(np.float32)).to(cuda)
    c2 = f(*spread, n, 2) * torch.where(f(0, 1, n, 2) < 0.5, -1.0, 1.0)
    w1, w2 = f(-1, 1, n), f(-1, 1, n)
    still = int(translating * n)
    w1[:still] = 0.0
    w2[:still] = 0.0
    b1 = toi_cuda.pack_moving_obbs(torch.zeros_like(c2), f(0.5, 3, n, 2), f(0, 7, n),
                                   torch.zeros_like(c2), w1)
    b2 = toi_cuda.pack_moving_obbs(c2, f(0.5, 3, n, 2), f(0, 7, n),
                                   -c2 / c2.norm(dim=-1, keepdim=True), w2)
    return b1, b2


# Kernel 12 refills a lane as its pair converges (a warp walks a range of
# pairs): each case below is bitwise its plain version, whose torch cos/sin
# on the card round as the kernel's sincosf. m = 1001 gives 8,008 pairs, a
# multiple neither of 32 nor of a warp's range or a block's.
@pytest.mark.parametrize("case,m,translating,kw", [
    ("odd_n", 1001, 0.25, dict(t_max=8.0, iters=64, tol=1e-4)),
    ("all_translating", 1024, 1.0, dict(t_max=8.0, iters=64, tol=1e-4)),
    ("iters_0", 1001, 0.25, dict(t_max=8.0, iters=0, tol=1e-4)),
    ("iters_1", 1001, 0.25, dict(t_max=8.0, iters=1, tol=1e-4)),
    ("iters_exhausted", 1024, 0.0, dict(t_max=8.0, iters=5, tol=1e-6)),
    ("t_max_below_every_hit", 1001, 0.25, dict(t_max=0.25, iters=64, tol=1e-4)),
])
def test_moving_obb_toi_kernel_edge_cases_bitwise(cuda, case, m, translating, kw):
    b1, b2 = _toi_batch(cuda, m, seed=len(case), translating=translating)
    before = toi_cuda.LAUNCHES
    got = toi_cuda.moving_obb_toi_cuda_t(b1, b2, block=1, **kw)
    want, steps = toi_cuda.moving_obb_toi_plain(b1, b2, return_steps=True, **kw)
    want, steps = want.reshape(-1), steps.reshape(-1)
    torch.cuda.synchronize()
    assert toi_cuda.LAUNCHES == before + 1
    assert got.shape == (8 * m,)
    assert torch.equal(got, want), case
    hits = int(torch.isfinite(want).sum())
    if case == "t_max_below_every_hit":
        assert hits == 0
    elif case == "iters_exhausted":
        assert int((steps == kw["iters"]).sum()) > 0
    elif case != "iters_0":
        assert 0 < hits
    if case == "all_translating":
        assert int(steps.sum()) == 0


def _polygon_pairs(cuda, n, k1, k2, layout):
    """n pairs of regular k-gons of radius U(0.5, 1) at random rotations:
    'mixed' centres both U(0, 10)^2 (the JAX bench's), 'overlapping' one
    centre a pair, 'separated' polygon 2 five units right of polygon 1."""
    rng = np.random.default_rng(100 * k1 + k2 + len(layout))

    def ring(c, k):
        r = rng.uniform(0.5, 1.0, (n, 1, 1))
        ang = rng.uniform(0, 2 * np.pi, (n, 1)) + 2 * np.pi * np.arange(k) / k
        p = c + r * np.stack([np.cos(ang), np.sin(ang)], -1)
        return polygon_cuda.pack_polygons(torch.from_numpy(p.astype(np.float32)).to(cuda))

    c1 = rng.uniform(0, 10, (n, 1, 2))
    c2 = {"mixed": rng.uniform(0, 10, (n, 1, 2)), "overlapping": c1,
          "separated": c1 + [5.0, 0.0]}[layout]
    return ring(c1, k1), ring(c2, k2)


# Kernel 9 splits a tile's pairs into those one of polygon 1's first edge
# normals separates, those that need every axis, and those that then need
# the segment tests: each case is bitwise its plain version and its sign
# kernel 6's plain label, at both ends of the split (all overlapping, all
# separated), on every (K1, K2) bucket pair, with zero-length edges from
# padding (k = 3, 5, 13) and n not a multiple of a tile.
@pytest.mark.parametrize("k1,k2", [(4, 4), (4, 8), (4, 16), (8, 4), (8, 8), (8, 16),
                                   (16, 4), (16, 8), (16, 16), (3, 5), (5, 13)])
@pytest.mark.parametrize("layout", ["overlapping", "mixed", "separated"])
def test_polygon_distance_kernel_split_bitwise(cuda, k1, k2, layout):
    n = 8 * 3001
    a, b = _polygon_pairs(cuda, n, k1, k2, layout)
    before = distance_cuda.LAUNCHES["polygon_distance"]
    got = distance_cuda.polygon_distance_cuda_t(a, b, k1=k1, k2=k2, block=1)
    want = distance_cuda.polygon_distance_plain(a, b, k1, k2).reshape(-1)
    label = polygon_cuda.sat_polygons_plain(a, b, k1, k2).reshape(-1)
    torch.cuda.synchronize()
    assert distance_cuda.LAUNCHES["polygon_distance"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got <= 0, label > 0)
    overlap = int((want < 0).sum())
    assert overlap == {"overlapping": n, "separated": 0}.get(layout, overlap)
    assert layout != "mixed" or 0 < overlap < n


def test_polygon_distance_counting_build_counts_the_split(cuda):
    n = 1 << 18
    a, b = _polygon_pairs(cuda, n, 8, 8, "mixed")
    got, undecided, separated = distance_cuda.polygon_distance_passes(a, b, k1=8, k2=8)
    want = distance_cuda.polygon_distance_plain(a, b, 8, 8).reshape(-1)
    assert torch.equal(got, want)
    overlap = int((want < 0).sum())
    assert separated == n - overlap
    assert overlap <= undecided < overlap + 0.05 * n


def test_query_models_launch_the_kernels(cuda):
    n = 5000  # padded to the alignment and sliced back
    pos, wh, th = _boxes(cuda, n, 23)
    model = CollisionProbabilityModel()
    distance_cuda.reset_launches()
    manifold_cuda.reset_launches()
    toi_cuda.reset_launches()
    d = model.distance(pos, th, wh, impl="auto")
    assert d.device.type == "cuda" and d.shape == (n,)
    assert torch.equal((d <= 0).to(torch.int32), model.collide(pos, th, wh, method="obb"))
    assert float((d - model.distance(pos, th, wh)).abs().max()) <= 2e-5
    count = model.contact_manifold(pos, th, wh)[0]
    assert count.shape == (n,) and count.dtype == torch.int32
    t = model.time_of_impact(pos, th, wh, -pos, 0.5, t_max=4.0, impl="auto")
    assert t.shape == (n,) and bool(torch.isfinite(t).any())
    pmodel = PolygonCollisionProbabilityModel(ROBOT_4GON)
    configs = example_polygon_configs(n, k=8, seed=3, device=cuda)
    pd = pmodel.distance(configs, impl="cuda")
    assert torch.equal((pd <= 0).to(torch.int32), pmodel.collide(configs))
    pmodel.contact_manifold(configs)
    torch.cuda.synchronize()
    assert distance_cuda.LAUNCHES == {"obb_distance": 1, "polygon_distance": 1}
    assert manifold_cuda.LAUNCHES == 2 and toi_cuda.LAUNCHES == 1
    with pytest.raises(ValueError, match="impl='torch'"):
        model.distance(pos.clone().requires_grad_(True), th, wh, impl="cuda")
    assert distance_cuda.LAUNCHES["obb_distance"] == 1


# ---- the trajectory kernels (13, 14, 15) ---------------------------------
# Kernel 13 and 14 share kernel 1's / kernel 7's stream with their plain
# versions; sincosf, log1pf and the advancement's tolerance band can flip
# only a sample within an ulp of a boundary or of tol: counts may differ by
# at most 1e-5 of all samples. Kernel 14 at zero velocity equals kernel 7
# bit for bit. Kernel 15 rounds every operation as its plain version:
# flags may differ on at most 1e-5 of lanes (cos/sin of the card), t0 is
# equal where they agree.


def _moving_rects(cuda, c, seed, rotating_share=0.5, shape_noise=True):
    from collide2d_tpu_torch.mc.moving import moving_configs

    rng = np.random.default_rng(seed)
    sd = rng.uniform(0, 0.4, (c, 5)).astype(np.float32)
    if not shape_noise:
        sd[:, 3:] = 0.0
    omega = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    omega[rng.uniform(size=c) >= rotating_share] = 0.0
    return moving_configs(rng.uniform(-6, 6, (c, 2)), rng.uniform(0, 2 * np.pi, c),
                          rng.uniform(0.5, 5, (c, 2)), sd, rng.uniform(-2, 2, (c, 2)),
                          omega, rng.uniform(0.5, 3, c), device=cuda)


@pytest.mark.parametrize("shape_noise,ca_iters", [(True, 48), (False, 48), (True, 0)])
def test_mc_toi_kernel_matches_plain(cuda, shape_noise, ca_iters):
    from collide2d_tpu_torch.ops import mc_toi_cuda

    c, n = 1024, 4096
    params = mc_toi_cuda.pack_mc_toi_params(
        _moving_rects(cuda, c, 30, shape_noise=shape_noise), ROBOT)
    uids = torch.from_numpy(np.random.default_rng(31).permutation(4 * c)[:c]
                            .astype(np.int32)).to(cuda)
    kw = dict(shape_noise=shape_noise, ca_iters=ca_iters, tol=1e-4)
    before = mc_toi_cuda.LAUNCHES
    got = mc_toi_cuda.mc_toi_counts(params, uids, SEED, n, **kw)
    want = mc_toi_cuda.mc_toi_counts_plain(params, uids, SEED, n,
                                           max_elems=1 << 22, **kw)
    torch.cuda.synchronize()
    assert mc_toi_cuda.LAUNCHES == before + 1
    assert 0 < int(want.sum()) < c * n
    assert int((got - want).abs().sum()) <= 1e-5 * c * n
    # split and compaction leave the counts unchanged
    first = mc_toi_cuda.mc_toi_counts(params, uids, SEED, 1000, **kw)
    second = mc_toi_cuda.mc_toi_counts(params, uids, SEED, n - 1000, offset=1000, **kw)
    assert torch.equal(first + second, got)
    keep = torch.arange(0, c, 3, device=cuda)
    assert torch.equal(mc_toi_cuda.mc_toi_counts(params[keep].contiguous(),
                                                 uids[keep].contiguous(), SEED, n,
                                                 **kw), got[keep])


@pytest.mark.parametrize("ca_iters", [0, 48])
@pytest.mark.parametrize("n,offset", ODD_SAMPLES)
def test_mc_toi_kernel_matches_plain_at_odd_sizes_and_offsets(cuda, n, offset, ca_iters):
    from collide2d_tpu_torch.ops import mc_toi_cuda

    c = 512
    params = mc_toi_cuda.pack_mc_toi_params(_moving_rects(cuda, c, 32), ROBOT)
    uids = torch.from_numpy(np.random.default_rng(33).permutation(4 * c)[:c]
                            .astype(np.int32)).to(cuda)
    kw = dict(ca_iters=ca_iters, tol=1e-4)
    before = mc_toi_cuda.LAUNCHES
    got = mc_toi_cuda.mc_toi_counts(params, uids, SEED, n, offset=offset, **kw)
    want = mc_toi_cuda.mc_toi_counts_plain(params, uids, SEED, n, offset=offset, **kw)
    torch.cuda.synchronize()
    assert mc_toi_cuda.LAUNCHES == before + 1
    assert 0 < int(want.sum()) < c * n
    assert int((got - want).abs().sum()) <= 1e-5 * c * n
    cut = min(n - 1, max(1, (1 << 32) - offset)) if offset else n // 2
    if 0 < cut < n:
        first = mc_toi_cuda.mc_toi_counts(params, uids, SEED, cut, offset=offset, **kw)
        second = mc_toi_cuda.mc_toi_counts(params, uids, SEED, n - cut,
                                           offset=offset + cut, **kw)
        assert torch.equal(first + second, got)


def _moving_polygons(cuda, c, seed, k=6, still=False):
    from collide2d_tpu_torch.mc.moving import moving_polygon_configs

    b = example_polygon_configs(c, k=k, seed=seed, device=cuda)
    rng = np.random.default_rng(seed)
    vel = np.zeros((c, 2), np.float32) if still else rng.uniform(-2, 2, (c, 2))
    return b, moving_polygon_configs(b.position, b.pose_theta, b.obstacle_verts,
                                     b.std_dev, vel, 0.0, rng.uniform(0.5, 3, c),
                                     device=cuda)


@pytest.mark.parametrize("shape", list(MC_POLY_SHAPES))
def test_mc_moving_polygon_kernel_matches_plain(cuda, mc_poly_libraries, shape):
    from collide2d_tpu_torch.ops import mc_moving_polygon_cuda as mmp

    k, robot, a_keep = MC_POLY_SHAPES[shape]
    c, n = 2048, 8192
    _, configs = _moving_polygons(cuda, c, 32, k=k)
    params = mmp.pack_moving_polygon_mc_params(configs, robot, a_keep)
    uids = torch.arange(c, dtype=torch.int32, device=cuda)
    dims = dict(k=k, k2=len(robot), k2a=len(a_keep))
    before = mmp.LAUNCHES
    got = mmp.mc_moving_poly_counts(params, uids, SEED, n, **dims)
    want = mmp.mc_moving_poly_counts_plain(params, uids, SEED, n, max_elems=1 << 20,
                                           **dims)
    torch.cuda.synchronize()
    assert mmp.LAUNCHES == before + 1
    assert 0 < int(want.sum()) < c * n
    assert int((got - want).abs().sum()) <= 1e-5 * c * n


@pytest.mark.parametrize("kernel", ["7", "14"])
def test_box_muller_polygon_kernels_match_plain(cuda, kernel):
    """The Box-Muller builds of kernels 7 and 14 (k = 8, the 4-gon robot's 2
    kept axes) against their plain versions, at the erf_inv builds' bar."""
    from collide2d_tpu_torch.ops import mc_moving_polygon_cuda as mmp

    k, robot, a_keep = MC_POLY_SHAPES["k8"]
    c, n = 2048, 8192
    static, configs = _moving_polygons(cuda, c, 34, k=k)
    mod = mc_polygon_cuda if kernel == "7" else mmp
    pack = (mc_polygon_cuda.pack_polygon_mc_params if kernel == "7"
            else mmp.pack_moving_polygon_mc_params)
    params = pack(static if kernel == "7" else configs, robot, a_keep)
    count = mod.mc_poly_counts if kernel == "7" else mmp.mc_moving_poly_counts
    plain = (mod.mc_poly_counts_plain if kernel == "7"
             else mmp.mc_moving_poly_counts_plain)
    uids = torch.arange(c, dtype=torch.int32, device=cuda)
    dims = dict(k=k, k2=len(robot), k2a=len(a_keep), normal_method="box_muller")
    before, bm_before = mod.LAUNCHES, mod.BOX_MULLER_LAUNCHES
    got = count(params, uids, SEED, n, **dims)
    want = plain(params, uids, SEED, n, max_elems=1 << 20, **dims)
    torch.cuda.synchronize()
    assert (mod.LAUNCHES, mod.BOX_MULLER_LAUNCHES) == (before, bm_before + 1)
    assert 0 < int(want.sum()) < c * n
    assert int((got - want).abs().sum()) <= 1e-5 * c * n


@pytest.mark.parametrize("shape", list(MC_POLY_SHAPES))
def test_mc_moving_polygon_kernel_at_zero_velocity_is_kernel_7(cuda, mc_poly_libraries,
                                                               shape):
    from collide2d_tpu_torch.ops import mc_moving_polygon_cuda as mmp

    k, robot, a_keep = MC_POLY_SHAPES[shape]
    c, n = 2048, 8192
    static, configs = _moving_polygons(cuda, c, 33, k=k, still=True)
    uids = torch.arange(c, dtype=torch.int32, device=cuda)
    dims = dict(k=k, k2=len(robot), k2a=len(a_keep))
    moving = mmp.mc_moving_poly_counts(
        mmp.pack_moving_polygon_mc_params(configs, robot, a_keep), uids, SEED, n,
        **dims)
    still = mc_polygon_cuda.mc_poly_counts(
        mc_polygon_cuda.pack_polygon_mc_params(static, robot, a_keep), uids,
        SEED, n, **dims)
    assert torch.equal(moving, still) and 0 < int(still.sum()) < c * n


def test_screen_kernel_matches_plain(cuda):
    from collide2d_tpu_torch.ops import screen_cuda

    c, s = 1024, 512
    configs = _moving_rects(cuda, c, 34, rotating_share=1.0)
    z = torch.randn((c, s, 5), generator=torch.Generator(device=cuda).manual_seed(35),
                    device=cuda)
    params = screen_cuda.pack_screen_params(configs, ROBOT)
    before = screen_cuda.LAUNCHES
    flags, t0 = screen_cuda.rotating_screen(z, params)
    want_f, want_t = screen_cuda.rotating_screen_plain(z, params)
    torch.cuda.synchronize()
    assert screen_cuda.LAUNCHES == before + 1
    assert torch.equal(flags, want_f) and torch.equal(t0, want_t)
    for bit in (1, 2, 4):
        assert 0 < int(((want_f & bit) != 0).sum()) < c * s


# Kernel 15 builds one library per segment count (the segment loop
# unrolled) and takes two lanes a thread, 512 a block: counts 1, 7, 8 and
# 32, and lane counts off a block's, each bitwise its plain version.
@pytest.mark.parametrize("n_seg,s", [(1, 511), (7, 513), (8, 511), (8, 513), (32, 511),
                                     (32, 513)])
def test_screen_kernel_instantiations_match_plain(cuda, n_seg, s):
    from collide2d_tpu_torch.ops import screen_cuda

    c = 512
    configs = _moving_rects(cuda, c, 40 + n_seg, rotating_share=0.8)
    z = torch.randn((c, s, 5), generator=torch.Generator(device=cuda).manual_seed(s),
                    device=cuda)
    params = screen_cuda.pack_screen_params(configs, ROBOT)
    flags, t0 = screen_cuda.rotating_screen(z, params, n_seg=n_seg)
    want_f, want_t = screen_cuda.rotating_screen_plain(z, params, n_seg=n_seg)
    assert torch.equal(flags, want_f) and torch.equal(t0, want_t)
    assert 0 < int((want_f & 1).sum()) < c * s


def test_screen_library_refuses_another_segment_count(cuda):
    from collide2d_tpu_torch.ops import screen_cuda

    lib = screen_cuda._kernel_lib(8)
    assert lib.rotating_screen_segments() == 8
    z = torch.zeros((2, 4, 5), device=cuda)
    params = torch.zeros((2, 16), device=cuda)
    f = torch.empty((2, 4), dtype=torch.int32, device=cuda)
    t0 = torch.empty((2, 4), device=cuda)
    f32 = ctypes.c_float
    err = lib.rotating_screen_launch(z.data_ptr(), params.data_ptr(), f.data_ptr(),
                                     t0.data_ptr(), 2, 4, 7, f32(1 / 7), f32(0.5 / 7),
                                     f32(1e-4), f32(np.pi), 0)
    assert err != 0


def test_movelabel_on_cuda_launches_the_trajectory_kernels(cuda, tmp_path):
    from collide2d_tpu_torch.ops import mc_moving_polygon_cuda, mc_toi_cuda, screen_cuda

    rects = _moving_rects(cuda, 512, 36, rotating_share=0.0)
    fields = {f: getattr(rects, f).cpu().numpy() for f in rects._fields}
    fields["position"] = fields["position"] * 0.5
    np.savez(tmp_path / "trans.npz", **fields)
    fields["omega"] = np.full(512, 0.3, np.float32)
    np.savez(tmp_path / "rot.npz", **fields)
    _, polys = _moving_polygons(cuda, 512, 37)
    np.savez(tmp_path / "poly.npz", robot_verts=ROBOT_4GON,
             **{f: getattr(polys, f).cpu().numpy() for f in polys._fields})
    cap = ["--max_samples", "40000", "--seed", "3", "--device", "cuda"]
    for name, extra, kernel in (("trans", [], "13"), ("rot", [], "15"),
                                ("rot", ["--impl", "cuda"], "13"), ("poly", [], "14")):
        for mod in (mc_toi_cuda, mc_moving_polygon_cuda, screen_cuda):
            mod.reset_launches()
        out = tmp_path / f"{name}_{kernel}.npz"
        assert cli.main(["movelabel", "--data_in", str(tmp_path / f"{name}.npz"),
                         "--data_out", str(out), *cap, *extra]) == 0
        launches = {"13": mc_toi_cuda.LAUNCHES, "14": mc_moving_polygon_cuda.LAUNCHES,
                    "15": screen_cuda.LAUNCHES}
        assert launches[kernel] > 0, (name, extra, launches)
        with np.load(out) as d:
            assert np.isfinite(d["cp"]).all() and 0 < d["cp"].mean() < 1


# Checkpoint / resume on the fused Monte Carlo kernels: a run interrupted
# from its progress hook and resumed from its checkpoint writes labels
# bitwise equal to an uninterrupted run (the Philox streams are keyed by
# seed, uid and sample index), and the resume starts past the checkpoint.
class _Stop(Exception):
    pass


def _resume_case(cuda, kernel):
    from collide2d_tpu_torch.ops import mc_moving_polygon_cuda, mc_toi_cuda

    c = 4096
    if kernel == "1":
        rng = np.random.default_rng(41)
        sd = rng.uniform(0, 0.3, (c, 5)).astype(np.float32)
        sd[:, 3:] = 0.0
        cfg = (rng.uniform(-6, 6, (c, 2)), rng.uniform(0, 2 * np.pi, c),
               rng.uniform(0.5, 5, (c, 2)), sd)
        return configs_from_numpy(cfg, cuda), ROBOT, mc_cuda
    if kernel == "7":
        return example_polygon_configs(c, k=8, seed=42, device=cuda), ROBOT_4GON, \
            mc_polygon_cuda
    if kernel == "13":
        return _moving_rects(cuda, c, 43, rotating_share=0.0), ROBOT, mc_toi_cuda
    return _moving_polygons(cuda, c, 44, k=8)[1], ROBOT_4GON, mc_moving_polygon_cuda


@pytest.mark.parametrize("kernel", ["1", "7", "13", "14"])
def test_resume_is_bitwise_on_the_fused_kernels(cuda, tmp_path, kernel):
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities as acp
    from collide2d_tpu_torch.mc.estimator import AdaptiveConfig

    configs, robot, mod = _resume_case(cuda, kernel)
    cfg, key = AdaptiveConfig(max_samples=200_000), prng.PRNGKey(9)
    base = acp(key, configs, robot, cfg)
    ckpt = tmp_path / "ckpt.npz"

    def bomb(*, round, **kw):
        if round >= 3:
            raise _Stop

    with pytest.raises(_Stop):
        acp(key, configs, robot, cfg, progress=bomb, checkpoint_path=str(ckpt),
            checkpoint_every=1)
    with np.load(ckpt) as z:
        n_saved = int(z["n_samples"])
    mod.reset_launches()
    seen = []
    out = acp(key, configs, robot, cfg, checkpoint_path=str(ckpt), checkpoint_every=1,
              progress=lambda **kw: seen.append(kw["n_samples"]))
    assert mod.LAUNCHES > 0
    assert n_saved > 0 and min(seen) > n_saved
    for got, want in zip(out, base):
        np.testing.assert_array_equal(got, want)
    assert 0 < base[0].mean() < 1 and not ckpt.exists()


# Kernel 11 (scene raycast): bitwise its plain version (the same separately
# rounded products and sums, IEEE division).
@pytest.mark.parametrize("n_shapes,k,tile,t_max", [
    (64, 8, 0, float("inf")), (64, 8, 0, 4.0),
    (600, 8, 0, float("inf")),  # 4,800 faces: past one 3,072-face tile
    (600, 8, 37, float("inf")), (200, 5, 0, 10.0)])
def test_raycast_kernel_matches_plain(cuda, n_shapes, k, tile, t_max):
    from collide2d_tpu_torch.ops import raycast_cuda

    rng = np.random.default_rng(n_shapes + k + tile)
    polys = _polygons(rng, n_shapes, k, cuda, spread=30.0)
    mask = torch.from_numpy(np.arange(k)[None] < rng.integers(3, k + 1, (n_shapes, 1))).to(cuda)
    table = raycast_cuda.pack_scene_tables(polys, mask)
    r = 1 << 15
    g = torch.Generator(device=cuda).manual_seed(41)
    o = torch.rand((r, 2), generator=g, device=cuda) * 80.0 - 40.0
    d = torch.randn((r, 2), generator=g, device=cuda)
    before = raycast_cuda.LAUNCHES
    got = raycast_cuda.scene_raycast_cuda_t(o, d, table, t_max=t_max, tile_shapes=tile)
    want = raycast_cuda.scene_raycast_plain(o, d, table, t_max=t_max)
    torch.cuda.synchronize()
    assert raycast_cuda.LAUNCHES == before + 1
    assert all(map(torch.equal, got, want))
    assert got[1].dtype == torch.int32 and got[2].shape == (r, 2)
    assert 0 < int(torch.isfinite(want[0]).sum()) < r


# Kernel 11's libraries: its own per face count (4, 8, 16), the generic one
# (12, 20), and both tile sizes. The rays of one warp leave a shape at
# different faces (origins spread over the scene, some inside a shape, t_max
# cutting some short), and the early exit must not change a bit.
@pytest.mark.parametrize("k,kp", [(4, 4), (7, 8), (8, 8), (11, 12), (16, 16), (19, 20)])
@pytest.mark.parametrize("tile", [0, 13])
def test_raycast_kernel_builds_and_exits_match_plain(cuda, k, kp, tile):
    from collide2d_tpu_torch.ops import raycast_cuda

    rng = np.random.default_rng(100 * k + tile)
    n_shapes = 300
    polys = _polygons(rng, n_shapes, k, cuda, spread=20.0)
    mask = torch.from_numpy(np.arange(k)[None] < rng.integers(3, k + 1, (n_shapes, 1))).to(cuda)
    table = raycast_cuda.pack_scene_tables(polys, mask)
    assert table.shape[1] == kp
    r = 3 * 1000 + 7  # a ragged last block
    g = torch.Generator(device=cuda).manual_seed(k)
    o = torch.rand((r, 2), generator=g, device=cuda) * 50.0 - 25.0
    o[::9] = polys[torch.arange(0, r, 9, device=cuda) % n_shapes].mean(1)  # inside starts
    d = torch.randn((r, 2), generator=g, device=cuda)
    for t_max in (float("inf"), 3.0):
        want = raycast_cuda.scene_raycast_plain(o, d, table, t_max=t_max)
        every = r * n_shapes * kp
        got = raycast_cuda.scene_raycast_cuda_t(o, d, table, t_max=t_max, tile_shapes=tile)
        assert all(map(torch.equal, got, want)), t_max
        counted, faces = raycast_cuda.scene_raycast_faces(o, d, table, t_max=t_max,
                                                          tile_shapes=tile)
        assert all(map(torch.equal, counted, want)), t_max
        assert 0 < faces <= every
        if kp >= 8:  # a vote falls inside the shape, and some warps leave it early
            assert faces < every, t_max
        assert int((want[0] == 0).sum()) > 0 and bool(torch.isfinite(want[0]).any())


# From 2^22 rays on, kernel 11 takes two rays a thread: that instantiation
# bitwise its plain version.
@pytest.mark.parametrize("k", [8, 12])
def test_raycast_kernel_two_rays_a_thread_match_plain(cuda, k):
    from collide2d_tpu_torch.ops import raycast_cuda

    rng = np.random.default_rng(200 + k)
    polys = _polygons(rng, 48, k, cuda, spread=20.0)
    table = raycast_cuda.pack_scene_tables(polys)
    r = (1 << 22) + 129  # a ragged last block
    g = torch.Generator(device=cuda).manual_seed(k)
    o = torch.rand((r, 2), generator=g, device=cuda) * 50.0 - 25.0
    d = torch.randn((r, 2), generator=g, device=cuda)
    lib = raycast_cuda._kernel_lib(table.shape[1])
    lib.scene_raycast_thread_rays.argtypes = [ctypes.c_longlong]
    assert lib.scene_raycast_thread_rays(r) == 2
    want = raycast_cuda.scene_raycast_plain(o, d, table, t_max=6.0)
    got = raycast_cuda.scene_raycast_cuda_t(o, d, table, t_max=6.0)
    assert all(map(torch.equal, got, want))
    assert bool(torch.isfinite(want[0]).any()) and not bool(torch.isfinite(want[0]).all())


def test_scene_raycast_auto_launches_kernel_11(cuda):
    from collide2d_tpu_torch.ops import raycast, raycast_cuda

    polys = _polygons(np.random.default_rng(42), 32, 6, cuda, spread=10.0)
    o = torch.zeros((3, 4, 2), device=cuda)
    d = torch.randn((3, 4, 2), generator=torch.Generator(device=cuda).manual_seed(43),
                    device=cuda)
    before = raycast_cuda.LAUNCHES
    t, idx, nrm = raycast.scene_raycast(o, d, polys)
    one = raycast.scene_raycast(o[1, 2], d[1, 2], polys)
    torch.cuda.synchronize()
    assert raycast_cuda.LAUNCHES == before + 2
    assert t.shape == (3, 4) and nrm.shape == (3, 4, 2) and one[0].shape == ()
    assert one[0] == t[1, 2] and one[1] == idx[1, 2]
    ref = raycast.scene_raycast(o.cpu(), d.cpu(), polys.cpu(), impl="torch")
    hit = torch.isfinite(ref[0])
    assert torch.equal(torch.isfinite(t.cpu()), hit)
    assert float((t.cpu()[hit] - ref[0][hit]).abs().max()) <= 1e-4
    with pytest.raises(ValueError, match="impl='torch'"):
        raycast.scene_raycast(o.requires_grad_(True), d, polys)


def test_scene_raycast_takes_a_host_scene_to_the_rays_card(cuda):
    # a scene built on the host as numpy runs on the rays' card (kernel 11,
    # results on the card); a CPU tensor scene against card rays raises
    from collide2d_tpu_torch.ops import raycast, raycast_cuda

    polys = _polygons(np.random.default_rng(45), 32, 6, cuda, spread=10.0)
    o = torch.zeros((64, 2), device=cuda)
    d = torch.randn((64, 2), generator=torch.Generator(device=cuda).manual_seed(46),
                    device=cuda)
    before = raycast_cuda.LAUNCHES
    got = raycast.scene_raycast(o, d, polys.cpu().numpy())
    torch.cuda.synchronize()
    assert raycast_cuda.LAUNCHES == before + 1
    assert all(x.device.type == "cuda" for x in got)
    want = raycast.scene_raycast(o, d, polys)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="more than one device"):
        raycast.scene_raycast(o, d, polys.cpu())


def test_scene_functions_on_cuda_match_cpu(cuda):
    from collide2d_tpu_torch.ops import manifold_cuda, polygon_cuda, scene

    rng = np.random.default_rng(44)
    polys = _polygons(rng, 300, 8, cuda, spread=25.0)
    host = polys.cpu()
    polygon_cuda.reset_launches()
    manifold_cuda.reset_launches()
    assert torch.equal(scene.scene_collision_matrix(polys, row_tile=37).cpu(),
                       scene.scene_collision_matrix(host, row_tile=37))
    for got, want in ((scene.scene_colliding_pairs(polys, capacity=512),
                       scene.scene_colliding_pairs(host, capacity=512)),
                      (scene.scene_colliding_pairs_swept(polys, capacity=512, window=40),
                       scene.scene_colliding_pairs_swept(host, capacity=512, window=40))):
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    got = scene.scene_contact_manifolds(polys, capacity=512, broad_phase="swept", window=40)
    want = scene.scene_contact_manifolds(host, capacity=512, broad_phase="swept", window=40)
    torch.cuda.synchronize()
    assert polygon_cuda.LAUNCHES > 0 and manifold_cuda.LAUNCHES > 0
    c = int(want[1])
    assert int(got[1]) == c >= 3 and not bool(want[6])
    assert torch.equal(got[0].cpu(), want[0])
    # kernel 10 against ops.manifold at coordinates up to ~28, where an ulp
    # is 1.9e-6 and a depth is a difference of two such projections
    count, points, depths, normal = (a.cpu()[:c] for a in got[2:6])
    assert int((count != want[2][:c]).sum()) <= 1e-5 * c
    valid = torch.arange(2)[None] < want[2][:c, None]
    assert float((points - want[3][:c]).abs().amax(-1)[valid].max()) <= 1e-4
    assert float((depths - want[4][:c]).abs()[valid].max()) <= 1e-4
    assert float((normal - want[5][:c]).abs().max()) <= 2e-5
    # k = 20 (the K = 32 bucket): the matrix is `ops.sat.sat_polygons` on
    # every pair (the CPU route's dense tiles, like JAX's, refuse k1 + k2 >
    # 32 on a broadcast tile), the swept lists and manifolds the CPU's
    from collide2d_tpu_torch.ops.sat import sat_polygons

    polys = _polygons(rng, 200, 20, cuda, spread=12.0)
    host = polys.cpu()
    polygon_cuda.reset_launches()
    manifold_cuda.reset_launches()
    m = scene.scene_collision_matrix(polys, row_tile=37).cpu()
    i, j = torch.meshgrid(torch.arange(200), torch.arange(200), indexing="ij")
    want_m = (sat_polygons(host[i.reshape(-1)], host[j.reshape(-1)]) == 1).reshape(200, 200)
    want_m.fill_diagonal_(False)
    assert torch.equal(m, want_m) and 0 < int(m.sum())
    pairs, count, _ = scene.scene_colliding_pairs(polys, capacity=2048)
    assert torch.equal(pairs[: int(count)].cpu(), torch.nonzero(torch.triu(want_m)).int())
    kw = dict(capacity=2048, window=199)
    got = scene.scene_colliding_pairs_swept(polys, **kw)
    assert all(torch.equal(a.cpu(), b) for a, b in
               zip(got, scene.scene_colliding_pairs_swept(host, **kw)))
    got = scene.scene_contact_manifolds(polys, broad_phase="swept", **kw)
    want = scene.scene_contact_manifolds(host, broad_phase="swept", **kw)
    torch.cuda.synchronize()
    assert polygon_cuda.LAUNCHES > 0 and manifold_cuda.LAUNCHES > 0
    c = int(want[1])
    assert int(got[1]) == c > 0
    count, points, depths, normal = (a.cpu()[:c] for a in got[2:6])
    assert int((count != want[2][:c]).sum()) <= 1e-5 * c
    valid = torch.arange(2)[None] < want[2][:c, None]
    assert float((points - want[3][:c]).abs().amax(-1)[valid].max()) <= 1e-4
    assert float((depths - want[4][:c]).abs()[valid].max()) <= 1e-4
    assert float((normal - want[5][:c]).abs().max()) <= 2e-5


def _stream_tolerance(a: torch.Tensor, b: torch.Tensor, s: float) -> float:
    return 1e-5 * float(a.double().abs().sum() * s + b.double().abs().sum())


# M = 1 (a single float4 a thread for 16 threads), M = 4,097 (tiles of the
# plain version off the kernel's float4 grid), 2^20 (the bench's 2^23 pairs)
@pytest.mark.parametrize("m", [1, 4097, 1 << 20])
def test_stream_kernel_matches_plain(cuda, m):
    g = torch.Generator(device=cuda).manual_seed(m)
    r1 = torch.rand((8, 8, m), generator=g, device=cuda) * 24.0 - 12.0
    r2 = torch.rand((8, 8, m), generator=g, device=cuda) * 24.0 - 12.0
    s = 1.0 + 37e-9
    before = stream_cuda.LAUNCHES
    got = stream_cuda.stream_sum(r1, r2, s)
    again = stream_cuda.stream_sum(r1, r2, s)
    want = stream_cuda.stream_sum_plain(r1, r2, s)
    torch.cuda.synchronize()
    assert stream_cuda.LAUNCHES == before + 2
    assert torch.equal(got, again)  # no float atomics: the same value
    assert abs(float(got) - float(want)) <= _stream_tolerance(r1, r2, s)


# flat counts off the float4 width: the kernel's scalar tail
@pytest.mark.parametrize("n", [1, 3, 4 * 9999 + 1, 4 * 9999 + 3])
def test_stream_kernel_tail(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    a = torch.rand((n,), generator=g, device=cuda) - 0.25
    b = torch.rand((n,), generator=g, device=cuda) - 0.75
    got = stream_cuda._launch(a, b, 0.5)
    want = a.double().sum() * 0.5 + b.double().sum()
    assert abs(float(got) - float(want)) <= _stream_tolerance(a, b, 0.5)
    assert torch.equal(got, stream_cuda._launch(a, b, 0.5))


def test_stream_kernel_rejects_misaligned_inputs(cuda):
    x = torch.zeros((8, 8, 5), device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        stream_cuda._launch(x.reshape(-1)[1:], x.reshape(-1)[1:], 1.0)


def test_bench_entry_points_on_cuda(cuda):
    from collide2d_tpu_torch import bench
    from collide2d_tpu_torch.utils import benchmarks as bm

    head = bench.headline(log=lambda obj: None)
    assert head["bandwidth_check"] == "ok"
    assert 0 < head["effective_gbps"] <= 1.15 * head["hbm_read_gbps"]
    out = bm.bench_scene_raycast_cuda(rays=1 << 16, iters=2)
    assert out["metric"] == "scene_rays_per_sec_cuda" and out["value"] > 0


# ---- the learned model: featurize through kernel 8, training on the card ----
# Bars: the card's distance is its plain version's bit for bit on the
# card's tensors (kernel 8 rounds as the plain version does there);
# against the CPU's plain version the distance may differ by 1 ulp
# (torch's CPU sqrt misrounds a fraction of a percent of inputs) and the
# margin is bitwise wherever the distance is, else within 2 ulp. A card-saved bfloat16
# model predicts on the CPU within 2e-3 (the card's products run on the
# tensor cores, the CPU's in float32).


def _learned_tables(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    positions = rng.uniform(-6, 6, size=(n, 2)).astype(np.float32)
    positions[:16] = 0.0
    poses = rng.uniform(0.5, 4.0, size=(8, 3)).astype(np.float32)
    poses[0, :2] = (-2.5, 1.5)
    std = np.sqrt(rng.uniform(0.0, 0.09, size=(4, 5))).astype(np.float32)
    return (positions, rng.integers(0, 4, size=n), rng.integers(0, 8, size=n),
            poses, std)


def _learned_toy(n=2048, seed=0, device="cpu"):
    from collide2d_tpu_torch.models import learned

    positions, var_idx, pose_idx, poses, std = _learned_tables(n, seed)
    feats = learned.featurize(positions, var_idx, pose_idx, poses, std, device=device)
    gap = np.linalg.norm(positions, axis=1) - 0.5 * (poses[pose_idx, 0] + poses[pose_idx, 1])
    return feats, (1.0 / (1.0 + np.exp(3.0 * gap))).astype(np.float32)


def test_featurize_on_cuda_launches_kernel_8_and_equals_plain(cuda):
    from collide2d_tpu_torch.models import learned

    args = _learned_tables()
    distance_cuda.reset_launches()
    got = learned.featurize(*args, device=cuda)
    assert distance_cuda.LAUNCHES["obb_distance"] == 1
    cpu = learned.featurize(*args, device="cpu")
    np.testing.assert_array_equal(got[:, :11], cpu[:, :11])
    ulps = np.abs(got[:, 11:].view(np.int32).astype(np.int64)
                  - cpu[:, 11:].view(np.int32).astype(np.int64))
    assert ulps[:, 0].max() <= 1 and ulps[:, 1].max() <= 2
    assert ulps[ulps[:, 0] == 0, 1].max(initial=0) == 0
    # the plain version on the card's tensors: the same bits
    t = torch.from_numpy(got).to(cuda)
    rw, rh = (float(np.float32(v * 0.5)) for v in learned.ROBOT_WH)
    x = t[:, 0]
    plain = distance_cuda.obb_signed_distance_tile(
        0.0 - x, 0.0 - t[:, 1], t[:, 4], t[:, 5], torch.full_like(x, rw),
        torch.full_like(x, rh), torch.ones_like(x), torch.zeros_like(x),
        t[:, 2].abs() * 0.5, t[:, 3].abs() * 0.5)
    assert torch.equal(plain, t[:, 11])


def test_tensor_core_product_matches_the_float32_one(cuda):
    from collide2d_tpu_torch.models import learned

    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(8192, 256, device=cuda, generator=g).to(torch.bfloat16).requires_grad_()
    b = torch.randn(256, 256, device=cuda, generator=g).to(torch.bfloat16).requires_grad_()
    out = learned._mm_tensor_cores(a, b)
    want = learned._mm_exact_f32(a, b)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
    up = torch.randn_like(out)
    ga, gb = torch.autograd.grad((out * up).sum(), (a, b))
    wa, wb = torch.autograd.grad((want * up).sum(), (a, b))
    assert ga.dtype == gb.dtype == torch.bfloat16
    # the card's backward rounds the output gradient to bfloat16 first
    torch.testing.assert_close(ga.float(), wa.float(), rtol=2e-2, atol=0.5)
    torch.testing.assert_close(gb.float(), wb.float(), rtol=2e-2, atol=5.0)


def test_training_learns_on_cuda(cuda):
    from collide2d_tpu_torch.models import learned

    feats, labels = _learned_toy(device=cuda)
    cfg = learned.TrainConfig(hidden=(64, 64), epochs=30, batch_size=256,
                              learning_rate=3e-3, val_fraction=0.125, seed=0)
    res = learned.train_model(feats, labels, cfg, device=cuda)
    assert res.history[-1] < 0.8 * res.history[0]
    assert res.val_mae < 0.7 * float(np.mean(np.abs(labels - labels.mean())))


def test_cuda_saved_model_predicts_the_same_on_the_cpu(cuda, tmp_path):
    from collide2d_tpu_torch.models import learned

    feats, labels = _learned_toy(n=1024, seed=3, device=cuda)
    cfg = learned.TrainConfig(hidden=(64, 64), epochs=3, batch_size=128, seed=1)
    res = learned.train_model(feats, labels, cfg, device=cuda)
    path = tmp_path / "model.npz"
    learned.save_model(path, res, cfg)
    on_card = learned.LearnedCollisionModel.load(path, device=cuda)
    again = learned.LearnedCollisionModel.load(path, device=cuda)
    a = on_card.cp_from_features(feats).cpu().numpy()
    np.testing.assert_array_equal(a, again.cp_from_features(feats).cpu().numpy())
    b = learned.LearnedCollisionModel.load(path, device="cpu").cp_from_features(feats).numpy()
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-3)


# Multi-device rounds on logical meshes of the one card: kernels 1, 7, 13
# and 14 under a (2, 2) mesh (each sample shard a contiguous range of
# sample indices through the round wrappers' offset) give counts BITWISE
# the unsharded launch's, since the Philox
# streams are keyed by (seed, uid, sample index).
@pytest.mark.parametrize("kernel", ["1", "7", "13", "14"])
def test_mesh_round_is_bitwise_the_unsharded_launch(cuda, kernel):
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.estimator import mc_round
    from collide2d_tpu_torch.parallel import make_mesh

    configs, robot, mod = _resume_case(cuda, kernel)
    uids = torch.arange(configs.num, dtype=torch.int32, device=cuda)
    kw = dict(n_batch=4096, impl="cuda", ca_iters=0)
    key = prng.PRNGKey(11)
    base = mc_round(key, uids, configs, robot, 3, **kw)
    mod.reset_launches()
    got = mc_round(key, uids, configs, robot, 3, mesh=make_mesh([cuda] * 4, sample_axis=2),
                   **kw)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == 4
    assert got.device == base.device and torch.equal(got, base)
    assert 0 < int(base.sum()) < configs.num * 4096


@pytest.mark.parametrize("n", [4096 + 64 * 5, 4096 + 64 * 5 + 33])
def test_mesh_uneven_granule_split_is_bitwise(cuda, n):
    """Kernel 1 over 3 sample shards and 3 uneven config blocks (4,096 rows):
    69 granules, 23 a shard, with and without a 33-sample tail."""
    from collide2d_tpu_torch.mc import estimator as est
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.parallel import make_mesh

    configs, robot, _ = _resume_case(cuda, "1")
    uids = torch.arange(configs.num, dtype=torch.int32, device=cuda)
    key = prng.PRNGKey(12)
    base = mc_cuda.mc_round_cuda(key, uids, configs, robot, 5, n_batch=n,
                                 shape_noise=False)
    got = est._cuda_sharded_counts(key, uids, configs, robot, 5, n_batch=n,
                                   mesh=make_mesh([cuda] * 9, sample_axis=3),
                                   shape_noise=False)
    assert torch.equal(got, base)


def test_mesh_resume_is_bitwise_on_kernel_1(cuda, tmp_path):
    """A kernel-1 run interrupted under a (2, 2) logical mesh resumes from
    its checkpoint, without the mesh, to the unsharded labels bit for bit."""
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities as acp
    from collide2d_tpu_torch.mc.estimator import AdaptiveConfig
    from collide2d_tpu_torch.parallel import make_mesh

    configs, robot, mod = _resume_case(cuda, "1")
    cfg, key = AdaptiveConfig(max_samples=200_000), prng.PRNGKey(9)
    base = acp(key, configs, robot, cfg)
    mesh = make_mesh([cuda] * 4, sample_axis=2)
    assert all(np.array_equal(a, b) for a, b in
               zip(acp(key, configs, robot, cfg, mesh=mesh), base))
    ckpt = tmp_path / "ckpt.npz"

    def bomb(*, round, **kw):
        if round >= 3:
            raise _Stop

    with pytest.raises(_Stop):
        acp(key, configs, robot, cfg, progress=bomb, checkpoint_path=str(ckpt),
            checkpoint_every=1, mesh=mesh)
    with np.load(ckpt) as z:
        n_saved = int(z["n_samples"])
    seen = []
    out = acp(key, configs, robot, cfg, checkpoint_path=str(ckpt), checkpoint_every=1,
              progress=lambda **kw: seen.append(kw["n_samples"]))
    assert n_saved > 0 and min(seen) > n_saved
    for got, want in zip(out, base):
        np.testing.assert_array_equal(got, want)


# ---- the round epilogue (the adaptive loop's stopping rule and freeze) ----
# The kernel rounds as mc/stats.py does (csrc/round_epilogue.cuh): state
# and done count bitwise the plain update's, on states that run several
# rounds; the adaptive driver's labels bitwise those of the plain path (the
# torch update and a table packed every round, patched in).

_EPILOGUE_BINS = [((0.0, 0.01, 0.1, 1.0), (0.0001, 0.001, 0.01)),
                  ((0.0, 0.3, 0.2, 0.55, 1.0), (0.004, 0.0005, 0.003, 0.02))]


@pytest.mark.parametrize("bins", range(len(_EPILOGUE_BINS)))
@pytest.mark.parametrize("into_n_true", [False, True])
def test_round_epilogue_matches_plain_over_rounds(cuda, bins, into_n_true):
    from collide2d_tpu_torch.ops import round_epilogue_cuda as rec

    edges, targets = _EPILOGUE_BINS[bins]
    rng = np.random.default_rng(50 + bins)
    c = 70_001
    probs = np.array([0.0, 1e-4, 5e-4, 0.002, 0.008, 0.03, 0.12, 0.25, 0.5, 0.9, 0.99, 1.0])
    uids = torch.from_numpy(np.where(rng.random(c) < 0.9, np.arange(c), -1)
                            .astype(np.int32))
    want = (torch.zeros(c, dtype=torch.int32), torch.zeros(c, dtype=torch.bool),
            torch.zeros(c, dtype=torch.int32), torch.ones(c, dtype=torch.int32))
    got = tuple(t.to(cuda) for t in want)
    n_after, rounds, done_counts = 0, 14, []
    rec.reset_launches()
    for r in range(rounds):
        nb = 1_000 if r < 6 else 50_000
        n_after += nb
        counts = rng.binomial(nb, probs[rng.integers(0, len(probs), c)]).astype(np.int32)
        last = r == rounds - 1 or r % 4 == 3
        *want, want_done = rec.round_update_plain(
            *want, torch.from_numpy(counts), n_after, edges, targets,
            uids if last else None)
        counts_dev = torch.from_numpy(counts).to(cuda)
        if into_n_true:  # the fused kernel's counts already added in
            got[0].add_(counts_dev)
        out = rec.round_update(*got, None if into_n_true else counts_dev, n_after,
                               edges, targets, uids=uids.to(cuda) if last else None)
        assert all(o is g for o, g in zip(out[:4], got))  # in place
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        assert (out[4] is None) == (not last)
        if last:
            assert out[4].shape == () and int(out[4]) == int(want_done)
        done_counts.append(int(want[1].sum()))
    assert rec.LAUNCHES == rounds
    assert any(0 < d < c for d in done_counts)  # rows froze over several rounds


@pytest.mark.parametrize("kernel", ["1", "7", "13", "14"])
def test_round_issues_at_most_three_device_operations(cuda, kernel):
    """A run of same-plan rounds on a hoisted table: each round is the
    fused kernel (adding into n_true) and the epilogue; the run's last
    round also zeroes the done count (a memset). Nothing else reaches the
    card."""
    from torch.profiler import ProfilerActivity, profile

    from collide2d_tpu_torch.mc import estimator as est
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.driver import AdaptiveRun
    from collide2d_tpu_torch.ops import round_epilogue_cuda as rec

    configs, robot, mod = _resume_case(cuda, kernel)
    run = AdaptiveRun(prng.PRNGKey(3), configs, robot, est.AdaptiveConfig())
    ops, rounds = run.ops, 5
    assert ops.table is not None
    ops.run_rounds(1024, 64, 1, 1024, 0)  # warm: builds and loads both libraries
    torch.cuda.synchronize()
    mod.reset_launches()
    rec.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        handle = ops.run_rounds(1024, 64, rounds, 2048, 16)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    fused_name = {"1": "mc_counts_kernel", "7": "mc_poly_counts_kernel",
                  "13": "mc_toi_counts_kernel", "14": "mc_moving_poly_counts_kernel"}
    fused = [n for n in names if fused_name[kernel] in n]
    epilogue = [n for n in names if "round_epilogue_kernel" in n]
    memset = [n for n in names if "memset" in n.lower()]
    copies = [n for n in names if "memcpy" in n.lower()]  # the done count's readback
    assert (len(fused), len(epilogue), len(memset), len(copies)) == (rounds, rounds, 1, 1)
    assert len(names) - len(copies) <= 3 * rounds
    assert (mod.LAUNCHES, rec.LAUNCHES) == (rounds, rounds)
    assert 0 <= ops.resolve(handle) <= configs.num


def _plain_round_path(monkeypatch):
    """The plain path: the torch update (`round_update_plain`) and a
    table packed every round."""
    from collide2d_tpu_torch.mc import estimator as est
    from collide2d_tpu_torch.ops import round_epilogue_cuda as rec

    def plain(n_true, done, k_frozen, n_frozen, counts, n_after, bins, acc, *, uids=None):
        return rec.round_update_plain(n_true, done, k_frozen, n_frozen, counts,
                                      n_after, bins, acc, uids)

    monkeypatch.setattr(rec, "round_update", plain)
    monkeypatch.setattr(est, "pack_round_table", lambda *a, **k: None)


def test_polylabel_labels_are_the_plain_round_paths(cuda, tmp_path, monkeypatch):
    from collide2d_tpu_torch.ops import round_epilogue_cuda as rec

    b = example_polygon_configs(20_000, k=8, seed=17, device="cpu")
    np.savez(tmp_path / "in.npz", robot_verts=ROBOT_4GON,
             position=(b.position * 0.6).numpy(), pose_theta=b.pose_theta.numpy(),
             obstacle_verts=b.obstacle_verts.numpy(), std_dev=b.std_dev.numpy())
    argv = ["polylabel", "--device", "cuda", "--data_in", str(tmp_path / "in.npz"),
            "--seed", "3"]
    rec.reset_launches()
    assert cli.main([*argv, "--data_out", str(tmp_path / "got.npz")]) == 0
    assert rec.LAUNCHES > 0
    with monkeypatch.context() as m:
        _plain_round_path(m)
        assert cli.main([*argv, "--data_out", str(tmp_path / "want.npz")]) == 0
    with np.load(tmp_path / "got.npz") as got, np.load(tmp_path / "want.npz") as want:
        for name in ("cp", "n_samples", "converged"):
            np.testing.assert_array_equal(got[name], want[name])
        assert 0 < got["converged"].mean() < 1 or got["converged"].all()


def test_movelabel_labels_are_the_plain_round_paths(cuda, tmp_path, monkeypatch):
    """A translation-only k = 8 file: kernel 14 counting from the table
    packed once a buffer into n_true gives the labels of a table packed
    every round and the torch update."""
    from collide2d_tpu_torch.ops import mc_moving_polygon_cuda
    from collide2d_tpu_torch.ops import round_epilogue_cuda as rec

    c = 20_000
    b = example_polygon_configs(c, k=8, seed=18, device="cpu")
    rng = np.random.default_rng(18)
    np.savez(tmp_path / "in.npz", robot_verts=ROBOT_4GON,
             position=(b.position * 0.6).numpy(), pose_theta=b.pose_theta.numpy(),
             obstacle_verts=b.obstacle_verts.numpy(), std_dev=b.std_dev.numpy(),
             velocity=rng.uniform(-2, 2, (c, 2)).astype(np.float32),
             omega=np.zeros(c, np.float32),
             t_max=rng.uniform(0.5, 2, c).astype(np.float32))
    argv = ["movelabel", "--device", "cuda", "--data_in", str(tmp_path / "in.npz"),
            "--seed", "3"]
    rec.reset_launches()
    mc_moving_polygon_cuda.reset_launches()
    assert cli.main([*argv, "--data_out", str(tmp_path / "got.npz")]) == 0
    assert rec.LAUNCHES > 0 and mc_moving_polygon_cuda.LAUNCHES == rec.LAUNCHES
    with monkeypatch.context() as m:
        _plain_round_path(m)
        assert cli.main([*argv, "--data_out", str(tmp_path / "want.npz")]) == 0
    with np.load(tmp_path / "got.npz") as got, np.load(tmp_path / "want.npz") as want:
        for name in ("cp", "n_samples", "converged"):
            np.testing.assert_array_equal(got[name], want[name])
        assert 0 < got["cp"].mean() < 1


def test_generate_batch_is_the_plain_round_paths(cuda, tmp_path, monkeypatch):
    from collide2d_tpu_torch.ops import round_epilogue_cuda as rec

    argv = ["generate", "--device", "cuda", "-n", "1", "-b", "4096", "--seed", "9",
            "--num_poses", "4096", "--num_variances", "4096", "--verbose", "false"]
    rec.reset_launches()
    assert cli.main([*argv, "--data_dir", str(tmp_path / "got")]) == 0
    assert rec.LAUNCHES > 0
    with monkeypatch.context() as m:
        _plain_round_path(m)
        assert cli.main([*argv, "--data_dir", str(tmp_path / "want")]) == 0
    got = (tmp_path / "got" / "0.npy").read_bytes()
    assert len(got) > 4096 * 5 * 4 and got == (tmp_path / "want" / "0.npy").read_bytes()
