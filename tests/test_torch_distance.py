"""The port's signed-distance path on the CPU against the JAX package.

- `ops.distance` against `collide2d_tpu.ops.distance` (the ``jnp`` path):
  the same formulas, so values agree to a few ulps (atol 1e-5 on
  distances up to ~10: XLA and torch may round a division or a square root
  of the same operands an ulp apart); witness points and normals too.
- Gradients of the torch `distance` against `jax.grad` of the JAX model's
  ``jnp`` path, on pairs away from touching (rtol 1e-4, atol 1e-5).
- Kernels 8 and 9's plain versions against the Pallas kernels in
  interpret mode on the same packed inputs: values within 2e-5 (kernel 8
  is kernel 4's gap arithmetic; kernel 9 scales by 1/sqrt where the TPU
  has rsqrt, and pads to the CUDA kernel's K bucket), signs bitwise the
  port's `obb_collide` / `sat_polygons` labels.
- The models' `distance` / `closest_points` against the JAX models, the
  kernel routing (CPU tensors never launch; inputs that require grad
  raise), and the build path's hash of the shared headers.

The CUDA kernels themselves cannot run here: tests/test_torch_gpu.py holds
them against these plain versions and skips without a card.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from collide2d_tpu.mc.estimator import PolygonConfigs as JPolygonConfigs
from collide2d_tpu.models import collision_model as jm
from collide2d_tpu.ops import distance as jd
from collide2d_tpu.ops import distance_pallas as jdp
from collide2d_tpu.ops import polygon_pallas as jpp
from collide2d_tpu.ops import sat_pallas as jsp
from collide2d_tpu_torch.models import collision_model as tm
from collide2d_tpu_torch.ops import distance as td
from collide2d_tpu_torch.ops import distance_cuda as tdc
from collide2d_tpu_torch.ops import polygon_cuda as tpc
from collide2d_tpu_torch.ops import sat as tsat
from collide2d_tpu_torch.ops import sat_cuda as tsc
from collide2d_tpu_torch.utils import cuda_build

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ATOL = 1e-5  # the jnp path against ops.distance (same formulas)
KERNEL_ATOL = 2e-5  # plain versions against the Pallas kernels
ROBOT = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87],
                  [-2.035, 0.87]], np.float32)


def polygons(rng, n, k, spread=3.0):
    """(n, k, 2) float32 convex CCW k-gons: ellipse points at sorted angles,
    shifted by up to ``spread``."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, k)), axis=-1)
    ab = rng.uniform(0.3, 2.5, (n, 1, 2))
    shift = rng.uniform(-spread, spread, (n, 1, 2))
    return (np.stack([np.cos(ang), np.sin(ang)], -1) * ab + shift).astype(np.float32)


def boxes(rng, n):
    """Param-form box pairs (negative extents included, as obb_collide
    takes them): c1, e1, t1, c2, e2, t2 float32."""
    f = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)  # noqa: E731
    return (f(-6, 6, n, 2), f(-2, 5, n, 2), f(0, 7, n), f(-6, 6, n, 2),
            f(-2, 5, n, 2), f(0, 7, n))


def _j(*a):
    return [jnp.asarray(x) for x in a]


def jit(fn, **static):
    """``fn`` jitted with ``static`` bound: one XLA compile instead of one
    per operation in eager mode, which is what keeps these tests fast."""
    return jax.jit(functools.partial(fn, **static))


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def assert_witnesses_agree(got, want, atol, normal_atol, normal_rows=None):
    """``(dist, pa, pb, normal)`` against JAX's. ``dist`` within ``atol`` and
    ``normal`` within ``normal_atol`` (on ``normal_rows``); the witness
    points equal, or at a witness tie (an edge parallel to the normal has
    two support points whose projections differ by rounding, and which one
    a tie returns depends on the compilation, as the JAX docstring says)
    the two lie on the same supporting lines: their difference is
    perpendicular to the normal. The identity pb - pa = dist * normal holds
    for every row."""
    dist, pa, pb, normal = (a.numpy() for a in got)
    want = [np.asarray(a) for a in want]
    np.testing.assert_allclose(dist, want[0], rtol=0, atol=atol)
    rows = slice(None) if normal_rows is None else normal_rows
    np.testing.assert_allclose(normal[rows], want[3][rows], rtol=0, atol=normal_atol)
    for g, w in ((pa, want[1]), (pb, want[2])):
        tie = np.abs(g - w).max(axis=-1) > atol
        assert tie.mean() <= 0.05
        np.testing.assert_allclose(((g - w) * normal).sum(-1)[tie], 0.0, atol=1e-4)
    np.testing.assert_allclose(pb - pa, dist[:, None] * normal, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k1,k2,masked", [(4, 8, False), (3, 5, False),
                                          (6, 6, True)])
def test_polygon_signed_distance_vs_jax(k1, k2, masked):
    rng = np.random.default_rng(k1 * 10 + k2)
    n = 256
    p1, p2 = polygons(rng, n, k1), polygons(rng, n, k2)
    m1 = m2 = None
    if masked:
        m1 = np.arange(k1)[None] < rng.integers(3, k1 + 1, (n, 1))
        m2 = np.arange(k2)[None] < rng.integers(3, k2 + 1, (n, 1))
        p1 = np.where(m1[..., None], p1, 50.0).astype(np.float32)
    jm1 = None if m1 is None else jnp.asarray(m1)
    jm2 = None if m2 is None else jnp.asarray(m2)
    want = np.asarray(jit(jd.polygon_signed_distance)(*_j(p1, p2), jm1, jm2))
    tm1 = None if m1 is None else torch.from_numpy(m1)
    tm2 = None if m2 is None else torch.from_numpy(m2)
    got = td.polygon_signed_distance(*_t(p1, p2), tm1, tm2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (want > 0).any() and (want < 0).any()


@pytest.mark.parametrize("k1,k2", [(4, 8), (5, 5)])
def test_polygon_closest_points_vs_jax(k1, k2):
    rng = np.random.default_rng(3 + k1 + k2)
    p1, p2 = polygons(rng, 256, k1), polygons(rng, 256, k2)
    want = jit(jd.polygon_closest_points)(*_j(p1, p2))
    assert_witnesses_agree(td.polygon_closest_points(*_t(p1, p2)), want, ATOL, ATOL)
    assert (want[0] < 0).any() and (want[0] > 0).any()


def test_rect_param_forms_vs_jax():
    args = boxes(np.random.default_rng(4), 256)
    want = np.asarray(jit(jd.rect_signed_distance)(*_j(*args)))
    np.testing.assert_allclose(td.rect_signed_distance(*_t(*args)).numpy(), want,
                               rtol=0, atol=ATOL)
    # torch's cos/sin place the vertices an ulp from JAX's: the normal of a
    # small separation carries that ulp over the separation
    assert_witnesses_agree(td.rect_closest_points(*_t(*args)),
                           jit(jd.rect_closest_points)(*_j(*args)), ATOL, 1e-4,
                           np.abs(want) > 1e-2)


def test_distance_gradient_vs_jax_grad():
    rng = np.random.default_rng(5)
    c = 128
    pos = rng.uniform(-6, 6, (c, 2)).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, c).astype(np.float32)
    wh = rng.uniform(0.5, 4, (c, 2)).astype(np.float32)
    jmodel = jm.CollisionProbabilityModel()
    d = np.asarray(jax.jit(jmodel.distance)(*_j(pos, th, wh)))
    want = np.asarray(jax.jit(jax.grad(lambda p: jnp.sum(jmodel.distance(
        p, jnp.asarray(th), jnp.asarray(wh)))))(jnp.asarray(pos)))
    keep = np.abs(d) > 0.05  # away from touching
    p_t = torch.from_numpy(pos).requires_grad_(True)
    dist = tm.CollisionProbabilityModel().distance(p_t, *_t(th, wh))
    (got,) = torch.autograd.grad(dist.sum(), p_t)
    np.testing.assert_allclose(got.numpy()[keep], want[keep], rtol=1e-4, atol=1e-5)
    assert keep.sum() > 100 and (d < 0).any() and (d > 0).any()


def test_kernel8_plain_vs_pallas_interpret_and_sign():
    n = 256
    c1, e1, t1, c2, e2, t2 = boxes(np.random.default_rng(6), n)
    b1, b2 = jsp.pack_obbs(*_j(c1, e1, t1)), jsp.pack_obbs(*_j(c2, e2, t2))
    want = np.asarray(jdp.obb_distance_pallas_t(b1, b2, 0.25, block=16,
                                                interpret=True))
    a, b = _t(np.asarray(b1), np.asarray(b2))
    # the packers agree (cos/sin an ulp apart)
    np.testing.assert_allclose(tsc.pack_obbs(*_t(c1, e1, t1)).numpy(), a.numpy(),
                               rtol=0, atol=1e-7)
    got = tdc.obb_distance_cuda_t(a, b, 0.25, block=16)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=KERNEL_ATOL)
    label = tsc.obb_collide_cuda_t(a, b, 0.25, block=16).numpy()
    np.testing.assert_array_equal((got.numpy() <= 0), label > 0)
    assert 0 < label.mean() < 1


def test_kernel8_drop_in_matches_jnp_and_obb_collide():
    args = boxes(np.random.default_rng(7), 250)  # padded to the alignment
    got = tdc.rect_distance_cuda(*_t(*args)).numpy()
    assert got.shape == (250,)
    np.testing.assert_allclose(got, np.asarray(jit(jd.rect_signed_distance)(*_j(*args))),
                               rtol=0, atol=KERNEL_ATOL)
    np.testing.assert_array_equal((got <= 0).astype(np.int32),
                                  tsat.obb_collide(*_t(*args)).numpy())


@pytest.mark.parametrize("k1,k2", [(3, 6), (4, 8)])
def test_kernel9_plain_vs_pallas_interpret_and_sign(k1, k2):
    rng = np.random.default_rng(k1 * 7 + k2)
    n = 256
    p1, p2 = polygons(rng, n, k1), polygons(rng, n, k2)
    a, b = jpp.pack_polygons(jnp.asarray(p1)), jpp.pack_polygons(jnp.asarray(p2))
    want = np.asarray(jdp.polygon_distance_pallas_t(a, b, k1=k1, k2=k2, block=16,
                                                    interpret=True))
    a_t, b_t = tpc.pack_polygons(torch.from_numpy(p1)), tpc.pack_polygons(torch.from_numpy(p2))
    got = tdc.polygon_distance_cuda_t(a_t, b_t, k1=k1, k2=k2, block=16).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=KERNEL_ATOL)
    np.testing.assert_array_equal((got <= 0).astype(np.int32),
                                  tsat.sat_polygons(*_t(p1, p2)).numpy())
    assert (want > 0).any() and (want < 0).any()


def test_kernel9_wide_k_and_drop_in_vs_jnp():
    # k = 12 pads to the 16 bucket; N not aligned pads with the last pair
    rng = np.random.default_rng(8)
    for k1, k2, n in ((12, 12, 64), (5, 7, 201)):
        p1, p2 = polygons(rng, n, k1), polygons(rng, n, k2)
        got = tdc.polygon_distance_cuda(*_t(p1, p2)).numpy()
        assert got.shape == (n,)
        np.testing.assert_allclose(got, np.asarray(jit(jd.polygon_signed_distance)(
            *_j(p1, p2))), rtol=0, atol=KERNEL_ATOL)
        np.testing.assert_array_equal((got <= 0).astype(np.int32),
                                      tsat.sat_polygons(*_t(p1, p2)).numpy())


@pytest.fixture(scope="module")
def rect_case():
    """`example_configs` rows (the JAX example's draws) and the JAX model's
    distance and witnesses on them."""
    t = tm.example_configs(256, seed=9, device="cpu")  # the JAX example's threefry draws
    jmodel = jm.CollisionProbabilityModel()
    args = _j(t.position, t.pose_theta, t.obstacle_wh)
    return (t, np.asarray(jax.jit(jmodel.distance)(*args)),
            jax.jit(jmodel.closest_points)(*args))


@pytest.fixture(scope="module")
def polygon_case():
    t = tm.example_polygon_configs(256, k=8, seed=10, device="cpu")
    b = JPolygonConfigs(*_j(*t))
    jmodel = jm.PolygonCollisionProbabilityModel(ROBOT)
    return t, np.asarray(jax.jit(jmodel.distance)(b)), jax.jit(jmodel.closest_points)(b)


@pytest.mark.parametrize("impl", ["torch", "auto", "cuda"])
def test_rect_model_distance_vs_jax(rect_case, impl):
    t, want, _ = rect_case
    model = tm.CollisionProbabilityModel()
    got = model.distance(t.position, t.pose_theta, t.obstacle_wh, impl=impl).numpy()
    # the port places the robot with torch's cos/sin: an ulp from JAX's
    np.testing.assert_allclose(got, want, rtol=0, atol=KERNEL_ATOL)
    np.testing.assert_array_equal(
        (got <= 0).astype(np.int32),
        model.collide(t.position, t.pose_theta, t.obstacle_wh, method="obb").numpy())
    assert (want < 0).any() and (want > 0).any()


def test_rect_model_closest_points_vs_jax(rect_case):
    t, want, want_cp = rect_case
    # the normal of a small separation carries the placement's ulp over the
    # separation: compare it away from touching
    assert_witnesses_agree(
        tm.CollisionProbabilityModel().closest_points(t.position, t.pose_theta,
                                                      t.obstacle_wh),
        want_cp, KERNEL_ATOL, 1e-4, np.abs(want) > 1e-2)


@pytest.mark.parametrize("impl", ["torch", "auto"])
def test_polygon_model_distance_vs_jax(polygon_case, impl):
    t, want, want_cp = polygon_case
    model = tm.PolygonCollisionProbabilityModel(ROBOT)
    got = model.distance(t, impl=impl).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=KERNEL_ATOL)
    np.testing.assert_array_equal((got <= 0).astype(np.int32),
                                  model.collide(t, impl="torch").numpy())
    if impl == "torch":
        assert_witnesses_agree(model.closest_points(t), want_cp, KERNEL_ATOL, 1e-4,
                               np.abs(want) > 1e-2)


def test_cpu_tensors_never_launch_and_grad_raises():
    tdc.reset_launches()
    b = tm.example_configs(64, seed=11, device="cpu")
    model = tm.CollisionProbabilityModel()
    model.distance(b.position, b.pose_theta, b.obstacle_wh, impl="cuda")
    pb = tm.example_polygon_configs(64, k=6, seed=11, device="cpu")
    tm.PolygonCollisionProbabilityModel(ROBOT).distance(pb, impl="cuda")
    assert tdc.LAUNCHES == {"obb_distance": 0, "polygon_distance": 0}
    pos = b.position.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="impl='torch'"):
        model.distance(pos, b.pose_theta, b.obstacle_wh, impl="auto")
    with pytest.raises(ValueError, match="impl='torch'"):
        tm.PolygonCollisionProbabilityModel(ROBOT).distance(
            pb._replace(position=pb.position.clone().requires_grad_(True)), impl="cuda")
    # the torch path keeps the gradient
    assert model.distance(pos, b.pose_theta, b.obstacle_wh).requires_grad
    with pytest.raises(ValueError, match="impl"):
        model.distance(b.position, b.pose_theta, b.obstacle_wh, impl="pallas")


def test_wrappers_reject_what_the_kernels_do_not_take():
    # k = 17 is taken (the K = 32 bucket) and equals the jnp path
    rng = np.random.default_rng(17)
    p1, p2 = polygons(rng, 4096, 17), polygons(rng, 4096, 4)
    a, b = tpc.pack_polygons(torch.from_numpy(p1)), tpc.pack_polygons(torch.from_numpy(p2))
    got = tdc.polygon_distance_cuda_t(a, b, k1=17, k2=4).numpy()
    np.testing.assert_allclose(got, np.asarray(jit(jd.polygon_signed_distance)(*_j(p1, p2))),
                               rtol=0, atol=KERNEL_ATOL)
    assert (got < 0).any() and (got > 0).any()
    with pytest.raises(ValueError, match="float32"):
        tdc.polygon_distance_cuda_t(a.bfloat16(), b.bfloat16(), k1=17, k2=4)
    box = tsc.pack_obbs(torch.zeros((8192, 2)), torch.ones((8192, 2)), torch.zeros(8192))
    with pytest.raises(ValueError, match="multiple of block"):
        tdc.obb_distance_cuda_t(box[:, :, :100], box[:, :, :100])
    with pytest.raises(ValueError, match="unsupported device"):
        tdc.obb_distance_cuda_t(box.to("meta"), box.to("meta"))


def test_library_path_hashes_the_shared_headers(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "shared.cuh"\n')
    monkeypatch.setattr(cuda_build, "CSRC_DIR", src)
    before = cuda_build.library_path("k")
    (src / "shared.cuh").write_text("// one\n")
    one = cuda_build.library_path("k")
    (src / "shared.cuh").write_text("// two\n")
    two = cuda_build.library_path("k")
    assert len({before, one, two}) == 3
    assert two == cuda_build.library_path("k")  # stable for unchanged files
    assert two.name.startswith("libk-") and two.parent == cuda_build.BUILD_DIR
