"""The port's contact-manifold path on the CPU against the JAX package.

Bars (as the JAX package's own tests, tests/test_manifold.py:271-408):
counts exact; points and depths on the valid slots and the normal of
non-empty manifolds within 1e-5 for `ops.manifold` against the ``jnp``
path (the same formulas; XLA and torch may round a division an ulp
apart), within 2e-5 for kernel 10's plain version against the Pallas
kernel in interpret mode (the unit normal is n * (1 / sqrt(|n|^2)) in two
IEEE operations where the TPU has rsqrt, and polygons are padded to the
CUDA kernel's K bucket) and for the models (torch's cos/sin place the robot
an ulp from JAX's), 3e-5 at k = 12 (as the JAX test). Cases: random pairs,
mixed k, the speculative margin, degenerate (all-zero-edge) rows, masks.

The CUDA kernel itself cannot run here: tests/test_torch_gpu.py holds it
against this plain version and skips without a card.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from collide2d_tpu.mc.estimator import PolygonConfigs as JPolygonConfigs
from collide2d_tpu.models import collision_model as jm
from collide2d_tpu.ops import manifold as jmf
from collide2d_tpu.ops import manifold_pallas as jmp
from collide2d_tpu.ops import polygon_pallas as jpp
from collide2d_tpu_torch.models import collision_model as tm
from collide2d_tpu_torch.ops import manifold as tmf
from collide2d_tpu_torch.ops import manifold_cuda as tmc
from collide2d_tpu_torch.ops import polygon_cuda as tpc

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ATOL = 1e-5
KERNEL_ATOL = 2e-5
ROBOT = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87],
                  [-2.035, 0.87]], np.float32)
N, BLOCK = 256, 16  # two grid steps of the Pallas kernel


def polygons(rng, n, k, spread=3.0):
    """(n, k, 2) float32 convex CCW k-gons: ellipse points at sorted angles,
    shifted by up to ``spread``."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, k)), axis=-1)
    ab = rng.uniform(0.3, 2.5, (n, 1, 2))
    shift = rng.uniform(-spread, spread, (n, 1, 2))
    return (np.stack([np.cos(ang), np.sin(ang)], -1) * ab + shift).astype(np.float32)


def square(cx, cy, half):
    return np.array([[cx - half, cy - half], [cx + half, cy - half],
                     [cx + half, cy + half], [cx - half, cy + half]], np.float32)


def pad(p, k):
    """Repeat the last vertex of (n, k0, 2) up to k."""
    return np.concatenate([p, np.repeat(p[:, -1:], k - p.shape[1], 1)], 1)


def jit(fn, **static):
    """``fn`` jitted with ``static`` bound: one XLA compile instead of one
    per operation in eager mode."""
    return jax.jit(functools.partial(fn, **static))


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def assert_manifolds_agree(got, want, atol):
    """Counts equal; valid slots' points and depths and the normal of
    non-empty manifolds within ``atol``."""
    count, points, depths, normal = (np.asarray(a) for a in got)
    w_count, w_points, w_depths, w_normal = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(count, w_count)
    valid = np.arange(2)[None] < w_count[:, None]
    np.testing.assert_allclose(points[valid], w_points[valid], rtol=0, atol=atol)
    np.testing.assert_allclose(depths[valid], w_depths[valid], rtol=0, atol=atol)
    live = w_count > 0
    np.testing.assert_allclose(normal[live], w_normal[live], rtol=0, atol=atol)
    assert count.dtype == np.int32 and points.shape == count.shape + (2, 2)


@pytest.mark.parametrize("k1,k2,margin,masked", [
    (8, 8, 0.0, False), (5, 8, 0.1, False), (6, 6, 0.0, True)])
def test_polygon_contact_manifold_vs_jax(k1, k2, margin, masked):
    rng = np.random.default_rng(k1 * 10 + k2)
    n = 256
    p1, p2 = polygons(rng, n, k1), polygons(rng, n, k2)
    m1 = m2 = None
    if masked:
        m1 = np.arange(k1)[None] < rng.integers(3, k1 + 1, (n, 1))
        m2 = np.arange(k2)[None] < rng.integers(3, k2 + 1, (n, 1))
        p2 = np.where(m2[..., None], p2, -40.0).astype(np.float32)
    want = jit(jmf.polygon_contact_manifold, margin=margin)(
        jnp.asarray(p1), jnp.asarray(p2), None if m1 is None else jnp.asarray(m1),
        None if m2 is None else jnp.asarray(m2))
    got = tmf.polygon_contact_manifold(
        *_t(p1, p2), None if m1 is None else torch.from_numpy(m1),
        None if m2 is None else torch.from_numpy(m2), margin=margin)
    assert_manifolds_agree(got, want, ATOL)
    assert (np.asarray(want[0]) == 2).any() and (np.asarray(want[0]) == 0).any()


def test_margin_degenerate_and_rect_forms_vs_jax():
    # speculative contact of two squares 0.05 apart; a degenerate point pair
    a = np.broadcast_to(square(0, 0, 1.0), (8, 4, 2)).copy()
    b = np.broadcast_to(square(0, 2.05, 1.0), (8, 4, 2)).copy()
    count, _, depths, normal = tmf.polygon_contact_manifold(*_t(a, b), margin=0.1)
    assert (count.numpy() == 2).all()
    np.testing.assert_allclose(depths.numpy(), -0.05, atol=1e-6)
    np.testing.assert_allclose(normal.numpy(), np.broadcast_to([0.0, 1.0], (8, 2)),
                               atol=1e-6)
    pt = np.tile(np.array([[0.5, 0.5]], np.float32), (8, 4, 1))
    assert (tmf.polygon_contact_manifold(*_t(pt, pt))[0].numpy() == 0).all()
    rng = np.random.default_rng(3)
    f = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)  # noqa: E731
    args = (f(-3, 3, 256, 2), f(-2, 5, 256, 2), f(0, 7, 256), f(-3, 3, 256, 2),
            f(0.5, 5, 256, 2), f(0, 7, 256))
    want = jit(jmf.rect_contact_manifold, margin=0.05)(*(jnp.asarray(x) for x in args))
    # torch's cos/sin build the vertices an ulp from JAX's
    assert_manifolds_agree(tmf.rect_contact_manifold(*_t(*args), margin=0.05), want,
                           KERNEL_ATOL)


def _kernel_vs_interpret(p1, p2, k1, k2, margin):
    a, b = jpp.pack_polygons(jnp.asarray(p1)), jpp.pack_polygons(jnp.asarray(p2))
    want = jmp.polygon_manifold_pallas_t(a, b, k1=k1, k2=k2, margin=margin,
                                         block=BLOCK, interpret=True)
    out = tmc.polygon_manifold_cuda_t(*map(tpc.pack_polygons, _t(p1, p2)), k1=k1,
                                      k2=k2, margin=margin, block=BLOCK)
    assert out.dtype == torch.float32 and out.shape == (9, 8, len(p1) // 8)
    n = len(p1)
    assert_manifolds_agree(tmc.unpack_manifold(out, n), tmc.unpack_manifold(
        torch.from_numpy(np.array(want)), n), KERNEL_ATOL)
    return np.asarray(want)[0].reshape(-1)


def test_kernel10_plain_vs_pallas_interpret_k8_with_degenerate_rows():
    rng = np.random.default_rng(4)
    p1, p2 = polygons(rng, N, 8), polygons(rng, N, 8)
    p1[:16] = 0.5  # both degenerate: an empty manifold
    p2[:16] = 0.5
    p1[16:32] = 0.25  # a point against a polygon: contacts through its faces
    count = _kernel_vs_interpret(p1, p2, 8, 8, 0.0)
    assert (count[:16] == 0).all() and (count == 2).any() and (count == 1).any()


def test_kernel10_plain_vs_pallas_interpret_mixed_k_with_margin():
    rng = np.random.default_rng(5)
    p1, p2 = polygons(rng, N, 4), pad(polygons(rng, N, 7), 8)
    p1[:64] = square(0, 0, 1.0)  # square stacks 0.05 apart: speculative
    p2[:64] = pad(square(0, 2.05, 1.0)[None], 8)[0]
    count = _kernel_vs_interpret(p1, p2, 4, 8, 0.1)
    assert (count[:64] == 2).all() and (count == 0).any()


def test_kernel10_plain_wide_k_and_drop_in_vs_jnp():
    # k = 12 pads to the 16 bucket (the JAX test's k = 12 case, bar 3e-5);
    # an unaligned N pads with the last pair
    rng = np.random.default_rng(6)
    for k1, k2, n, atol in ((12, 12, 256, 3e-5), (5, 8, 201, KERNEL_ATOL)):
        ang = np.linspace(0, 2 * np.pi, k1, endpoint=False)
        if k1 == 12:
            a = ang[None] + rng.uniform(0, 7, (n, 1))
            rad = rng.uniform(0.5, 2, (n, 1))
            p1 = np.stack([rng.uniform(-3, 3, (n, 1)) + rad * np.cos(a),
                           rng.uniform(-3, 3, (n, 1)) + rad * np.sin(a)], -1)
            p1, p2 = p1.astype(np.float32), polygons(rng, n, k2)
        else:
            p1, p2 = polygons(rng, n, k1), polygons(rng, n, k2)
        want = jit(jmf.polygon_contact_manifold)(jnp.asarray(p1), jnp.asarray(p2))
        got = tmc.polygon_manifold_cuda(*_t(p1, p2))
        assert got[0].shape == (n,)
        assert_manifolds_agree(got, want, atol)
        assert (np.asarray(want[0]) > 0).sum() >= 5


@functools.cache
def jax_model_manifold(kind, margin=0.0):
    """The JAX model's ``jnp`` manifold on the port's example rows (the JAX
    examples' threefry draws), computed once per case: (rows, result)."""
    if kind == "rect":
        t = tm.example_configs(256, seed=7, device="cpu")
        args = [jnp.asarray(a.numpy()) for a in (t.position, t.pose_theta, t.obstacle_wh)]
        return t, jax.jit(functools.partial(jm.CollisionProbabilityModel().contact_manifold,
                                            margin=margin, impl="jnp"))(*args)
    t = tm.example_polygon_configs(256, k=8, seed=8, device="cpu")
    b = JPolygonConfigs(*(jnp.asarray(a.numpy()) for a in t))
    return t, jax.jit(functools.partial(
        jm.PolygonCollisionProbabilityModel(ROBOT).contact_manifold, impl="jnp"))(b)


@pytest.mark.parametrize("impl", ["torch", "auto"])
@pytest.mark.parametrize("margin", [0.0, 0.1])
def test_rect_model_contact_manifold_vs_jax(impl, margin):
    t, want = jax_model_manifold("rect", margin)
    got = tm.CollisionProbabilityModel().contact_manifold(
        t.position, t.pose_theta, t.obstacle_wh, margin=margin, impl=impl)
    assert_manifolds_agree(got, want, KERNEL_ATOL)
    assert (np.asarray(want[0]) > 0).any()


@pytest.mark.parametrize("impl", ["torch", "auto"])
def test_polygon_model_contact_manifold_vs_jax(impl):
    t, want = jax_model_manifold("kgon")
    got = tm.PolygonCollisionProbabilityModel(ROBOT).contact_manifold(t, impl=impl)
    assert_manifolds_agree(got, want, KERNEL_ATOL)
    assert (np.asarray(want[0]) > 0).any()


def test_cpu_tensors_never_launch_and_grad_raises():
    tmc.reset_launches()
    t = tm.example_configs(64, seed=9, device="cpu")
    model = tm.CollisionProbabilityModel()
    model.contact_manifold(t.position, t.pose_theta, t.obstacle_wh, impl="cuda")
    pc = tm.example_polygon_configs(64, k=6, seed=9, device="cpu")
    tm.PolygonCollisionProbabilityModel(ROBOT).contact_manifold(pc, impl="cuda")
    assert tmc.LAUNCHES == 0
    pos = t.position.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="impl='torch'"):
        model.contact_manifold(pos, t.pose_theta, t.obstacle_wh)
    with pytest.raises(ValueError, match="impl='torch'"):
        tmc.polygon_manifold_cuda(torch.zeros((8, 4, 2), requires_grad=True),
                                  torch.zeros((8, 4, 2)))
    assert model.contact_manifold(pos, t.pose_theta, t.obstacle_wh,
                                  impl="torch")[2].requires_grad


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = tpc.pack_polygons(torch.zeros((4096, 17, 2)))
    b = tpc.pack_polygons(torch.zeros((4096, 4, 2)))
    with pytest.raises(ValueError, match="K1, K2 <= 16"):
        tmc.polygon_manifold_cuda_t(a, b, k1=17, k2=4)
    with pytest.raises(ValueError, match="must be"):
        tmc.polygon_manifold_cuda_t(a, b, k1=16, k2=4)
    with pytest.raises(ValueError, match="float32"):
        tmc.polygon_manifold_cuda_t(b.bfloat16(), b.bfloat16(), k1=4, k2=4)
    with pytest.raises(ValueError, match="impl"):
        tm.PolygonCollisionProbabilityModel(ROBOT).contact_manifold(
            tm.example_polygon_configs(8, k=4, device="cpu"), impl="pallas")
