"""The port's k-gon SAT path on the CPU against the JAX package.

Bitwise (labels are integers, every projection is a separately rounded
multiply and add on both sides):

- `ops.sat.sat_polygons` against `collide2d_tpu.ops.sat.sat_polygons`:
  the unrolled branch (k1 + k2 <= 32) and the vectorised one, mixed k,
  touching pairs, padding masks;
- `polygon_aabb`, `candidate_mask`, `collide_polygons_pruned` and the
  `obstacle_verts` branch of `possible_collision_mask`;
- kernel 6's plain version (`ops.polygon_cuda.sat_polygons_cuda_t` on CPU
  tensors) against `sat_polygons_pallas_t(..., interpret=True)`, f32 and
  bf16, on the same packed inputs;
- the models' `collide` / `collide_polygons` against the JAX models.

The CUDA kernel itself cannot run here: tests/test_torch_gpu.py holds it
against this plain version and skips without a card.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from collide2d_tpu.mc.estimator import PolygonConfigs as JPolygonConfigs
from collide2d_tpu.models import collision_model as jm
from collide2d_tpu.ops import broad_phase as jbp
from collide2d_tpu.ops import geometry as jgeo
from collide2d_tpu.ops import polygon_pallas as jpp
from collide2d_tpu.ops import sat as jsat
from collide2d_tpu_torch.mc.estimator import polygon_configs_from_numpy
from collide2d_tpu_torch.models import collision_model as tm
from collide2d_tpu_torch.ops import broad_phase as tbp
from collide2d_tpu_torch.ops import geometry as tgeo
from collide2d_tpu_torch.ops import polygon_cuda as tpc
from collide2d_tpu_torch.ops import sat as tsat

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ROBOT = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87],
                  [-2.035, 0.87]], np.float32)


@pytest.fixture(scope="module")
def model_case():
    b = jm.example_polygon_configs(n=4096, k=6, seed=3)
    return b, polygon_configs_from_numpy(b, "cpu")


def _polygons(rng, n, k, spread=3.0):
    """(n, k, 2) float32 convex k-gons: ellipse points at sorted angles,
    shifted by up to ``spread``."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, k)), axis=-1)
    ab = rng.uniform(0.3, 2.5, (n, 1, 2))
    shift = rng.uniform(-spread, spread, (n, 1, 2))
    return (np.stack([np.cos(ang), np.sin(ang)], -1) * ab + shift).astype(np.float32)


def _touching(n):
    """(n, 4, 2) unit squares and their neighbours sharing an edge or a
    corner exactly: every pair touches, so every pair collides."""
    sq = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    offs = np.array([[1, 0], [0, 1], [1, 1], [-1, 0], [0, -1], [-1, -1]],
                    np.float32)
    base = np.broadcast_to(sq, (n, 4, 2)) * 0.5 + np.arange(n, dtype=np.float32)[
        :, None, None] * 0.25
    return base.astype(np.float32), (base + 0.5 * offs[np.arange(n) % 6][:, None]
                                     ).astype(np.float32)


def _labels_j(p1, p2, m1=None, m2=None):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(jsat.sat_polygons(j(p1), j(p2), j(m1), j(m2)))


def _labels_t(p1, p2, m1=None, m2=None):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return tsat.sat_polygons(t(p1), t(p2), t(m1), t(m2)).numpy()


@pytest.mark.parametrize("k1,k2", [(4, 8), (6, 6), (3, 5), (8, 8), (12, 12),
                                   (16, 16), (20, 16)])
def test_sat_polygons_bitwise_vs_jax(k1, k2):
    # (20, 16) takes the vectorised branch (k1 + k2 > 32)
    rng = np.random.default_rng(k1 * 31 + k2)
    p1, p2 = _polygons(rng, 3000, k1), _polygons(rng, 3000, k2)
    want = _labels_j(p1, p2)
    np.testing.assert_array_equal(_labels_t(p1, p2), want)
    assert 0 < want.mean() < 1


def test_touching_polygons_collide():
    p1, p2 = _touching(60)
    want = _labels_j(p1, p2)
    assert want.all()
    np.testing.assert_array_equal(_labels_t(p1, p2), want)


def test_sat_polygons_masks_bitwise_vs_jax():
    rng = np.random.default_rng(5)
    k = 8
    p1, p2 = _polygons(rng, 2000, k), _polygons(rng, 2000, k)
    m1 = np.arange(k)[None] < rng.integers(3, k + 1, (2000, 1))
    m2 = np.arange(k)[None] < rng.integers(3, k + 1, (2000, 1))
    # garbage in the padded slots: the mask must make it harmless
    p1 = np.where(m1[..., None], p1, 1e3).astype(np.float32)
    p2 = np.where(m2[..., None], p2, -1e3).astype(np.float32)
    want = _labels_j(p1, p2, m1, m2)
    np.testing.assert_array_equal(_labels_t(p1, p2, m1, m2), want)
    np.testing.assert_array_equal(
        tsat._normalize_padding(torch.from_numpy(p1), torch.from_numpy(m1)).numpy(),
        np.asarray(jsat._normalize_padding(jnp.asarray(p1), jnp.asarray(m1))))


@pytest.mark.parametrize("masked", [False, True])
def test_polygon_aabb_bitwise_vs_jax(masked):
    rng = np.random.default_rng(6)
    p = _polygons(rng, 500, 7)
    m = (np.arange(7)[None] < rng.integers(2, 8, (500, 1))) if masked else None
    lo_j, hi_j = jgeo.polygon_aabb(jnp.asarray(p), None if m is None else jnp.asarray(m))
    lo_t, hi_t = tgeo.polygon_aabb(torch.from_numpy(p),
                                   None if m is None else torch.from_numpy(m))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("spread", [3.0, 40.0])
def test_candidate_mask_and_pruned_bitwise_vs_jax(impl, spread):
    # spread 40: sparse candidates, so the compacted path runs (bucket <
    # n/2); spread 3: dense, so the full narrow phase runs
    rng = np.random.default_rng(7)
    n = 8192
    p1, p2 = _polygons(rng, n, 5, spread), _polygons(rng, n, 7, spread)
    cand_j = np.asarray(jbp.candidate_mask(jnp.asarray(p1), jnp.asarray(p2)))
    cand_t = tbp.candidate_mask(torch.from_numpy(p1), torch.from_numpy(p2)).numpy()
    np.testing.assert_array_equal(cand_t, cand_j)
    want = np.asarray(jbp.collide_polygons_pruned(jnp.asarray(p1), jnp.asarray(p2)))
    got = tbp.collide_polygons_pruned(torch.from_numpy(p1), torch.from_numpy(p2),
                                      impl=impl).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, _labels_j(p1, p2))
    assert want.any()
    if spread > 10:
        assert 2 * jbp.bucket_for(int(cand_j.sum()), n) < n  # compaction ran


@pytest.mark.parametrize("sigma", [3.0, 6.0])
def test_possible_collision_mask_polygon_branch_vs_jax(model_case, sigma):
    b = model_case[0]
    b = b._replace(position=b.position * 3.0)  # a mix of kept and pruned rows
    want = np.asarray(jbp.possible_collision_mask(b, jnp.asarray(ROBOT), sigma))
    got = tbp.possible_collision_mask(polygon_configs_from_numpy(b, "cpu"),
                                      ROBOT, sigma).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1


@pytest.mark.parametrize("k1,k2,bf16", [
    (4, 8, False), (4, 8, True), (6, 6, False), (6, 6, True), (3, 5, False),
    (3, 12, False)])
def test_kernel6_plain_bitwise_vs_pallas_interpret(k1, k2, bf16):
    rng = np.random.default_rng(k1 + 10 * k2)
    n = 8 * jpp.LANE_BLOCK
    p1, p2 = _polygons(rng, n, k1), _polygons(rng, n, k2)
    pack_j = jpp.pack_polygons_bf16 if bf16 else jpp.pack_polygons
    a, b = pack_j(jnp.asarray(p1)), pack_j(jnp.asarray(p2))
    want = np.asarray(jpp.sat_polygons_pallas_t(a, b, k1=k1, k2=k2, interpret=True))
    pack_t = tpc.pack_polygons_bf16 if bf16 else tpc.pack_polygons
    a_t, b_t = pack_t(torch.from_numpy(p1)), pack_t(torch.from_numpy(p2))
    # the packers agree bitwise too
    np.testing.assert_array_equal(a_t.float().numpy(), np.asarray(a, np.float32))
    got = tpc.sat_polygons_cuda_t(a_t, b_t, k1=k1, k2=k2)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1


def test_drop_in_pads_any_n_and_matches_jax():
    rng = np.random.default_rng(11)
    for n, k0, precision in ((1, 3, "f32"), (4100, 5, "bf16")):
        p1 = tpc.pad_polygons(torch.from_numpy(_polygons(rng, n, k0)), 8)
        p2 = torch.from_numpy(_polygons(rng, n, 6))
        np.testing.assert_array_equal(
            p1.numpy(), np.asarray(jpp.pad_polygons(jnp.asarray(p1[:, :k0].numpy()), 8)))
        want = np.asarray(jpp.sat_polygons_pallas(
            jnp.asarray(p1.numpy()), jnp.asarray(p2.numpy()),
            interpret=True, precision=precision))
        got = tpc.sat_polygons_cuda(p1, p2, precision=precision)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = tpc.pack_polygons(torch.zeros((4096, 4, 2)))
    b = tpc.pack_polygons(torch.zeros((4096, 6, 2)))
    with pytest.raises(ValueError, match="dtype"):
        tpc.sat_polygons_cuda_t(a.double(), b.double(), k1=4, k2=6)
    with pytest.raises(ValueError, match="must be"):
        tpc.sat_polygons_cuda_t(a, b, k1=4, k2=5)
    with pytest.raises(ValueError, match="multiple of block"):
        tpc.sat_polygons_cuda_t(a[:, :, :100], b[:, :, :100], k1=4, k2=6)
    with pytest.raises(ValueError, match="unsupported device"):
        tpc.sat_polygons_cuda_t(a.to("meta"), b.to("meta"), k1=4, k2=6)
    with pytest.raises(ValueError, match="N % 8"):
        tpc.pack_polygons(torch.zeros((12, 4, 2)))
    with pytest.raises(ValueError, match="precision"):
        tpc.sat_polygons_cuda(torch.zeros((8, 4, 2)), torch.zeros((8, 4, 2)),
                              precision="f16")


def test_cpu_tensors_never_launch():
    tpc.reset_launches()
    rng = np.random.default_rng(12)
    p = torch.from_numpy(_polygons(rng, 100, 5))
    tpc.sat_polygons_cuda(p, p)
    tm.PolygonCollisionProbabilityModel(ROBOT).collide(
        tm.example_polygon_configs(64, k=5, device="cpu"))
    assert tpc.LAUNCHES == 0


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("broad_phase,precision", [
    (False, "f32"), (True, "f32"), ("prune", "f32"), (False, "bf16")])
def test_models_collide_match_jax(model_case, impl, broad_phase, precision):
    b, t = model_case
    jmodel = jm.PolygonCollisionProbabilityModel(ROBOT)
    jrobot = jgeo.transform_vertices(jnp.asarray(ROBOT)[None], b.position[:, 0],
                                     b.position[:, 1], b.pose_theta)
    # collide_polygons on the JAX-placed robot: both sides see the same vertices
    want = np.asarray(jm.CollisionProbabilityModel().collide_polygons(
        jrobot, b.obstacle_verts, broad_phase=broad_phase, precision=precision))
    got = tm.CollisionProbabilityModel().collide_polygons(
        torch.from_numpy(np.asarray(jrobot)), t.obstacle_verts,
        broad_phase=broad_phase, precision=precision, impl=impl)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1
    if precision == "f32":
        # the k-gon model places the robot with torch's cos/sin; the labels
        # are the JAX model's (an ulp could flip only an exactly touching pair)
        got_m = tm.PolygonCollisionProbabilityModel(ROBOT).collide(
            t, broad_phase=broad_phase, impl=impl)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(jmodel.collide(b)))


def test_models_reject_bad_arguments(model_case):
    _, t = model_case
    model = tm.PolygonCollisionProbabilityModel(ROBOT)
    with pytest.raises(ValueError, match="bf16"):
        model.collide(t, broad_phase="prune", precision="bf16")
    with pytest.raises(ValueError, match="precision"):
        model.collide(t, precision="f16")
    with pytest.raises(ValueError, match="impl"):
        model.collide(t, impl="pallas")
    with pytest.raises(ValueError, match="broad_phase"):
        model.collide(t, broad_phase="sweep")


def test_masked_collide_polygons_matches_jax():
    rng = np.random.default_rng(13)
    p1, p2 = _polygons(rng, 3000, 8), _polygons(rng, 3000, 8)
    m1 = np.arange(8)[None] < rng.integers(3, 9, (3000, 1))
    m2 = np.arange(8)[None] < rng.integers(3, 9, (3000, 1))
    for bp in (False, True, "prune"):
        want = np.asarray(jm.CollisionProbabilityModel().collide_polygons(
            jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(m1), jnp.asarray(m2),
            broad_phase=bp))
        got = tm.CollisionProbabilityModel().collide_polygons(
            torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(m1),
            torch.from_numpy(m2), broad_phase=bp)
        np.testing.assert_array_equal(got.numpy(), want)


def test_polygon_configs_type_round_trip(model_case):
    b, t = model_case
    assert isinstance(b, JPolygonConfigs) and t.num == 4096
    assert t.obstacle_verts.shape == (4096, 6, 2) and t.std_dev.shape == (4096, 3)
