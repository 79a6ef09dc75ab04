"""Kernels 6, 9 and 10 above 16 vertices: their plain versions on the CPU
against the JAX package.

On a card the three kernels loop over the true K above 16 vertices, one
library for every K (csrc/polygon_big_k.cuh); the plain versions of kernels
9 and 10 pad a polygon of k > 16 vertices to the next power of two (32, 64,
...; `distance_cuda._padded_columns`), which those loops reproduce bit for
bit, and kernel 6's labels do not depend on the padding. On the same
numpy rows (4-gons against 17-, 20-, 32- and 64-gons, and 32-gons against
32-gons) each plain version is held to the JAX package's jnp function and
to its Pallas kernel run with ``interpret=True``: labels and signs bitwise, distances within 2e-5
(tests/test_torch_distance.py's bar for kernel 9's plain version), manifold
counts equal and points, depths and normals within 2e-5
(tests/test_torch_manifold.py's bar for kernel 10's). The bucket rule of the
CUDA header (compiled with g++) is the wrappers', and the models' routes at
k = 20 equal the JAX models' on the same rows. Kernel 10's cases are in
tests/test_torch_polygon_k_above_16_manifold.py (the Pallas kernels' compiles
in interpret mode take minutes at these K: two files spread them over two
test workers).

The kernels themselves run only on a card: tests/test_torch_gpu.py holds
them to these plain versions there.
"""

import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from collide2d_tpu.models import collision_model as jm
from collide2d_tpu.ops import distance as jd
from collide2d_tpu.ops import distance_pallas as jdp
from collide2d_tpu.ops import geometry as jgeo
from collide2d_tpu.ops import polygon_pallas as jpp
from collide2d_tpu.ops import sat as jsat
from collide2d_tpu_torch.mc.estimator import polygon_configs_from_numpy
from collide2d_tpu_torch.models import collision_model as tm
from collide2d_tpu_torch.ops import distance_cuda as tdc
from collide2d_tpu_torch.ops import manifold_cuda as tmc
from collide2d_tpu_torch.ops import polygon_cuda as tpc
from collide2d_tpu_torch.utils import cuda_build

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

KERNEL_ATOL = 2e-5
SHAPES = [(4, 17), (4, 20), (4, 32), (4, 64), (32, 32)]
N, BLOCK = 4096, 256  # two grid steps of each Pallas kernel (M = 512)
ROBOT = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87],
                  [-2.035, 0.87]], np.float32)


def polygons(rng, n, k, spread=3.0):
    """(n, k, 2) float32 convex CCW k-gons: ellipse points at sorted angles,
    shifted by up to ``spread``."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, k)), axis=-1)
    ab = rng.uniform(0.3, 2.5, (n, 1, 2))
    shift = rng.uniform(-spread, spread, (n, 1, 2))
    return (np.stack([np.cos(ang), np.sin(ang)], -1) * ab + shift).astype(np.float32)


def _rows(k1, k2):
    """The pair batch of a shape: numpy rows, and both packages' packings."""
    rng = np.random.default_rng(1000 * k1 + k2)
    p1, p2 = polygons(rng, N, k1), polygons(rng, N, k2)
    packed_j = (jpp.pack_polygons(jnp.asarray(p1)), jpp.pack_polygons(jnp.asarray(p2)))
    packed_t = (tpc.pack_polygons(torch.from_numpy(p1)), tpc.pack_polygons(torch.from_numpy(p2)))
    return p1, p2, packed_j, packed_t


def jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


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


@pytest.mark.parametrize("k1,k2", SHAPES)
def test_kernel6_plain_vs_jnp_and_pallas(k1, k2):
    p1, p2, (a, b), (a_t, b_t) = _rows(k1, k2)
    got = tpc.sat_polygons_cuda_t(a_t, b_t, k1=k1, k2=k2).numpy()
    want = np.asarray(jpp.sat_polygons_pallas_t(a, b, k1=k1, k2=k2, block=BLOCK,
                                                 interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got.astype(np.int32), np.asarray(jit(jsat.sat_polygons)(jnp.asarray(p1),
                                                                 jnp.asarray(p2))))
    assert 0 < want.mean() < 1


def test_kernel6_bf16_plain_vs_pallas():
    k1, k2 = 4, 20
    p1, p2, _, _ = _rows(k1, k2)
    a = jpp.pack_polygons_bf16(jnp.asarray(p1))
    b = jpp.pack_polygons_bf16(jnp.asarray(p2))
    want = np.asarray(jpp.sat_polygons_pallas_t(a, b, k1=k1, k2=k2, block=BLOCK,
                                                 interpret=True))
    a_t = tpc.pack_polygons_bf16(torch.from_numpy(p1))
    b_t = tpc.pack_polygons_bf16(torch.from_numpy(p2))
    np.testing.assert_array_equal(a_t.float().numpy(), np.asarray(a, np.float32))
    np.testing.assert_array_equal(tpc.sat_polygons_cuda_t(a_t, b_t, k1=k1, k2=k2).numpy(),
                                  want)
    assert 0 < want.mean() < 1


@pytest.mark.parametrize("k1,k2", SHAPES)
def test_kernel9_plain_vs_jnp_and_pallas(k1, k2):
    p1, p2, (a, b), (a_t, b_t) = _rows(k1, k2)
    # the plain version pads each polygon to the kernel's bucket
    assert [tdc._padded_columns(x, k)[0].shape[0] for x, k in ((a_t, k1), (b_t, k2))] == [
        tpc.k_bucket(k1), tpc.k_bucket(k2)]
    got = tdc.polygon_distance_cuda_t(a_t, b_t, k1=k1, k2=k2, block=BLOCK).numpy()
    want = np.asarray(jdp.polygon_distance_pallas_t(a, b, k1=k1, k2=k2, block=BLOCK,
                                                    interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=KERNEL_ATOL)
    np.testing.assert_allclose(
        got, np.asarray(jit(jd.polygon_signed_distance)(jnp.asarray(p1), jnp.asarray(p2))),
        rtol=0, atol=KERNEL_ATOL)
    labels = np.asarray(jit(jsat.sat_polygons)(jnp.asarray(p1), jnp.asarray(p2)))
    np.testing.assert_array_equal((got <= 0).astype(np.int32), labels)
    assert (want > 0).any() and (want < 0).any()


_BUCKET_PROGRAM = r"""
#include <cstdio>
#define __device__
#define __forceinline__ inline
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline float __fsqrt_rn(float a) { return a; }
#include "polygon_soa.cuh"
int main() {
  for (int k = 0; k <= 300; ++k) printf("%d %d\n", k, collide2d::k_bucket(k));
  return 0;
}
"""


@pytest.mark.parametrize("kb1", [0])  # 0: the default build, the one every K takes
def test_header_bucket_rule_is_the_wrappers(tmp_path, kb1):
    # csrc/polygon_soa.cuh's k_bucket (the registers' buckets of the K <= 16
    # bodies, and the padding kernel 9's run-time-K body reproduces) against
    # polygon_cuda.k_bucket
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/polygon_soa.cuh on the host")
    src, exe = tmp_path / "bucket.cc", tmp_path / "bucket"
    src.write_text(_BUCKET_PROGRAM)
    subprocess.run([gxx, "-std=c++17", "-I", str(cuda_build.CSRC_DIR), "-o",
                    str(exe), str(src)], check=True, capture_output=True, timeout=120)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                         timeout=60).stdout.split("\n")[:-1]
    assert len(out) == 301
    for line in out:
        k, bucket = (int(x) for x in line.split())
        if k == 0:
            assert bucket == 0
            continue
        assert bucket == tpc.k_bucket(k), k
    assert [tpc.k_bucket(k) for k in (1, 5, 16, 17, 33, 65, 129)] == [
        4, 8, 16, 32, 64, 128, 256]
    with pytest.raises(ValueError, match="at least one vertex"):
        tpc.k_bucket(0)


@pytest.fixture(scope="module")
def k20_case():
    b = jm.example_polygon_configs(n=2048, k=20, seed=3)
    return b, polygon_configs_from_numpy(b, "cpu")


def test_models_at_k20_match_jax(k20_case):
    b, t = k20_case
    jmodel = jm.PolygonCollisionProbabilityModel(ROBOT)
    model = tm.PolygonCollisionProbabilityModel(ROBOT)
    # the k-gon model places the robot with torch's cos/sin (an ulp from
    # XLA's): labels equal, values within the kernels' bar
    want = np.asarray(jmodel.collide(b))
    np.testing.assert_array_equal(model.collide(t).numpy(), want)
    assert 0 < want.mean() < 1
    jrobot = np.asarray(jgeo.transform_vertices(jnp.asarray(ROBOT)[None], b.position[:, 0],
                                                b.position[:, 1], b.pose_theta))
    np.testing.assert_array_equal(
        tm.CollisionProbabilityModel().collide_polygons(
            torch.from_numpy(jrobot), t.obstacle_verts).numpy(),
        np.asarray(jm.CollisionProbabilityModel().collide_polygons(jrobot,
                                                                   b.obstacle_verts)))
    got_d = model.distance(t, impl="auto").numpy()
    np.testing.assert_allclose(got_d, np.asarray(jmodel.distance(b)), rtol=0,
                               atol=KERNEL_ATOL)
    np.testing.assert_array_equal((got_d <= 0).astype(np.int32), want)
    assert_manifolds_agree(model.contact_manifold(t), jmodel.contact_manifold(b),
                           KERNEL_ATOL)
