"""Port geometry + SAT against the JAX package and the SAT.py oracle.

Tolerance: bitwise. Inputs are 4096 seeded rectangle pairs made with
numpy and handed to both packages. `transform_vertices` goes through
cos/sin, whose last bit may differ between XLA's and torch's CPU
libraries, so it is held bitwise on the angles where both libraries round
cos and sin alike (the test prints that share); every SAT comparison takes
JAX's vertices as its input.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import SAT
from collide2d_tpu.ops import geometry as jgeo
from collide2d_tpu.ops import sat as jsat
from collide2d_tpu_torch.ops import geometry as tgeo
from collide2d_tpu_torch.ops import sat as tsat
from tests.conftest import oracle_vertices, random_rect_params

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

N = 4096


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(20261016)
    p1 = random_rect_params(rng, N)
    p2 = random_rect_params(rng, N)
    v1 = np.array(jgeo.rects_from_params(
        jnp.stack([p1[2], p1[3]], -1), jnp.stack([p1[0], p1[1]], -1), p1[4]))
    v2 = np.array(jgeo.rects_from_params(
        jnp.stack([p2[2], p2[3]], -1), jnp.stack([p2[0], p2[1]], -1), p2[4]))
    return p1, p2, v1, v2


def test_rect_vertices_bitwise(pairs):
    p1, _, _, _ = pairs
    want = np.asarray(jgeo.rect_vertices(p1[0], p1[1]))
    got = tgeo.rect_vertices(torch.from_numpy(p1[0]), torch.from_numpy(p1[1]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_transform_and_params_bitwise(pairs):
    # Same formula, same float32 operation order: on the same vertices
    # and angles the results are bitwise equal wherever both libraries
    # round cos/sin alike; the share where they do not is reported.
    p1, _, v1, _ = pairs
    w, h, x, y, t = (torch.from_numpy(a) for a in p1)
    got = tgeo.rects_from_params(torch.stack([x, y], -1), torch.stack([w, h], -1), t)
    agree = (np.asarray(jnp.cos(p1[4])) == torch.cos(t).numpy()) & (
        np.asarray(jnp.sin(p1[4])) == torch.sin(t).numpy())
    print(f"cos/sin agree bitwise on {agree.mean():.2%} of angles")
    assert agree.mean() > 0.85, agree.mean()
    np.testing.assert_array_equal(got.numpy()[agree], v1[agree])


def test_polygon_edges_and_normals_bitwise(pairs):
    _, _, v1, _ = pairs
    np.testing.assert_array_equal(
        tgeo.polygon_edges(torch.from_numpy(v1)).numpy(),
        np.asarray(jgeo.polygon_edges(jnp.asarray(v1))))
    np.testing.assert_array_equal(
        tgeo.edge_normals(torch.from_numpy(v1)).numpy(),
        np.asarray(jgeo.edge_normals(jnp.asarray(v1))))


@pytest.mark.parametrize("fn", ["sat_rects_reference", "sat_rects"])
def test_sat_bitwise_vs_jax(pairs, fn):
    _, _, v1, v2 = pairs
    want = np.asarray(getattr(jsat, fn)(jnp.asarray(v1), jnp.asarray(v2)))
    got = getattr(tsat, fn)(torch.from_numpy(v1), torch.from_numpy(v2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < want.mean() < 0.95  # both labels well represented


def test_project_all_bitwise(pairs):
    _, _, v1, v2 = pairs
    axes = np.concatenate([np.asarray(jgeo.polygon_edges(jnp.asarray(v1))),
                           np.asarray(jgeo.polygon_edges(jnp.asarray(v2)))], -2)
    want = np.asarray(jsat._project_all(jnp.asarray(axes), jnp.asarray(v1)))
    got = tsat._project_all(torch.from_numpy(axes), torch.from_numpy(v1))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sat_reference_vs_oracle():
    # The reference-semantics pair: float32 vertices from SAT.py's own
    # arithmetic, labels from SAT.convex_collide.
    rng = np.random.default_rng(7)
    n = 1024
    v1 = oracle_vertices(*random_rect_params(rng, n))
    v2 = oracle_vertices(*random_rect_params(rng, n))
    want = np.array([SAT.convex_collide(v1[i].ravel(), v2[i].ravel())
                     for i in range(n)])
    got = tsat.sat_rects_reference(torch.from_numpy(v1), torch.from_numpy(v2))
    np.testing.assert_array_equal(got.numpy(), want)


def test_touching_rectangles_collide():
    a = tgeo.rect_vertices(torch.tensor(2.0), torch.tensor(2.0))
    b = a + torch.tensor([2.0, 0.0])
    assert int(tsat.sat_rects_reference(a, b)) == 1
    assert int(tsat.sat_rects(a, b)) == 1


def test_obb_collide_bitwise_vs_jax(pairs):
    p1, p2, _, _ = pairs
    c1 = np.stack([p1[2], p1[3]], -1)
    c2 = np.stack([p2[2], p2[3]], -1)
    e1 = np.stack([p1[0], p1[1]], -1)
    e2 = np.stack([p2[0], p2[1]], -1)
    want = np.asarray(jsat.obb_collide(c1, e1, p1[4], c2, e2, p2[4]))
    got = tsat.obb_collide(*(torch.from_numpy(a) for a in (c1, e1, p1[4], c2, e2, p2[4])))
    # cos/sin may round differently in the last bit between the two CPU
    # libraries; a flipped label needs a pair within an ulp of touching.
    np.testing.assert_array_equal(got.numpy(), want)
