"""The port's scene queries on the CPU against the JAX package.

On `tests/test_scene.py`'s random scenes (mixed k up to 8, repeat-last
padded) the collision matrix, the dense pair list and the swept pair list
with its certificate are bitwise the JAX package's: both run the same SAT
(`ops.sat.sat_polygons` here, jnp `sat_polygons` there), and the pair
extraction keeps JAX's row-major prefix and slot order. The manifolds:
counts equal; points, depths and normals on the valid rows within 1e-5 of
JAX's `scene_contact_manifolds`, tests/test_torch_manifold.py's allowance
for `ops.manifold` against the ``jnp`` path (the same formulas; XLA and
torch may round a division or a multiply-add apart). The swept scene's
coordinates reach 30, where an ulp is 1.9e-6, and a depth (a difference of
two such projections) differs by up to 3.8e-6 there.

On CUDA tensors the same functions run kernels 6 and 10:
tests/test_torch_gpu.py holds them against these CPU results.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from collide2d_tpu.ops import scene as js
from collide2d_tpu_torch.ops import manifold_cuda, polygon_cuda
from collide2d_tpu_torch.ops import scene as ts
from tests.test_scene import _random_scene

torch.set_num_threads(1)

ATOL = 1e-5


def _scene(seed, **kw):
    return np.array(_random_scene(np.random.default_rng(seed), **kw))


def _np(xs):
    return [np.asarray(x) for x in xs]


def _assert_equal(got, want):
    for g, w in zip(_np(got), _np(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_matrix_bitwise_jax():
    p = _scene(1)
    got = ts.scene_collision_matrix(torch.from_numpy(p)).numpy()
    want = np.asarray(js.scene_collision_matrix(jnp.asarray(p)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == bool and (got == got.T).all() and not got.diagonal().any()
    assert got.any()


@pytest.mark.parametrize("tile", [1, 5, 16, 37, 200])
def test_row_tile_invariance(tile):
    p = torch.from_numpy(_scene(2, n=37))
    base = ts.scene_collision_matrix(p, row_tile=64)
    assert torch.equal(base, ts.scene_collision_matrix(p, row_tile=tile))
    want = _np(js.scene_colliding_pairs(jnp.asarray(p.numpy()), capacity=128,
                                        row_tile=tile))
    _assert_equal(ts.scene_colliding_pairs(p, capacity=128, row_tile=tile), want)


@pytest.mark.parametrize("n,tile", [(48, 64), (203, 8), (203, 64)])
def test_pairs_bitwise_jax(n, tile):
    p = _scene(3, n=n, spread=10.0 if n > 100 else 6.0)
    got = ts.scene_colliding_pairs(torch.from_numpy(p), capacity=1024, row_tile=tile)
    want = js.scene_colliding_pairs(jnp.asarray(p), capacity=1024, row_tile=tile)
    _assert_equal(got, want)
    m = np.asarray(js.scene_collision_matrix(jnp.asarray(p)))
    pairs, count, overflow = _np(got)
    assert not overflow and count == np.triu(m, 1).sum() >= 3
    np.testing.assert_array_equal(pairs[:count], np.argwhere(np.triu(m, 1)))


def test_pair_overflow_contract():
    p = _scene(4)
    total = int(np.asarray(js.scene_colliding_pairs(jnp.asarray(p), capacity=512)[1]))
    cap = total - 1
    got = ts.scene_colliding_pairs(torch.from_numpy(p), capacity=cap)
    _assert_equal(got, js.scene_colliding_pairs(jnp.asarray(p), capacity=cap))
    assert bool(got[2]) and int(got[1]) == cap


def test_touching_squares_and_mask_padding():
    sq = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    scene = np.stack([np.concatenate([s, s[-1:]]) for s in (sq, sq + [1.0, 0.0],
                                                             sq + [5.0, 5.0])])
    m = ts.scene_collision_matrix(torch.from_numpy(scene)).numpy()
    assert m[0, 1] and m[1, 0] and not m[0, 2] and not m[1, 2]
    arb = scene.copy()
    arb[:, -1] = 99.0  # a garbage padding slot, masked out
    mask = np.array([[True] * 4 + [False]] * 3)
    got = ts.scene_collision_matrix(torch.from_numpy(arb), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, m)
    np.testing.assert_array_equal(got, np.asarray(js.scene_collision_matrix(
        jnp.asarray(arb), jnp.asarray(mask))))


@pytest.mark.parametrize("n,spread,cap,window", [
    (60, 6.0, 256, 59),  # the full window: equals the dense query
    (250, 30.0, 512, 32),  # a sparse scene certifies a small window
    (40, 0.5, 1024, 8),  # a dense cluster raises the certificate
    (60, 6.0, 20, 59),  # capacity overflow: a sorted subset
])
def test_swept_bitwise_jax(n, spread, cap, window):
    p = _scene(5, n=n, spread=spread)
    got = ts.scene_colliding_pairs_swept(torch.from_numpy(p), capacity=cap, window=window)
    want = js.scene_colliding_pairs_swept(jnp.asarray(p), capacity=cap, window=window)
    _assert_equal(got, want)
    pairs, count, overflow, exceeded = _np(got)
    dense = _np(ts.scene_colliding_pairs(torch.from_numpy(p), capacity=4096))
    if not exceeded and not overflow:  # certified: the dense query's pairs
        np.testing.assert_array_equal(pairs, dense[0][:cap])
        assert count == dense[1]
    m = ts.scene_collision_matrix(torch.from_numpy(p)).numpy()
    for i, j in pairs[:count]:
        assert i < j and m[i, j]
    assert exceeded == (n == 40) and overflow == (cap == 20)


def test_swept_mask_padding():
    sq = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    scene = np.stack([np.concatenate([s, s[-1:]]) for s in (sq, sq + [0.5, 0.5],
                                                             sq + [9.0, 9.0])])
    scene[:, -1] = 77.0  # garbage padding, masked out
    mask = np.array([[True] * 4 + [False]] * 3)
    got = ts.scene_colliding_pairs_swept(torch.from_numpy(scene), torch.from_numpy(mask),
                                         capacity=8, window=2)
    _assert_equal(got, js.scene_colliding_pairs_swept(jnp.asarray(scene), jnp.asarray(mask),
                                                      capacity=8, window=2))
    assert int(got[1]) == 1 and got[0][0].tolist() == [0, 1]


@pytest.mark.parametrize("broad_phase,n,spread,window", [
    ("dense", 48, 6.0, 64), ("swept", 250, 30.0, 32)])
def test_manifolds_vs_jax(broad_phase, n, spread, window):
    p = _scene(6, n=n, spread=spread)
    got = _np(ts.scene_contact_manifolds(torch.from_numpy(p), capacity=512,
                                         broad_phase=broad_phase, window=window))
    want = _np(js.scene_contact_manifolds(jnp.asarray(p), capacity=512,
                                          broad_phase=broad_phase, window=window))
    pairs, count, n_c, points, depths, normals, exceeded = got
    np.testing.assert_array_equal(pairs, want[0])
    assert count == want[1] >= 1 and not exceeded and not want[6]
    v = slice(0, int(count))
    np.testing.assert_array_equal(n_c, want[2])
    assert (n_c[v] >= 1).all()  # every listed pair genuinely touches
    valid = np.arange(2)[None] < n_c[v, None]
    np.testing.assert_allclose(points[v][valid], want[3][v][valid], rtol=0, atol=ATOL)
    np.testing.assert_allclose(depths[v][valid], want[4][v][valid], rtol=0, atol=ATOL)
    np.testing.assert_allclose(normals[v], want[5][v], rtol=0, atol=ATOL)
    assert points.shape == (512, 2, 2) and n_c.dtype == np.int32


def test_swept_manifolds_fail_closed_and_bad_broad_phase():
    cluster = _scene(7, n=40, spread=0.5)
    got = ts.scene_contact_manifolds(torch.from_numpy(cluster), capacity=1024,
                                     broad_phase="swept", window=4)
    want = js.scene_contact_manifolds(jnp.asarray(cluster), capacity=1024,
                                      broad_phase="swept", window=4)
    assert int(got[1]) == 0 and bool(got[6]) and not got[0].any()
    _assert_equal([got[0], got[1], got[6]], [want[0], want[1], want[6]])
    with pytest.raises(ValueError, match="broad_phase"):
        ts.scene_contact_manifolds(torch.from_numpy(cluster), capacity=8,
                                   broad_phase="grid")


def test_cpu_tensors_never_launch_the_kernels():
    polygon_cuda.reset_launches()
    manifold_cuda.reset_launches()
    p = torch.from_numpy(_scene(8, n=24))
    ts.scene_collision_matrix(p)
    ts.scene_colliding_pairs_swept(p, capacity=64, window=8)
    ts.scene_contact_manifolds(p, capacity=64)
    assert polygon_cuda.LAUNCHES == 0 and manifold_cuda.LAUNCHES == 0


def test_exports_match_the_jax_package():
    import collide2d_tpu
    import collide2d_tpu_torch

    learned = set(collide2d_tpu._LEARNED_EXPORTS)
    assert learned == {"LearnedCollisionModel", "TrainConfig", "train_model", "featurize"}
    missing = (set(collide2d_tpu.__all__) | learned) - set(collide2d_tpu_torch.__all__)
    assert not missing, sorted(missing)
    for name in collide2d_tpu_torch.__all__:
        assert callable(getattr(collide2d_tpu_torch, name)), name


@pytest.fixture
def card_route(monkeypatch):
    """Run the CUDA tensors' route (kernels 6 and 10 through their
    wrappers, which take their plain versions on CPU tensors) on the CPU."""
    monkeypatch.setattr(ts, "_on_card", lambda p: True)


def test_card_route_matches_jax(card_route):
    p = _scene(9, n=53)  # 53 * 53 pairs: not a multiple of kernel 6's 4,096
    tp = torch.from_numpy(p)
    want_m = np.asarray(js.scene_collision_matrix(jnp.asarray(p)))
    for tile in (7, 64):
        np.testing.assert_array_equal(ts.scene_collision_matrix(tp, row_tile=tile).numpy(),
                                      want_m)
        _assert_equal(ts.scene_colliding_pairs(tp, capacity=256, row_tile=tile),
                      js.scene_colliding_pairs(jnp.asarray(p), capacity=256, row_tile=tile))
    for cap, window in ((256, 52), (10, 52), (256, 5)):
        _assert_equal(ts.scene_colliding_pairs_swept(tp, capacity=cap, window=window),
                      js.scene_colliding_pairs_swept(jnp.asarray(p), capacity=cap,
                                                     window=window))
    # k above 16: kernel 6 pads to the K = 32 bucket. JAX's dense queries
    # stack both polygons' edge normals on a broadcast tile, which its jnp
    # `sat_polygons` refuses at k1 + k2 > 32, so the matrix and the dense
    # list are held to JAX's `sat_polygons` on every pair (tests/test_scene.py's
    # oracle) and the swept list to JAX's
    from collide2d_tpu.ops.sat import sat_polygons as j_sat_polygons
    from tests.test_scene import _random_scene as j_random_scene

    for kmax, n in ((17, 40), (20, 33)):
        p = np.array(j_random_scene(np.random.default_rng(kmax), n=n, spread=4.0,
                                    kmax=kmax))
        tp = torch.from_numpy(p)
        i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        want_m = np.array(j_sat_polygons(jnp.asarray(p[i.reshape(-1)]),
                                         jnp.asarray(p[j.reshape(-1)]))).reshape(n, n) == 1
        np.fill_diagonal(want_m, False)
        got_m = ts.scene_collision_matrix(tp, row_tile=7).numpy()
        np.testing.assert_array_equal(got_m, want_m)
        assert 0 < got_m.sum() < n * (n - 1)
        pairs, count, overflow = ts.scene_colliding_pairs(tp, capacity=1024, row_tile=7)
        want_pairs = np.argwhere(np.triu(want_m))
        assert int(count) == len(want_pairs) and not bool(overflow)
        np.testing.assert_array_equal(pairs[: int(count)].numpy(), want_pairs)
        _assert_equal(ts.scene_colliding_pairs_swept(tp, capacity=1024, window=n - 1),
                      js.scene_colliding_pairs_swept(jnp.asarray(p), capacity=1024,
                                                     window=n - 1))


def test_card_route_manifolds_match_jax(card_route):
    # kernel 10's plain version: tests/test_torch_manifold.py's kernel bar
    p = _scene(6, n=48)
    got = _np(ts.scene_contact_manifolds(torch.from_numpy(p), capacity=256))
    want = _np(js.scene_contact_manifolds(jnp.asarray(p), capacity=256))
    np.testing.assert_array_equal(got[0], want[0])
    c = int(got[1])
    assert c == want[1] >= 3
    np.testing.assert_array_equal(got[2][:c], want[2][:c])
    valid = np.arange(2)[None] < got[2][:c, None]
    for i, atol in ((3, 2e-5), (4, 2e-5)):
        np.testing.assert_allclose(got[i][:c][valid], want[i][:c][valid], rtol=0, atol=atol)
    np.testing.assert_allclose(got[5][:c], want[5][:c], rtol=0, atol=2e-5)
    # k = 20 (kernel 10 at the K = 32 bucket) after the swept broad phase,
    # which JAX runs at any k
    from tests.test_scene import _random_scene as j_random_scene

    p = np.array(j_random_scene(np.random.default_rng(20), n=33, spread=4.0, kmax=20))
    kw = dict(capacity=512, broad_phase="swept", window=32)
    got = _np(ts.scene_contact_manifolds(torch.from_numpy(p), **kw))
    want = _np(js.scene_contact_manifolds(jnp.asarray(p), **kw))
    np.testing.assert_array_equal(got[0], want[0])
    c = int(got[1])
    assert c == want[1] >= 3 and not bool(got[6])
    np.testing.assert_array_equal(got[2][:c], want[2][:c])
    valid = np.arange(2)[None] < got[2][:c, None]
    for i in (3, 4):
        np.testing.assert_allclose(got[i][:c][valid], want[i][:c][valid], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got[5][:c], want[5][:c], rtol=0, atol=2e-5)
