"""The port's ray casting on the CPU against the JAX package.

Bars:

- `polygon_raycast`, `rect_raycast` and ``scene_raycast(impl='torch')``
  against JAX's ``jnp`` path: the same formulas in the same order, so
  bitwise is expected; the bar is 1e-6 (torch's cos/sin place a box's
  vertices an ulp from JAX's).
- Kernel 11's plain version (`ops.raycast_cuda.scene_raycast_plain`, unit
  normal tables) against a float32 NumPy evaluation of the same formulas,
  every product and sum rounded on its own: bitwise.
- The same plain version against JAX's Pallas kernel in interpret mode, on
  tests/test_raycast.py:172-221's 67-ray x 11-shape masked scene: hit/miss
  equal, indices equal away from razor ties, normals within 1e-6 and t
  within 1e-5. XLA:CPU fuses the interpret run's multiply-adds, and the
  cancellation in ``num = off - no`` then moves t by up to ~15 ulps
  (1.8e-6 at t ~ 2 on this scene); the separately rounded plain version is
  the NumPy evaluation's bit for bit.
- The plain version against JAX's ``jnp`` path (unnormalised normals): the
  JAX test's bar, hit/miss and indices away from ties, t and normal 1e-5.

The CUDA kernel itself cannot run here: tests/test_torch_gpu.py holds it
against this plain version and skips without a card.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from collide2d_tpu.ops import raycast as jr
from collide2d_tpu.ops.raycast_pallas import scene_raycast_pallas
from collide2d_tpu_torch.ops import raycast as tr
from collide2d_tpu_torch.ops import raycast_cuda as trc
from tests.test_sat import _regular_polygon

torch.set_num_threads(1)

ATOL = 1e-6
KERNEL_ATOL = 1e-5


def _sq(cx, cy, half):
    return np.array([[cx - half, cy - half], [cx + half, cy - half],
                     [cx + half, cy + half], [cx - half, cy + half]], np.float32)


def _t(*a):
    return [torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32))) for x in a]


def _both_polygon(o, d, poly, mask=None, t_max=np.inf):
    """(port, JAX) `polygon_raycast` as numpy (t, normal) pairs."""
    got = tr.polygon_raycast(*_t(o, d, poly),
                             None if mask is None else torch.from_numpy(mask), t_max=t_max)
    want = jr.polygon_raycast(jnp.asarray(o), jnp.asarray(d), jnp.asarray(poly),
                              None if mask is None else jnp.asarray(mask), t_max=t_max)
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


def _assert_same(got, want, atol=ATOL):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(np.isinf(g), np.isinf(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=atol)


def test_closed_forms_vs_jax():
    sq = _sq(5.0, 0.0, 1.0)  # x in [4, 6], y in [-1, 1]
    cases = [  # (origin, direction, t_max, expected t, expected normal)
        ([0, 0], [1, 0], np.inf, 4.0, [-1, 0]),
        ([0, 0], [2, 0], np.inf, 2.0, [-1, 0]),  # t in units of |direction|
        ([0, 2], [1, 0], np.inf, np.inf, [0, 0]),  # miss above
        ([0, 5], [1, 0], np.inf, np.inf, [0, 0]),  # parallel, miss side
        ([0, 0], [1, 0], 3.0, np.inf, [0, 0]),  # t_max cuts the hit
        ([0, 0], [-1, 0], np.inf, np.inf, [0, 0]),  # pointing away
        ([5, 0], [1, 0], np.inf, 0.0, [0, 0]),  # inside: t = 0, zero normal
        ([6, 0], [-1, 0], np.inf, 0.0, [1, 0]),  # boundary start: the face normal
    ]
    for o, d, t_max, t_want, n_want in cases:
        got, want = _both_polygon(np.float32(o), np.float32(d), sq, t_max=t_max)
        _assert_same(got, want)
        np.testing.assert_allclose(got[0], t_want, atol=1e-6)
        np.testing.assert_allclose(got[1], n_want, atol=1e-6)


def test_random_polygons_vs_jax_batched():
    rng = np.random.default_rng(20260821)
    n = 512
    k = 8
    polys = np.stack([np.concatenate([p, np.repeat(p[-1:], k - len(p), 0)]) for p in (
        _regular_polygon(int(rng.integers(3, 9)), rng.uniform(0.5, 2.0),
                         rng.uniform(-2, 2), rng.uniform(-2, 2), rng.uniform(0, 7))
        for _ in range(n))])
    o = rng.uniform(-8, 8, (n, 2)).astype(np.float32)
    d = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    got, want = _both_polygon(o, d, polys)
    _assert_same(got, want)
    t, nrm = got
    hit = np.isfinite(t) & (t > 0)
    assert hit.sum() >= 20
    np.testing.assert_allclose(np.linalg.norm(nrm[hit], axis=-1), 1.0, atol=1e-5)
    assert (np.einsum("ij,ij->i", nrm[hit], d[hit]) <= 1e-6).all()  # entering


def test_padding_mask_and_degenerate_vs_jax():
    poly = _regular_polygon(5, 1.0, 0.0, 0.0, 0.4)
    pad = np.concatenate([poly, np.repeat(poly[-1:], 3, 0)])
    arb = np.concatenate([poly, np.full((3, 2), 9.0, np.float32)])
    mask = np.array([True] * 5 + [False] * 3)
    o, d = np.float32([-4.0, 0.1]), np.float32([1.0, 0.0])
    base, _ = _both_polygon(o, d, poly)
    for p, m in ((pad, None), (arb, mask)):
        got, want = _both_polygon(o, d, p, m)
        _assert_same(got, want)
        _assert_same(got, base)
    pt = np.tile(np.float32([[0.0, 0.1]]), (4, 1))  # a point: never hit
    got, want = _both_polygon(o, d, pt)
    _assert_same(got, want)
    assert np.isinf(got[0])


def test_rect_raycast_vs_jax():
    rng = np.random.default_rng(5)
    n = 256
    f = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)  # noqa: E731
    o, c, e, th = f(-6, 6, n, 2), f(-2, 2, n, 2), f(-3, 3, n, 2), f(0, 7, n)
    d = (c - o + f(-1, 1, n, 2)).astype(np.float32)  # most rays aim at their box
    got = [x.numpy() for x in tr.rect_raycast(*_t(o, d, c, e, th))]
    want = [np.asarray(x) for x in jr.rect_raycast(o, d, c, e, th)]
    _assert_same(got, want)
    assert np.isfinite(got[0]).sum() >= 100


def _scene(rng, n=11, k=7):
    polys = np.stack([_regular_polygon(k, rng.uniform(0.3, 1.2), rng.uniform(-6, 6),
                                       rng.uniform(-6, 6), rng.uniform(0, 7))
                      for _ in range(n)]).astype(np.float32)
    mask = np.ones((n, k), bool)
    mask[0, 5:] = False  # two shapes cut to pentagons through the mask
    mask[1, 6:] = False
    return polys, mask


def test_scene_raycast_torch_vs_jnp_single_and_batched():
    rng = np.random.default_rng(7)
    polys, mask = _scene(rng)
    o = rng.uniform(-8, 8, (3, 67, 2)).astype(np.float32)  # a rank-2 ray batch
    d = rng.uniform(-1, 1, (3, 67, 2)).astype(np.float32)
    for t_max in (np.inf, 4.0):
        got = [x.numpy() for x in tr.scene_raycast(*_t(o, d, polys), torch.from_numpy(mask),
                                                   t_max=t_max, impl="torch")]
        want = [np.asarray(x) for x in jr.scene_raycast(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(polys), jnp.asarray(mask), t_max=t_max)]
        assert got[1].dtype == np.int32 and got[1].shape == (3, 67)
        np.testing.assert_array_equal(got[1], want[1])
        _assert_same([got[0], got[2]], [want[0], want[2]])
    got = [x.numpy() for x in tr.scene_raycast(*_t([0, 0], [1, 0], polys), impl="torch")]
    want = [np.asarray(x) for x in jr.scene_raycast(
        jnp.asarray([0.0, 0.0]), jnp.asarray([1.0, 0.0]), jnp.asarray(polys))]
    assert got[0].shape == () and got[2].shape == (2,)
    np.testing.assert_array_equal(got[1], want[1])
    _assert_same([got[0], got[2]], [want[0], want[2]])


def _numpy_kernel11(o, d, table, t_max):
    """Kernel 11 in float32 NumPy, every product and sum rounded on its own:
    (t, index, normal)."""
    f = np.float32
    nx, ny, off = (table[None, :, :, c] for c in range(3))  # (1, N, KP)
    ox, oy, dx, dy = (a[:, None, None] for a in (o[:, 0], o[:, 1], d[:, 0], d[:, 1]))
    no = (nx * ox).astype(f) + (ny * oy).astype(f)
    nd = (nx * dx).astype(f) + (ny * dy).astype(f)
    num = off - no
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = num / np.where(nd == 0, f(1), nd)
    pm = (nd == 0) & (num < 0)
    lo = np.where(nd < 0, ratio, np.where(pm, f(np.inf), f(-np.inf)))
    hi = np.where(nd > 0, ratio, np.where(pm, f(-np.inf), f(np.inf)))
    entry, exit_ = lo.max(-1), hi.min(-1)
    ia = lo.argmax(-1)  # the first face at the maximum
    hit = (entry <= exit_) & (entry <= f(t_max)) & (exit_ >= 0) & (table[None, :, 0, 3] > 0)
    keep = hit & ~(entry < 0)
    t_all = np.where(hit, np.maximum(entry, f(0)), f(np.inf))
    idx = t_all.argmin(-1)
    rows = np.arange(len(o))
    face = ia[rows, idx]
    nrm = table[idx, face, :2] * keep[rows, idx][:, None]
    return t_all[rows, idx], idx.astype(np.int32), nrm


def test_plain_vs_numpy_pallas_interpret_and_jnp():
    rng = np.random.default_rng(20260821)
    polys, mask = _scene(rng)
    r = 67
    o = rng.uniform(-8, 8, (r, 2)).astype(np.float32)
    d = rng.uniform(-1, 1, (r, 2)).astype(np.float32)
    table = trc.pack_scene_tables(torch.from_numpy(polys), torch.from_numpy(mask))
    assert table.shape == (11, 8, 4)
    for t_max in (np.inf, 4.0):
        got = [x.numpy() for x in trc.scene_raycast_plain(*_t(o, d), table, t_max=t_max)]
        ref = _numpy_kernel11(o, d, table.numpy(), t_max)
        for g, w in zip(got, ref):
            np.testing.assert_array_equal(g, w)
        pallas = [np.asarray(x) for x in scene_raycast_pallas(
            o, d, polys, jnp.asarray(mask), t_max=t_max, block=16, interpret=True)]
        jnp_path = [np.asarray(x) for x in jr.scene_raycast(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(polys), jnp.asarray(mask),
            t_max=t_max)]
        # razor ties: rays whose two nearest per-shape hits lie within 1e-4
        ts_all = np.asarray(jr.polygon_raycast(
            jnp.asarray(o)[:, None], jnp.asarray(d)[:, None], jnp.asarray(polys),
            jnp.asarray(mask), t_max=t_max)[0])
        two = np.sort(ts_all, axis=1)[:, :2]
        hit = np.isfinite(two[:, 0])
        with np.errstate(invalid="ignore"):
            clear = hit & (np.isinf(two[:, 1]) | (two[:, 1] - two[:, 0] > 1e-4))
        assert clear.any() and (~hit).any()
        for want, n_atol in ((pallas, ATOL), (jnp_path, KERNEL_ATOL)):
            assert np.array_equal(np.isinf(got[0]), np.isinf(want[0]))
            np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=0, atol=KERNEL_ATOL)
            np.testing.assert_array_equal(got[1][clear], want[1][clear])
            np.testing.assert_allclose(got[2][clear], want[2][clear], rtol=0, atol=n_atol)
        np.testing.assert_array_equal(got[1][~hit], 0)


def test_plain_conventions():
    # inside start (t = 0, zero normal), a miss (+inf, index 0, zero
    # normal), a point shape never hit, the first of tied duplicates
    sq = _sq(4.0, 0.0, 1.0)
    pt = np.tile(np.float32([[9.0, 9.0]]), (4, 1))
    scene = np.stack([pt, sq, sq])
    o = np.float32([[0, 0], [4, 0], [0, -9]])
    d = np.float32([[1, 0], [1, 0], [1, 0]])
    table = trc.pack_scene_tables(torch.from_numpy(scene))
    for t, idx, nrm in (trc.scene_raycast_plain(*_t(o, d), table),
                        tr.scene_raycast(*_t(o, d, scene), impl="auto")):
        t, idx, nrm = t.numpy(), idx.numpy(), nrm.numpy()
        np.testing.assert_allclose(t[0], 3.0, atol=1e-6)
        assert idx[0] == 1
        np.testing.assert_allclose(nrm[0], [-1.0, 0.0], atol=1e-6)
        assert t[1] == 0.0 and np.all(nrm[1] == 0.0)
        assert np.isinf(t[2]) and idx[2] == 0 and np.all(nrm[2] == 0.0)


def test_plain_chunks_are_bitwise():
    rng = np.random.default_rng(3)
    polys, mask = _scene(rng, n=13, k=6)
    o = rng.uniform(-8, 8, (101, 2)).astype(np.float32)
    d = rng.normal(size=(101, 2)).astype(np.float32)
    table = trc.pack_scene_tables(torch.from_numpy(polys), torch.from_numpy(mask))
    runs = [trc.scene_raycast_plain(*_t(o, d), table, t_max=5.0, chunk=c) for c in (1, 7, 101)]
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(a, b)
    assert torch.isfinite(runs[0][0]).any()


def test_auto_routes_to_the_plain_version_on_cpu():
    rng = np.random.default_rng(9)
    polys, mask = _scene(rng)
    o = rng.uniform(-8, 8, (2, 5, 2)).astype(np.float32)
    d = rng.uniform(-1, 1, (2, 5, 2)).astype(np.float32)
    trc.reset_launches()
    t, idx, nrm = tr.scene_raycast(*_t(o, d, polys), torch.from_numpy(mask), t_max=4.0)
    assert trc.LAUNCHES == 0
    assert t.shape == (2, 5) and idx.dtype == torch.int32 and nrm.shape == (2, 5, 2)
    table = trc.pack_scene_tables(torch.from_numpy(polys), torch.from_numpy(mask))
    want = trc.scene_raycast_plain(*_t(o.reshape(-1, 2), d.reshape(-1, 2)), table, t_max=4.0)
    assert torch.equal(t.reshape(-1), want[0]) and torch.equal(idx.reshape(-1), want[1])
    one = tr.scene_raycast(*_t(o[0, 0], d[0, 0], polys), torch.from_numpy(mask), t_max=4.0)
    assert one[0].shape == () and one[0] == t[0, 0] and one[1] == idx[0, 0]


def test_grad_and_what_the_kernel_does_not_take():
    rng = np.random.default_rng(10)
    polys, _ = _scene(rng, n=4, k=5)
    o = torch.zeros((3, 2), requires_grad=True)
    d = torch.ones((3, 2))
    with pytest.raises(ValueError, match="impl='torch'"):
        tr.scene_raycast(o, d, torch.from_numpy(polys))
    t, _, _ = tr.scene_raycast(o, d, torch.from_numpy(polys), impl="torch")
    assert t.requires_grad
    with pytest.raises(ValueError, match="impl"):
        tr.scene_raycast(d, d, torch.from_numpy(polys), impl="pallas")
    table = trc.pack_scene_tables(torch.from_numpy(polys))
    with pytest.raises(ValueError, match="float32"):
        trc.scene_raycast_cuda_t(d.double(), d.double(), table)
    with pytest.raises(ValueError, match="contiguous"):
        trc.scene_raycast_cuda_t(torch.ones((2, 3))[:, :2], d[:2], table)
    with pytest.raises(ValueError, match="multiple of 4"):
        trc.scene_raycast_cuda_t(d, d, table[:, :3].contiguous())
    with pytest.raises(ValueError, match="one scene"):
        tr.scene_raycast(d, d, torch.from_numpy(polys)[None])


def test_inputs_follow_the_torch_tensors_device():
    # Numpy or Python inputs go to the device of the torch tensors among the
    # inputs, and torch tensors on two devices raise: nothing is moved
    # between devices behind the caller's back. The "meta" device stands in
    # for a card here.
    rng = np.random.default_rng(11)
    polys, mask = _scene(rng, n=4, k=5)
    o = torch.zeros((3, 2), device="meta")
    d = torch.ones((3, 2), device="meta")
    t, idx, nrm = tr.scene_raycast(o, d, polys, mask, impl="torch")
    assert t.device.type == idx.device.type == nrm.device.type == "meta"
    assert t.shape == (3,) and nrm.shape == (3, 2)
    t, nrm = tr.polygon_raycast(o, d, polys[:3], mask[:3])
    assert t.device.type == "meta" and t.shape == (3,)
    t, nrm = tr.rect_raycast(o, d, np.zeros((3, 2), np.float32), [[2.0, 1.0]] * 3, 0.3)
    assert t.device.type == "meta"
    # the kernel's wrapper takes CPU and CUDA tensors only: no silent route
    with pytest.raises(ValueError, match="unsupported device"):
        tr.scene_raycast(o, d, polys, mask)
    on_host = torch.from_numpy(polys)
    with pytest.raises(ValueError, match="more than one device"):
        tr.scene_raycast(o, d, on_host)
    with pytest.raises(ValueError, match="more than one device"):
        tr.scene_raycast(o, d, on_host, impl="torch")
    with pytest.raises(ValueError, match="more than one device"):
        tr.scene_raycast(o, d, polys, torch.from_numpy(mask))
    with pytest.raises(ValueError, match="more than one device"):
        tr.polygon_raycast(o, torch.ones((3, 2)), polys[:3])
    with pytest.raises(ValueError, match="more than one device"):
        tr.rect_raycast(o, d, torch.zeros((3, 2)), [[2.0, 1.0]] * 3, 0.3)
    # numpy rays against a CPU scene: the CPU, as before
    t, idx, _ = tr.scene_raycast(np.zeros((3, 2), np.float32), np.ones((3, 2), np.float32),
                                 on_host)
    assert t.device.type == "cpu"
