"""The SAT kernels' packers and plain versions against the JAX Pallas kernels.

The four ``*_cuda_t`` functions run their plain versions on CPU tensors;
they are held against ``sat_pallas``'s kernels run in interpret mode at
``block=128``, as tests/test_pallas.py runs them. Tolerance: labels
bitwise, counts exact. Inputs are made with numpy (or JAX's own random
pairs, as tests/test_pallas.py uses) and the port gets JAX's packed rows
as numpy, so the comparison holds the test itself and not two cos/sin
libraries.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from collide2d_tpu.ops import sat as jsat
from collide2d_tpu.ops import sat_pallas as jsp
from collide2d_tpu.utils.benchmarks import _random_pairs
from collide2d_tpu_torch.ops import sat_cuda as tsc

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

BLOCK = 128
N = 8 * 4 * BLOCK


def _t(a) -> torch.Tensor:
    """A JAX or numpy array as a torch tensor of the same dtype (bfloat16
    through float32, which holds every bfloat16 value exactly)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pairs():
    r1, r2 = _random_pairs(N, seed=7)
    return np.asarray(r1), np.asarray(r2)


def _touching_pairs():
    """Axis-aligned rectangles on an integer grid: edge and corner
    contact (collide), and pairs one float32 step apart (separated)."""
    def box(x0, y0, x1, y1):
        return [[x0, y0], [x1, y0], [x1, y1], [x0, y1]]

    gap = float(np.nextafter(np.float32(2.0), np.float32(3.0)))
    a, b = [], []
    for k in range(N // 4):
        s = float(k % 7)
        a += [box(0, 0, 2, 2)] * 4
        b += [box(2, s / 7, 4, 2 + s), box(-3, 2, 0, 5), box(gap, 0, 4, 2),
              box(0, gap, 2, 4)]
    return np.asarray(a, np.float32), np.asarray(b, np.float32)


def _bf16_exact(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


CASES = ["random", "touching", "bf16_lossless", "bf16_lossy"]


def _case(pairs, name):
    """(r1, r2, pack name) of a label case."""
    if name == "touching":
        return (*_touching_pairs(), "pack_rects")
    r1, r2 = pairs
    if name == "bf16_lossless":
        return _bf16_exact(r1), _bf16_exact(r2), "pack_rects_bf16"
    return r1, r2, "pack_rects_bf16" if name == "bf16_lossy" else "pack_rects"


@pytest.mark.parametrize("pack", ["pack_rects", "pack_rects_bf16"])
def test_pack_rects_matches_jax(pairs, pack):
    r1, _ = pairs
    want = np.asarray(getattr(jsp, pack)(jnp.asarray(r1)).astype(jnp.float32))
    got = getattr(tsc, pack)(_t(r1))
    assert got.shape == (8, 8, N // 8) and got.is_contiguous()
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)


def test_pack_obbs_rows_and_unpack():
    rng = np.random.default_rng(3)
    c = rng.uniform(-6, 6, (64, 2)).astype(np.float32)
    e = rng.uniform(-5, 5, (64, 2)).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, 64).astype(np.float32)
    want = np.asarray(jsp.pack_obbs(c, e, th))
    got = tsc.pack_obbs(_t(c), _t(e), _t(th)).numpy()
    assert got.shape == want.shape == (6, 8, 8)
    # The non-trigonometric rows are exact; cos/sin rows are torch's.
    np.testing.assert_array_equal(got[[0, 1, 4, 5]], want[[0, 1, 4, 5]])
    np.testing.assert_array_equal(got[2].ravel(), torch.cos(_t(th)).numpy())
    np.testing.assert_array_equal(got[3].ravel(), torch.sin(_t(th)).numpy())
    out = torch.arange(16.0).reshape(8, 2)
    np.testing.assert_array_equal(tsc.unpack_labels(out).numpy(),
                                  np.asarray(jsp.unpack_labels(jnp.arange(16.0).reshape(8, 2))))
    with pytest.raises(ValueError, match="N % 8"):
        tsc.pack_rects(torch.zeros((12, 4, 2)))


@pytest.mark.parametrize("shift", [0.0, 1e6])
@pytest.mark.parametrize("case", CASES)
def test_sat_label_plain_bitwise_vs_pallas(pairs, case, shift):
    r1, r2, pack = _case(pairs, case)
    j1, j2 = (getattr(jsp, pack)(jnp.asarray(r)) for r in (r1, r2))
    want = np.asarray(jsp.sat_rects_pallas_t(j1, j2, shift, block=BLOCK,
                                             interpret=True))
    got = tsc.sat_rects_cuda_t(_t(j1), _t(j2), shift, block=BLOCK)
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_array_equal(got.numpy(), want)
    if shift:
        assert want.sum() == 0  # a huge shift separates every pair
    else:
        assert 0 < want.sum() < N
    if case == "touching" and not shift:
        np.testing.assert_array_equal(want.reshape(-1, 4)[0], [1, 1, 0, 0])


@pytest.mark.parametrize("case", CASES)
def test_sat_count_plain_exact_vs_pallas(pairs, case):
    r1, r2, pack = _case(pairs, case)
    j1, j2 = (getattr(jsp, pack)(jnp.asarray(r)) for r in (r1, r2))
    want = jsp.sat_count_pallas_t(j1, j2, block=BLOCK, interpret=True)
    got = tsc.sat_count_cuda_t(_t(j1), _t(j2), block=BLOCK)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == float(want) == float(np.asarray(jsat.sat_rects(
        jnp.asarray(r1 if "bf16" not in case else _bf16_exact(r1)),
        jnp.asarray(r2 if "bf16" not in case else _bf16_exact(r2)))).sum())


def test_bf16_lossless_equals_f32_and_lossy_close(pairs):
    r1, r2 = pairs
    q1, q2 = _bf16_exact(r1), _bf16_exact(r2)
    f32 = tsc.sat_rects_cuda_t(tsc.pack_rects(_t(q1)), tsc.pack_rects(_t(q2)),
                               block=BLOCK)
    b16 = tsc.sat_rects_cuda_t(tsc.pack_rects_bf16(_t(q1)),
                               tsc.pack_rects_bf16(_t(q2)), block=BLOCK)
    assert torch.equal(f32, b16)
    full = tsc.sat_rects_cuda_t(tsc.pack_rects(_t(r1)), tsc.pack_rects(_t(r2)),
                                block=BLOCK)
    coarse = tsc.sat_rects_cuda_t(tsc.pack_rects_bf16(_t(r1)),
                                  tsc.pack_rects_bf16(_t(r2)), block=BLOCK)
    assert (full != coarse).float().mean() < 0.02


def _boxes(seed, n=N):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    e = rng.uniform(0.1, 5, (n, 2)).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    return c, e, th


def _touching_boxes():
    """Unrotated boxes on an integer grid: edge contact, corner contact and
    one float32 step apart (angle 0: cos 1, sin 0 exactly)."""
    gap = float(np.nextafter(np.float32(2.0), np.float32(3.0)))
    c1 = np.zeros((N, 2), np.float32)
    c2 = np.tile(np.asarray([[2, 0], [2, 2], [gap, 0], [0, gap]], np.float32),
                 (N // 4, 1))
    e = np.full((N, 2), 2.0, np.float32)
    th = np.zeros(N, np.float32)
    return (c1, e, th), (c2, e, th)


@pytest.mark.parametrize("shift", [0.0, 0.37, 1e6])
@pytest.mark.parametrize("case", ["random", "touching"])
def test_obb_label_and_count_plain_vs_pallas(case, shift):
    if case == "touching":
        a, b = _touching_boxes()
    else:
        a, b = _boxes(1), _boxes(2)
    j1, j2 = jsp.pack_obbs(*a), jsp.pack_obbs(*b)
    want = np.asarray(jsp.obb_collide_pallas_t(j1, j2, shift, block=BLOCK,
                                               interpret=True))
    got = tsc.obb_collide_cuda_t(_t(j1), _t(j2), shift, block=BLOCK)
    assert got.dtype == torch.float32 and got.shape == (N,)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "touching" and shift == 0.0:
        np.testing.assert_array_equal(want.reshape(-1, 4)[0], [1, 1, 0, 0])
    want_n = jsp.obb_count_pallas_t(j1, j2, shift, block=BLOCK, interpret=True)
    got_n = tsc.obb_count_cuda_t(_t(j1), _t(j2), shift, block=BLOCK)
    assert got_n.dim() == 0 and float(got_n) == float(want_n) == want.sum()


def test_drop_ins_pad_arbitrary_n():
    # 1000 pairs: not a multiple of 8 * block, padded and sliced back.
    r1, r2 = (np.asarray(r) for r in _random_pairs(1000, seed=3))
    for precision in ("f32", "bf16"):
        want = np.asarray(jsp.sat_rects_pallas(jnp.asarray(r1), jnp.asarray(r2),
                                               block=BLOCK, interpret=True,
                                               precision=precision))
        got = tsc.sat_rects_cuda(_t(r1), _t(r2), block=BLOCK, precision=precision)
        assert got.dtype == torch.int32 and got.shape == (1000,)
        np.testing.assert_array_equal(got.numpy(), want)
    a, b = _boxes(4, 1000), _boxes(5, 1000)
    want = np.asarray(jsp.obb_collide_pallas(*a, *b, block=BLOCK, interpret=True))
    got = tsc.obb_collide_cuda(*(_t(x) for x in (*a, *b)), block=BLOCK)
    assert got.dtype == torch.int32 and got.shape == (1000,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsat.obb_collide(*a, *b)))


def test_wrappers_reject_what_the_kernels_do_not_take(pairs):
    r1t = tsc.pack_rects(_t(pairs[0]))
    with pytest.raises(ValueError, match="multiple of block"):
        tsc.sat_rects_cuda_t(r1t, r1t, block=3 * BLOCK)
    with pytest.raises(ValueError, match="dtype"):
        tsc.sat_rects_cuda_t(r1t.double(), r1t.double(), block=BLOCK)
    with pytest.raises(ValueError, match="dtype"):
        tsc.sat_count_cuda_t(r1t, r1t.to(torch.bfloat16), block=BLOCK)
    with pytest.raises(ValueError, match=r"\(8, 8, M\)"):
        tsc.sat_count_cuda_t(r1t[:6], r1t[:6], block=BLOCK)
    with pytest.raises(ValueError, match="dtype"):
        tsc.obb_collide_cuda_t(r1t[:6].to(torch.bfloat16),
                               r1t[:6].to(torch.bfloat16), block=BLOCK)
    with pytest.raises(ValueError, match=r"\(6, 8, M\)"):
        tsc.obb_count_cuda_t(r1t, r1t, block=BLOCK)


def test_cpu_tensors_never_launch(pairs):
    tsc.reset_launches()
    r1t, r2t = (tsc.pack_rects(_t(r)) for r in pairs)
    b = tsc.pack_obbs(*(_t(x) for x in _boxes(6, N)))
    tsc.sat_rects_cuda_t(r1t, r2t, block=BLOCK)
    tsc.sat_count_cuda_t(r1t, r2t, block=BLOCK)
    tsc.obb_collide_cuda_t(b, b, block=BLOCK)
    tsc.obb_count_cuda_t(b, b, block=BLOCK)
    assert tsc.LAUNCHES == dict.fromkeys(tsc.LAUNCHES, 0)
