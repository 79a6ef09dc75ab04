"""The CUDA kernels on the card; every test skips without one.

The file imports no JAX (the machine with the card has none), so it runs
there without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerance of the Monte Carlo kernel against its plain version: the two
share the Philox stream, the 23-bit codes, the erf_inv polynomial and the
separation test, but round ``sincosf`` and contracted multiply-adds
their own way, which can flip only a sample within an ulp of touching:
the counts may differ by at most 1e-5 of all samples. The SAT kernels
round every operation as their plain versions do: labels bitwise, counts
exact.
"""

import numpy as np
import pytest
import torch

from collide2d_tpu_torch.mc.estimator import configs_from_numpy
from collide2d_tpu_torch.models.collision_model import CollisionProbabilityModel
from collide2d_tpu_torch.ops import mc_cuda, sat_cuda
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
