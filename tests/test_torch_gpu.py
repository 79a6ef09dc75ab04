"""The fused Monte Carlo kernel on the card; every test skips without one.

The file imports no JAX (the machine with the card has none), so it runs
there without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerance of the kernel against its plain version: the two share the
Philox stream, the 23-bit codes, the erf_inv polynomial and the
separation test, but round ``sincosf`` and contracted multiply-adds
their own way, which can flip only a sample within an ulp of touching:
the counts may differ by at most 1e-5 of all samples.
"""

import numpy as np
import pytest
import torch

from collide2d_tpu_torch.mc.estimator import configs_from_numpy
from collide2d_tpu_torch.ops import mc_cuda

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
