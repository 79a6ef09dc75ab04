"""Kernel 13's plain version (`ops.mc_toi_cuda`) on the CPU.

(a) `pack_mc_toi_params` gives the TPU kernel's rows 0-15, transposed
    (rows 16-18 there are zero padding); the advancement bound may differ
    by an ulp (torch's and XLA's hypot).
(b) Fed the TPU kernel's test draws (the `_TEST_UNIFORM_FN` stub) the plain
    version gives `mc_toi_counts_pallas(..., interpret=True)`'s counts on a
    mixed batch: translation-only rows bitwise, rotating rows within the
    JAX test's allowance, at most 2 per row and 6 in all (tests/test_pallas.py:
    709-735: a graze whose final distance lands within an ulp of tol).
(c) Philox counts are a pure function of (seed, uid, sample index): bitwise
    invariant under permutation, compaction and an offset split.
(d) The step counts the plain version reports, and the wrapper's routing.

The CUDA kernel itself runs in tests/test_torch_gpu.py (skipped here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collide2d_tpu.ops.mc_pallas as mcp
import collide2d_tpu.ops.mc_toi_pallas as jmtp
from collide2d_tpu.mc.moving import moving_configs as j_moving_configs
from collide2d_tpu_torch.mc.moving import moving_configs
from collide2d_tpu_torch.ops import mc_toi_cuda
from tests.conftest import deterministic_uniform_stub

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ROBOT = (4.07, 1.74)


def _rows(seed, c, rotating_share=0.5, shape_sigma=0.4):
    rng = np.random.default_rng(seed)
    omega = rng.uniform(-0.5, 0.5, c)
    omega[: int(c * (1 - rotating_share))] = 0.0
    sd = rng.uniform(0, 0.4, (c, 5))
    sd[:, 3:] = rng.uniform(0, shape_sigma, (c, 2)) if shape_sigma else 0.0
    return tuple(np.asarray(a, np.float32) for a in (
        rng.uniform(-6, 6, (c, 2)), rng.uniform(0, 2 * np.pi, c),
        rng.uniform(0.5, 5, (c, 2)), sd, rng.uniform(-2, 2, (c, 2)), omega,
        rng.uniform(0.5, 3, c)))


def test_pack_matches_tpu_rows():
    rows = _rows(0, 200)
    want = np.asarray(jmtp.pack_mc_toi_params(j_moving_configs(*rows),
                                              jnp.asarray(ROBOT, jnp.float32)))
    got = mc_toi_cuda.pack_mc_toi_params(moving_configs(*rows), ROBOT)
    assert got.shape == (200, mc_toi_cuda.PARAM_COLS) and got.is_contiguous()
    assert want.shape == (jmtp.PARAM_ROWS, 200) and not want[16:].any()
    np.testing.assert_array_equal(got.numpy()[:, :15], want[:15].T)
    np.testing.assert_allclose(got.numpy()[:, 15], want[15], rtol=2**-22, atol=0)


def _stub_uniforms(c, sub, n_draws):
    """Replay the stub outside the kernel: call 2d+h is draw d of half h,
    shaped (sub/2, C); the kernel's two halves are two samples per row."""
    stub = deterministic_uniform_stub()
    calls = [np.asarray(stub((sub // 2, c))) for _ in range(2 * n_draws)]
    u = np.zeros((c, sub, n_draws), np.float32)
    for d in range(n_draws):
        u[:, : sub // 2, d] = calls[2 * d].T
        u[:, sub // 2:, d] = calls[2 * d + 1].T
    return torch.from_numpy(u)


@pytest.mark.parametrize("shape_noise", [True, False])
def test_plain_equals_tpu_kernel_on_stub_draws(monkeypatch, shape_noise):
    c, sub, ca_iters, tol = jmtp.LANE_CONFIGS, 16, 64, 1e-4
    rows = _rows(1, c, shape_sigma=0.4 if shape_noise else 0.0)
    params_j = jmtp.pack_mc_toi_params(j_moving_configs(*rows),
                                       jnp.asarray(ROBOT, jnp.float32))
    monkeypatch.setattr(mcp, "_TEST_UNIFORM_FN", deterministic_uniform_stub())
    want = np.asarray(jmtp.mc_toi_counts_pallas(
        jnp.asarray([1, 2], jnp.int32), params_j, jnp.int32(1), sub=sub,
        shape_noise=shape_noise, ca_iters=ca_iters, tol=tol, interpret=True))
    params = torch.from_numpy(np.ascontiguousarray(np.asarray(params_j)[:16].T))
    got = mc_toi_cuda.mc_toi_counts_plain(
        params, torch.arange(c, dtype=torch.int32), (1, 2), sub,
        shape_noise=shape_noise, ca_iters=ca_iters, tol=tol,
        uniforms=_stub_uniforms(c, sub, 5 if shape_noise else 3)).numpy()
    trans = rows[5] == 0
    np.testing.assert_array_equal(got[trans], want[trans])
    diff = np.abs(got - want)[~trans]
    assert diff.max(initial=0) <= 2 and diff.sum() <= 6
    assert 0 < want[trans].sum() < trans.sum() * sub
    assert 0 < want[~trans].sum() < (~trans).sum() * sub


@pytest.fixture(scope="module")
def philox_case():
    rows = _rows(2, 96)
    params = mc_toi_cuda.pack_mc_toi_params(moving_configs(*rows), ROBOT)
    uids = torch.from_numpy(np.random.default_rng(3).permutation(1000)[:96]
                            .astype(np.int32))
    seed = (0x12345678, 0x9ABCDEF0)
    return params, uids, seed, mc_toi_cuda.mc_toi_counts_plain(params, uids, seed, 600)


def test_counts_invariant_under_permutation_compaction_and_split(philox_case):
    params, uids, seed, counts = philox_case
    keep = torch.from_numpy(np.random.default_rng(4).permutation(96)[:40])
    sub = mc_toi_cuda.mc_toi_counts_plain(params[keep].contiguous(),
                                          uids[keep].contiguous(), seed, 600)
    np.testing.assert_array_equal(sub.numpy(), counts[keep].numpy())
    first = mc_toi_cuda.mc_toi_counts_plain(params, uids, seed, 250)
    second = mc_toi_cuda.mc_toi_counts_plain(params, uids, seed, 350, offset=250)
    np.testing.assert_array_equal((first + second).numpy(), counts.numpy())
    small = mc_toi_cuda.mc_toi_counts_plain(params, uids, seed, 600, max_elems=4096)
    np.testing.assert_array_equal(small.numpy(), counts.numpy())
    other = mc_toi_cuda.mc_toi_counts_plain(params, uids, (seed[0], seed[1] ^ 1), 600)
    assert (other != counts).any() and 0 < int(counts.sum()) < 96 * 600


def test_steps_and_translation_rows(philox_case):
    params, uids, seed, counts = philox_case
    got, steps, warp_steps = mc_toi_cuda.mc_toi_counts_plain(
        params, uids, seed, 600, return_steps=True)
    assert torch.equal(got, counts)
    rotating = params[:, 14] != 0
    assert int(steps[~rotating].sum()) == 0 and int(steps[rotating].sum()) > 0
    assert bool((warp_steps >= steps / 32).all())  # a warp max >= its mean
    # ca_iters = 0: every row takes the exact window, rotating or not
    window = mc_toi_cuda.mc_toi_counts_plain(params, uids, seed, 600, ca_iters=0)
    assert torch.equal(window[~rotating], counts[~rotating])


def test_wrapper_routes_cpu_to_plain_and_validates(philox_case):
    params, uids, seed, counts = philox_case
    before = mc_toi_cuda.LAUNCHES
    got = mc_toi_cuda.mc_toi_counts(params, uids, seed, 600)
    np.testing.assert_array_equal(got.numpy(), counts.numpy())
    assert mc_toi_cuda.LAUNCHES == before  # the plain version is not a launch
    with pytest.raises(ValueError, match="float32"):
        mc_toi_cuda.mc_toi_counts(params.double(), uids, seed, 10)
    with pytest.raises(ValueError, match="uids"):
        mc_toi_cuda.mc_toi_counts(params, uids.long(), seed, 10)
    with pytest.raises(ValueError, match="contiguous"):
        mc_toi_cuda.mc_toi_counts(params.t().contiguous().t(), uids, seed, 10)
    with pytest.raises(ValueError, match="ca_iters"):
        mc_toi_cuda.mc_toi_counts(params, uids, seed, 10, ca_iters=-1)
    with pytest.raises(ValueError, match="unsupported device"):
        mc_toi_cuda.mc_toi_counts(params.to("meta"), uids.to("meta"), seed, 10)


def test_wrapper_adds_the_counts_into_out(philox_case):
    params, uids, seed, counts = philox_case
    base = torch.arange(96, dtype=torch.int32) * 7
    out = base.clone()
    got = mc_toi_cuda.mc_toi_counts(params, uids, seed, 600, out=out)
    assert got is out and torch.equal(out, base + counts)


# an out of another dtype, shape, device or layout than int32 (C,) raises
_BAD_OUT = {
    "dtype": lambda c: torch.zeros(c, dtype=torch.int64),
    "shape": lambda c: torch.zeros(c + 1, dtype=torch.int32),
    "device": lambda c: torch.zeros(c, dtype=torch.int32, device="meta"),
    "strided": lambda c: torch.zeros(2 * c, dtype=torch.int32)[::2],
}


@pytest.mark.parametrize("bad", list(_BAD_OUT))
def test_wrapper_validates_out(philox_case, bad):
    params, uids, seed, _ = philox_case
    with pytest.raises(ValueError, match="out must be a contiguous int32"):
        mc_toi_cuda.mc_toi_counts(params, uids, seed, 10, out=_BAD_OUT[bad](96))
