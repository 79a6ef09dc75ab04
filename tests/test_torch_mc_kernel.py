"""The fused Monte Carlo kernel's plain version (`ops.mc_cuda`) on the CPU.

(a) Fed the TPU kernel's test draws (the `_TEST_UNIFORM_FN` stub of
    tests/conftest.py) it must return exactly the counts of
    `mc_counts_pallas(..., interpret=True)` under the same stub, at
    C = 128, sub = 16, with shape noise on and off.
(b) Philox counts are a pure function of (seed, uid, sample index):
    bitwise invariant when rows are permuted and compacted, and when one
    call of n samples is split into two calls at an offset.
(c) Statistically, the Philox path agrees with JAX's threefry
    `collision_probability(impl='jnp')` at C = 256, n = 16384: per-row
    pooled z-scores with mean z^2 in [0.75, 1.33] and max |z| < 6, rows
    where both estimates are 0 or both are 1 skipped.

(d) ``normal_method="box_muller"``: fed the same stub draws, the plain
    version equals ``mc_counts_pallas(..., normal_method="box_muller",
    interpret=True)`` exactly (the stub's pairs replayed as the TPU kernel
    pairs them); on Philox a sample's normals are its own pairs' outputs,
    and its counts agree with the erf_inv stream's statistically.

The CUDA kernel itself cannot run here: tests/test_torch_gpu.py holds it
against this plain version and skips without a card.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import collide2d_tpu.ops.mc_pallas as mcp
from collide2d_tpu.mc.estimator import Configs as JConfigs
from collide2d_tpu.mc.estimator import collision_probability as j_collision_probability
from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.estimator import collision_probability, configs_from_numpy
from collide2d_tpu_torch.mc.noise import sample_configuration_batch
from collide2d_tpu_torch.ops import mc_cuda
from tests.conftest import deterministic_uniform_stub

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ROBOT = (4.07, 1.74)


def _numpy_configs(rng, c, shape_sigma=0.4):
    sd = rng.uniform(0, 0.4, (c, 5)).astype(np.float32)
    sd[:, 3:] = rng.uniform(0, shape_sigma, (c, 2)) if shape_sigma else 0.0
    return (
        rng.uniform(-6, 6, (c, 2)).astype(np.float32),
        rng.uniform(0, 2 * np.pi, c).astype(np.float32),
        rng.uniform(0.5, 5, (c, 2)).astype(np.float32),
        sd,
    )


def test_pack_mc_params_matches_tpu_layout():
    rng = np.random.default_rng(0)
    cfg_np = _numpy_configs(rng, 300)
    want = np.asarray(mcp.pack_mc_params(JConfigs(*map(jnp.asarray, cfg_np)),
                                         jnp.asarray(ROBOT, jnp.float32))).T
    got = mc_cuda.pack_mc_params(configs_from_numpy(cfg_np, "cpu"), ROBOT)
    assert got.shape == (300, mc_cuda.PARAM_COLS) and got.is_contiguous()
    trig = [2, 3]  # cos/sin may differ in the last bit between libraries
    other = [i for i in range(16) if i not in trig]
    np.testing.assert_array_equal(got.numpy()[:, other], want[:, other])
    np.testing.assert_allclose(got.numpy()[:, trig], want[:, trig], rtol=0, atol=2**-23)


@pytest.mark.parametrize("shape_noise", [True, False])
def test_plain_equals_tpu_kernel_on_stub_draws(monkeypatch, shape_noise):
    c, sub = mcp.LANE_CONFIGS, 16
    rng = np.random.default_rng(1)
    cfg_np = _numpy_configs(rng, c, shape_sigma=0.4 if shape_noise else 0.0)
    params_j = mcp.pack_mc_params(JConfigs(*map(jnp.asarray, cfg_np)),
                                  jnp.asarray(ROBOT, jnp.float32))
    monkeypatch.setattr(mcp, "_TEST_UNIFORM_FN", deterministic_uniform_stub())
    want = np.asarray(mcp.mc_counts_pallas(
        jnp.asarray([1, 2], jnp.int32), params_j, jnp.int32(1), sub=sub,
        shape_noise=shape_noise, interpret=True))
    # Replay the stub outside the kernel: call 2d+h is draw d (dx, dy,
    # theta, dw, dh) of half h, shaped (sub/2, C); the kernel's two
    # halves are two samples per row.
    stub = deterministic_uniform_stub()
    n_draws = 5 if shape_noise else 3
    calls = [np.asarray(stub((sub // 2, c))) for _ in range(2 * n_draws)]
    u = np.zeros((c, sub, n_draws), np.float32)
    for d in range(n_draws):
        u[:, : sub // 2, d] = calls[2 * d].T
        u[:, sub // 2:, d] = calls[2 * d + 1].T
    params = torch.from_numpy(np.ascontiguousarray(np.asarray(params_j).T))
    got = mc_cuda.mc_counts_plain(
        params, torch.arange(c, dtype=torch.int32), (1, 2), sub,
        shape_noise=shape_noise, uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < c * sub  # both outcomes present


@pytest.mark.parametrize("shape_noise", [True, False])
def test_plain_box_muller_equals_tpu_kernel_on_stub_draws(monkeypatch, shape_noise):
    """`normal_method="box_muller"`: the stub's calls 2d and 2d + 1 are pair
    d's u1 and u2; the TPU kernel gives the first half of the samples r cos
    a and the second r sin a, as `mc_cuda.uniform_normals` pairs them."""
    c, sub = mcp.LANE_CONFIGS, 16
    rng = np.random.default_rng(6)
    cfg_np = _numpy_configs(rng, c, shape_sigma=0.4 if shape_noise else 0.0)
    params_j = mcp.pack_mc_params(JConfigs(*map(jnp.asarray, cfg_np)),
                                  jnp.asarray(ROBOT, jnp.float32))
    monkeypatch.setattr(mcp, "_TEST_UNIFORM_FN", deterministic_uniform_stub())
    want = np.asarray(mcp.mc_counts_pallas(
        jnp.asarray([1, 2], jnp.int32), params_j, jnp.int32(1), sub=sub,
        shape_noise=shape_noise, interpret=True, normal_method="box_muller"))
    stub = deterministic_uniform_stub()
    n_draws = 5 if shape_noise else 3
    calls = [np.asarray(stub((sub // 2, c))) for _ in range(2 * n_draws)]
    u = np.zeros((c, sub, n_draws), np.float32)
    for d in range(n_draws):
        u[:, : sub // 2, d] = calls[2 * d].T
        u[:, sub // 2:, d] = calls[2 * d + 1].T
    params = torch.from_numpy(np.ascontiguousarray(np.asarray(params_j).T))
    got = mc_cuda.mc_counts_plain(
        params, torch.arange(c, dtype=torch.int32), (1, 2), sub,
        shape_noise=shape_noise, normal_method="box_muller",
        uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < c * sub  # both outcomes present


def test_box_muller_philox_pairs_within_a_sample():
    """The Box-Muller stream: a sample's normals are its own pairs' outputs
    (c0, s0, c1, s1, c2) of words 0-3 of draw block 0 and 0-1 of block 1,
    so they depend on (seed, uid, sample index) alone."""
    uids = torch.tensor([3, 70000, 5], dtype=torch.int32)
    seed = (0xDEADBEEF, 0x01234567)
    z = mc_cuda.philox_normals(uids, seed, 10, 40, 7, 5, "box_muller")
    w = mc_cuda._philox_words(uids, seed, 10, 40, 7, 6) >> 8
    c0, s0 = prng.box_muller_from_codes(w[..., 0], w[..., 1])
    c1, s1 = prng.box_muller_from_codes(w[..., 2], w[..., 3])
    c2, _ = prng.box_muller_from_codes(w[..., 4], w[..., 5])
    assert torch.equal(z, torch.stack([c0, s0, c1, s1, c2], dim=-1))
    assert torch.equal(mc_cuda.philox_normals(uids, seed, 10, 40, 7, 3, "box_muller"),
                       z[..., :3])
    part = mc_cuda.philox_normals(uids[1:2], seed, 25, 40, 7, 5, "box_muller")
    assert torch.equal(part, z[1:2, 15:])
    with pytest.raises(ValueError, match="normal_method"):
        mc_cuda.philox_normals(uids, seed, 0, 4, 0, 3, "polar")


@pytest.mark.parametrize("shape_noise", [True, False])
def test_box_muller_counts_agree_with_erfinv_statistically(shape_noise):
    """The two normal draws are two streams of one distribution: per-row
    pooled z-scores of their counts with mean z^2 in [0.6, 1.5] and max |z|
    < 6, rows where both estimates are 0 or both are 1 skipped."""
    c, n = 256, 8192
    rng = np.random.default_rng(7)
    params = mc_cuda.pack_mc_params(
        configs_from_numpy(_numpy_configs(rng, c, 0.4 if shape_noise else 0.0), "cpu"),
        ROBOT)
    uids = torch.arange(c, dtype=torch.int32)
    p = {m: mc_cuda.mc_counts(params, uids, (9, 10), n, shape_noise=shape_noise,
                              normal_method=m).numpy() / n
         for m in mc_cuda.NORMAL_METHODS}
    a, b = p["erfinv"], p["box_muller"]
    keep = ~(((a == 0) & (b == 0)) | ((a == 1) & (b == 1)))
    a, b = a[keep], b[keep]
    pbar = (a + b) / 2
    z = (a - b) / np.sqrt(pbar * (1 - pbar) * 2 / n)
    print(f"{a.size} rows compared: mean z^2 {np.mean(z * z):.3f}, "
          f"max |z| {np.abs(z).max():.2f}")
    assert a.size >= 80
    assert 0.6 <= np.mean(z * z) <= 1.5 and np.abs(z).max() < 6


@pytest.fixture(scope="module")
def philox_case():
    rng = np.random.default_rng(2)
    cfg_np = _numpy_configs(rng, 96)
    params = mc_cuda.pack_mc_params(configs_from_numpy(cfg_np, "cpu"), ROBOT)
    uids = torch.from_numpy(rng.permutation(1000)[:96].astype(np.int32))
    seed = (0x12345678, 0x9ABCDEF0)
    counts = mc_cuda.mc_counts_plain(params, uids, seed, 3000)
    return params, uids, seed, counts


def test_counts_invariant_under_permutation_and_compaction(philox_case):
    params, uids, seed, counts = philox_case
    keep = torch.from_numpy(np.random.default_rng(3).permutation(96)[:40])
    sub = mc_cuda.mc_counts_plain(params[keep].contiguous(), uids[keep].contiguous(),
                                  seed, 3000)
    np.testing.assert_array_equal(sub.numpy(), counts[keep].numpy())


def test_counts_invariant_under_offset_split(philox_case):
    params, uids, seed, counts = philox_case
    first = mc_cuda.mc_counts_plain(params, uids, seed, 1100)
    second = mc_cuda.mc_counts_plain(params, uids, seed, 1900, offset=1100)
    np.testing.assert_array_equal((first + second).numpy(), counts.numpy())
    # chunking of the sample axis inside the plain version changes nothing
    small = mc_cuda.mc_counts_plain(params, uids, seed, 3000, max_elems=4096)
    np.testing.assert_array_equal(small.numpy(), counts.numpy())


def test_counts_depend_on_seed_uid_and_shape_noise(philox_case):
    params, uids, seed, counts = philox_case
    other = mc_cuda.mc_counts_plain(params, uids, (seed[0], seed[1] ^ 1), 3000)
    assert (other != counts).any()
    shifted = mc_cuda.mc_counts_plain(params, uids + 1, seed, 3000)
    assert (shifted != counts).any()


def test_plain_philox_agrees_with_threefry_statistically():
    c, n = 256, 16384
    rng = np.random.default_rng(4)
    poses = rng.uniform([0.1, 0.1, 0.0], [5.0, 5.0, 2 * np.pi], (512, 3)).astype(np.float32)
    sds = np.sqrt(rng.uniform(0.0, 0.3, (512, 5))).astype(np.float32)
    pos, _, _, pose, sd = sample_configuration_batch(
        prng.PRNGKey(8), torch.from_numpy(poses), torch.from_numpy(sds),
        num_configs=c, r_offset=0.0, spread=1.0)
    cfg_np = (pos.numpy(), pose[:, 2].numpy(), pose[:, :2].numpy(), sd.numpy())
    p_jax = np.asarray(j_collision_probability(
        jax.random.PRNGKey(21), JConfigs(*map(jnp.asarray, cfg_np)),
        jnp.asarray(ROBOT, jnp.float32), n, impl="jnp"), np.float64)
    p_port = collision_probability(
        prng.PRNGKey(77), configs_from_numpy(cfg_np, "cpu"), ROBOT, n,
        impl="cuda").numpy().astype(np.float64)
    both_degenerate = ((p_jax == 0) & (p_port == 0)) | ((p_jax == 1) & (p_port == 1))
    a, b = p_jax[~both_degenerate], p_port[~both_degenerate]
    pbar = (a + b) / 2
    z = (a - b) / np.sqrt(pbar * (1 - pbar) * 2 / n)
    print(f"{a.size} rows compared: mean z^2 {np.mean(z * z):.3f}, "
          f"max |z| {np.abs(z).max():.2f}")
    assert a.size >= 100
    assert 0.75 <= np.mean(z * z) <= 1.33
    assert np.abs(z).max() < 6


def test_wrapper_routes_cpu_to_plain_and_validates(philox_case):
    params, uids, seed, counts = philox_case
    before = mc_cuda.LAUNCHES
    got = mc_cuda.mc_counts(params, uids, seed, 3000)
    np.testing.assert_array_equal(got.numpy(), counts.numpy())
    assert mc_cuda.LAUNCHES == before  # the plain version is not a launch
    with pytest.raises(ValueError, match="float32"):
        mc_cuda.mc_counts(params.double(), uids, seed, 10)
    with pytest.raises(ValueError, match="uids"):
        mc_cuda.mc_counts(params, uids.long(), seed, 10)
    with pytest.raises(ValueError, match="contiguous"):
        mc_cuda.mc_counts(params.t().contiguous().t(), uids, seed, 10)
    with pytest.raises(ValueError, match="unsupported device"):
        mc_cuda.mc_counts(params.to("meta"), uids.to("meta"), seed, 10)

