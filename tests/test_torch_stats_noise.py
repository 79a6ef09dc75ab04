"""Port stats + noise against the JAX package.

Tolerances: stats bitwise (same float32 operations in the same order);
sampler indices and gathered table rows exact; positions within 2 ulp at
the ring's scale (|position| < 16, where one ulp is 2^-20): cos/sin and
the shift normal may round differently in the last bits between XLA's
and torch's CPU libraries.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from collide2d_tpu.mc import noise as jnoise
from collide2d_tpu.mc import stats as jstats
from collide2d_tpu_torch.mc import noise as tnoise
from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc import stats as tstats

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

BINS = (0.0, 0.01, 0.1, 1.0)
ACC = (0.0001, 0.001, 0.01)
RING_ULP = 2.0**-20  # one float32 ulp for magnitudes in [8, 16)


def _grid():
    """(n, k) pairs: k = 0, k = n, p on every bin edge, k > 46340, and a
    seeded spread of ordinary values."""
    rng = np.random.default_rng(3)
    n = [1000, 2000, 20_000, 36_928, 120_000, 4_000_000, 3_000_064]
    pairs = []
    for nn in n:
        pairs += [(nn, 0), (nn, nn), (nn, 1), (nn, nn - 1)]
        for edge in BINS:
            pairs.append((nn, int(round(edge * nn))))
        pairs += [(nn, int(k)) for k in rng.integers(0, nn + 1, 40)]
    pairs += [(4_000_000, 46_341), (4_000_000, 1_000_000), (3_000_000, 2_999_999)]
    arr = np.asarray(pairs, np.int64)
    return arr[:, 0].astype(np.int32), arr[:, 1].astype(np.int32)


def test_calc_slack_bitwise():
    n, k = _grid()
    want = np.asarray(jstats.calc_slack(n, k))
    got = tstats.calc_slack(torch.from_numpy(n), torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, want)


def test_get_bin_bitwise():
    n, k = _grid()
    p = (k.astype(np.float32) / n.astype(np.float32))
    p = np.concatenate([p, np.asarray(BINS, np.float32), [-0.5, 1.5]]).astype(np.float32)
    want = np.asarray(jstats.get_bin(p, BINS))
    got = tstats.get_bin(torch.from_numpy(p), BINS).numpy()
    np.testing.assert_array_equal(got, want)
    # a boundary value lands in the LATER bin (last match wins)
    assert int(tstats.get_bin(torch.tensor(0.01), BINS)) == 1


def test_is_converged_bitwise():
    n, k = _grid()
    want = np.asarray(jstats.is_converged(n, k, jnp.asarray(BINS), jnp.asarray(ACC)))
    got = tstats.is_converged(torch.from_numpy(n), torch.from_numpy(k), BINS, ACC).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    # scalar n (as _fused_round passes it) against a vector of counts
    want_s = np.asarray(jstats.is_converged(36_928, k, jnp.asarray(BINS), jnp.asarray(ACC)))
    got_s = tstats.is_converged(36_928, torch.from_numpy(k), BINS, ACC).numpy()
    np.testing.assert_array_equal(got_s, want_s)


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(11)
    poses = rng.uniform([0.1, 0.1, 0.0], [5.0, 5.0, 2 * np.pi], (64, 3)).astype(np.float32)
    variances = rng.uniform(0.0, 0.3, (48, 5)).astype(np.float32)
    variances[:, 3:] = 0.0
    return poses, np.sqrt(variances)


@pytest.mark.parametrize("seed", [0, 42])
def test_sample_configuration_batch_vs_jax(tables, seed):
    poses, sds = tables
    kw = dict(num_configs=4096, r_offset=(4.07 + 1.74) / 4.0, spread=4.0)
    want = [np.asarray(a) for a in jnoise.sample_configuration_batch(
        jax.random.PRNGKey(seed), jnp.asarray(poses), jnp.asarray(sds), **kw)]
    got = [a.numpy() for a in tnoise.sample_configuration_batch(
        prng.PRNGKey(seed), torch.from_numpy(poses), torch.from_numpy(sds), **kw)]
    for name, g, w in zip(("pos", "pose_idx", "var_idx", "pose", "sd"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    assert np.abs(want[0]).max() < 16
    diff = np.abs(got[0].astype(np.float64) - want[0])
    print(f"positions: {(diff > 0).mean():.2%} differ, max {diff.max() / RING_ULP:.1f} ring ulp")
    assert diff.max() <= 2 * RING_ULP


def test_sample_noise_vs_jax(tables):
    _, sds = tables
    want = jnoise.sample_noise(jax.random.PRNGKey(5), jnp.asarray(sds), (16,))
    got = tnoise.sample_noise(prng.PRNGKey(5), torch.from_numpy(sds), (16,))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        # normals within 1 ulp (see test_torch_prng), times a sigma < 0.6
        np.testing.assert_allclose(g.numpy(), w, rtol=4e-7, atol=0)


def test_sampled_obstacle_vertices_vs_jax(tables):
    poses, sds = tables
    want_noise = jnoise.sample_noise(jax.random.PRNGKey(6), jnp.asarray(sds), ())
    base = poses[:48, :2]
    want = np.asarray(jnoise.sampled_obstacle_vertices(jnp.asarray(base), want_noise))
    noise = tnoise.NoiseParams(*(torch.from_numpy(np.array(a)) for a in want_noise))
    got = tnoise.sampled_obstacle_vertices(torch.from_numpy(base), noise).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0**-22)
