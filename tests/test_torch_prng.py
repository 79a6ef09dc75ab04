"""The port's threefry against `jax.random`, and its Philox4x32-10 against
Random123's known-answer vectors.

Tolerances: key words, bits, uniforms and integers exact (XLA contracts
``floats * span + lo`` and the erf_inv polynomial into FMAs inside jit,
which `prng.fma` reproduces). Normals within 1 ulp: `prng.log1p` follows
XLA's CPU ``log1p`` inside ``erf_inv``, and an FMA emulated in float64
may still round a tie differently; the test reports how many differ.
Box-Muller pairs (`prng.box_muller_from_codes`, the kernels' Box-Muller
builds) against the TPU kernels' ``_box_muller`` formula on the same 24-bit
codes: within 4 ulp of the pair's radius r (absolute; measured at most 2),
since torch's and XLA's CPU ``log``, ``cos`` and ``sin`` round apart.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from collide2d_tpu_torch.mc import prng

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**31 - 1, -1])
def test_prngkey(seed):
    np.testing.assert_array_equal(
        prng.PRNGKey(seed), np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))


def test_fold_in_and_split():
    k = jax.random.PRNGKey(42)
    kp = prng.PRNGKey(42)
    for d in [0, 1, 5, 2**31 - 1, 2**32 - 1, 123456789]:
        np.testing.assert_array_equal(prng.fold_in(kp, d),
                                      np.asarray(jax.random.fold_in(k, d)))
    np.testing.assert_array_equal(prng.split(kp, 7), np.asarray(jax.random.split(k, 7)))


def test_batched_fold_in_matches_vmap():
    k = jax.random.PRNGKey(3)
    uids = np.arange(-1, 300, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda u: jax.random.fold_in(k, u))(jnp.asarray(uids)))
    k0, k1 = prng.fold_in_many(prng.PRNGKey(3), torch.from_numpy(uids))
    np.testing.assert_array_equal(np.stack([k0.numpy(), k1.numpy()], -1), want)
    step = np.asarray(jax.vmap(jax.random.fold_in, (0, None))(jnp.asarray(want), 17))
    s0, s1 = prng.fold_in_pair(k0, k1, 17)
    np.testing.assert_array_equal(np.stack([s0.numpy(), s1.numpy()], -1), step)


@pytest.mark.parametrize("shape", [(5,), (3, 7), (2, 3, 4)])
def test_random_bits(shape):
    k = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.bits(k, shape, jnp.uint32))
    got = prng.random_bits(prng.PRNGKey(11), shape).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 2 * np.pi), (-3.0, 5.5)])
def test_uniform_exact(lo, hi):
    k = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.uniform(k, (4096,), jnp.float32, lo, hi))
    got = prng.uniform(prng.PRNGKey(5), (4096,), lo, hi).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("lo,hi", [(0, 16), (0, 64**4), (3, 1000), (0, 7), (5, 5)])
def test_randint_exact(lo, hi):
    k = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.randint(k, (4096,), lo, hi))
    got = prng.randint(prng.PRNGKey(9), (4096,), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_normal_close_to_jax():
    k = jax.random.PRNGKey(1)
    want = np.asarray(jax.random.normal(k, (65536,), jnp.float32))
    got = prng.normal(prng.PRNGKey(1), (65536,)).numpy()
    u = _ulps(got, want)
    print(f"normals: {int((u > 0).sum())} of {u.size} differ, max {int(u.max())} ulp")
    assert u.max() <= 1
    # batched keys (the estimator's per-config streams), (C, lanes, 5)
    keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(64))
    want_b = np.asarray(jax.vmap(lambda kk: jax.random.normal(kk, (32, 5)))(keys))
    k0, k1 = prng.fold_in_many(prng.PRNGKey(1), torch.arange(64, dtype=torch.int32))
    got_b = prng.normal((k0, k1), (32, 5)).numpy()
    assert _ulps(got_b, want_b).max() <= 1


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.5], dtype=torch.float32)
    got = prng.erf_inv(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert np.isneginf(got[0]) and np.isposinf(got[1]) and got[2] == 0.0
    assert _ulps(got[2:], want[2:]).max() <= 1


def test_log1p_matches_xla():
    x = np.random.default_rng(6).uniform(-1, 1, 65536).astype(np.float32)
    for arg in (x * -x, x, np.abs(x) * 7):
        want = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(arg)))
        got = prng.log1p(torch.from_numpy(arg)).numpy()
        assert _ulps(got, want).max() <= 1


def test_normal_from_codes_finite_at_extremes():
    codes = torch.tensor([0, 1, (1 << 23) - 2, (1 << 23) - 1], dtype=torch.int64)
    z = prng.normal_from_codes(codes).numpy()
    assert np.isfinite(z).all()
    assert z[0] < -5.0 and z[-1] > 5.0 and z[0] == -z[-1]


@pytest.mark.parametrize("words,want", [
    (0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    (0xFFFFFFFF, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(words, want):
    # Random123 kat_vectors: philox4x32_10 with counter and key all `words`.
    assert prng.philox4x32(words, words, words, words, words, words) == want
    t = torch.full((3,), words, dtype=torch.int64)
    out = prng.philox4x32(t, t, t, t, words, words)
    assert all((o == w).all() for o, w in zip(out, want))


def test_philox_random123_pi_vector():
    # Random123 kat_vectors: counter = digits of pi, key = next digits.
    out = prng.philox4x32(0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344,
                          0xA4093822, 0x299F31D0)
    assert out == (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)


def test_box_muller_matches_the_tpu_kernels_formula(monkeypatch):
    import collide2d_tpu.ops.mc_pallas as mcp

    rng = np.random.default_rng(5)
    n = 1 << 18
    b = rng.integers(0, 1 << 24, (2, n)).astype(np.int32)
    b[0, :4] = [0, 1, (1 << 24) - 1, (1 << 24) - 2]  # r largest, r = 0
    b[1, :4] = [0, (1 << 24) - 1, 1 << 22, 1 << 23]  # a = 0, 2 pi, pi/2, pi
    u = (b.astype(np.float32) + 1) * np.float32(2.0**-24)  # exact
    draws = iter([u[0], u[1]])
    monkeypatch.setattr(mcp, "_TEST_UNIFORM_FN", lambda shape: jnp.asarray(next(draws)))
    jc, js = (np.asarray(x) for x in mcp._box_muller((n,)))
    tc, ts = (x.numpy() for x in prng.box_muller_from_codes(torch.from_numpy(b[0]),
                                                            torch.from_numpy(b[1])))
    r = np.sqrt(-2 * np.log(u[0].astype(np.float64))).astype(np.float32)
    ulp = np.spacing(np.maximum(r, np.float32(2.0**-24)))
    for got, want in ((tc, jc), (ts, js)):
        assert np.isfinite(got).all()
        assert (np.abs(got - want) <= 4 * ulp).all()
        print(f"bitwise on {(got == want).mean():.2%}, at most "
              f"{(np.abs(got - want) / ulp).max():.1f} ulp of r")
    assert np.abs(tc).max() < 5.8 and np.abs(ts).max() < 5.8

