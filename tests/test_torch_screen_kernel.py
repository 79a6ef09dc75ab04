"""Kernel 15's plain version (`ops.screen_cuda`) and the fused-screen
cascade on the CPU, against the JAX package.

(a) `pack_screen_params` gives the TPU kernel's (C, 16) rows.
(b) On the same draws z, the plain screen and `rotating_screen_pallas(...,
    interpret=True)`: flags differ on at most 1e-3 of lanes (the CPU's
    cos/sin ulp can move a lane at a screen boundary), t0 equal where the
    flags agree.
(c) The fused-screen cascade (`counts_chunk_moving(screen_impl='cuda')`, the
    plain screen on a CPU tensor) against JAX's
    `_counts_chunk_fused_screen(interpret=True)`: counts within 4 in total
    (tests/test_pallas.py:1025), masks as in (b), and bitwise the port's
    torch cascade; zero-omega rows agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collide2d_tpu.mc import moving as jmoving
from collide2d_tpu.ops import screen_pallas as jsp
from collide2d_tpu_torch.mc import moving
from collide2d_tpu_torch.ops import screen_cuda

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ROBOT = np.array([4.07, 1.74], np.float32)


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return tuple(np.asarray(a, np.float32) for a in (
        rng.uniform(-6, 6, (n, 2)), rng.uniform(0, 2 * np.pi, n),
        rng.uniform(0.5, 5, (n, 2)), rng.uniform(0, 0.3, (n, 5)),
        rng.uniform(-2, 2, (n, 2)), rng.uniform(-0.5, 0.5, n),
        rng.uniform(0.5, 3, n)))


def test_pack_matches_tpu_rows():
    rows = _rows(0, 50)
    want = np.asarray(jsp.pack_screen_params(jmoving.moving_configs(*rows),
                                             jnp.asarray(ROBOT)))
    got = screen_cuda.pack_screen_params(moving.moving_configs(*rows), ROBOT)
    assert got.shape == (50, screen_cuda.N_PARAMS) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy()[:, :15], want[:, :15])
    np.testing.assert_allclose(got.numpy()[:, 15], want[:, 15], rtol=2**-22, atol=0)


def test_plain_screen_matches_tpu_kernel():
    n, s = 64, 128
    rows = _rows(1, n)
    z = np.array(jax.random.normal(jax.random.PRNGKey(3), (n, s, 5)))
    want_f, want_t = jsp.rotating_screen_pallas(
        jnp.moveaxis(jnp.asarray(z), 2, 0),
        jsp.pack_screen_params(jmoving.moving_configs(*rows), jnp.asarray(ROBOT)),
        interpret=True)
    want_f, want_t = np.asarray(want_f), np.asarray(want_t)
    before = screen_cuda.LAUNCHES
    flags, t0 = screen_cuda.rotating_screen(
        torch.from_numpy(z),
        screen_cuda.pack_screen_params(moving.moving_configs(*rows), ROBOT))
    assert screen_cuda.LAUNCHES == before
    assert flags.dtype == torch.int32 and t0.shape == (n, s)
    agree = flags.numpy() == want_f
    assert (~agree).sum() <= 1e-3 * n * s
    np.testing.assert_array_equal(t0.numpy()[agree], want_t[agree])
    for bit in (1, 2, 4):
        assert 0 < ((want_f & bit) != 0).sum() < n * s


def _keys(n, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    words = np.asarray(jax.random.key_data(keys)).astype(np.int64)
    return keys, (torch.from_numpy(words[:, 0]), torch.from_numpy(words[:, 1]))


def test_fused_screen_counts_match_jax():
    n, s = 64, 128
    rows = _rows(2, n)
    jkeys, keys = _keys(n, 0)
    jc, tc = jmoving.moving_configs(*rows), moving.moving_configs(*rows)
    want, jmasks = jmoving.counts_chunk_moving(
        jkeys, jc, ROBOT, s, return_screen_masks=True, screen_impl="pallas",
        screen_interpret=True)
    got, masks = moving.counts_chunk_moving(keys, tc, ROBOT, s,
                                            return_screen_masks=True,
                                            screen_impl="cuda")
    assert int(np.abs(got.numpy() - np.asarray(want)).sum()) <= 4
    for a, b in zip(masks, jmasks):
        assert int((a.numpy() != np.asarray(b)).sum()) <= 1e-3 * n * s
    # the fused route is the torch cascade on the same draws
    torch_route, tmasks = moving.counts_chunk_moving(keys, tc, ROBOT, s,
                                                     return_screen_masks=True,
                                                     screen_impl="torch")
    assert torch.equal(got, torch_route)
    assert all(torch.equal(a, b) for a, b in zip(masks, tmasks))
    # zero omega: the window verdict, exactly
    jc0 = jc._replace(omega=jnp.zeros_like(jc.omega))
    tc0 = tc._replace(omega=torch.zeros_like(tc.omega))
    want0 = np.asarray(jmoving.counts_chunk_moving(
        jkeys, jc0, ROBOT, s, screen_impl="pallas", screen_interpret=True))
    got0 = moving.counts_chunk_moving(keys, tc0, ROBOT, s, screen_impl="cuda")
    np.testing.assert_array_equal(got0.numpy(), want0)


def test_wrapper_validates():
    z = torch.zeros((4, 8, 5))
    params = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="z must be"):
        screen_cuda.rotating_screen(z[..., :4], params)
    with pytest.raises(ValueError, match="params must be"):
        screen_cuda.rotating_screen(z, params[:3])
    with pytest.raises(ValueError, match="n_seg"):
        screen_cuda.rotating_screen(z, params, n_seg=0)
    with pytest.raises(ValueError, match="unsupported device"):
        screen_cuda.rotating_screen(z.to("meta"), params.to("meta"))
