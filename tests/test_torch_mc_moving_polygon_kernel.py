"""Kernel 14's plain version (`ops.mc_moving_polygon_cuda`) on the CPU.

(a) `pack_moving_polygon_mc_params` gives the TPU kernel's rows,
    transposed, with and without the robot-axis dedupe (values to 1e-5,
    the sigmas, normals and velocity rows bitwise).
(b) Fed the TPU kernel's test draws the plain version equals
    `mc_moving_poly_counts_pallas(..., interpret=True)` bit for bit, with
    and without the dedupe.
(c) At zero velocity it is bitwise kernel 7's plain version on the same
    Philox stream, and its counts do not change under compaction or an
    offset split.

(d) ``normal_method="box_muller"``: the plain version equals the TPU
    kernel's Box-Muller draws in interpret mode on the stub, counts equal
    kernel 7's Box-Muller counts at zero velocity and keep under
    compaction and an offset split.

The CUDA kernel itself runs in tests/test_torch_gpu.py (skipped here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import collide2d_tpu.ops.mc_moving_polygon_pallas as jmmp
import collide2d_tpu.ops.mc_pallas as mcp
from collide2d_tpu.mc.moving import moving_polygon_configs as j_configs
from collide2d_tpu.models.collision_model import example_polygon_configs
from collide2d_tpu_torch.mc.moving import moving_polygon_configs
from collide2d_tpu_torch.ops import mc_moving_polygon_cuda as mmp
from collide2d_tpu_torch.ops import mc_polygon_cuda
from tests.conftest import deterministic_uniform_stub

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ROBOT = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87],
                  [-2.035, 0.87]], np.float32)
K, K2 = 6, 4


@pytest.fixture(scope="module")
def batch():
    b = example_polygon_configs(128, k=K, seed=19)
    rng = np.random.default_rng(8)
    rows = (np.asarray(b.position), np.asarray(b.pose_theta),
            np.asarray(b.obstacle_verts), np.asarray(b.std_dev),
            rng.uniform(-2, 2, (128, 2)).astype(np.float32), 0.0,
            rng.uniform(0.5, 3, 128).astype(np.float32))
    return j_configs(*rows), moving_polygon_configs(*rows)


@pytest.mark.parametrize("dedup", [False, True])
def test_pack_matches_jax(batch, dedup):
    jb, tb = batch
    a_keep = (0, 1) if dedup else None
    k2a = 2 if dedup else K2
    want = np.asarray(jmmp.pack_moving_polygon_mc_params(jb, jnp.asarray(ROBOT),
                                                         a_keep)).T
    got = mmp.pack_moving_polygon_mc_params(tb, ROBOT, a_keep)
    assert got.shape == want.shape == (128, mmp._num_rows(K, K2, k2a))
    assert got.is_contiguous() and got.dtype == torch.float32
    o = mc_polygon_cuda._offsets(K, K2, k2a)
    v = mmp._static_rows(K, K2, k2a)
    exact = list(range(3)) + list(range(o["nx"], o["p1"])) + [v, v + 1]
    np.testing.assert_array_equal(got.numpy()[:, exact], want[:, exact])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _stub_uniforms(c, sub):
    stub = deterministic_uniform_stub()
    calls = [np.asarray(stub((sub // 2, c))) for _ in range(6)]
    u = np.zeros((c, sub, 3), np.float32)
    for d in range(3):
        u[:, : sub // 2, d] = calls[2 * d].T
        u[:, sub // 2:, d] = calls[2 * d + 1].T
    return torch.from_numpy(u)


@pytest.mark.parametrize("dedup", [False, True])
def test_plain_equals_tpu_kernel_on_stub_draws(monkeypatch, batch, dedup):
    jb, _ = batch
    c, sub = jmmp.LANE_CONFIGS, 16
    a_keep = (0, 1) if dedup else None
    k2a = 2 if dedup else K2
    params_j = jmmp.pack_moving_polygon_mc_params(jb, jnp.asarray(ROBOT), a_keep)
    monkeypatch.setattr(mcp, "_TEST_UNIFORM_FN", deterministic_uniform_stub())
    want = np.asarray(jmmp.mc_moving_poly_counts_pallas(
        jnp.asarray([1, 2], jnp.int32), params_j, jnp.int32(1), sub=sub, k=K,
        k2=K2, k2_axes=k2a, interpret=True))
    params = torch.from_numpy(np.ascontiguousarray(np.asarray(params_j).T))
    got = mmp.mc_moving_poly_counts_plain(
        params, torch.arange(c, dtype=torch.int32), (1, 2), sub, k=K, k2=K2,
        k2a=k2a, uniforms=_stub_uniforms(c, sub))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < c * sub


@pytest.mark.parametrize("dedup", [False, True])
def test_plain_box_muller_equals_tpu_kernel_on_stub_draws(monkeypatch, batch, dedup):
    """`normal_method="box_muller"` on the same stub draws (pair d's u1 and
    u2 are calls 2d and 2d + 1, as `mc_cuda.uniform_normals` reads them)."""
    jb, _ = batch
    c, sub = jmmp.LANE_CONFIGS, 16
    a_keep = (0, 1) if dedup else None
    k2a = 2 if dedup else K2
    params_j = jmmp.pack_moving_polygon_mc_params(jb, jnp.asarray(ROBOT), a_keep)
    monkeypatch.setattr(mcp, "_TEST_UNIFORM_FN", deterministic_uniform_stub())
    want = np.asarray(jmmp.mc_moving_poly_counts_pallas(
        jnp.asarray([1, 2], jnp.int32), params_j, jnp.int32(1), sub=sub, k=K,
        k2=K2, k2_axes=k2a, interpret=True, normal_method="box_muller"))
    params = torch.from_numpy(np.ascontiguousarray(np.asarray(params_j).T))
    got = mmp.mc_moving_poly_counts_plain(
        params, torch.arange(c, dtype=torch.int32), (1, 2), sub, k=K, k2=K2,
        k2a=k2a, normal_method="box_muller", uniforms=_stub_uniforms(c, sub))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < c * sub


def test_box_muller_zero_velocity_is_bitwise_kernel_7(batch):
    """The Box-Muller builds of kernels 14 and 7 draw the same normals: at
    zero velocity their plain versions count alike, and the counts keep
    under compaction and an offset split."""
    _, tb = batch
    still = tb._replace(velocity=torch.zeros_like(tb.velocity))
    uids = torch.arange(128, dtype=torch.int32)
    seed, dims = (0x0BADF00D, 0x12345678), dict(k=K, k2=K2, k2a=2)
    kw = dict(normal_method="box_muller", **dims)
    moving = mmp.mc_moving_poly_counts(
        mmp.pack_moving_polygon_mc_params(still, ROBOT, (0, 1)), uids, seed, 512, **kw)
    static = mc_polygon_cuda.mc_poly_counts(
        mc_polygon_cuda.pack_polygon_mc_params(still, ROBOT, (0, 1)), uids, seed, 512,
        **kw)
    assert torch.equal(moving, static) and 0 < int(static.sum()) < 128 * 512
    erfinv = mc_polygon_cuda.mc_poly_counts(
        mc_polygon_cuda.pack_polygon_mc_params(still, ROBOT, (0, 1)), uids, seed, 512,
        **dims)
    assert not torch.equal(erfinv, static)  # another stream
    params = mmp.pack_moving_polygon_mc_params(tb, ROBOT, (0, 1))
    whole = mmp.mc_moving_poly_counts(params, uids, seed, 700, **kw)
    split = (mmp.mc_moving_poly_counts(params, uids, seed, 300, **kw)
             + mmp.mc_moving_poly_counts(params, uids, seed, 400, offset=300, **kw))
    assert torch.equal(split, whole)
    keep = torch.arange(1, 128, 5)
    assert torch.equal(mmp.mc_moving_poly_counts(params[keep].contiguous(),
                                                 uids[keep].contiguous(), seed, 700,
                                                 **kw), whole[keep])


def test_zero_velocity_is_bitwise_kernel_7(batch):
    _, tb = batch
    still = tb._replace(velocity=torch.zeros_like(tb.velocity))
    uids = torch.from_numpy(np.random.default_rng(9).permutation(500)[:128]
                            .astype(np.int32))
    seed = (0x0BADF00D, 0x12345678)
    for a_keep in ((0, 1), (0, 1, 2, 3)):
        dims = dict(k=K, k2=K2, k2a=len(a_keep))
        moving = mmp.mc_moving_poly_counts(
            mmp.pack_moving_polygon_mc_params(still, ROBOT, a_keep), uids, seed, 512,
            **dims)
        static = mc_polygon_cuda.mc_poly_counts(
            mc_polygon_cuda.pack_polygon_mc_params(still, ROBOT, a_keep), uids, seed,
            512, **dims)
        assert torch.equal(moving, static) and 0 < int(static.sum()) < 128 * 512


def test_counts_invariant_and_wrapper_validates(batch):
    _, tb = batch
    params = mmp.pack_moving_polygon_mc_params(tb, ROBOT, (0, 1))
    uids = torch.arange(128, dtype=torch.int32)
    seed = (5, 6)
    dims = dict(k=K, k2=K2, k2a=2)
    before = mmp.LAUNCHES
    whole = mmp.mc_moving_poly_counts(params, uids, seed, 700, **dims)
    assert mmp.LAUNCHES == before  # the plain version is not a launch
    split = (mmp.mc_moving_poly_counts(params, uids, seed, 300, **dims)
             + mmp.mc_moving_poly_counts(params, uids, seed, 400, offset=300, **dims))
    assert torch.equal(split, whole)
    keep = torch.arange(0, 128, 3)
    assert torch.equal(mmp.mc_moving_poly_counts(params[keep].contiguous(),
                                                 uids[keep].contiguous(), seed, 700,
                                                 **dims), whole[keep])
    with pytest.raises(ValueError, match="params must be"):
        mmp.mc_moving_poly_counts(params[:, :-8].contiguous(), uids, seed, 10, **dims)
    with pytest.raises(ValueError, match="K2A"):
        mmp.mc_moving_poly_counts(params, uids, seed, 10, k=K, k2=K2, k2a=5)
    with pytest.raises(ValueError, match="unsupported device"):
        mmp.mc_moving_poly_counts(params.to("meta"), uids.to("meta"), seed, 10, **dims)


@pytest.fixture(scope="module")
def out_case(batch):
    _, tb = batch
    params = mmp.pack_moving_polygon_mc_params(tb, ROBOT, (0, 1))
    return params, torch.arange(128, dtype=torch.int32), (7, 8), dict(k=K, k2=K2, k2a=2)


def test_wrapper_adds_the_counts_into_out(out_case):
    params, uids, seed, dims = out_case
    fresh = mmp.mc_moving_poly_counts(params, uids, seed, 300, **dims)
    base = torch.arange(128, dtype=torch.int32) * 7
    out = base.clone()
    got = mmp.mc_moving_poly_counts(params, uids, seed, 300, out=out, **dims)
    assert got is out and torch.equal(out, base + fresh)
    assert 0 < int(fresh.sum()) < 128 * 300


# an out of another dtype, shape, device or layout than int32 (C,) raises
_BAD_OUT = {
    "dtype": lambda c: torch.zeros(c, dtype=torch.int64),
    "shape": lambda c: torch.zeros(c + 1, dtype=torch.int32),
    "device": lambda c: torch.zeros(c, dtype=torch.int32, device="meta"),
    "strided": lambda c: torch.zeros(2 * c, dtype=torch.int32)[::2],
}


@pytest.mark.parametrize("bad", list(_BAD_OUT))
def test_wrapper_validates_out(out_case, bad):
    params, uids, seed, dims = out_case
    with pytest.raises(ValueError, match="out must be a contiguous int32"):
        mmp.mc_moving_poly_counts(params, uids, seed, 10, out=_BAD_OUT[bad](128),
                                  **dims)
