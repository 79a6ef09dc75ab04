"""The port's learned collision model (``collide2d_tpu_torch/models/
learned.py``) against the JAX package's, on the CPU.

Inputs come from numpy seeds; both packages get the same arrays. The
tolerances, each with its reason:

- `featurize`: columns 0-10 bitwise (host gathers, numpy's cos/sin); the
  signed distance within 1 ulp: kernel 8's plain version takes torch's
  CPU ``sqrt``, which misrounds a fraction of a percent of inputs (with a
  correctly rounded square root it is bitwise; on the card the kernel's
  IEEE ``sqrtf`` is); the margin bitwise wherever the distance is (it is
  the distance over the same scale), else within 2 ulp (a quotient of a
  distance 1 ulp off). ``dx = 0 - x`` in the kernel's layout equals JAX's
  ``-x`` bitwise, ``x = y = 0`` rows included.
- `cp_from_configs` against the tables path: atol 2e-6, JAX's own bar.
- initial weights: within 1 ulp (`prng.normal` is held to 1 ulp).
- the epoch permutation: bitwise at 1, 2 and 3 shuffle rounds.
- the forward pass on the same weights: float32 logits within rtol 1e-5
  (summation order of the products); bfloat16 cp within atol 2e-3.
- one AdamW step against ``optax.adamw`` on the same gradients: the
  parameters within rtol 1e-6, atol lr x 1e-5 near zero (optax's float32
  bias correction; the test says why).
- a 3-epoch float32 `train_model` against JAX's: the loss history within
  rtol 1e-5, the parameters within rtol 1e-4 + atol 1e-6 (both packages
  sum the products in their own order; measured ~1e-6).
- ``.npz`` artifacts exchanged both ways: bfloat16 cps within atol 2e-3.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from collide2d_tpu.cli import main as jmain
from collide2d_tpu.models import learned as jl
from collide2d_tpu_torch import cli as tcli
from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.estimator import Configs
from collide2d_tpu_torch.models import learned as tl
from collide2d_tpu_torch.ops import distance_cuda

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

BF16_CP_ATOL = 2e-3


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _tables(n=2048, seed=0):
    """The JAX test's `_toy_problem` rows and tables."""
    rng = np.random.default_rng(seed)
    positions = rng.uniform(-6, 6, size=(n, 2)).astype(np.float32)
    poses = rng.uniform(0.5, 4.0, size=(8, 3)).astype(np.float32)
    variances = rng.uniform(0.0, 0.09, size=(4, 5)).astype(np.float32)
    std = np.sqrt(variances)
    pose_idx = rng.integers(0, 8, size=n)
    var_idx = rng.integers(0, 4, size=n)
    return positions, var_idx, pose_idx, poses, std


def _toy_problem(n=2048, seed=0):
    """Learnable synthetic task in the real feature semantics (the JAX
    test's): cp is a smooth function of the robot-obstacle gap."""
    positions, var_idx, pose_idx, poses, std = _tables(n, seed)
    feats = tl.featurize(positions, var_idx, pose_idx, poses, std, device="cpu")
    gap = np.linalg.norm(positions, axis=1) - 0.5 * (
        poses[pose_idx, 0] + poses[pose_idx, 1]
    )
    labels = (1.0 / (1.0 + np.exp(3.0 * gap))).astype(np.float32)
    return feats, labels


def _edge_tables():
    """The toy tables plus rows at the origin, on an axis, and obstacles
    with negative extents and angles past pi."""
    positions, var_idx, pose_idx, poses, std = _tables(512, seed=3)
    positions[:16] = 0.0
    positions[16:32, 0] = 0.0
    positions[32:48, 1] = 0.0
    poses[0, :2] = (-2.5, 1.5)
    poses[1, :2] = (3.0, -0.75)
    poses[2, 2] = 4.5
    pose_idx[:64] = np.arange(64) % 3
    return positions, var_idx, pose_idx, poses, std


def _assert_physics_columns(got: np.ndarray, want: np.ndarray) -> None:
    """The distance within 1 ulp; the margin bitwise where the distance is
    bitwise, else within 2 ulp."""
    d_ulps = _ulps(got[:, 11], want[:, 11])
    m_ulps = _ulps(got[:, 12], want[:, 12])
    assert d_ulps.max() <= 1
    assert m_ulps[d_ulps == 0].max(initial=0) == 0
    assert m_ulps.max() <= 2


# ---------------------------------------------------------------------------
# Features


@pytest.mark.parametrize("tables", [_tables, _edge_tables])
def test_featurize_matches_jax(tables):
    args = tables()
    want = jl.featurize(*args)
    distance_cuda.reset_launches()
    got = tl.featurize(*args, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, :11].view(np.int32), want[:, :11].view(np.int32))
    _assert_physics_columns(got, want)
    assert distance_cuda.LAUNCHES["obb_distance"] == 0  # the plain version ran


def test_kernel_layout_distance_is_jax_negation_bitwise():
    """Kernel 8's layout forms dx = 0 - x: on the same rows it is the
    closed form with JAX's operands (-x, -y) bit for bit, x = y = 0 rows
    included."""
    positions, var_idx, pose_idx, poses, std = _edge_tables()
    f = torch.from_numpy(tl.featurize(positions, var_idx, pose_idx, poses, std,
                                      device="cpu"))
    x, y = torch.from_numpy(positions[:, 0]), torch.from_numpy(positions[:, 1])
    rw, rh = (float(np.float32(v * 0.5)) for v in tl.ROBOT_WH)
    want = distance_cuda.obb_signed_distance_tile(
        -x, -y, f[:, 4], f[:, 5], torch.full_like(x, rw), torch.full_like(x, rh),
        torch.ones_like(x), torch.zeros_like(x), f[:, 2].abs() * 0.5,
        f[:, 3].abs() * 0.5)
    assert (positions[:, 0] == 0).sum() >= 16 and (positions[:, 1] == 0).sum() >= 16
    np.testing.assert_array_equal(f[:, 11].numpy().view(np.int32),
                                  want.numpy().view(np.int32))


def test_featurize_resolves_tables():
    positions = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    poses = np.array([[5.0, 6.0, 0.0], [7.0, 8.0, np.pi / 2]], np.float32)
    std = np.arange(10, dtype=np.float32).reshape(2, 5)
    f = tl.featurize(positions, [1.0, 0.0], [0.0, 1.0], poses, std, device="cpu")
    assert f.shape == (2, tl.NUM_FEATURES)
    np.testing.assert_allclose(f[0, :2], [1.0, 2.0])
    np.testing.assert_allclose(f[0, 2:4], [5.0, 6.0])  # pose 0 w,h
    np.testing.assert_allclose(f[0, 4:6], [1.0, 0.0])  # cos/sin(0)
    np.testing.assert_allclose(f[0, 6:11], std[1])     # var row 1
    np.testing.assert_allclose(f[1, 4:6], [0.0, 1.0], atol=1e-6)
    assert f[0, 11] < 0  # the robot overlaps the 5 x 6 obstacle
    s_eff = (np.hypot(std[1, 0], std[1, 1])
             + 0.5 * np.hypot(5.0, 6.0) * std[1, 2]
             + 0.5 * np.hypot(std[1, 3], std[1, 4]))
    np.testing.assert_allclose(
        f[0, 12], np.clip(f[0, 11] / max(s_eff, 1e-3), -40, 40), rtol=1e-5
    )


def test_featurize_rejects_out_of_range_indices():
    poses = np.zeros((2, 3), np.float32)
    std = np.zeros((2, 5), np.float32)
    pos = np.zeros((1, 2), np.float32)
    with pytest.raises(ValueError, match="pose_idx"):
        tl.featurize(pos, [0], [2], poses, std, device="cpu")
    with pytest.raises(ValueError, match="var_idx"):
        tl.featurize(pos, [5], [0], poses, std, device="cpu")


def test_cp_from_configs_matches_featurize_path():
    """The Configs surrogate surface produces the features the model was
    trained on (column order pinned against featurize)."""
    rng = np.random.default_rng(2)
    n = 64
    poses = rng.uniform(0.5, 4.0, size=(4, 3)).astype(np.float32)
    std = np.sqrt(rng.uniform(0, 0.09, size=(4, 5))).astype(np.float32)
    positions = rng.uniform(-6, 6, size=(n, 2)).astype(np.float32)
    pose_idx = rng.integers(0, 4, size=n)
    var_idx = rng.integers(0, 4, size=n)
    feats, labels = _toy_problem(n=512, seed=7)
    cfg = tl.TrainConfig(hidden=(16,), epochs=1, batch_size=128,
                         val_fraction=0.0, seed=0)
    res = tl.train_model(feats, labels, cfg, device="cpu")
    model = tl.LearnedCollisionModel(res.params, res.norm_mean, res.norm_std,
                                     cfg.compute_dtype, device="cpu")
    configs = Configs(*(torch.from_numpy(a) for a in (
        positions, poses[pose_idx, 2], poses[pose_idx, 0:2], std[var_idx])))
    via_configs = model.cp_from_configs(configs).numpy()
    via_tables = model.cp(positions, var_idx, pose_idx, poses, std)
    np.testing.assert_allclose(via_configs, via_tables, rtol=0, atol=2e-6)
    assert via_configs.shape == (n,)


# ---------------------------------------------------------------------------
# Model


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_init_params_match_jax(seed):
    want = jl.init_params(jax.random.PRNGKey(seed), (64, 32))
    got = tl.params_to_jax(tl.init_params(prng.PRNGKey(seed), (64, 32), device="cpu"))
    assert list(got) == list(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == np.float32 and got[k].shape == w.shape, k
        assert _ulps(got[k], w).max() <= 1, k


@pytest.mark.parametrize("n,rounds", [(1000, 1), (1 << 17, 2), (300_007, 2), (1 << 22, 3)])
def test_permutation_matches_jax(n, rounds):
    assert int(np.ceil(3 * np.log(n) / np.log(2.0**32 - 1))) == rounds
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(11), n))
    got = tl.permutation(prng.PRNGKey(11), n, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _carried(seed=3, hidden=(64, 64)):
    jp = jl.init_params(jax.random.PRNGKey(seed), hidden)
    return jp, tl.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _standardized(n=512, seed=5):
    feats, _ = _toy_problem(n, seed)
    return ((feats - feats.mean(0)) / feats.std(0)).astype(np.float32)


def test_params_round_trip_through_the_module():
    jp, model = _carried()
    back = tl.params_to_jax(model)
    assert list(back) == list(jp)
    for k in jp:
        np.testing.assert_array_equal(back[k], np.asarray(jp[k]))
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_forward_float32_matches_jax():
    jp, model = _carried()
    x = _standardized()
    want = np.asarray(jl.apply_model(jp, jnp.asarray(x), jnp.float32))
    got = tl.apply_model(model, torch.from_numpy(x), torch.float32).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_forward_bfloat16_matches_jax():
    jp, model = _carried()
    x = _standardized()
    want = np.asarray(jl.apply_model(jp, jnp.asarray(x), jnp.bfloat16))
    got = tl.apply_model(model, torch.from_numpy(x), torch.bfloat16).detach().numpy()
    print(f"bfloat16 logits bitwise equal to JAX's: {np.mean(got == want):.4f} of rows")
    sig = lambda z: 1.0 / (1.0 + np.exp(-z.astype(np.float64)))  # noqa: E731
    np.testing.assert_allclose(sig(got), sig(want), rtol=0, atol=BF16_CP_ATOL)


def _one_unit_model(w0_col, b0):
    """hidden (1,): logit = gelu(x @ w0 + b0) cast, times 1, plus 0."""
    params = {"w0": np.zeros((tl.NUM_FEATURES, 1), np.float32),
              "b0": np.asarray([b0], np.float32),
              "wout": np.ones((1, 1), np.float32), "bout": np.zeros(1, np.float32)}
    params["w0"][:len(w0_col), 0] = w0_col
    return params


def test_gelu_is_the_tanh_approximation():
    params = _one_unit_model([1.0], 0.0)
    x = np.zeros((1, tl.NUM_FEATURES), np.float32)
    x[0, 0] = 1.0
    with torch.no_grad():
        got = float(tl.apply_model(tl.params_from_jax(params, "cpu"),
                                   torch.from_numpy(x), torch.float32)[0])
    tanh_gelu = float(jax.nn.gelu(jnp.float32(1.0)))  # JAX's default
    erf_gelu = float(jax.nn.gelu(jnp.float32(1.0), approximate=False))
    assert abs(tanh_gelu - erf_gelu) > 1e-4
    assert got == pytest.approx(tanh_gelu, abs=1e-6)
    assert float(np.asarray(jl.apply_model(params, jnp.asarray(x), jnp.float32))[0]) \
        == pytest.approx(got, abs=1e-6)


def test_bfloat16_product_is_float32_with_the_bias_before_the_cast():
    """1 + 2^-10 is no bfloat16 value: a product rounded to bfloat16 before
    the bias would give 1 - 1 = 0; JAX's float32 product keeps 2^-10."""
    a = torch.tensor([[1.0, 2.0**-10]], dtype=torch.bfloat16)
    b = torch.ones((2, 1), dtype=torch.bfloat16)
    out = tl._product(a, b)
    assert out.dtype == torch.float32 and float(out) == 1.0 + 2.0**-10
    assert float(torch.mm(a, b)) == 1.0  # a bfloat16-output product

    params = _one_unit_model([1.0, 2.0**-10], -1.0)
    x = np.zeros((1, tl.NUM_FEATURES), np.float32)
    x[0, :2] = 1.0
    got = tl.apply_model(tl.params_from_jax(params, "cpu"), torch.from_numpy(x),
                         torch.bfloat16)
    want = np.asarray(jl.apply_model(params, jnp.asarray(x), jnp.bfloat16))
    assert got.dtype == torch.float32 and float(got[0]) > 0
    assert float(got[0]) == float(want[0])


def test_adamw_step_matches_optax():
    """One AdamW step on the same gradients from the same initial weights:
    ``optax.adamw(lr, weight_decay)`` against the port's `adamw` (torch's
    AdamW with optax's constants). The parameters agree within rtol 1e-6,
    with an atol of lr x 1e-5 for those near zero (the biases start at
    0): optax rounds its bias correction ``1 - b2**t`` in float32, 1.3e-5
    off at b2 = 0.999 and 6.4e-6 after the square root, where torch's is a
    double."""
    lr = 3e-3
    jp, model = _carried(seed=4, hidden=(32,))
    start = tl.params_to_jax(model)
    rng = np.random.default_rng(0)
    grads = {k: rng.standard_normal(np.shape(v)).astype(np.float32) * 1e-2
             for k, v in jp.items()}
    tx = optax.adamw(lr, weight_decay=1e-4)
    updates, _ = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                           tx.init(jp), jp)
    want = {k: np.asarray(v) for k, v in optax.apply_updates(jp, updates).items()}
    opt = tl.adamw(model, lr, weight_decay=1e-4)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[name])
    opt.step()
    got = tl.params_to_jax(model)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=lr * 1e-5)
        assert not np.array_equal(got[k], start[k]), k


def test_train_float32_matches_jax():
    feats, labels = _toy_problem(n=512, seed=5)
    kw = dict(hidden=(16,), epochs=3, batch_size=128, val_fraction=0.25, seed=4,
              compute_dtype="float32")
    want = jl.train_model(feats, labels, jl.TrainConfig(**kw))
    got = tl.train_model(feats, labels, tl.TrainConfig(**kw), device="cpu")
    np.testing.assert_allclose(got.history, want.history, rtol=1e-5)
    for k in want.params:
        np.testing.assert_allclose(got.params[k], np.asarray(want.params[k]),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.norm_mean, want.norm_mean)
    np.testing.assert_array_equal(got.norm_std, want.norm_std)
    assert got.val_mae == pytest.approx(want.val_mae, rel=1e-4)
    assert got.val_bce == pytest.approx(want.val_bce, rel=1e-4)


def test_training_learns_and_beats_mean_predictor():
    feats, labels = _toy_problem()
    cfg = tl.TrainConfig(hidden=(64, 64), epochs=30, batch_size=256,
                         learning_rate=3e-3, val_fraction=0.125, seed=0)
    res = tl.train_model(feats, labels, cfg, device="cpu")
    assert res.history[-1] < 0.8 * res.history[0]
    # must beat the constant-mean predictor on held-out rows
    mean_mae = float(np.mean(np.abs(labels - labels.mean())))
    assert res.val_mae < 0.7 * mean_mae
    assert len(res.val_mae_per_bin) == 3


def test_save_load_roundtrip_identical_predictions(tmp_path):
    feats, labels = _toy_problem(n=512)
    cfg = tl.TrainConfig(hidden=(16,), epochs=2, batch_size=128,
                         val_fraction=0.25, seed=1)
    res = tl.train_model(feats, labels, cfg, device="cpu")
    path = tmp_path / "model.npz"
    tl.save_model(path, res, cfg)
    model = tl.LearnedCollisionModel.load(path, device="cpu")
    direct = tl.LearnedCollisionModel(res.params, res.norm_mean, res.norm_std,
                                      cfg.compute_dtype, device="cpu")
    a = model.cp_from_features(feats[:64]).numpy()
    b = direct.cp_from_features(feats[:64]).numpy()
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a <= 1)).all()
    assert not list(tmp_path.glob("*.tmp.*"))


def test_training_is_deterministic():
    """Same data + TrainConfig -> bit-identical parameters (threefry
    shuffles, a fixed split)."""
    feats, labels = _toy_problem(n=512, seed=5)
    cfg = tl.TrainConfig(hidden=(16,), epochs=2, batch_size=128,
                         val_fraction=0.25, seed=4)
    a = tl.train_model(feats, labels, cfg, device="cpu")
    b = tl.train_model(feats, labels, cfg, device="cpu")
    assert a.history == b.history
    for k in a.params:
        np.testing.assert_array_equal(a.params[k], b.params[k])
    np.testing.assert_array_equal(a.norm_mean, b.norm_mean)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_npz_artifacts_load_across_packages(tmp_path, direction):
    feats, labels = _toy_problem(n=512, seed=2)
    kw = dict(hidden=(16, 16), epochs=2, batch_size=128, val_fraction=0.25, seed=3)
    path = tmp_path / "model.npz"
    if direction == "port_to_jax":
        cfg = tl.TrainConfig(**kw)
        tl.save_model(path, tl.train_model(feats, labels, cfg, device="cpu"), cfg)
    else:
        cfg = jl.TrainConfig(**kw)
        jl.save_model(path, jl.train_model(feats, labels, cfg), cfg)
    want = np.asarray(jl.LearnedCollisionModel.load(path).cp_from_features(feats))
    got = tl.LearnedCollisionModel.load(path, device="cpu").cp_from_features(feats).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_CP_ATOL)


# ---------------------------------------------------------------------------
# Dataset plumbing and the CLI


def test_load_training_data_balance_bins(tmp_path):
    from collide2d_tpu_torch.data.schemas import pack_dataset_rows
    from collide2d_tpu_torch.utils.io_npy import save_npy

    rng = np.random.default_rng(0)
    n = 300
    cp = np.concatenate([
        np.zeros(200, np.float32),                       # [0, 0.01) bin
        rng.uniform(0.02, 0.09, 60).astype(np.float32),  # [0.01, 0.1)
        rng.uniform(0.2, 0.9, 40).astype(np.float32),    # [0.1, 1]
    ])
    rows = pack_dataset_rows(
        rng.uniform(-5, 5, (n, 2)).astype(np.float32), cp,
        np.zeros(n, np.float32), np.zeros(n, np.float32),
    )
    data_dir = tmp_path / "data"
    save_npy(data_dir / "0.npy", rows)
    save_npy(data_dir / "poses.npy", np.ones((1, 3), np.float32))
    save_npy(data_dir / "variances.npy", np.zeros((1, 5), np.float32))

    feats, labels = tl.load_training_data(data_dir, device="cpu")
    assert labels.shape == (n,)
    bins = (0.0, 0.01, 0.1, 1.0)
    feats_b, labels_b = tl.load_training_data(data_dir, balance_bins=bins, device="cpu")
    assert labels_b.shape == (120,)  # smallest bin has 40 rows -> 3 x 40
    assert (labels_b < 0.01).sum() == 40
    assert ((labels_b >= 0.01) & (labels_b < 0.1)).sum() == 40
    want_f, want_l = jl.load_training_data(data_dir, balance_bins=bins)
    np.testing.assert_array_equal(labels_b, want_l)
    np.testing.assert_array_equal(feats_b[:, :11], want_f[:, :11])


def test_load_training_data_rejects_non_finite_rows(tmp_path):
    from collide2d_tpu_torch.utils.io_npy import save_npy

    rows = np.zeros((8, 5), np.float32)
    rows[2, 0] = np.nan
    data_dir = tmp_path / "data"
    save_npy(data_dir / "0.npy", rows)
    save_npy(data_dir / "poses.npy", np.ones((1, 3), np.float32))
    save_npy(data_dir / "variances.npy", np.zeros((1, 5), np.float32))
    with pytest.raises(ValueError, match="NaN"):
        tl.load_training_data(data_dir, device="cpu")
    # with balance_bins too: a NaN cp falls outside every bin mask
    with pytest.raises(ValueError, match="NaN"):
        tl.load_training_data(data_dir, balance_bins=(0.0, 0.01, 0.1, 1.0), device="cpu")


def test_load_training_data_resolves_dataset_dir(tmp_path):
    """On a dataset the port's own ``generate`` writes (CPU, plain kernel)."""
    from collide2d_tpu_torch.data.pipeline import GenerateConfig, generate_dataset

    data_dir = tmp_path / "data"
    generate_dataset(GenerateConfig(
        data_dir=str(data_dir), num_batches=1, batch_size=128, num_poses=4,
        num_variances=4, seed=1, verbose=False, max_samples=2000,
        bin_accuracy=(0.05, 0.05, 0.1), device="cpu"))
    feats, labels = tl.load_training_data(data_dir, device="cpu")
    assert feats.shape == (128, tl.NUM_FEATURES)
    assert labels.shape == (128,)
    assert ((labels >= 0) & (labels <= 1)).all()
    # features carry the actual table values, not the indices
    rows = np.load(data_dir / "0.npy")
    poses = np.load(data_dir / "poses.npy")
    np.testing.assert_array_equal(feats[:, 2], poses[rows[:, 4].astype(int), 0])
    want, _ = jl.load_training_data(data_dir)
    np.testing.assert_array_equal(feats[:, :11], want[:, :11])
    _assert_physics_columns(feats, want)


@pytest.fixture(scope="module")
def jax_dataset(tmp_path_factory):
    """A micro-dataset the JAX package generates (its test's settings)."""
    from collide2d_tpu.data.pipeline import GenerateConfig, generate_dataset
    from collide2d_tpu.mc.estimator import AdaptiveConfig

    data_dir = tmp_path_factory.mktemp("learned") / "data"
    generate_dataset(GenerateConfig(
        data_dir=str(data_dir), num_batches=2, batch_size=128,
        num_poses=8, num_variances=8, seed=0, verbose=False,
        adaptive=AdaptiveConfig(
            max_samples=2000, initial_batch=1000,
            initial_phase_samples=2000, later_batch=1000,
            bin_accuracy=(0.05, 0.05, 0.1), min_active=64,
        ),
        max_samples=2000,
    ))
    return data_dir


def test_cli_train_predict_on_generated_dataset(tmp_path, jax_dataset):
    """generate (JAX) -> train -> predict with both packages' CLIs at
    float32: the port's artifact and JAX's hold to each other."""
    train = ["train", "--data_dir", str(jax_dataset), "--hidden", "16",
             "--epochs", "3", "--batch_size", "64", "--val_fraction", "0.1",
             "--verbose", "0", "--compute_dtype", "float32"]
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    assert tcli.main([*train, "--out", str(ours), "--device", "cpu"]) == 0
    assert jmain([*train, "--out", str(theirs)]) == 0
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k.startswith("param_"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6)
            elif k != "meta_json":
                np.testing.assert_array_equal(a[k], b[k])

    rows = np.load(jax_dataset / "0.npy")
    relabel_in = tmp_path / "relabel_rows.npy"
    np.save(relabel_in, rows[:, [0, 1, 3, 4]])
    for data_in in (jax_dataset / "0.npy", relabel_in):
        out, jout = tmp_path / "pred.npy", tmp_path / "jpred.npy"
        predict = ["predict", "--data_in", str(data_in), "--data_dir", str(jax_dataset)]
        assert tcli.main([*predict, "--model", str(ours), "--out", str(out),
                          "--device", "cpu"]) == 0
        assert jmain([*predict, "--model", str(theirs), "--out", str(jout)]) == 0
        cps = np.load(out)
        assert cps.shape == (rows.shape[0],) and ((cps >= 0) & (cps <= 1)).all()
        np.testing.assert_allclose(cps, np.load(jout), rtol=0, atol=1e-5)


def test_data_parallel_is_rejected(tmp_path, jax_dataset):
    """Data-parallel training runs now: over ["cpu", "cpu"] it trains, and
    ``train --data_parallel`` on the one CPU device writes the
    single-device run's model; over one device it is a no-op, as in JAX."""
    train = ["train", "--data_dir", str(jax_dataset), "--hidden", "8", "--epochs",
             "1", "--batch_size", "64", "--verbose", "0", "--device", "cpu"]
    assert tcli.main([*train, "--out", str(tmp_path / "a.npz")]) == 0
    assert tcli.main([*train, "--out", str(tmp_path / "b.npz"), "--data_parallel"]) == 0
    with np.load(tmp_path / "a.npz") as x, np.load(tmp_path / "b.npz") as y:
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k])
    feats, labels = _toy_problem(n=256)
    cfg = tl.TrainConfig(hidden=(8,), epochs=1, batch_size=64, data_parallel=True)
    res = tl.train_model(feats, labels, cfg, devices=["cpu", "cpu"], device="cpu")
    assert np.isfinite(res.history[-1])
    one = dataclasses.replace(cfg, data_parallel=False)
    a = tl.train_model(feats, labels, cfg, device="cpu")
    b = tl.train_model(feats, labels, one, device="cpu")
    assert a.history == b.history
    for k in a.params:
        np.testing.assert_array_equal(a.params[k], b.params[k])


def test_learned_module_imports_no_jax():
    code = ("import sys, collide2d_tpu_torch.models.learned; "
            "assert 'jax' not in sys.modules and 'optax' not in sys.modules; "
            "assert 'collide2d_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("n_dev", [2, 3])
def test_data_parallel_training_matches_single_device(n_dev):
    """tests/test_learned.py:119 on the port: f32 data-parallel training over
    ["cpu"] * n_dev (each replica the gradient of its slice of every
    minibatch, summed on the first) agrees with the single-device run and
    with JAX's data-parallel run on its CPU mesh (the same devices count).
    1,152 rows divide over 2 and 3 devices, so no row is cut."""
    from tests.conftest import cpu_devices

    feats, labels = _toy_problem(n=1152, seed=3)
    kw = dict(hidden=(32,), epochs=3, batch_size=128, val_fraction=0.0, seed=2,
              compute_dtype="float32")
    single = tl.train_model(feats, labels, tl.TrainConfig(**kw), device="cpu")
    dp = tl.train_model(feats, labels, tl.TrainConfig(**kw, data_parallel=True),
                        devices=["cpu"] * n_dev, device="cpu")
    jdp = jl.train_model(feats, labels, jl.TrainConfig(**kw, data_parallel=True),
                         devices=cpu_devices()[:n_dev])
    for k in single.params:
        np.testing.assert_allclose(dp.params[k], single.params[k],
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(dp.params[k], np.asarray(jdp.params[k]),
                                   rtol=2e-4, atol=2e-5)


def test_data_parallel_truncation_respects_batch_count():
    """tests/test_learned.py:167 on the port: over 3 devices the 512 rows are
    cut to 510 before the steps are counted, and the run trains."""
    feats, labels = _toy_problem(n=512, seed=6)
    res = tl.train_model(
        feats, labels,
        tl.TrainConfig(hidden=(8,), epochs=1, batch_size=128, val_fraction=0.0,
                       seed=0, data_parallel=True),
        devices=["cpu"] * 3, device="cpu")
    assert np.isfinite(res.history[-1])
    with pytest.raises(ValueError, match="data-parallel truncation"):
        tl.train_model(feats[:130], labels[:130], tl.TrainConfig(
            hidden=(8,), epochs=1, batch_size=130, val_fraction=0.0,
            data_parallel=True), devices=["cpu"] * 3, device="cpu")
