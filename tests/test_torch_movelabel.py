"""The trajectory slice end to end on the CPU: ``collide2d-torch movelabel``
against the JAX package's ``collide2d movelabel``, the adaptive driver's
impl resolution, and both models' trajectory entry points.

- ``movelabel --device cpu --impl threefry`` reads the same ``.npz`` as
  JAX's ``movelabel --impl jnp`` and writes the same ``cp``, ``n_samples``
  and ``converged`` for translation-only rectangles, rotating rectangles
  and translation-only k-gons, up to the ulp-draw allowance: at most 1 row
  in 16 may differ (a count moves only for a draw within an ulp of a
  boundary, or a rotating graze within an ulp of tol, where the CPU's
  cos/sin differ from XLA's), by at most 2e-3 in cp.
- Rows that ``--prune_sigma`` keeps are bitwise the unpruned run's, pruned
  rows have cp = 0, for the kernel path and the threefry path.
- ``--impl auto`` resolves as the JAX driver on a TPU, 'pallas' read as
  'cuda' and 'jnp' as 'threefry', except that translation-only k-gons take
  kernel 14; ``--impl cuda`` on rotating k-gon rows exits with JAX's
  message.
- `CollisionProbabilityModel` and `PolygonCollisionProbabilityModel`:
  `trajectory_probability` and `label` agree with the JAX models.
"""

import jax
import numpy as np
import pytest
import torch

import collide2d_tpu.cli as jcli
from collide2d_tpu.mc.estimator import AdaptiveConfig as JAdaptiveConfig
from collide2d_tpu.mc import moving as jmoving
from collide2d_tpu.models import collision_model as jm
from collide2d_tpu.ops.broad_phase import possible_collision_mask as j_possible_collision_mask
from collide2d_tpu_torch import cli as tcli
from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.driver import _resolve_trajectory
from collide2d_tpu_torch.mc.estimator import AdaptiveConfig, mc_round
from collide2d_tpu_torch.mc.moving import (
    moving_configs_from_numpy,
    moving_polygon_configs_from_numpy,
)
from collide2d_tpu_torch.models import collision_model as tm
from collide2d_tpu_torch.ops import mc_moving_polygon_cuda, mc_toi_cuda
from collide2d_tpu_torch.ops.broad_phase import possible_collision_mask

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ROBOT = np.array([4.07, 1.74], np.float32)
ROBOT_4GON = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87],
                       [-2.035, 0.87]], np.float32)
CAP = ["--max_samples", "6000"]  # six rounds of 1000


def _rect_fields(n, seed, rotating):
    rng = np.random.default_rng(seed)
    f = dict(position=rng.uniform(-5, 5, (n, 2)), pose_theta=rng.uniform(0, 6, n),
             obstacle_wh=rng.uniform(0.5, 4, (n, 2)),
             std_dev=rng.uniform(0, 0.3, (n, 5)), velocity=rng.uniform(-2, 2, (n, 2)),
             t_max=rng.uniform(0.5, 3, n))
    if rotating:
        f["omega"] = rng.uniform(-0.5, 0.5, n)
    return {k: np.asarray(v, np.float32) for k, v in f.items()}


def _poly_fields(n, seed, rotating=False, scale=0.6):
    """`example_polygon_configs` rows, positions scaled by ``scale`` (0.6
    pulls them towards the obstacle so cp spans 0 to 1), with motion."""
    b = jm.example_polygon_configs(n=n, k=5, seed=seed)
    rng = np.random.default_rng(seed)
    f = dict(obstacle_verts=np.asarray(b.obstacle_verts),
             position=np.asarray(b.position) * scale, pose_theta=np.asarray(b.pose_theta),
             std_dev=np.asarray(b.std_dev), velocity=rng.uniform(-2, 2, (n, 2)),
             t_max=rng.uniform(0.5, 3, n), robot_verts=ROBOT_4GON)
    if rotating:
        f["omega"] = rng.uniform(-0.5, 0.5, n)
    return {k: np.asarray(v, np.float32) for k, v in f.items()}


def _outputs(path):
    with np.load(path) as d:
        return d["cp"], d["n_samples"], d["converged"]


def _assert_close_labels(got, want):
    cp_g, n_g, c_g = got
    cp_w, n_w, c_w = want
    assert cp_g.dtype == cp_w.dtype and cp_g.shape == cp_w.shape
    differ = (cp_g != cp_w) | (n_g != n_w) | (c_g != c_w)
    assert differ.sum() <= max(1, cp_w.size // 16)
    assert np.abs(cp_g - cp_w).max() <= 2e-3


@pytest.mark.parametrize("kind,extra", [
    ("translation", []), ("rotating", []), ("kgon", []),
    ("translation", ["--prune_sigma", "6"]),
])
def test_movelabel_threefry_matches_jax(tmp_path, kind, extra):
    fields = (_poly_fields(32, 3) if kind == "kgon"
              else _rect_fields(32, 4, kind == "rotating"))
    np.savez(tmp_path / "in.npz", **fields)
    io = ["--data_in", str(tmp_path / "in.npz"), "--seed", "11", *CAP, *extra]
    assert jcli.main(["movelabel", *io, "--data_out", str(tmp_path / "jax.npz"),
                      "--impl", "jnp"]) == 0
    assert tcli.main(["movelabel", *io, "--data_out", str(tmp_path / "port.npz"),
                      "--device", "cpu", "--impl", "threefry"]) == 0
    want = _outputs(tmp_path / "jax.npz")
    _assert_close_labels(_outputs(tmp_path / "port.npz"), want)
    assert 0 < want[0].mean() < 1 and want[2].any()


@pytest.mark.parametrize("kind,impl", [("translation", "auto"), ("kgon", "auto"),
                                       ("rotating", "threefry")])
def test_prune_keeps_rows_bitwise(tmp_path, kind, impl):
    fields = (_poly_fields(40, 5, scale=2.0) if kind == "kgon"
              else _rect_fields(40, 6, kind == "rotating"))
    np.savez(tmp_path / "in.npz", **fields)
    outs = {}
    for name, extra in (("full", []), ("pruned", ["--prune_sigma", "2"])):
        assert tcli.main(["movelabel", "--device", "cpu", "--data_in",
                          str(tmp_path / "in.npz"), "--data_out",
                          str(tmp_path / f"{name}.npz"), "--seed", "5", "--impl", impl,
                          "--max_samples", "4000", *extra]) == 0
        outs[name] = _outputs(tmp_path / f"{name}.npz")
    cfgs, robot = tcli.movelabel_inputs(str(tmp_path / "in.npz"),
                                        tcli.parse_args(["movelabel", "--data_in", "x",
                                                         "--data_out", "y"]), "cpu")
    keep = possible_collision_mask(cfgs, robot, 2.0).numpy()
    assert 0 < keep.mean() < 1
    for got, want in zip(outs["pruned"], outs["full"]):
        np.testing.assert_array_equal(got[keep], want[keep])
    assert (outs["pruned"][0][~keep] == 0).all() and outs["pruned"][2][~keep].all()
    cp, n_used, _ = outs["full"]
    assert np.isfinite(cp).all() and (cp >= 0).all() and (cp <= 1).all()
    assert (n_used > 0).all() and (n_used <= 4096).all()


def test_motion_reach_in_the_prune_mask():
    # statically far, but the motion covers it: kept; out of reach: pruned
    f = _rect_fields(3, 7, rotating=False)
    f["position"] = np.array([[40.0, 0.0], [400.0, 400.0], [3.0, 0.0]], np.float32)
    f["velocity"] = np.array([[-10.0, 0.0], [0.0, 0.0], [0.0, 0.0]], np.float32)
    f["t_max"] = np.array([4.0, 1.0, 1.0], np.float32)
    cfgs = moving_configs_from_numpy(
        [f[k] for k in ("position", "pose_theta", "obstacle_wh", "std_dev",
                        "velocity")] + [np.zeros(3, np.float32), f["t_max"]], "cpu")
    want = np.asarray(j_possible_collision_mask(
        jmoving.moving_configs(*(a.numpy() for a in cfgs)), ROBOT, 6.0))
    got = possible_collision_mask(cfgs, ROBOT, 6.0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [True, False, True])


@pytest.mark.parametrize("kind,rotating,impl,want", [
    ("rect", False, "auto", ("cuda", 0)),
    ("rect", False, "threefry", ("threefry", 0)),
    ("rect", True, "auto", ("threefry", 48)),
    ("rect", True, "cuda", ("cuda", 48)),
    ("rect", True, "threefry", ("threefry", 48)),
    ("kgon", False, "auto", ("cuda", 0)),
    ("kgon", False, "cuda", ("cuda", 0)),
    ("kgon", False, "threefry", ("threefry", 0)),
    ("kgon", True, "auto", ("threefry", 48)),
    ("kgon", True, "threefry", ("threefry", 48)),
])
def test_auto_resolution(kind, rotating, impl, want):
    if kind == "rect":
        cfgs = moving_configs_from_numpy(
            [_rect_fields(8, 8, True)[k] for k in ("position", "pose_theta",
                                                   "obstacle_wh", "std_dev",
                                                   "velocity", "omega", "t_max")], "cpu")
    else:
        f = _poly_fields(8, 8, rotating=True)
        cfgs = moving_polygon_configs_from_numpy(
            [f[k] for k in ("position", "pose_theta", "obstacle_verts", "std_dev",
                            "velocity", "omega", "t_max")], "cpu")
    if not rotating:
        cfgs = cfgs._replace(omega=torch.zeros_like(cfgs.omega))
    got, (ca_iters, _) = _resolve_trajectory(cfgs, AdaptiveConfig(impl=impl))
    assert (got, ca_iters) == want


def test_cuda_on_rotating_kgons_exits_with_jax_message(tmp_path, capsys):
    np.savez(tmp_path / "in.npz", **_poly_fields(8, 9, rotating=True))
    with pytest.raises(SystemExit, match="supports only translation-only"):
        tcli.main(["movelabel", "--device", "cpu", "--data_in", str(tmp_path / "in.npz"),
                   "--data_out", str(tmp_path / "o.npz"), "--impl", "cuda"])
    assert not (tmp_path / "o.npz").exists()
    still = moving_polygon_configs_from_numpy(
        [*jm.example_polygon_configs(4), np.zeros((4, 2)), np.zeros(4), np.ones(4)],
        "cpu")
    with pytest.raises(ValueError, match="TRANSLATION-ONLY"):
        mc_round(prng.PRNGKey(0), torch.arange(4, dtype=torch.int32), still,
                 ROBOT_4GON, 0, n_batch=64, impl="cuda")


def test_kernel_paths_on_cpu_never_launch(tmp_path):
    mc_toi_cuda.reset_launches()
    mc_moving_polygon_cuda.reset_launches()
    for name, fields in (("r", _rect_fields(16, 10, False)), ("p", _poly_fields(16, 10))):
        np.savez(tmp_path / f"{name}.npz", **fields)
        assert tcli.main(["movelabel", "--device", "cpu", "--data_in",
                          str(tmp_path / f"{name}.npz"), "--data_out",
                          str(tmp_path / "o.npz"), "--seed", "1", *CAP]) == 0
    assert mc_toi_cuda.LAUNCHES == 0 and mc_moving_polygon_cuda.LAUNCHES == 0


def test_rect_model_trajectory_entry_points_match_jax():
    f = _rect_fields(24, 12, rotating=True)
    names = ("position", "pose_theta", "obstacle_wh", "std_dev", "velocity", "omega",
             "t_max")
    jc = jmoving.moving_configs(*(f[k] for k in names))
    tc = moving_configs_from_numpy([f[k] for k in names], "cpu")
    want = np.asarray(jm.CollisionProbabilityModel(ROBOT).trajectory_probability(
        jax.random.PRNGKey(2), jc, 1024))
    got = tm.CollisionProbabilityModel(ROBOT).trajectory_probability(
        prng.PRNGKey(2), tc, 1024).numpy()
    assert (got != want).sum() <= 2 and np.abs(got - want).max() <= 2e-3
    want = jm.CollisionProbabilityModel(ROBOT).label(
        jax.random.PRNGKey(4), jc, JAdaptiveConfig(impl="jnp", max_samples=4000))
    got = tm.CollisionProbabilityModel(ROBOT).label(
        prng.PRNGKey(4), tc, AdaptiveConfig(impl="threefry", max_samples=4000))
    _assert_close_labels(got, want)


def test_polygon_model_trajectory_entry_points_match_jax():
    f = _poly_fields(24, 13)
    names = ("position", "pose_theta", "obstacle_verts", "std_dev", "velocity")
    jc = jmoving.moving_polygon_configs(*(f[k] for k in names), 0.0, f["t_max"])
    tc = moving_polygon_configs_from_numpy(list(jc), "cpu")
    jmodel = jm.PolygonCollisionProbabilityModel(ROBOT_4GON)
    tmodel = tm.PolygonCollisionProbabilityModel(ROBOT_4GON)
    want = np.asarray(jmodel.trajectory_probability(jax.random.PRNGKey(2), jc, 1024))
    got = tmodel.trajectory_probability(prng.PRNGKey(2), tc, 1024).numpy()
    assert (got != want).sum() <= 1 and np.abs(got - want).max() <= 1e-3
    want = jmodel.label(jax.random.PRNGKey(4), jc,
                        JAdaptiveConfig(impl="jnp", max_samples=4000))
    got = tmodel.label(prng.PRNGKey(4), tc,
                       AdaptiveConfig(impl="threefry", max_samples=4000))
    _assert_close_labels(got, want)
    # the kernel path (kernel 14's plain version) labels within the cap
    cp, n_used, _ = tmodel.label(prng.PRNGKey(4), tc, AdaptiveConfig(max_samples=4000))
    assert np.isfinite(cp).all() and (n_used <= 4096).all()


@pytest.mark.parametrize("flags,name", [
    (["--data_parallel"], "--data_parallel"),
    (["--sample_parallel", "2"], "--sample_parallel"),
    (["--schedule", "opt"], "--schedule"),
])
def test_unported_movelabel_flags_fail_loudly(tmp_path, capsys, flags, name):
    """The multi-device flags run (--data_parallel over the one CPU device:
    the labels of a run without it; --sample_parallel 2 with one device:
    JAX's "needs that many devices" exit, nothing written); --schedule opt
    stays an argparse error."""
    np.savez(tmp_path / "in.npz", **_rect_fields(4, 14, False))
    cmd = ["movelabel", "--device", "cpu", "--data_in", str(tmp_path / "in.npz"),
           "--seed", "3", "--max_samples", "2000"]
    if name == "--data_parallel":
        assert tcli.main([*cmd, "--data_out", str(tmp_path / "ref.npz")]) == 0
        assert tcli.main([*cmd, "--data_out", str(tmp_path / "out.npz"), *flags]) == 0
        with np.load(tmp_path / "ref.npz") as ref, np.load(tmp_path / "out.npz") as out:
            for f in ("cp", "n_samples", "converged"):
                np.testing.assert_array_equal(out[f], ref[f])
        return
    with pytest.raises(SystemExit) as e:
        tcli.main([*cmd, "--data_out", str(tmp_path / "out.npz"), *flags])
    assert e.value.code != 0
    if name == "--sample_parallel":
        assert "needs that many devices, have 1" in str(e.value.code)
    else:
        assert name in capsys.readouterr().err
    assert not (tmp_path / "out.npz").exists()


def test_movelabel_reports_a_missing_field(tmp_path):
    f = _rect_fields(4, 15, rotating=False)
    del f["obstacle_wh"]
    np.savez(tmp_path / "bad.npz", **f)
    with pytest.raises(SystemExit, match="obstacle_wh"):
        tcli.main(["movelabel", "--device", "cpu", "--data_in",
                   str(tmp_path / "bad.npz"), "--data_out", str(tmp_path / "o.npz")])
    f = _poly_fields(4, 15)
    del f["robot_verts"]
    np.savez(tmp_path / "bad.npz", **f)
    with pytest.raises(SystemExit, match="robot_verts"):
        tcli.main(["movelabel", "--device", "cpu", "--data_in",
                   str(tmp_path / "bad.npz"), "--data_out", str(tmp_path / "o.npz")])
