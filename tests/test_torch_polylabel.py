"""The k-gon slice end to end on the CPU: ``collide2d-torch polylabel``
against the JAX package's ``collide2d polylabel``.

- ``polylabel --device cpu --impl threefry`` reads the same ``.npz`` as
  JAX's ``polylabel --impl jnp`` (vertex mask included) and writes the
  same ``cp``, ``n_samples`` and ``converged`` (a count may differ only for
  a draw within an ulp of a separation boundary: at most 1 row in 100
  may differ, by at most 1e-3 in cp), with and without ``--prune_sigma``.
- The default path (the fused kernel's plain version on a CPU device)
  writes finite cp in [0, 1] within the cap, and its pruned run keeps
  every candidate row's label bit for bit.
- `PolygonCollisionProbabilityModel.forward`, `forward_pruned` and
  `label` agree with the JAX model on pinned seeds (same tolerance).
- `PolygonConfigs.from_padded` rewrites masked slots as JAX does.
- Flags of features the port lacks exit naming the flag.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import collide2d_tpu.cli as jcli
from collide2d_tpu.mc.estimator import AdaptiveConfig as JAdaptiveConfig
from collide2d_tpu.mc.estimator import PolygonConfigs as JPolygonConfigs
from collide2d_tpu.models import collision_model as jm
from collide2d_tpu_torch import cli as tcli
from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.estimator import (
    AdaptiveConfig,
    PolygonConfigs,
    polygon_configs_from_numpy,
)
from collide2d_tpu_torch.models import collision_model as tm
from collide2d_tpu_torch.ops import mc_polygon_cuda
from collide2d_tpu_torch.ops.broad_phase import possible_collision_mask

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ROBOT = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87],
                  [-2.035, 0.87]], np.float32)
CAP = ["--max_samples", "20000"]  # the initial phase only: 20 rounds of 1000


def _npz(path, n=48, k=5, seed=3, masked=False, scale=0.6):
    """A polylabel input: `example_polygon_configs` rows with positions
    scaled by ``scale`` (0.6 pulls them towards the obstacle, so cp spans
    0 to 1); with ``masked``, some rows are triangles padded with garbage
    behind a vertex mask."""
    b = jm.example_polygon_configs(n=n, k=k, seed=seed)
    fields = dict(obstacle_verts=np.asarray(b.obstacle_verts),
                  position=np.asarray(b.position) * scale,
                  pose_theta=np.asarray(b.pose_theta),
                  std_dev=np.asarray(b.std_dev), robot_verts=ROBOT)
    if masked:
        mask = np.ones((n, k), bool)
        mask[::3, 3:] = False
        fields["obstacle_verts"] = np.where(mask[..., None], fields["obstacle_verts"],
                                            7.0).astype(np.float32)
        fields["mask"] = mask
    np.savez(path, **fields)
    return path


def _outputs(path):
    with np.load(path) as d:
        return d["cp"], d["n_samples"], d["converged"]


def _assert_close_labels(got, want):
    cp_g, n_g, c_g = got
    cp_w, n_w, c_w = want
    assert cp_g.dtype == cp_w.dtype and cp_g.shape == cp_w.shape
    differ = (cp_g != cp_w) | (n_g != n_w) | (c_g != c_w)
    assert differ.sum() <= max(1, cp_w.size // 100)
    assert np.abs(cp_g - cp_w).max() <= 1e-3


@pytest.mark.parametrize("extra,masked", [([], True), (["--prune_sigma", "6"], False)])
def test_polylabel_threefry_matches_jax(tmp_path, extra, masked):
    data = _npz(tmp_path / "in.npz", masked=masked)
    assert jcli.main(["polylabel", "--data_in", str(data), "--data_out",
                      str(tmp_path / "jax.npz"), "--impl", "jnp", "--seed", "11",
                      *CAP, *extra]) == 0
    assert tcli.main(["polylabel", "--device", "cpu", "--data_in", str(data),
                      "--data_out", str(tmp_path / "port.npz"), "--impl",
                      "threefry", "--seed", "11", *CAP, *extra]) == 0
    want = _outputs(tmp_path / "jax.npz")
    _assert_close_labels(_outputs(tmp_path / "port.npz"), want)
    assert 0 < want[0].mean() < 1 and want[2].any()


def test_polylabel_kernel_path_and_prune_keep_rows(tmp_path, capsys):
    data = _npz(tmp_path / "in.npz", n=64, k=6, seed=4, scale=1.0)
    outs = {}
    for name, extra in (("full", []), ("pruned", ["--prune_sigma", "3"])):
        assert tcli.main(["polylabel", "--device", "cpu", "--data_in", str(data),
                          "--data_out", str(tmp_path / f"{name}.npz"), "--seed",
                          "5", *CAP, *extra]) == 0
        outs[name] = _outputs(tmp_path / f"{name}.npz")
    assert "labeled 64 configurations" in capsys.readouterr().out
    cp, n_used, done = outs["full"]
    assert np.isfinite(cp).all() and (cp >= 0).all() and (cp <= 1).all()
    # the kernel path rounds each 1000-sample round up to its 64-sample granule
    assert (n_used > 0).all() and (n_used <= 20 * 1024).all()
    with np.load(data) as d:
        cfgs = PolygonConfigs.from_padded(d["position"], d["pose_theta"],
                                          d["obstacle_verts"], d["std_dev"])
    keep = possible_collision_mask(cfgs, ROBOT, 3.0).numpy()
    assert 0 < keep.mean() < 1
    for got, want in zip(outs["pruned"], outs["full"]):
        np.testing.assert_array_equal(got[keep], want[keep])
    assert (outs["pruned"][0][~keep] == 0).all() and outs["pruned"][2][~keep].all()


def test_kernel_path_on_cpu_never_launches(tmp_path):
    mc_polygon_cuda.reset_launches()
    data = _npz(tmp_path / "in.npz", n=16)
    tcli.main(["polylabel", "--device", "cpu", "--data_in", str(data),
               "--data_out", str(tmp_path / "o.npz"), "--seed", "1", *CAP])
    assert mc_polygon_cuda.LAUNCHES == 0


@pytest.fixture(scope="module")
def model_case():
    b = jm.example_polygon_configs(n=32, k=5, seed=6)
    b = b._replace(position=b.position * 0.6)
    return b, polygon_configs_from_numpy(b, "cpu")


def test_model_forward_and_pruned_match_jax(model_case):
    b, t = model_case
    jmodel = jm.PolygonCollisionProbabilityModel(ROBOT)
    tmodel = tm.PolygonCollisionProbabilityModel(ROBOT)
    want = np.asarray(jmodel.forward(jax.random.PRNGKey(2), b, 1024))
    got = tmodel.forward(prng.PRNGKey(2), t, 1024).numpy()
    assert (got != want).sum() <= 1 and np.abs(got - want).max() <= 1e-3
    want = np.asarray(jmodel.forward_pruned(jax.random.PRNGKey(2), b, 1024,
                                            sigma_margin=2.0))
    got = tmodel.forward_pruned(prng.PRNGKey(2), t, 1024, sigma_margin=2.0)
    assert (got != want).sum() <= 1 and np.abs(got - want).max() <= 1e-3
    assert (want == 0).any() and (want > 0).any()


def test_model_label_matches_jax(model_case):
    b, t = model_case
    want = jm.PolygonCollisionProbabilityModel(ROBOT).label(
        jax.random.PRNGKey(4), b, JAdaptiveConfig(impl="jnp", max_samples=8000))
    got = tm.PolygonCollisionProbabilityModel(ROBOT).label(
        prng.PRNGKey(4), t, AdaptiveConfig(impl="threefry", max_samples=8000))
    _assert_close_labels(got, want)


def test_from_padded_matches_jax_and_validates():
    rng = np.random.default_rng(7)
    verts = rng.uniform(-2, 2, (10, 6, 2)).astype(np.float32)
    mask = np.arange(6)[None] < rng.integers(1, 7, (10, 1))
    args = (rng.uniform(-5, 5, (10, 2)), rng.uniform(0, 6, 10), verts,
            rng.uniform(0, 0.3, (10, 3)))
    want = JPolygonConfigs.from_padded(*map(jnp.asarray, args), mask=jnp.asarray(mask))
    got = PolygonConfigs.from_padded(*args, mask=mask, device="cpu")
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    with pytest.raises(ValueError, match="std_dev"):
        PolygonConfigs.from_padded(args[0], args[1], verts, np.zeros((10, 5)))


@pytest.mark.parametrize("flags,name", [
    (["--checkpoint_every", "-1"], "--checkpoint_every"),
    (["--data_parallel"], "--data_parallel"),
    (["--sample_parallel", "2"], "--sample_parallel"),
    (["--schedule", "opt"], "--schedule"),
])
def test_unported_polylabel_flags_fail_loudly(tmp_path, capsys, flags, name):
    """--data_parallel runs (over the one CPU device: the labels of a run
    without it); --sample_parallel 2 with one device exits as JAX's CLI
    does; a negative --checkpoint_every and --schedule opt stay argparse
    errors. Nothing is written by a refused command."""
    data = _npz(tmp_path / "in.npz", n=8)
    cmd = ["polylabel", "--device", "cpu", "--data_in", str(data), "--seed", "3",
           "--max_samples", "2000"]
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
    assert not (tmp_path / "out.npz").exists()  # nothing ran


def test_polylabel_reports_a_missing_field(tmp_path):
    np.savez(tmp_path / "bad.npz", position=np.zeros((4, 2), np.float32))
    with pytest.raises(SystemExit, match="obstacle_verts"):
        tcli.main(["polylabel", "--device", "cpu", "--data_in",
                   str(tmp_path / "bad.npz"), "--data_out", str(tmp_path / "o.npz")])
