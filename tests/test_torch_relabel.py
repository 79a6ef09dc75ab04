"""`relabel`, ``--prune_sigma`` and ``--schedule opt`` of the port against
the JAX package.

(a) `relabel` with the threefry impl against JAX's ``relabel --impl jnp``
    on a small generated dataset: equal files (rows in input order,
    numbering after the existing batches).
(b) pruning: the JAX prune contract (tests/test_mc.py) on the port, on
    both impls; pruned adaptive labels and a pruned ``generate`` equal
    the JAX ones (threefry) and the unpruned run on every kept row.
(c) ``--schedule opt``: `mc.schedule_sim` equal to JAX's on the same cp
    array, and ``generate`` / ``relabel`` with ``opt`` equal to JAX's.
(d) the flags that stay unported still fail loudly; ztest rejects opt.
Tolerance: bitwise.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

import collide2d_tpu.cli as jcli
from collide2d_tpu.mc import estimator as jest
from collide2d_tpu.mc import schedule_sim as jsim
from collide2d_tpu.ops.broad_phase import possible_collision_mask as jmask
from collide2d_tpu.utils.benchmarks import _sparse_scene_configs
from collide2d_tpu_torch import cli as tcli
from collide2d_tpu_torch.mc import schedule_sim as tsim
from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities
from collide2d_tpu_torch.mc.estimator import AdaptiveConfig, configs_from_numpy
from collide2d_tpu_torch.ops.broad_phase import possible_collision_mask
from collide2d_tpu_torch.utils import native

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ROBOT = (4.07, 1.74)
SMALL = ["--num_poses", "16", "--num_variances", "16", "--max_samples", "4000",
         "--verbose", "false"]
COMMON = ["-n", "2", "-b", "128", "--seed", "5", *SMALL]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A JAX-generated dataset, its (N, 4) relabel input and an output
    directory template holding its tables and meta."""
    root = tmp_path_factory.mktemp("relabel")
    data = root / "data"
    assert jcli.main(["generate", "--impl", "jnp", "--data_dir", str(data),
                      *COMMON]) == 0
    inp = root / "in"
    inp.mkdir()
    for i in range(2):
        rows = np.load(data / f"{i}.npy")
        np.save(inp / f"{i}.npy", rows[:, [0, 1, 3, 4]].astype(np.float32))
    return data, inp


def _out_dir(dataset, path, existing: int = 0):
    """An output directory with the dataset's tables and meta, plus
    ``existing`` batches already in it."""
    data, _ = dataset
    path.mkdir()
    for name in ("poses.npy", "variances.npy"):
        shutil.copy(data / name, path / name)
    shutil.copytree(data / "meta", path / "meta")
    for i in range(existing):
        shutil.copy(data / f"{i}.npy", path / f"{i}.npy")
    return path


RELABEL = ["--max_samples", "4000", "--seed", "9", "--verbose", "false"]


# The opt schedule tests convergence every 64 samples early on, and each
# threefry round costs the CPU tens of milliseconds: its case is smaller.
@pytest.mark.parametrize("schedule,cap,rows", [("reference", "4000", 128),
                                               ("opt", "2000", 32)])
def test_relabel_threefry_matches_jax(dataset, tmp_path, schedule, cap, rows):
    _, full_inp = dataset
    inp = tmp_path / "in"
    inp.mkdir()
    batches = 2 if rows == 128 else 1
    for i in range(batches):
        np.save(inp / f"{i}.npy", np.load(full_inp / f"{i}.npy")[:rows])
    theirs = _out_dir(dataset, tmp_path / "jax")
    ours = _out_dir(dataset, tmp_path / "port")
    args = ["--data_in", str(inp), "--shuffle", "false", "--schedule", schedule,
            *RELABEL, "--max_samples", cap]
    assert jcli.main(["relabel", "--impl", "jnp", "--data_out", str(theirs),
                      *args]) == 0
    assert tcli.main(["relabel", "--impl", "threefry", "--device", "cpu",
                      "--data_out", str(ours), *args]) == 0
    for i in range(batches):
        a, b = np.load(ours / f"{i}.npy"), np.load(theirs / f"{i}.npy")
        assert a.shape == (rows, 5) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        # input order kept: every column but cp is the input's
        np.testing.assert_array_equal(a[:, [0, 1, 3, 4]], np.load(inp / f"{i}.npy"))
    assert not (ours / f"{batches}.npy").exists()


def test_relabel_numbering_shuffle_and_kernel_path(dataset, tmp_path):
    data, inp = dataset
    out = _out_dir(dataset, tmp_path / "out", existing=2)
    assert tcli.main(["relabel", "--device", "cpu", "--data_in", str(inp),
                      "--data_out", str(out), "--shuffle", "true",
                      *RELABEL]) == 0
    for i in range(2):
        # numbering continues after the two batches already there
        np.testing.assert_array_equal(np.load(out / f"{i}.npy"),
                                      np.load(data / f"{i}.npy"))
        rows = np.load(out / f"{2 + i}.npy")
        assert rows.shape == (128, 5) and np.isfinite(rows).all()
        assert (rows[:, 2] >= 0).all() and (rows[:, 2] <= 1).all()
        # shuffled with the reference's seed-0 engine: the port's own
        # libstdc++ build (without it the permutation would be numpy's)
        assert native.available()
        perm = native.std_shuffle_perm(128, 0)
        np.testing.assert_array_equal(rows[:, [0, 1, 3, 4]],
                                      np.load(inp / f"{i}.npy")[perm])
    assert not (out / "4.npy").exists()


@pytest.fixture(scope="module")
def sparse():
    c = _sparse_scene_configs(256, box=20.0, seed=11)
    return c, configs_from_numpy(c, "cpu")


PRUNE_KW = dict(max_samples=4000, initial_batch=1000, initial_phase_samples=2000,
                later_batch=2000, bin_accuracy=(0.02, 0.02, 0.05), min_active=16)
KEY = np.asarray(jax.random.key_data(jax.random.PRNGKey(2)))


@pytest.mark.parametrize("impl", ["cuda", "threefry"])
def test_adaptive_prune_sigma_contract(sparse, impl):
    # tests/test_mc.py::test_adaptive_prune_sigma on the port: pruned rows
    # emit cp 0 with zero samples and count as done; kept rows equal the
    # unpruned run bit for bit (uid-keyed streams on both impls).
    _, cfgs = sparse
    base_cp, base_n, _ = adaptive_collision_probabilities(
        KEY, cfgs, ROBOT, AdaptiveConfig(impl=impl, **PRUNE_KW))
    cp, n_used, done = adaptive_collision_probabilities(
        KEY, cfgs, ROBOT, AdaptiveConfig(impl=impl, prune_sigma=6.0, **PRUNE_KW))
    mask = possible_collision_mask(cfgs, ROBOT, 6.0).numpy()
    assert 0 < mask.sum() < len(mask)
    np.testing.assert_array_equal(cp[mask], base_cp[mask])
    np.testing.assert_array_equal(n_used[mask], base_n[mask])
    assert (cp[~mask] == 0).all() and (n_used[~mask] == 0).all()
    assert done[~mask].all()
    np.testing.assert_array_equal(base_cp[~mask], 0)


def test_adaptive_prune_matches_jax(sparse):
    jc, tc = sparse
    want = jest.adaptive_collision_probabilities(
        jax.random.PRNGKey(2), jc, np.asarray(ROBOT, np.float32),
        jest.AdaptiveConfig(impl="jnp", prune_sigma=6.0, **PRUNE_KW))
    got = adaptive_collision_probabilities(
        KEY, tc, ROBOT, AdaptiveConfig(impl="threefry", prune_sigma=6.0, **PRUNE_KW))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(
        possible_collision_mask(tc, ROBOT, 6.0).numpy(),
        np.asarray(jmask(jc, np.asarray(ROBOT, np.float32), 6.0)))


def test_everything_pruned_labels_zero():
    far = _sparse_scene_configs(64, box=20.0, seed=3)
    far = far._replace(position=np.asarray(far.position) + 100.0)
    cp, n_used, done = adaptive_collision_probabilities(
        KEY, configs_from_numpy(far, "cpu"), ROBOT,
        AdaptiveConfig(prune_sigma=6.0, **PRUNE_KW))
    assert (cp == 0).all() and (n_used == 0).all() and done.all()


@pytest.mark.parametrize("impl", ["cuda", "threefry"])
def test_generate_prune_keeps_candidates_bitwise(tmp_path, impl):
    args = ["generate", "--device", "cpu", "--impl", impl, "--no_shuffle",
            *COMMON]
    assert tcli.main([*args, "--data_dir", str(tmp_path / "full")]) == 0
    assert tcli.main([*args, "--data_dir", str(tmp_path / "pruned"),
                      "--prune_sigma", "2"]) == 0
    poses = np.load(tmp_path / "full" / "poses.npy")
    sds = np.sqrt(np.load(tmp_path / "full" / "variances.npy"))
    pruned_total = 0
    for i in range(2):
        full = np.load(tmp_path / "full" / f"{i}.npy")
        pruned = np.load(tmp_path / "pruned" / f"{i}.npy")
        np.testing.assert_array_equal(pruned[:, [0, 1, 3, 4]], full[:, [0, 1, 3, 4]])
        pose = poses[full[:, 4].astype(np.int64)]
        cfgs = configs_from_numpy((full[:, :2], pose[:, 2], pose[:, :2],
                                   sds[full[:, 3].astype(np.int64)]), "cpu")
        keep = possible_collision_mask(cfgs, ROBOT, 2.0).numpy()
        np.testing.assert_array_equal(pruned[keep], full[keep])
        assert (pruned[~keep, 2] == 0).all()
        pruned_total += int((~keep).sum())
    assert pruned_total > 0


def test_generate_prune_threefry_matches_jax(tmp_path):
    extra = ["--prune_sigma", "2", "--no_shuffle"]
    assert jcli.main(["generate", "--impl", "jnp", "--data_dir",
                      str(tmp_path / "jax"), *COMMON, *extra]) == 0
    assert tcli.main(["generate", "--impl", "threefry", "--device", "cpu",
                      "--data_dir", str(tmp_path / "port"), *COMMON, *extra]) == 0
    for i in range(2):
        a = np.load(tmp_path / "port" / f"{i}.npy")
        b = np.load(tmp_path / "jax" / f"{i}.npy")
        np.testing.assert_array_equal(a[:, 2:], b[:, 2:])


def test_generate_opt_threefry_matches_jax(tmp_path, capsys):
    # Small for the reason given at test_relabel_threefry_matches_jax.
    common = ["-n", "1", "-b", "32", "--seed", "5", "--num_poses", "16",
              "--num_variances", "16", "--max_samples", "2000",
              "--schedule", "opt", "--no_shuffle"]  # verbose: logs the schedule
    assert jcli.main(["generate", "--impl", "jnp", "--data_dir",
                      str(tmp_path / "jax"), *common]) == 0
    jlog = capsys.readouterr().out
    assert tcli.main(["generate", "--impl", "threefry", "--device", "cpu",
                      "--data_dir", str(tmp_path / "port"), *common]) == 0
    tlog = capsys.readouterr().out
    def points(log):  # the checkpoint list the opt line prints
        line = [ln for ln in log.splitlines() if ln.startswith("opt schedule")]
        assert len(line) == 1
        return line[0].split("probe: ")[1]

    assert points(tlog) == points(jlog)
    a = np.load(tmp_path / "port" / "0.npy")
    b = np.load(tmp_path / "jax" / "0.npy")
    np.testing.assert_array_equal(a[:, 2:], b[:, 2:])


@pytest.fixture(scope="module")
def cp_mix():
    rng = np.random.default_rng(0)
    return np.concatenate([np.zeros(3000), rng.uniform(0, 0.02, 600),
                           rng.uniform(0, 1, 400), np.ones(50)])


@pytest.mark.parametrize("schedule", [None, "tuned", (1000, 5000, 40000)])
def test_schedule_sim_matches_jax(cp_mix, schedule):
    tcfg = AdaptiveConfig(max_samples=400_000, schedule=schedule)
    jcfg = jest.AdaptiveConfig(max_samples=400_000, schedule=schedule)
    np.testing.assert_array_equal(tsim.round_boundaries(tcfg),
                                  jsim.round_boundaries(jcfg, impl="pallas"))
    t_frozen = tsim.simulate_convergence(cp_mix, tcfg, seed=1)
    np.testing.assert_array_equal(
        t_frozen, jsim.simulate_convergence(cp_mix, jcfg, seed=1, impl="pallas"))
    assert tsim.simulate_schedule(t_frozen, tcfg) == jsim.simulate_schedule(
        t_frozen, jcfg, impl="pallas")


def test_optimize_checkpoints_matches_jax(cp_mix):
    for cap in (400_000, 4_000_000):
        tcfg = AdaptiveConfig(max_samples=cap)
        jcfg = jest.AdaptiveConfig(max_samples=cap)
        t_min, t_grid = tsim.min_convergence_points(cp_mix, tcfg, seed=0)
        j_min, j_grid = jsim.min_convergence_points(cp_mix, jcfg, seed=0)
        np.testing.assert_array_equal(t_min, j_min)
        np.testing.assert_array_equal(t_grid, j_grid)
        pts = tsim.optimize_checkpoints(t_min, tcfg)
        assert pts == jsim.optimize_checkpoints(j_min, jcfg)
        assert 0 < len(pts) <= 24 and all(p < cap for p in pts)
        thin = tsim.optimize_checkpoints(t_min, tcfg, max_checkpoints=3)
        assert thin == jsim.optimize_checkpoints(j_min, jcfg, max_checkpoints=3)


def test_ztest_rejects_opt_schedule(dataset, tmp_path):
    data, inp = dataset
    with pytest.raises(ValueError, match="fixed cadence"):
        tcli.main(["ztest", "--device", "cpu", "--data_dir", str(data),
                   "--data_file_in", str(inp / "0.npy"), "--data_file_out",
                   str(tmp_path / "cps.npy"), "--schedule", "opt",
                   "--verbose", "false"])
    assert not (tmp_path / "cps.npy").exists()


@pytest.mark.parametrize("flags,name", [
    (["--resume"], "--resume"),
    (["--checkpoint_every", "4"], "--checkpoint_every"),
    (["--trace_dir", "t"], "--trace_dir"),
    (["--data_parallel"], "--data_parallel"),
    (["--sample_parallel", "2"], "--sample_parallel"),
])
def test_unported_relabel_flags_fail_loudly(tmp_path, capsys, flags, name):
    with pytest.raises(SystemExit) as e:
        tcli.main(["relabel", "--device", "cpu", "--data_in", str(tmp_path),
                   "--data_out", str(tmp_path / "out"), *flags])
    assert e.value.code != 0
    assert name in capsys.readouterr().err
    assert not (tmp_path / "out").exists()  # nothing ran
