"""The port's `generate` / `ztest` / `compare` CLI against the JAX package.

(a) threefry impl vs JAX ``--impl jnp`` at the same seed: tables and meta
    byte-identical, index columns exact, positions within 2 ulp at the
    ring's scale, and at least 99% of cp values identical.
(b) the default impl (the fused kernel's plain version on the CPU) vs
    JAX: same configurations; labels agree by per-row z-scores (mean z^2
    in [0.75, 1.33], max |z| < 6, rows where both are 0 or both 1
    skipped). Accuracy targets too tight to converge before the cap keep
    every row at exactly max_samples, so the z-scores use one n.
(c) ``--overlap_batches 1`` and ``3`` give bitwise-equal files.
(d) ztest + compare run end to end (exit 0).
(e) importing the port leaves jax out of sys.modules.
(f) flags of unported features fail loudly, naming the flag.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import collide2d_tpu.cli as jcli
from collide2d_tpu_torch import cli as tcli

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

RING_ULP = 2.0**-20
COMMON = ["-n", "2", "-b", "128", "--num_poses", "16", "--num_variances", "16",
          "--max_samples", "4000", "--seed", "5", "--verbose", "false"]


def _port(tmp, name, *extra):
    out = tmp / name
    assert tcli.main(["generate", "--device", "cpu", "--data_dir", str(out),
                      *COMMON, *extra]) == 0
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "data"
    assert jcli.main(["generate", "--impl", "jnp", "--data_dir", str(out), *COMMON]) == 0
    return out


@pytest.fixture(scope="module")
def port_threefry(tmp_path_factory):
    return _port(tmp_path_factory.mktemp("tf"), "data", "--impl", "threefry")


@pytest.fixture(scope="module")
def port_default(tmp_path_factory):
    return _port(tmp_path_factory.mktemp("def"), "data")


@pytest.mark.parametrize("name", ["poses.npy", "variances.npy",
                                  "meta/accuracy_bins.npy", "meta/bin_accuracy.npy"])
def test_tables_byte_identical(jax_run, port_threefry, name):
    assert (port_threefry / name).read_bytes() == (jax_run / name).read_bytes()


@pytest.mark.parametrize("batch", [0, 1])
def test_threefry_generate_matches_jax_jnp(jax_run, port_threefry, batch):
    a = np.load(port_threefry / f"{batch}.npy")
    b = np.load(jax_run / f"{batch}.npy")
    assert a.shape == b.shape == (128, 5) and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a[:, 3:], b[:, 3:])
    assert np.abs(a[:, :2].astype(np.float64) - b[:, :2]).max() <= 2 * RING_ULP
    same = (a[:, 2] == b[:, 2]).mean()
    print(f"batch {batch}: {same:.2%} of cp values identical")
    assert same >= 0.99


def test_kernel_path_generate_agrees_with_jax(tmp_path):
    tight = ["--bin_accuracy", "1e-6", "1e-6", "1e-6"]
    n = 4000
    ours = _port(tmp_path, "ours", *tight)
    theirs = tmp_path / "jax"
    assert jcli.main(["generate", "--impl", "jnp", "--data_dir", str(theirs),
                      *COMMON, *tight]) == 0
    z_all = []
    for batch in range(2):
        a = np.load(ours / f"{batch}.npy")
        b = np.load(theirs / f"{batch}.npy")
        np.testing.assert_array_equal(a[:, 3:], b[:, 3:])
        pa, pb = a[:, 2].astype(np.float64), b[:, 2].astype(np.float64)
        skip = ((pa == 0) & (pb == 0)) | ((pa == 1) & (pb == 1))
        pa, pb = pa[~skip], pb[~skip]
        pbar = (pa + pb) / 2
        z_all.append((pa - pb) / np.sqrt(pbar * (1 - pbar) * 2 / n))
    z = np.concatenate(z_all)
    print(f"{z.size} rows: mean z^2 {np.mean(z * z):.3f}, max |z| {np.abs(z).max():.2f}")
    assert z.size >= 40
    assert 0.75 <= np.mean(z * z) <= 1.33
    assert np.abs(z).max() < 6


@pytest.mark.parametrize("impl", ["cuda", "threefry"])
def test_overlap_depth_does_not_change_outputs(tmp_path, impl):
    one = _port(tmp_path, "o1", "--impl", impl, "--overlap_batches", "1")
    three = _port(tmp_path, "o3", "--impl", impl, "--overlap_batches", "3")
    for batch in range(2):
        assert (one / f"{batch}.npy").read_bytes() == (three / f"{batch}.npy").read_bytes()


def test_default_generate_artifacts(port_default):
    for batch in range(2):
        rows = np.load(port_default / f"{batch}.npy")
        assert rows.shape == (128, 5) and rows.dtype == np.float32
        assert np.isfinite(rows).all()
        assert (rows[:, 2] >= 0).all() and (rows[:, 2] <= 1).all()
        assert set(np.unique(rows[:, 3])) <= set(np.arange(16.0))
    variances = np.load(port_default / "variances.npy")
    assert (variances[:, 3:] == 0).all()  # shape_variance off


def test_ztest_and_compare_end_to_end(port_default, tmp_path, capsys):
    rows = np.load(port_default / "0.npy")
    inp = tmp_path / "in.npy"
    np.save(inp, rows[:, [0, 1, 3, 4]].astype(np.float32))
    out = tmp_path / "cps.npy"
    assert tcli.main([
        "ztest", "--device", "cpu", "--data_dir", str(port_default),
        "--data_file_in", str(inp), "--data_file_out", str(out),
        "--cps_only", "true", "--max_samples", "4000", "--seed", "9",
        "--verbose", "false"]) == 0
    cps = np.load(out)
    assert cps.shape == (128,) and np.isfinite(cps).all()
    # 4000 samples a row: differences are a few 1e-3, far above the
    # production +-0.005 bar at 4e6 samples, so compare at a tolerance
    # that matches this sample count.
    batch = port_default / "0.npy"
    assert tcli.main(["compare", str(batch), str(out), "--n_samples_a", "4000",
                      "--n_samples_b", "4000", "--tolerance", "0.03"]) == 0
    assert "within +-0.03" in capsys.readouterr().out


def test_import_leaves_jax_out():
    code = ("import sys, collide2d_tpu_torch, collide2d_tpu_torch.cli, "
            "collide2d_tpu_torch.ops.mc_cuda, collide2d_tpu_torch.data.pipeline, "
            "collide2d_tpu_torch.data.balance, collide2d_tpu_torch.data.visualize, "
            "collide2d_tpu_torch.models.learned, collide2d_tpu_torch.parallel; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'optax' not in sys.modules, 'optax imported'; "
            "assert 'collide2d_tpu' not in sys.modules, 'collide2d_tpu imported'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("flags,name", [
    (["--data_parallel"], "--data_parallel"),
    (["--trace_dir", "t"], "--trace_dir"),
])
def test_unported_generate_flags_fail_loudly(tmp_path, flags, name):
    """Both flags run now: --data_parallel over the one CPU device is no
    mesh and writes the bytes of a run without it; --trace_dir leaves a
    non-empty torch.profiler trace beside the same bytes."""
    cmd = ["generate", "--device", "cpu", "-n", "1", "-b", "64", "--num_poses", "8",
           "--num_variances", "8", "--max_samples", "2000", "--seed", "5",
           "--verbose", "false"]
    assert tcli.main([*cmd, "--data_dir", str(tmp_path / "ref")]) == 0
    if name == "--trace_dir":
        flags = ["--trace_dir", str(tmp_path / "t")]
    assert tcli.main([*cmd, "--data_dir", str(tmp_path / "out"), *flags]) == 0
    assert ((tmp_path / "out" / "0.npy").read_bytes()
            == (tmp_path / "ref" / "0.npy").read_bytes())
    if name == "--trace_dir":
        traces = list((tmp_path / "t").glob("trace_*.json"))
        assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_unported_ztest_flag_fails_loudly(tmp_path):
    """--sample_parallel 2 with one device exits as JAX's CLI does, before
    anything runs."""
    with pytest.raises(SystemExit) as e:
        tcli.main(["ztest", "--device", "cpu", "--data_dir", str(tmp_path),
                   "--sample_parallel", "2"])
    assert "sample_parallel=2 needs that many devices, have 1" in str(e.value.code)
    assert not any(tmp_path.iterdir())
