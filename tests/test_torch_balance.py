"""The port's `balance` / `show` against the JAX package's.

- ``data/balance.py`` and ``data/visualize.py`` are host copies: each
  function is held bitwise against ``collide2d_tpu/data/balance.py`` and
  ``visualize.py`` on seeded inputs, the plots byte for byte as PNG (an
  SVG carries its date and random ids).
- ``collide2d-torch balance`` and ``show`` against ``collide2d balance``
  and ``show`` on the same data: the same exit codes, the same lines, and
  byte-identical balanced ``.npy`` files and contour images.
"""

import numpy as np
import pytest
import torch

import collide2d_tpu.cli as jcli
from collide2d_tpu.data import balance as jbal
from collide2d_tpu.data import visualize as jviz
from collide2d_tpu_torch import cli as tcli
from collide2d_tpu_torch.data import balance as tbal
from collide2d_tpu_torch.data import visualize as tviz

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)


BIN_SETS = {
    "default": [0.0, 0.001, 0.01, 0.1, 1.0],
    "reference": [0.0, 0.01, 0.1, 1.0],
    "two": [0.0, 0.5, 1.0],
}


def _rows(rng, n, var_levels=4, pose_levels=4):
    """Dataset rows (x, y, cp, var_idx, pose_idx): cp with exact zeros,
    ones and bin edges among uniform values, as labels come."""
    rows = np.empty((n, 5), np.float32)
    rows[:, :2] = rng.uniform(-5, 5, (n, 2))
    cp = rng.uniform(0, 1, n) ** 3
    pick = rng.integers(0, 5, n)
    cp = np.where(pick == 0, 0.0, cp)
    cp = np.where(pick == 1, 1.0, cp)
    cp = np.where(pick == 2, rng.choice([0.001, 0.01, 0.1, 0.5], n), cp)
    rows[:, 2] = cp
    rows[:, 3] = rng.integers(0, var_levels, n)
    rows[:, 4] = rng.integers(0, pose_levels, n)
    return rows


def _dataset(path, rng, sizes):
    path.mkdir(parents=True)
    for i, n in enumerate(sizes):
        np.save(path / f"{i}.npy", _rows(rng, n))
    np.save(path / "poses.npy", np.zeros((4, 3), np.float32))
    np.save(path / "variances.npy", np.zeros((4, 5), np.float32))
    np.save(path / "checkpoint3.npy", np.zeros((4, 5), np.float32))
    np.save(path / "cps.npy", np.zeros(9, np.float32))  # a 1-D artifact
    return path


def test_default_bins_equal():
    np.testing.assert_array_equal(tbal.DEFAULT_BALANCE_BINS, jbal.DEFAULT_BALANCE_BINS)
    assert tbal.DEFAULT_BALANCE_BINS.dtype == jbal.DEFAULT_BALANCE_BINS.dtype


def test_load_data_matches(tmp_path):
    d = _dataset(tmp_path / "d", np.random.default_rng(0), [10, 7, 31])
    got, want = tbal.load_data(d), jbal.load_data(d)
    assert got.shape == (48, 5) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    (tmp_path / "empty").mkdir()
    for mod in (tbal, jbal):
        with pytest.raises(FileNotFoundError):
            mod.load_data(tmp_path / "empty")


@pytest.mark.parametrize("bins", list(BIN_SETS))
def test_compute_bin_idx_matches(bins):
    y = _rows(np.random.default_rng(1), 500)[:, 2]
    got = tbal.compute_bin_idx(y, BIN_SETS[bins])
    want = jbal.compute_bin_idx(y, BIN_SETS[bins])
    assert len(got) == len(want) == len(BIN_SETS[bins]) - 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (np.stack(got).sum(0) == 1).all()


@pytest.mark.parametrize("bins", list(BIN_SETS))
def test_balance_matches(bins):
    rng = np.random.default_rng(2)
    d0, d1 = _rows(rng, 400), _rows(rng, 300)
    b0 = tbal.compute_bin_idx(d0[:, 2], BIN_SETS[bins])
    b1 = tbal.compute_bin_idx(d1[:, 2], BIN_SETS[bins])
    got, want = tbal.balance(d0, d1, b0, b1), jbal.balance(d0, d1, b0, b1)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    single = tbal.balance_single(d0, b0)
    np.testing.assert_array_equal(single, jbal.balance_single(d0, b0))
    assert len(single) % (len(BIN_SETS[bins]) - 1) == 0


def test_selectors_match():
    rows = _rows(np.random.default_rng(3), 400, var_levels=3, pose_levels=3)
    for var, pose in ((1.0, 2.0), (0.0, 0.0), (5.0, 1.0)):
        got = tviz.get_data_for_specific_var_and_pos(rows, var, pose)
        np.testing.assert_array_equal(got,
                                      jviz.get_data_for_specific_var_and_pos(rows, var, pose))
    for var in (0.0, 2.0):
        np.testing.assert_array_equal(tviz.get_data_for_specific_var(rows, var),
                                      jviz.get_data_for_specific_var(rows, var))


def test_plots_match(tmp_path):
    rows = _rows(np.random.default_rng(4), 300, var_levels=1, pose_levels=1)
    tviz.plot_contour(rows[:, 0], rows[:, 1], rows[:, 2], tmp_path / "t.png")
    jviz.plot_contour(rows[:, 0], rows[:, 1], rows[:, 2], tmp_path / "j.png")
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    # as PNG: an SVG carries its date and random clip-path ids
    tbal.plot_histogram(rows, out_path=tmp_path / "t_hist.png")
    jbal.plot_histogram(rows, out_path=tmp_path / "j_hist.png")
    assert (tmp_path / "t_hist.png").read_bytes() == (tmp_path / "j_hist.png").read_bytes()


def _both(tmp_path, capsys, argv_of):
    """Run ``argv_of(out_dir)`` through both CLIs; returns the exit codes
    and output lines with each output directory's name made the same."""
    result = {}
    for name, cli in (("torch", tcli), ("jax", jcli)):
        out = tmp_path / name
        out.mkdir()
        rc = cli.main(argv_of(out))
        captured = capsys.readouterr()
        result[name] = (rc, captured.out.replace(str(out), "OUT"),
                        captured.err.replace(str(out), "OUT"))
    return result


@pytest.mark.parametrize("n_dirs", [1, 2])
def test_balance_cli_matches(tmp_path, capsys, n_dirs):
    rng = np.random.default_rng(5)
    dirs = [_dataset(tmp_path / f"d{i}", rng, [200, 150]) for i in range(n_dirs)]

    res = _both(tmp_path, capsys, lambda out: [
        "balance", *map(str, dirs), "--out", str(out / "bal"),
        "--hist", str(out / "hist.svg")])
    assert res["torch"] == res["jax"]
    assert res["torch"][0] == 0
    names = ["bal_0.npy", "bal_1.npy"] if n_dirs == 2 else ["bal"]
    for name in names:
        t = tmp_path / "torch" / name
        t = t if t.exists() else t.with_suffix(".npy")
        j = tmp_path / "jax" / t.name
        assert t.read_bytes() == j.read_bytes()
        assert np.load(t).shape[1] == 5


@pytest.mark.parametrize("case", ["dense", "sparse"])
def test_show_cli_matches(tmp_path, capsys, case):
    rng = np.random.default_rng(6)
    rows = _rows(rng, 300, var_levels=1 if case == "dense" else 50, pose_levels=1)
    if case == "sparse":
        rows[:, 3] = np.arange(300) % 150  # 2 rows a slice: too few
    np.save(tmp_path / "0.npy", rows)
    res = _both(tmp_path, capsys, lambda out: [
        "show", str(tmp_path / "0.npy"), "--out", str(out / "contour.png")])
    assert res["torch"] == res["jax"]
    if case == "dense":
        assert res["torch"][0] == 0
        assert ((tmp_path / "torch" / "contour.png").read_bytes()
                == (tmp_path / "jax" / "contour.png").read_bytes())
    else:
        assert res["torch"][0] == 1 and "need >= 4" in res["torch"][2]
        assert not (tmp_path / "torch" / "contour.png").exists()
