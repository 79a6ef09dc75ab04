"""Checkpoint / resume of the port against the JAX package's contracts.

- The driver (tests/test_aux.py, test_mc_polygons.py, test_moving.py): a
  run interrupted from its progress hook leaves a checkpoint; resuming
  from it gives labels bitwise equal to an uninterrupted run, on the
  threefry path and on the fused kernels' plain versions (``impl='cuda'``
  on CPU tensors), for rectangles, k-gons and trajectories. A true resume
  is told from a restart (which is bitwise equal too) by its first
  progress report, already past the checkpointed sample count. A clean
  finish deletes the file; a file of another key, row count or
  configuration type, an unreadable one or one of an older format is
  ignored; a file that cannot be written raises; without a cadence
  nothing is read back.
- Across packages: the port resumes a checkpoint that JAX wrote mid-run
  on its jnp path and matches JAX's uninterrupted run at the threefry
  parity bar of tests/test_torch_pipeline.py (at least 99% of cp values
  identical); JAX loads the port's file with every field equal and
  resumes from it.
- The pipeline (tests/test_dataset.py): ``generate`` numbering and
  ``--resume`` under ``--overlap_batches``, an interrupted overlapped
  ``generate`` (no half-written batch, bitwise resume), ``relabel``'s
  ``.relabel_start`` marker (kept for its own run, overwritten when
  foreign or unreadable, removed on a clean finish), ``ztest``'s
  checkpoint; the CLI's flags, ``<data_out>.checkpoint.npz`` of
  ``polylabel`` and ``movelabel``, and a negative ``--checkpoint_every``
  rejected by every command.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collide2d_tpu.mc import driver as jdrv
from collide2d_tpu.mc.estimator import AdaptiveConfig as JAdaptiveConfig
from collide2d_tpu.mc.estimator import Configs as JConfigs
from collide2d_tpu.mc.estimator import adaptive_collision_probabilities as j_acp
from collide2d_tpu_torch import cli as tcli
from collide2d_tpu_torch.data import pipeline as tpl
from collide2d_tpu_torch.data.pipeline import (
    GenerateConfig,
    RelabelConfig,
    ZTestConfig,
    relabel_dataset,
    ztest,
)
from collide2d_tpu_torch.mc import driver as tdrv
from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities as acp
from collide2d_tpu_torch.mc.estimator import AdaptiveConfig, Configs
from collide2d_tpu_torch.mc.moving import moving_configs, moving_polygon_configs
from collide2d_tpu_torch.models.collision_model import example_polygon_configs
from collide2d_tpu_torch.utils.io_npy import get_num_batches_in_dir

# The suite runs one xdist worker per core: one torch thread each keeps
# the workers from oversubscribing the host.
torch.set_num_threads(1)

ROBOT = (4.07, 1.74)
ROBOT_4GON = np.array([[-2.035, -0.87], [2.035, -0.87], [2.035, 0.87],
                       [-2.035, 0.87]], np.float32)
# Tight targets so the loop needs several rounds and checkpoints land
# before the interrupt (tests/test_aux.py's CFG).
TIGHT = dict(max_samples=6000, initial_batch=1000, initial_phase_samples=2000,
             later_batch=2000, bin_accuracy=(0.002, 0.002, 0.005), min_active=32)
# The pipeline's short schedule: 8 rounds of 500 samples.
PIPE = ["--max_samples", "4000", "--verbose", "false"]
IMPLS = ["threefry", "cuda"]


class Stop(Exception):
    pass


def _bomb(at_round=3):
    """A progress hook that interrupts the run once round ``at_round`` is
    reported (the checkpoint of an earlier round then exists)."""
    def hook(*, round, **kw):
        if round >= at_round:
            raise Stop
    return hook


def _rects(n, seed=1234):
    rng = np.random.default_rng(seed)
    pose = rng.uniform(0, 0.3, (n, 3))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return Configs(f32(rng.uniform(-6, 6, (n, 2))), f32(rng.uniform(0, 2 * np.pi, n)),
                   f32(rng.uniform(0.5, 5, (n, 2))),
                   f32(np.concatenate([pose, np.zeros((n, 2))], axis=1)))


def _interrupt_and_resume(key, configs, robot, cfg, ckpt):
    """The uninterrupted labels, then a run interrupted after round 3 and
    its resume; returns (uninterrupted, resumed, checkpoint fields at the
    interrupt, the resumed run's progress sample counts)."""
    base = acp(key, configs, robot, cfg)
    with pytest.raises(Stop):
        acp(key, configs, robot, cfg, progress=_bomb(), checkpoint_path=str(ckpt),
            checkpoint_every=1)
    assert ckpt.exists()
    with np.load(ckpt) as z:
        saved = {k: z[k] for k in z.files}
    seen = []
    out = acp(key, configs, robot, cfg,
              progress=lambda **kw: seen.append(kw["n_samples"]),
              checkpoint_path=str(ckpt), checkpoint_every=1)
    return base, out, saved, seen


def _assert_resumed_bitwise(base, out, saved, seen, ckpt):
    assert int(saved["n_samples"]) > 0 and int(saved["round"]) >= 1
    # a resume, not a restart: the first report is past the checkpoint
    assert seen and min(seen) > int(saved["n_samples"]), (seen, saved["n_samples"])
    for got, want in zip(out, base):
        np.testing.assert_array_equal(got, want)
    assert not ckpt.exists()  # removed after a clean finish


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
def test_checkpoint_resume_identical_result(tmp_path, impl):
    cfg = AdaptiveConfig(**TIGHT, impl=impl)
    ckpt = tmp_path / "checkpoint.npz"
    base, out, saved, seen = _interrupt_and_resume(prng.PRNGKey(11), _rects(48), ROBOT,
                                                   cfg, ckpt)
    assert min(seen) > 2000  # the checkpoint held at least 2 rounds of work
    _assert_resumed_bitwise(base, out, saved, seen, ckpt)
    # the file had JAX's C rows and 4 rectangle fields
    assert saved["out_k"].shape == (48,) and int(saved["active_len"]) == 4
    assert str(saved["cfg_type"]) == "Configs"


@pytest.mark.parametrize("impl", IMPLS)
def test_checkpoint_key_mismatch_ignored(tmp_path, impl):
    cfg = AdaptiveConfig(**TIGHT, impl=impl)
    configs = _rects(32, seed=7)
    ckpt = tmp_path / "checkpoint.npz"
    with pytest.raises(Stop):
        acp(prng.PRNGKey(1), configs, ROBOT, cfg, progress=_bomb(),
            checkpoint_path=str(ckpt), checkpoint_every=1)
    assert ckpt.exists()
    got = acp(prng.PRNGKey(2), configs, ROBOT, cfg, checkpoint_path=str(ckpt),
              checkpoint_every=1)
    want = acp(prng.PRNGKey(2), configs, ROBOT, cfg)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", IMPLS)
def test_checkpoint_resume_with_unemitted_done_rows(tmp_path, impl):
    # A checkpoint taken before any repack holds done-but-unemitted rows:
    # the resume counts real rows, not active ones, or the next repack
    # bucket drops still-active rows (they would end with n = 0).
    rng = np.random.default_rng(4)
    n = 48
    f32 = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
    configs = Configs(f32(rng.uniform(-4, 4, (n, 2))), f32(rng.uniform(0, 7, n)),
                      f32(rng.uniform(0.5, 4, (n, 2))), f32(rng.uniform(0, 0.3, (n, 5))))
    cfg = AdaptiveConfig(max_samples=20_000, impl=impl)
    ckpt = tmp_path / "ckpt.npz"
    base, out, saved, seen = _interrupt_and_resume(prng.PRNGKey(5), configs, ROBOT,
                                                   cfg, ckpt)
    assert saved["done"].any()  # the case this test exists for
    _assert_resumed_bitwise(base, out, saved, seen, ckpt)
    assert (out[1] > 0).all()  # no row lost its sample budget


@pytest.mark.parametrize("impl", IMPLS)
def test_polygon_checkpoint_resume_identical(tmp_path, impl):
    configs = example_polygon_configs(48, k=6, seed=8, device="cpu")
    cfg = AdaptiveConfig(**TIGHT, impl=impl)
    ckpt = tmp_path / "checkpoint.npz"
    base, out, saved, seen = _interrupt_and_resume(prng.PRNGKey(11), configs,
                                                   ROBOT_4GON, cfg, ckpt)
    assert str(saved["cfg_type"]) == "PolygonConfigs"
    assert saved["active_2"].shape == (saved["uids"].shape[0], 6, 2)
    _assert_resumed_bitwise(base, out, saved, seen, ckpt)


def _trajectories(kind, n=48):
    rng = np.random.default_rng(5)
    pos = rng.uniform(-4, 4, (n, 2)).astype(np.float32)
    th = rng.uniform(0, 7, n).astype(np.float32)
    if kind == "kgon_translation":
        b = example_polygon_configs(n, k=5, seed=5, device="cpu")
        return moving_polygon_configs(b.position * 0.6, b.pose_theta, b.obstacle_verts,
                                      b.std_dev, rng.uniform(-2, 2, (n, 2)), 0.0,
                                      rng.uniform(0.5, 3, n), device="cpu"), ROBOT_4GON
    wh = rng.uniform(0.5, 4, (n, 2)).astype(np.float32)
    sd = rng.uniform(0, 0.3, (n, 5)).astype(np.float32)
    omega = 0.4 if kind == "rotating" else 0.0
    return moving_configs(pos, th, wh, sd, 0.6, omega, 1.0, device="cpu"), ROBOT


@pytest.mark.parametrize("kind,impl", [
    ("rotating", "auto"),          # the threefry screened cascade
    ("translation", "cuda"),       # kernel 13's plain version
    ("translation", "threefry"),
    ("kgon_translation", "cuda"),  # kernel 14's plain version
])
def test_trajectory_checkpoint_resume_identical(tmp_path, kind, impl):
    # Every configuration field is written by position: 7 for trajectories.
    configs, robot = _trajectories(kind)
    cfg = AdaptiveConfig(**TIGHT, impl=impl)
    ckpt = tmp_path / "moving_ckpt.npz"
    base, out, saved, seen = _interrupt_and_resume(prng.PRNGKey(5), configs, robot,
                                                   cfg, ckpt)
    assert int(saved["active_len"]) == 7
    assert str(saved["cfg_type"]) == type(configs).__name__
    _assert_resumed_bitwise(base, out, saved, seen, ckpt)


def _left_checkpoint(tmp_path, configs, key=11, impl="threefry"):
    ckpt = tmp_path / "checkpoint.npz"
    with pytest.raises(Stop):
        acp(prng.PRNGKey(key), configs, ROBOT, AdaptiveConfig(**TIGHT, impl=impl),
            progress=_bomb(), checkpoint_path=str(ckpt), checkpoint_every=1)
    return ckpt


def _rewrite(path, **changes):
    with np.load(path) as z:
        fields = {k: z[k] for k in z.files}
    for k, v in changes.items():
        if v is None:
            del fields[k]
        else:
            fields[k] = v
    np.savez(path, **fields)


@pytest.mark.parametrize("case", ["row_count", "cfg_type", "unreadable", "old_format",
                                  "pre_trajectory_format"])
def test_mismatched_checkpoint_ignored(tmp_path, case):
    configs = _rects(32, seed=3)
    ckpt = _left_checkpoint(tmp_path, configs)
    key_data = prng.PRNGKey(11)
    assert tdrv._load_checkpoint(str(ckpt), key_data, 32) is not None
    if case == "row_count":
        _rewrite(ckpt, n_configs=np.int64(33))
    elif case == "cfg_type":
        _rewrite(ckpt, cfg_type=np.str_("PolygonConfigs"))
    elif case == "unreadable":
        ckpt.write_bytes(b"not an npz")
    elif case == "old_format":  # a file without the integer emission buffers
        _rewrite(ckpt, out_k=None)
    else:  # 4 named configuration fields, no active_len
        with np.load(ckpt) as z:
            active = {f"active_{name}": z[f"active_{i}"] for i, name in enumerate(
                ("position", "pose_theta", "obstacle_wh", "std_dev"))}
        _rewrite(ckpt, active_len=None, active_0=None, active_1=None, active_2=None,
                 active_3=None, **active)
    assert tdrv._load_checkpoint(str(ckpt), key_data, 32) is None
    cfg = AdaptiveConfig(**TIGHT, impl="threefry")
    seen, fresh = [], []
    got = acp(prng.PRNGKey(11), configs, ROBOT, cfg, checkpoint_path=str(ckpt),
              checkpoint_every=1, progress=lambda **kw: seen.append(kw["n_samples"]))
    want = acp(prng.PRNGKey(11), configs, ROBOT, cfg, checkpoint_every=1,
               progress=lambda **kw: fresh.append(kw["n_samples"]))
    assert seen == fresh  # started from the first round
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not ckpt.exists()


def test_checkpoint_that_cannot_be_written_raises(tmp_path):
    with pytest.raises(OSError):
        acp(prng.PRNGKey(1), _rects(16), ROBOT, AdaptiveConfig(**TIGHT),
            checkpoint_path=str(tmp_path / "missing" / "ckpt.npz"), checkpoint_every=1)
    with pytest.raises(ValueError, match="checkpoint_every"):
        acp(prng.PRNGKey(1), _rects(16), ROBOT, AdaptiveConfig(**TIGHT),
            checkpoint_every=-1)


def test_no_readback_without_a_cadence(tmp_path, monkeypatch):
    # checkpoint_every = 0: the scheduler never calls the hook, so the
    # default path gains no host sync and writes no file.
    def fail(*a, **kw):
        raise AssertionError("checkpoint hook called without a cadence")

    monkeypatch.setattr(tdrv._TorchOps, "bookkeeping", fail)
    monkeypatch.setattr(tdrv, "_save_checkpoint", fail)
    ckpt = tmp_path / "ckpt.npz"
    acp(prng.PRNGKey(1), _rects(16), ROBOT, AdaptiveConfig(**TIGHT),
        checkpoint_path=str(ckpt))
    assert not ckpt.exists()


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------


def _jax_rects(configs):
    return JConfigs(*(jnp.asarray(a.numpy()) for a in configs))


def test_port_resumes_a_jax_checkpoint(tmp_path):
    configs = _rects(48, seed=21)
    jcfg = JAdaptiveConfig(**TIGHT, impl="jnp")
    key = jax.random.PRNGKey(11)
    want = j_acp(key, _jax_rects(configs), ROBOT, jcfg)
    ckpt = tmp_path / "checkpoint.npz"
    with pytest.raises(Stop):
        j_acp(key, _jax_rects(configs), ROBOT, jcfg, progress=_bomb(),
              checkpoint_path=str(ckpt), checkpoint_every=1)
    with np.load(ckpt) as z:
        n_saved = int(z["n_samples"])
    seen = []
    got = acp(prng.PRNGKey(11), configs, ROBOT, AdaptiveConfig(**TIGHT, impl="threefry"),
              progress=lambda **kw: seen.append(kw["n_samples"]),
              checkpoint_path=str(ckpt), checkpoint_every=1)
    assert min(seen) > n_saved  # resumed from JAX's state
    same = (got[0] == np.asarray(want[0])).mean()
    print(f"{same:.2%} of cp values identical to JAX's uninterrupted run")
    assert same >= 0.99
    assert (got[1] > 0).all() and not ckpt.exists()


@pytest.mark.parametrize("kind", ["rects", "trajectories"])
def test_jax_loads_a_port_checkpoint(tmp_path, monkeypatch, kind):
    if kind == "rects":
        configs, robot = _rects(48, seed=22), ROBOT
    else:
        configs, robot = _trajectories("translation")
    written = []
    real = tdrv._save_checkpoint

    def spy(path, key_data, n_configs, **kw):
        written.append(dict(kw, key_data=key_data, n_configs=n_configs))
        real(path, key_data, n_configs, **kw)

    monkeypatch.setattr(tdrv, "_save_checkpoint", spy)
    ckpt = tmp_path / "checkpoint.npz"
    key = prng.PRNGKey(11)
    with pytest.raises(Stop):
        acp(key, configs, robot, AdaptiveConfig(**TIGHT, impl="threefry"),
            progress=_bomb(), checkpoint_path=str(ckpt), checkpoint_every=1)
    last = written[-1]
    loaded = jdrv._load_checkpoint(str(ckpt), np.asarray(jax.random.key_data(
        jax.random.PRNGKey(11))).ravel(), 48, cfg_type=type(configs).__name__)
    assert loaded is not None
    assert len(loaded["active"]) == len(last["active"]) == len(configs)
    for a, b in zip(loaded["active"], last["active"]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for name in ("out_k", "out_nn", "out_flag", "uids", "n_true", "done",
                 "k_frozen", "n_frozen", "n_samples", "chunk_offset", "num_real",
                 "round"):
        a, b = np.asarray(loaded[name]), np.asarray(last[name])
        assert a.dtype == b.dtype or a.shape == (), name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert loaded["out_k"].dtype == np.int32 and loaded["out_flag"].dtype == bool
    assert loaded["out_k"].shape == (48,)
    with np.load(ckpt) as z:
        assert str(z["key_data"].dtype) == "uint32"
    if kind == "rects":
        # ... and resumes from it to a full run
        seen = []
        jcfg = JAdaptiveConfig(**TIGHT, impl="jnp")
        cp, n_used, _ = j_acp(jax.random.PRNGKey(11), _jax_rects(configs), ROBOT, jcfg,
                              progress=lambda **kw: seen.append(kw["n_samples"]),
                              checkpoint_path=str(ckpt), checkpoint_every=1)
        assert min(seen) > int(last["n_samples"])
        assert (np.asarray(n_used) > 0).all() and not ckpt.exists()


# ---------------------------------------------------------------------------
# The pipeline and the CLI
# ---------------------------------------------------------------------------

GEN = ["--num_poses", "16", "--num_variances", "16", "--seed", "5", *PIPE]


def _generate(data_dir, *extra):
    assert tcli.main(["generate", "--device", "cpu", "--data_dir", str(data_dir),
                      *GEN, *extra]) == 0


def test_generate_resume_numbering(tmp_path):
    data = tmp_path / "data"
    _generate(data, "-n", "2", "-b", "64")
    _generate(data, "-n", "1", "-b", "64", "-s", "2", "--pose_dir",
              str(data / "poses.npy"), "--variance_dir", str(data / "variances.npy"))
    assert (data / "2.npy").exists()
    assert get_num_batches_in_dir(data) == 3


def test_generate_overlap_resume_and_checkpoints(tmp_path):
    # Overlapped pipeline + --resume + one checkpoint file per batch: a
    # rerun skips written batches and rewrites a deleted one bitwise; a
    # clean finish leaves no checkpoint_*.
    d = tmp_path / "d"
    flags = ["-n", "3", "-b", "64", "--overlap_batches", "2", "--checkpoint_every",
             "2", "--resume"]
    _generate(d, *flags)
    assert get_num_batches_in_dir(d) == 3
    assert not list(d.glob("checkpoint_*.npz"))
    before = [(d / f"{i}.npy").read_bytes() for i in range(3)]
    mtime0 = (d / "0.npy").stat().st_mtime_ns
    (d / "1.npy").unlink()
    _generate(d, *flags)
    assert [(d / f"{i}.npy").read_bytes() for i in range(3)] == before
    assert (d / "0.npy").stat().st_mtime_ns == mtime0  # skipped, not rewritten
    # and the checkpointed runs' files are the plain run's
    plain = tmp_path / "plain"
    _generate(plain, "-n", "3", "-b", "64")
    assert [(plain / f"{i}.npy").read_bytes() for i in range(3)] == before


@pytest.mark.parametrize("overlap", [1, 2])
def test_interrupted_generate_resumes_bitwise(tmp_path, monkeypatch, overlap):
    # Interrupt a pipelined generate from a batch's progress hook: the
    # exception passes the prefetch thread and the async writer without a
    # hang, no half-written batch is left, and --resume finishes the run
    # with the uninterrupted run's bytes.
    flags = ["-n", "3", "-b", "64", "--overlap_batches", str(overlap)]
    plain = tmp_path / "plain"
    _generate(plain, *flags)
    want = [(plain / f"{i}.npy").read_bytes() for i in range(3)]

    d = tmp_path / "d"
    calls = {"n": 0}

    def bombing_logger(cfg, total):
        calls["n"] += 1
        return _bomb(3) if calls["n"] == 2 else None  # the second batch's run

    monkeypatch.setattr(tpl, "_progress_logger", bombing_logger)
    with pytest.raises(Stop):
        _generate(d, *flags, "--checkpoint_every", "1", "--resume")
    ckpts = sorted(p.name for p in d.glob("checkpoint_*.npz"))
    assert "checkpoint_1.npz" in ckpts
    written = sorted(p.name for p in d.iterdir() if p.suffix == ".npy"
                     and p.stem.isdigit())
    assert "1.npy" not in written
    for name in written:  # whatever was published is complete and right
        assert (d / name).read_bytes() == want[int(name[:-4])]
    assert not [p for p in d.iterdir() if ".tmp" in p.name]

    runs = []  # the rerun's progress reports, one list per batch it labels

    def recording_logger(cfg, total):
        runs.append(seen := [])
        return lambda **kw: seen.append(kw["n_samples"])

    monkeypatch.setattr(tpl, "_progress_logger", recording_logger)
    with np.load(d / "checkpoint_1.npz") as z:
        n_saved = int(z["n_samples"])
    _generate(d, *flags, "--checkpoint_every", "1", "--resume")
    assert [(d / f"{i}.npy").read_bytes() for i in range(3)] == want
    assert not list(d.glob("checkpoint_*.npz"))
    # batch 1 resumed: its first report is past its checkpoint
    first = runs[0 if "0.npy" in written else 1]
    assert n_saved > 0 and min(first) > n_saved, (first, n_saved)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """A generated dataset whose batches feed relabel and ztest."""
    data = tmp_path_factory.mktemp("tables") / "data"
    _generate(data, "-n", "2", "-b", "128")
    return data


def _copy_tables(src, dst):
    dst.mkdir(parents=True, exist_ok=True)
    for name in ("poses.npy", "variances.npy"):
        shutil.copy(src / name, dst / name)
    (dst / "meta").mkdir(exist_ok=True)
    for name in ("accuracy_bins.npy", "bin_accuracy.npy"):
        shutil.copy(src / "meta" / name, dst / "meta" / name)


def _relabel_input(tables, tmp_path, sizes):
    batch = np.load(tables / "1.npy")
    data_in = tmp_path / "rin"
    data_in.mkdir()
    start = 0
    for i, size in enumerate(sizes):
        np.save(data_in / f"{i}.npy",
                batch[start:start + size, [0, 1, 3, 4]].astype(np.float32))
        start += size
    return data_in


def _relabel(data_in, data_out, *extra):
    assert tcli.main(["relabel", "--device", "cpu", "--data_in", str(data_in),
                      "--data_out", str(data_out), "--shuffle", "false",
                      *PIPE, *extra]) == 0


def test_relabel_resume_skips_and_appends_once(tables, tmp_path):
    data_in = _relabel_input(tables, tmp_path, [64, 64])
    resume = ["--seed", "5", "--resume"]
    out_a = tmp_path / "out_a"
    _copy_tables(tables, out_a)
    _relabel(data_in, out_a, *resume)
    assert (out_a / "0.npy").exists() and (out_a / "1.npy").exists()
    assert not (out_a / ".relabel_start").exists()  # clean finish

    # a run killed after writing output batch 0: its marker and 0.npy
    out_b = tmp_path / "out_b"
    _copy_tables(tables, out_b)
    (out_b / ".relabel_start").write_text(json.dumps(
        {"start": 0, "data_in": str(data_in.resolve()), "seed": 5, "num_batches": 2}))
    shutil.copy(out_a / "0.npy", out_b / "0.npy")
    _relabel(data_in, out_b, *resume)
    assert get_num_batches_in_dir(out_b) == 2  # skipped 0, wrote 1 in the window
    assert (out_b / "1.npy").read_bytes() == (out_a / "1.npy").read_bytes()
    assert not (out_b / ".relabel_start").exists()

    # a foreign or pre-identity marker is overwritten, not obeyed
    for i, stale in enumerate(("0", json.dumps({"start": 0, "data_in": "/elsewhere",
                                                "seed": 99, "num_batches": 7}))):
        out_c = tmp_path / f"out_c{i}"
        _copy_tables(tables, out_c)
        (out_c / ".relabel_start").write_text(stale)
        _relabel(data_in, out_c, *resume)
        assert get_num_batches_in_dir(out_c) == 2
        assert (out_c / "1.npy").read_bytes() == (out_a / "1.npy").read_bytes()
        assert not (out_c / ".relabel_start").exists()


def test_relabel_marker_written_for_an_interrupted_run(tables, tmp_path, monkeypatch):
    # The marker pins the window while a resume run is in flight, and a
    # relabel resume without a fixed seed is refused.
    data_in = _relabel_input(tables, tmp_path, [64, 64])
    out = tmp_path / "out"
    _copy_tables(tables, out)
    monkeypatch.setattr(tpl, "_progress_logger", lambda cfg, total: _bomb(2))
    with pytest.raises(Stop):
        _relabel(data_in, out, "--seed", "5", "--resume", "--checkpoint_every", "1")
    marker = json.loads((out / ".relabel_start").read_text())
    assert marker == {"start": 0, "data_in": str(data_in.resolve()), "seed": 5,
                      "num_batches": 2}
    with pytest.raises(ValueError, match="seed"):
        relabel_dataset(RelabelConfig(data_in=str(data_in), data_out=str(out),
                                      resume=True, verbose=False, device="cpu"))


@pytest.mark.parametrize("impl", IMPLS)
def test_relabel_overlap_bitwise_and_checkpoint_cleanup(tables, tmp_path, impl):
    data_in = _relabel_input(tables, tmp_path, [40, 40, 40])
    outs = {}
    for overlap in (1, 3):
        out = tmp_path / f"ov{overlap}"
        _copy_tables(tables, out)
        _relabel(data_in, out, "--seed", "7", "--impl", impl, "--checkpoint_every", "2",
                 "--overlap_batches", str(overlap))
        assert not list(out.glob("checkpoint_*.npz"))
        outs[overlap] = [(out / f"{i}.npy").read_bytes() for i in range(3)]
    assert outs[1] == outs[3]


def test_ztest_checkpoint_resume(tables, tmp_path, monkeypatch):
    # --checkpoint_every writes data_dir/ztest_checkpoint.npz; a rerun with
    # the same seed resumes from it bitwise; a clean finish removes it.
    src = tmp_path / "zt"
    _copy_tables(tables, src)
    (src / "tmp").mkdir()
    np.save(src / "tmp" / "0.npy",
            np.load(tables / "1.npy")[:64, [0, 1, 3, 4]].astype(np.float32))
    kw = dict(data_dir=str(src), cps_only=True, seed=2, verbose=False, n_batch=1000,
              max_samples=6000, device="cpu")
    want = ztest(ZTestConfig(**kw, data_file_out=str(tmp_path / "want.npy")))
    monkeypatch.setattr(tpl, "_progress_logger", lambda cfg, total: _bomb(3))
    with pytest.raises(Stop):
        ztest(ZTestConfig(**kw, checkpoint_every=1))
    assert (src / "ztest_checkpoint.npz").exists()
    seen = []
    monkeypatch.setattr(tpl, "_progress_logger",
                        lambda cfg, total: lambda **k: seen.append(k["n_samples"]))
    got = ztest(ZTestConfig(**kw, checkpoint_every=1))
    assert got.shape == (64,) and min(seen) > 2000
    np.testing.assert_array_equal(got, want)
    assert not (src / "ztest_checkpoint.npz").exists()


def _polys(path, n=32):
    b = example_polygon_configs(n, k=5, seed=3, device="cpu")
    np.savez(path, obstacle_verts=b.obstacle_verts.numpy(),
             position=b.position.numpy() * 0.6, pose_theta=b.pose_theta.numpy(),
             std_dev=b.std_dev.numpy(), robot_verts=ROBOT_4GON)
    return path


def _moves(path, n=32):
    configs, _ = _trajectories("translation", n)
    np.savez(path, **{f: getattr(configs, f).numpy() for f in configs._fields})
    return path


@pytest.mark.parametrize("command", ["polylabel", "movelabel"])
def test_label_commands_checkpoint_and_resume(tmp_path, monkeypatch, command):
    # <data_out>.checkpoint.npz: written with --checkpoint_every, resumed by
    # a rerun with the same seed (here one interrupted through the CLI's
    # own call), removed on a clean finish.
    data = (_polys if command == "polylabel" else _moves)(tmp_path / "in.npz")
    argv = [command, "--device", "cpu", "--data_in", str(data), "--seed", "3",
            "--max_samples", "6000", "--bin_accuracy", "0.002", "0.002", "0.005"]
    assert tcli.main([*argv, "--data_out", str(tmp_path / "want.npz")]) == 0
    out = tmp_path / "got.npz"
    ckpt = tmp_path / "got.npz.checkpoint.npz"
    real = tdrv.adaptive_collision_probabilities

    def interrupted(*a, **kw):
        return real(*a, **dict(kw, progress=_bomb()))

    monkeypatch.setattr(tdrv, "adaptive_collision_probabilities", interrupted)
    with pytest.raises(Stop):
        tcli.main([*argv, "--data_out", str(out), "--checkpoint_every", "1"])
    assert ckpt.exists() and not out.exists()
    monkeypatch.setattr(tdrv, "adaptive_collision_probabilities", real)
    assert tcli.main([*argv, "--data_out", str(out), "--checkpoint_every", "1"]) == 0
    assert not ckpt.exists()
    with np.load(tmp_path / "want.npz") as a, np.load(out) as b:
        for name in ("cp", "n_samples", "converged"):
            np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("command", ["generate", "relabel", "ztest", "polylabel",
                                     "movelabel"])
def test_negative_checkpoint_every_is_rejected(tmp_path, capsys, command):
    argv = {
        "generate": ["--data_dir", str(tmp_path / "out")],
        "relabel": ["--data_in", str(tmp_path), "--data_out", str(tmp_path / "out")],
        "ztest": ["--data_dir", str(tmp_path / "out")],
        "polylabel": ["--data_in", "in.npz", "--data_out", str(tmp_path / "out")],
        "movelabel": ["--data_in", "in.npz", "--data_out", str(tmp_path / "out")],
    }[command]
    with pytest.raises(SystemExit) as e:
        tcli.main([command, "--device", "cpu", *argv, "--checkpoint_every", "-1"])
    assert e.value.code != 0
    assert "--checkpoint_every" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()  # nothing ran


def test_resume_flags_parse_into_the_configs():
    g = tcli.generate_config(tcli.parse_args(
        ["generate", "--checkpoint_every", "4", "--resume"]))
    assert (g.checkpoint_every, g.resume) == (4, True)
    r = tcli.relabel_config(tcli.parse_args(
        ["relabel", "--checkpoint_every", "3", "--resume", "--seed", "1"]))
    assert (r.checkpoint_every, r.resume) == (3, True)
    assert GenerateConfig().checkpoint_every == 0 and not GenerateConfig().resume
