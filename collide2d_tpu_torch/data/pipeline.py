"""The labeled-dataset pipeline: ``generate``, ``relabel`` and ``ztest``.

Counterpart of ``collide2d_tpu/data/pipeline.py``:

  generate  (generate_dataset.cu:255-524)              sample configs, label, emit
  relabel   (compute_collision_probability.cu:35-360)  relabel existing batches
  ztest     (ztest.cu:168-444)                         one file, fixed 10k per round

``schedule='opt'`` (generate and relabel) probes the workload's
collision probabilities once and places the convergence checkpoints by
`mc.schedule_sim.optimize_checkpoints`; ``prune_sigma > 0`` labels rows
that cannot touch cp = 0 without sampling. Neither is in the reference.
``checkpoint_every`` writes each batch's loop state every that many
rounds (``checkpoint_{batch}.npz``; ztest: ``ztest_checkpoint.npz``), and
``resume`` skips written batches and resumes mid-batch from those files.
``data_parallel`` / ``sample_parallel`` / ``mesh`` shard each run's rounds
over several devices (`parallel`; labels bitwise the unsharded run's), and
``trace_dir`` writes a profiler trace of the labeling
(`utils.profiling.trace`), with the ``pipeline/`` spans of this module
(`utils.profiling.span`): the table loads and uploads, and each batch's
pack and shuffle.

Tables (``poses.npy``, ``variances.npy``, ``meta/``) and batch files keep
the JAX package's byte layout, so either package reads the other's
datasets; with the same seed both sample the same configurations. The
configurations, tables and labeling state live on ``device``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import time
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import torch

from collide2d_tpu_torch.data import schemas
from collide2d_tpu_torch.mc import prng
from collide2d_tpu_torch.mc.driver import (
    AdaptiveRun,
    _CopyToHost,
    adaptive_collision_probabilities,
    run_interleaved,
)
from collide2d_tpu_torch.mc.estimator import (
    AdaptiveConfig,
    Configs,
    collision_probability,
)
from collide2d_tpu_torch.mc.noise import sample_configuration_batch
from collide2d_tpu_torch.utils import native
from collide2d_tpu_torch.utils.io_npy import (
    batch_path,
    get_num_batches_in_dir,
    load_npy,
    mkdirs,
    save_npy,
)
from collide2d_tpu_torch.utils.profiling import StepTimer, span, trace

TWO_PI = 2.0 * math.pi


@dataclass(frozen=True)
class GenerateConfig:
    """Knobs of the dataset generator — names/defaults per
    generate_dataset.cu:44-64, as in the JAX package."""

    data_dir: str = "./data/"
    pose_dir: str = ""
    variance_dir: str = ""
    num_batches: int = 100
    batch_size: int = 100_000
    start_batch_count: int = 0
    num_poses: int = 64**4
    num_variances: int = 64**4
    max_samples: int = 4_000_000
    min_variance: Sequence[float] = (0.0, 0.0, 0.0, 0.0, 0.0)
    max_variance: Sequence[float] = (0.3, 0.3, 0.3, 0.3, 0.3)
    min_pose: Sequence[float] = (0.1, 0.1, 0.0)
    max_pose: Sequence[float] = (5.0, 5.0, TWO_PI)
    accuracy_bins: Sequence[float] = (0.0, 0.01, 0.1, 1.0)
    bin_accuracy: Sequence[float] = (0.0001, 0.001, 0.01)
    robot_width: float = 4.07
    robot_height: float = 1.74
    spread: float = 4.0
    shape_variance: bool = False
    seed: int | None = None  # device PRNG seed (None: time-based)
    table_seed: int = 0  # host table RNG seed
    refcompat_tables: bool = False  # bit-identical libstdc++ table sampling
    shuffle: bool = True
    verbose: bool = True
    schedule: object = None  # None = reference | "tuned" | "opt" | tuple
    prune_sigma: float = 0.0  # see AdaptiveConfig.prune_sigma
    impl: str = "auto"  # 'auto' (= 'cuda') | 'cuda' | 'threefry'
    ladder: str = "eighth"
    # Cross-batch pipelining depth: up to this many batches labeled in
    # flight; outputs do not depend on it.
    overlap_batches: int = 3
    checkpoint_every: int = 0  # rounds between mid-batch checkpoints (0 = off)
    # Skip batches whose files exist and resume mid-batch from
    # checkpoint_{abs_batch}.npz, one per in-flight batch (needs a fixed
    # seed, so the keys reproduce).
    resume: bool = False
    data_parallel: bool = False  # shard the config axis over every card
    mesh: object = None  # explicit parallel.Mesh (tests / custom topologies)
    trace_dir: str = ""  # write a torch.profiler trace of the labeling here
    device: str = "cuda"

    @property
    def robot_wh(self) -> tuple[float, float]:
        return (self.robot_width, self.robot_height)

    @property
    def r_offset(self) -> float:
        return (self.robot_width + self.robot_height) / 4.0  # generate_dataset.cu:398


@dataclass(frozen=True)
class RelabelConfig:
    """compute_collision_probability.cu:35-42 flag set, plus the adaptive
    extensions of generate. Input batches are (N, 4) rows of ``data_in``;
    outputs continue the numbering after ``data_out``'s existing batches
    and use its tables and meta."""

    data_in: str = "./data_in/"
    data_out: str = "./data_out/"
    max_samples: int = 4_000_000
    robot_width: float = 4.07
    robot_height: float = 1.74
    shuffle: bool = True
    seed: int | None = None
    verbose: bool = True
    impl: str = "auto"
    schedule: object = None  # None = reference | "tuned" | "opt" | tuple
    prune_sigma: float = 0.0
    ladder: str = "eighth"
    overlap_batches: int = 3  # as GenerateConfig.overlap_batches
    checkpoint_every: int = 0  # rounds between mid-batch checkpoints (0 = off)
    # Skip output batches already written and resume mid-batch from
    # checkpoint_{abs_batch}.npz (needs a fixed seed); the first run's
    # output numbering is pinned by a .relabel_start marker, so a rerun
    # continues the same window instead of appending again.
    resume: bool = False
    data_parallel: bool = False
    # Shard each configuration's sample budget over this many devices (as
    # ZTestConfig.sample_parallel; ignored with data_parallel or a mesh).
    sample_parallel: int = 0
    mesh: object = None  # explicit parallel.Mesh (tests / custom topologies)
    trace_dir: str = ""  # write a torch.profiler trace of the labeling here
    device: str = "cuda"

    @property
    def robot_wh(self) -> tuple[float, float]:
        return (self.robot_width, self.robot_height)


@dataclass(frozen=True)
class ZTestConfig:
    """ztest.cu:37-47 flag set (shuffle off by default: an unshuffled
    output keeps the row correspondence the comparison needs)."""

    data_dir: str = "./data/"
    data_file_in: str = ""
    data_file_out: str = ""
    max_samples: int = 4_000_000
    robot_width: float = 4.07
    robot_height: float = 1.74
    shuffle: bool = False
    cps_only: bool = False
    meta_dir: str = ""
    seed: int | None = None
    verbose: bool = True
    n_batch: int = 10_000  # fixed per-round budget (ztest.cu:332)
    impl: str = "auto"
    schedule: object = None  # None = fixed n_batch | "tuned" | tuple
    prune_sigma: float = 0.0
    ladder: str = "eighth"
    # Mid-run checkpoints every N rounds to data_dir/ztest_checkpoint.npz;
    # a rerun with the same seed resumes from it.
    checkpoint_every: int = 0
    # Shard each configuration's sample budget over this many devices: a
    # (1, sample_parallel) mesh whose labels are bitwise the single-device
    # ones (estimator._sample_sharded_counts / _cuda_sharded_counts). Must
    # divide n_batch. 0 = off.
    sample_parallel: int = 0
    mesh: object = None  # explicit parallel.Mesh (tests / custom topologies)
    trace_dir: str = ""  # write a torch.profiler trace of the run here
    device: str = "cuda"

    @property
    def robot_wh(self) -> tuple[float, float]:
        return (self.robot_width, self.robot_height)


def _log(cfg, *msg):
    if cfg.verbose:
        print(*msg, flush=True)


def _progress_logger(cfg, total: int):
    """A StepTimer-backed progress callback: one line per host sync."""
    if not cfg.verbose:
        return None
    timer = StepTimer(log_every=1)
    last = {"n_samples": 0, "active": total}

    def cb(*, num_left: int, n_samples: int, round: int) -> None:
        timer.rounds = round - 1  # StepTimer increments to the true count
        timer.round_done(
            n_batch=n_samples - last["n_samples"],
            active=last["active"],
            done_total=total - num_left,
        )
        last["n_samples"] = n_samples
        last["active"] = num_left

    return cb


def _mesh_for(cfg):
    """The mesh a pipeline config asks for: an explicit ``mesh`` > data
    parallel (every device of ``cfg.device``'s kind on the config axis; no
    mesh over fewer than two) > ``sample_parallel`` (a (1, s) mesh)."""
    if getattr(cfg, "mesh", None) is not None:
        return cfg.mesh
    from collide2d_tpu_torch.parallel.sharding import local_devices, make_mesh

    devices = local_devices(cfg.device)
    if getattr(cfg, "data_parallel", False):
        if len(devices) < 2:
            return None
        return make_mesh(devices)
    s = getattr(cfg, "sample_parallel", 0)
    if s and s > 1:
        if len(devices) < s:
            raise ValueError(f"sample_parallel={s} needs that many devices, "
                             f"have {len(devices)}")
        return make_mesh(devices[:s], sample_axis=s)
    return None


def _master_key(seed: int | None) -> np.ndarray:
    if seed is None:
        seed = int(time.time_ns() % (2**31))  # reference: srand(time(0))
    return prng.PRNGKey(seed)


def _sample_tables(cfg: GenerateConfig) -> tuple[np.ndarray, np.ndarray]:
    """Host-side pose/variance table sampling (generate_dataset.cu:282-336),
    the JAX package's numpy streams exactly."""
    min_var = np.asarray(cfg.min_variance, np.float32).copy()
    max_var = np.asarray(cfg.max_variance, np.float32).copy()
    if not cfg.shape_variance:
        # generate_dataset.cu:285-290: zero the width/height noise dims.
        min_var[3:5] = 0.0
        max_var[3:5] = 0.0
    if cfg.refcompat_tables and native.available():
        eng = native.RefEngine(None if cfg.table_seed == 0 else cfg.table_seed)
        variances = eng.uniform_table(cfg.num_variances, min_var, max_var)
        poses = eng.uniform_table(cfg.num_poses, cfg.min_pose, cfg.max_pose)
    else:
        rng = np.random.default_rng(cfg.table_seed)
        variances = rng.uniform(
            min_var, max_var, (cfg.num_variances, 5)
        ).astype(np.float32)
        poses = rng.uniform(
            np.asarray(cfg.min_pose, np.float32),
            np.asarray(cfg.max_pose, np.float32),
            (cfg.num_poses, 3),
        ).astype(np.float32)
    return poses, variances


def _check_table_idx(idx, table_len: int, name: str) -> None:
    """Host-side bounds check before indexing the tables (negative decoded
    indices would otherwise wrap to the tail rows)."""
    idx = np.asarray(idx)
    if idx.size and (idx.min() < 0 or idx.max() >= table_len):
        raise ValueError(
            f"{name} index out of range [0, {table_len}): input rows "
            f"reference rows {idx.min()}..{idx.max()} — the input was "
            "generated against different tables?"
        )


def _batch_configs(positions, pose_idx, var_idx, poses_t: torch.Tensor,
                   std_devs_t: torch.Tensor) -> Configs:
    """Configs of relabel input rows, gathered from the device-resident
    tables (a gather computes nothing, so the rows equal a host gather
    bit for bit). Indices must be bounds-checked first."""
    dev = poses_t.device
    pose_cols = poses_t.index_select(
        0, torch.as_tensor(np.asarray(pose_idx, np.int64), device=dev))
    return Configs(
        position=torch.as_tensor(np.ascontiguousarray(positions, np.float32),
                                 device=dev),
        pose_theta=pose_cols[:, 2],
        obstacle_wh=pose_cols[:, 0:2],
        std_dev=std_devs_t.index_select(
            0, torch.as_tensor(np.asarray(var_idx, np.int64), device=dev)),
    )


def _opt_schedule(cfg, key, probe: Configs, accuracy_bins,
                  bin_accuracy) -> tuple[int, ...]:
    """``schedule='opt'``: a 16,384-sample fixed-budget probe of the
    workload's collision probabilities (on ``cfg.impl``), then the
    checkpoints that minimise expected sample slots for them. The
    checkpoints only move WHERE the per-bin criterion is tested; every
    label keeps the same guarantee."""
    from collide2d_tpu_torch.mc.schedule_sim import (
        min_convergence_points,
        optimize_checkpoints,
    )

    est_cp = collision_probability(key, probe, cfg.robot_wh, 1 << 14,
                                   impl=cfg.impl).cpu().numpy().astype(np.float64)
    base = AdaptiveConfig(
        accuracy_bins=tuple(float(x) for x in accuracy_bins),
        bin_accuracy=tuple(float(x) for x in bin_accuracy),
        max_samples=cfg.max_samples,
    )
    n_min, _ = min_convergence_points(est_cp, base, seed=0)
    pts = optimize_checkpoints(n_min, base)
    _log(cfg, f"opt schedule: {len(pts)} checkpoints from a {probe.num}-row "
              f"cp probe: {list(pts)[:8]}...")
    return tuple(pts)


def _label_batch(key, positions, pose_idx, var_idx, poses, std_devs, robot_wh,
                 adaptive: AdaptiveConfig, device, progress=None,
                 checkpoint_path=None, checkpoint_every: int = 0,
                 mesh=None) -> np.ndarray:
    """Label one batch (ztest's core): host gather of the table rows, one
    adaptive run on ``device``, rows back in INPUT order."""
    pose_idx = np.asarray(pose_idx, np.int64)
    var_idx = np.asarray(var_idx, np.int64)
    poses = np.asarray(poses, np.float32)
    std_devs = np.asarray(std_devs, np.float32)
    _check_table_idx(pose_idx, len(poses), "pose_idx")
    _check_table_idx(var_idx, len(std_devs), "var_idx")
    pose_rows = poses[pose_idx]
    f32 = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, np.float32), device=device)
    configs = Configs(
        position=f32(positions),
        pose_theta=f32(pose_rows[:, 2]),
        obstacle_wh=f32(pose_rows[:, 0:2]),
        std_dev=f32(std_devs[var_idx]),
    )
    cp, _, _ = adaptive_collision_probabilities(
        key, configs, robot_wh, adaptive, progress=progress,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        mesh=mesh,
    )
    return schemas.pack_dataset_rows(positions, cp, var_idx, pose_idx)


def _shuffle_rows(rows: np.ndarray, enabled: bool) -> np.ndarray:
    """Batch shuffle with the reference's fixed seed-0 engine
    (generate_dataset.cu:496)."""
    if not enabled:
        return rows
    return rows[native.std_shuffle_perm(len(rows), 0)]


def _pending_batches(cfg, num_batches: int, target_of) -> list[int]:
    """Batch indices still to label (``resume`` skips existing outputs)."""
    pending = []
    for batch_index in range(num_batches):
        target = target_of(batch_index)
        if cfg.resume and target.exists():
            _log(cfg, f"resume: skipping existing {target.name}")
            continue
        pending.append(batch_index)
    return pending


def _checkpoint_path(cfg, directory: Path, abs_index: int):
    """One checkpoint file per in-flight batch, named by its absolute
    index (batch counts read numeric names only, and balance skips
    checkpoint*), or None when checkpoints are off."""
    return directory / f"checkpoint_{abs_index}.npz" if cfg.checkpoint_every else None


class GenerateStats(NamedTuple):
    """What one `generate_dataset` or `relabel_dataset` call did, for
    progress reports and measurements: host clock seconds, counted from
    the start of labeling."""

    setup_seconds: float          # tables (sample or load, save, upload)
    label_seconds: float          # run_interleaved, writes flushed
    rows: int                     # configurations labeled
    samples_used: int             # sum of per-row sample denominators
    slots_dispatched: int         # device sample-slots dispatched


def _interleaved_finish(cfg, writer, state, num_batches: int, begin: float):
    """`run_interleaved`'s on_done: materialize -> pack (input order) ->
    shuffle -> async write -> progress line. The tag's columns are host
    arrays or pending `_CopyToHost` copies."""
    def host(x):
        return x.numpy() if isinstance(x, _CopyToHost) else x

    def _finish(tag, run):
        cp, n_used, _ = run.materialize()
        state["rows"] += len(cp)
        state["samples_used"] += int(n_used.sum())
        state["slots"] += run.ops.dispatched_slots
        with span("pipeline/pack"):
            rows = schemas.pack_dataset_rows(
                host(tag["positions"]), cp, host(tag["var_idx"]),
                host(tag["pose_idx"]),
            )
        with span("pipeline/shuffle"):
            rows = _shuffle_rows(rows, cfg.shuffle)
        writer.submit(tag["target"], rows)
        state["done"] += 1
        mins = (time.monotonic() - begin) / 60.0
        _log(cfg, f"batches generated: {state['done']}/{num_batches}, "
                  f"Time: {mins:.1f} [min]")
    return _finish


# ---------------------------------------------------------------------------
# Mode 1: generate (generate_dataset.cu main)
# ---------------------------------------------------------------------------


def generate_dataset(cfg: GenerateConfig) -> GenerateStats:
    device = torch.device(cfg.device)
    t_setup = time.monotonic()
    data_dir = mkdirs(cfg.data_dir)
    _log(cfg, f"data dir: {cfg.data_dir}")
    _log(cfg, f"num batches: {cfg.num_batches}")
    _log(cfg, f"num batch: {cfg.batch_size}")
    _log(cfg, f"start batch count: {cfg.start_batch_count}")

    # Pose/variance tables: sample or reuse (generate_dataset.cu:282-336).
    with span("pipeline/load_tables"):
        variances = (schemas.validate_variances(load_npy(cfg.variance_dir))
                     if cfg.variance_dir else None)
        poses = (schemas.validate_poses(load_npy(cfg.pose_dir))
                 if cfg.pose_dir else None)
        if poses is None or variances is None:
            sampled_poses, sampled_variances = _sample_tables(cfg)
            if variances is None:
                variances = sampled_variances
                save_npy(data_dir / "variances.npy", variances)
            if poses is None:
                poses = sampled_poses
                save_npy(data_dir / "poses.npy", poses)
        std_devs = np.sqrt(variances)  # generate_dataset.cu:310-317

    _log(cfg, f"num poses: {len(poses)}")
    _log(cfg, f"num variances: {len(variances)}")

    # Meta artifacts (generate_dataset.cu:346-352).
    save_npy(data_dir / "meta" / "accuracy_bins.npy",
             np.asarray(cfg.accuracy_bins, np.float32))
    save_npy(data_dir / "meta" / "bin_accuracy.npy",
             np.asarray(cfg.bin_accuracy, np.float32))

    key = _master_key(cfg.seed)
    # Device-resident tables, uploaded once per run.
    with span("pipeline/upload"):
        poses_t = torch.as_tensor(poses, device=device)
        std_devs_t = torch.as_tensor(std_devs, device=device)
    if cfg.schedule == "opt":
        # Probe a fresh draw of the workload's configurations.
        probe_key = prng.fold_in(key, 0x5EED)
        positions, _, _, pose_cols, sd_rows = sample_configuration_batch(
            probe_key, poses_t, std_devs_t,
            num_configs=min(16384, cfg.batch_size),
            r_offset=cfg.r_offset, spread=cfg.spread,
        )
        probe = Configs(position=positions, pose_theta=pose_cols[:, 2],
                        obstacle_wh=pose_cols[:, 0:2], std_dev=sd_rows)
        cfg = dataclasses.replace(cfg, schedule=_opt_schedule(
            cfg, prng.fold_in(probe_key, 1), probe, cfg.accuracy_bins,
            cfg.bin_accuracy))
    adaptive = AdaptiveConfig(
        accuracy_bins=tuple(cfg.accuracy_bins),
        bin_accuracy=tuple(cfg.bin_accuracy), max_samples=cfg.max_samples,
        impl=cfg.impl, schedule=cfg.schedule, prune_sigma=cfg.prune_sigma,
        ladder=cfg.ladder,
    )

    # The batch writer and shuffle build the native library at first use
    # (seconds of g++): that is set-up, not labeling.
    native.available()

    _log(cfg, f"Total number of configurations: {cfg.batch_size * cfg.num_batches}")
    _log(cfg, "Begin computation...")
    begin = time.monotonic()
    overlap = max(1, int(cfg.overlap_batches or 1))
    mesh = _mesh_for(cfg)
    pending = _pending_batches(
        cfg, cfg.num_batches,
        lambda i: batch_path(data_dir, cfg.start_batch_count + i))
    progress_state = {"done": cfg.num_batches - len(pending), "samples_used": 0,
                      "slots": 0, "rows": 0}

    def _start(batch_index: int):
        abs_index = cfg.start_batch_count + batch_index
        k_init, k_mc = prng.split(prng.fold_in(key, abs_index))
        positions, pose_idx, var_idx, pose_cols, sd_rows = (
            sample_configuration_batch(
                k_init, poses_t, std_devs_t, num_configs=cfg.batch_size,
                r_offset=cfg.r_offset, spread=cfg.spread,
            )
        )
        configs = Configs(
            position=positions,
            pose_theta=pose_cols[:, 2],
            obstacle_wh=pose_cols[:, 0:2],
            std_dev=sd_rows,
        )
        run = AdaptiveRun(
            k_mc, configs, cfg.robot_wh, adaptive,
            progress=_progress_logger(cfg, cfg.batch_size),
            checkpoint_path=_checkpoint_path(cfg, data_dir, abs_index),
            checkpoint_every=cfg.checkpoint_every,
            mesh=mesh,
        )
        # The host needs positions/indices only at pack time: start the
        # copies now, off the critical path.
        tag = dict(
            target=batch_path(data_dir, abs_index),
            positions=_CopyToHost(positions),
            pose_idx=_CopyToHost(pose_idx),
            var_idx=_CopyToHost(var_idx),
        )
        return tag, run

    with native.AsyncNpyWriter() as writer, trace(cfg.trace_dir or None):
        run_interleaved(
            [functools.partial(_start, i) for i in pending],
            overlap,
            _interleaved_finish(cfg, writer, progress_state,
                                cfg.num_batches, begin),
        )
        errors = writer.flush()
        if errors:
            raise IOError(f"{errors} batch file(s) failed to write")
    _log(cfg, "Finished computation")
    return GenerateStats(
        setup_seconds=begin - t_setup,
        label_seconds=time.monotonic() - begin,
        rows=progress_state["rows"],
        samples_used=progress_state["samples_used"],
        slots_dispatched=progress_state["slots"],
    )


# ---------------------------------------------------------------------------
# Mode 2: relabel (compute_collision_probability.cu main)
# ---------------------------------------------------------------------------


def _pinned_start(cfg: RelabelConfig, marker: Path, start_batch_count: int,
                  num_batches: int) -> int:
    """The output numbering of a ``resume`` run: the window that the
    ``.relabel_start`` marker pins when it carries this run's identity
    (input directory, seed, batch count); otherwise a new marker pins
    ``start_batch_count``. A marker left by another run, or an unreadable
    one, is overwritten: pinning its window would skip this run's batches
    as already written."""
    if cfg.seed is None:
        raise ValueError("relabel resume needs a fixed seed (the batch keys "
                         "must reproduce)")
    identity = {"data_in": str(Path(cfg.data_in).resolve()),
                "seed": int(cfg.seed), "num_batches": int(num_batches)}
    if marker.exists():
        try:
            saved = json.loads(marker.read_text())
            if (isinstance(saved, dict)
                    and {k: saved.get(k) for k in identity} == identity):
                return int(saved["start"])
        except (ValueError, KeyError, OSError):
            pass
    marker.write_text(json.dumps({"start": start_batch_count, **identity}))
    return start_batch_count


def relabel_dataset(cfg: RelabelConfig) -> GenerateStats:
    """Relabel every (N, 4) batch of ``data_in`` into ``data_out``: rows
    keep their input order (before the optional shuffle), batch ``i``
    labels with ``fold_in(key, i)`` and is written as batch
    ``existing + i`` (compute_collision_probability.cu:157). The tables
    and meta are ``data_out``'s."""
    device = torch.device(cfg.device)
    t_setup = time.monotonic()
    data_in = Path(cfg.data_in)
    data_out = mkdirs(cfg.data_out)
    start_batch_count = get_num_batches_in_dir(data_out)
    num_batches = get_num_batches_in_dir(data_in)
    marker = data_out / ".relabel_start"
    if cfg.resume:
        start_batch_count = _pinned_start(cfg, marker, start_batch_count,
                                          num_batches)

    _log(cfg, "Reading data...")
    with span("pipeline/load_tables"):
        poses = schemas.validate_poses(load_npy(data_out / "poses.npy"))
        variances = schemas.validate_variances(load_npy(data_out / "variances.npy"))
        accuracy_bins = load_npy(data_out / "meta" / "accuracy_bins.npy")
        bin_accuracy = load_npy(data_out / "meta" / "bin_accuracy.npy")
        std_devs = np.sqrt(variances)
    _log(cfg, f"num poses: {len(poses)}")
    _log(cfg, f"num variances: {len(variances)}")

    key = _master_key(cfg.seed)
    with span("pipeline/upload"):
        poses_t = torch.as_tensor(poses, device=device)
        std_devs_t = torch.as_tensor(std_devs, device=device)

    def read_batch(batch_index: int):
        positions, var_idx, pose_idx = schemas.unpack_relabel_rows(
            load_npy(batch_path(data_in, batch_index)))
        pose_idx = np.asarray(pose_idx, np.int64)
        var_idx = np.asarray(var_idx, np.int64)
        _check_table_idx(pose_idx, len(poses), "pose_idx")
        _check_table_idx(var_idx, len(std_devs), "var_idx")
        return positions, var_idx, pose_idx

    if cfg.schedule == "opt":
        # The input rows are the workload: probe the first batch's rows.
        positions, var_idx, pose_idx = read_batch(0)
        n = min(16384, len(positions))
        probe = _batch_configs(positions[:n], pose_idx[:n], var_idx[:n],
                               poses_t, std_devs_t)
        cfg = dataclasses.replace(cfg, schedule=_opt_schedule(
            cfg, prng.fold_in(key, 0x5EED), probe, accuracy_bins,
            bin_accuracy))
    adaptive = AdaptiveConfig(
        accuracy_bins=tuple(float(x) for x in accuracy_bins),
        bin_accuracy=tuple(float(x) for x in bin_accuracy),
        max_samples=cfg.max_samples, impl=cfg.impl, schedule=cfg.schedule,
        prune_sigma=cfg.prune_sigma, ladder=cfg.ladder,
    )
    native.available()  # the writer's g++ build is set-up, not labeling
    mesh = _mesh_for(cfg)

    def _start(batch_index: int):
        positions, var_idx, pose_idx = read_batch(batch_index)
        configs = _batch_configs(positions, pose_idx, var_idx, poses_t,
                                 std_devs_t)
        abs_index = start_batch_count + batch_index
        run = AdaptiveRun(
            prng.fold_in(key, batch_index), configs, cfg.robot_wh, adaptive,
            progress=_progress_logger(cfg, len(positions)),
            checkpoint_path=_checkpoint_path(cfg, data_out, abs_index),
            checkpoint_every=cfg.checkpoint_every,
            mesh=mesh,
        )
        tag = dict(target=batch_path(data_out, abs_index),
                   positions=positions, pose_idx=pose_idx, var_idx=var_idx)
        return tag, run

    pending = _pending_batches(
        cfg, num_batches, lambda i: batch_path(data_out, start_batch_count + i))
    _log(cfg, "Begin computation...")
    begin = time.monotonic()
    state = {"done": num_batches - len(pending), "samples_used": 0, "slots": 0,
             "rows": 0}
    with native.AsyncNpyWriter() as writer, trace(cfg.trace_dir or None):
        run_interleaved(
            [functools.partial(_start, i) for i in pending],
            max(1, int(cfg.overlap_batches or 1)),
            _interleaved_finish(cfg, writer, state, num_batches, begin),
        )
        errors = writer.flush()
        if errors:
            raise IOError(f"{errors} batch file(s) failed to write")
    marker.unlink(missing_ok=True)  # a clean finish: the next relabel appends
    _log(cfg, "Finished computation")
    return GenerateStats(
        setup_seconds=begin - t_setup,
        label_seconds=time.monotonic() - begin,
        rows=state["rows"],
        samples_used=state["samples_used"],
        slots_dispatched=state["slots"],
    )


# ---------------------------------------------------------------------------
# Mode 3: ztest (ztest.cu main) — high-precision validation of one file
# ---------------------------------------------------------------------------


def ztest(cfg: ZTestConfig) -> np.ndarray:
    data_dir = Path(cfg.data_dir)
    if not data_dir.exists():
        raise FileNotFoundError(f"data_dir {data_dir} does not exist")

    # Default meta bins written when absent (ztest.cu:186-194).
    if cfg.meta_dir:
        meta_dir = Path(cfg.meta_dir)
    else:
        meta_dir = data_dir / "meta"
        mkdirs(meta_dir)
        if not (meta_dir / "accuracy_bins.npy").exists():
            save_npy(meta_dir / "accuracy_bins.npy",
                     np.asarray([0.0, 0.01, 0.1, 1.0], np.float32))
            save_npy(meta_dir / "bin_accuracy.npy",
                     np.asarray([0.0001, 0.001, 0.01], np.float32))
    data_file_in = Path(cfg.data_file_in) if cfg.data_file_in else data_dir / "tmp" / "0.npy"
    data_file_out = Path(cfg.data_file_out) if cfg.data_file_out else data_dir / "0.npy"
    if not cfg.data_file_in:
        _log(cfg, f"Using default input file: {data_file_in}")
    if not cfg.data_file_out:
        _log(cfg, f"Using default output file: {data_file_out}")
    if data_file_out.exists():
        _log(cfg, f"Warning: {data_file_out} already exists, will be overwritten")

    poses = schemas.validate_poses(load_npy(data_dir / "poses.npy"))
    variances = schemas.validate_variances(load_npy(data_dir / "variances.npy"))
    accuracy_bins = load_npy(meta_dir / "accuracy_bins.npy")
    bin_accuracy = load_npy(meta_dir / "bin_accuracy.npy")
    std_devs = np.sqrt(variances)

    rows_in = load_npy(data_file_in)
    positions, var_idx, pose_idx = schemas.unpack_relabel_rows(rows_in)
    _log(cfg, f"num poses: {len(poses)}")
    _log(cfg, f"num variances: {len(variances)}")
    _log(cfg, f"num data points: {len(positions)}")

    # ztest.cu:332 fixes 10k samples per round; an explicit schedule
    # replaces that cadence (fixed_batch would win inside batch_for).
    if cfg.schedule == "opt":
        raise ValueError(
            "schedule='opt' is a generate/relabel feature (they probe a "
            "whole workload's cp distribution); ztest validates ONE file "
            "at a fixed cadence — pass an explicit checkpoint tuple or "
            "'tuned' to change it"
        )
    adaptive = AdaptiveConfig(
        accuracy_bins=tuple(float(x) for x in accuracy_bins),
        bin_accuracy=tuple(float(x) for x in bin_accuracy),
        max_samples=cfg.max_samples,
        fixed_batch=None if cfg.schedule is not None else cfg.n_batch,
        impl=cfg.impl,
        schedule=cfg.schedule,
        prune_sigma=cfg.prune_sigma,
        ladder=cfg.ladder,
    )
    mesh = cfg.mesh
    if mesh is None and cfg.sample_parallel and cfg.sample_parallel > 1:
        if cfg.n_batch % cfg.sample_parallel:
            raise ValueError(
                f"sample_parallel={cfg.sample_parallel} must divide "
                f"n_batch={cfg.n_batch}"
            )
        # Pure sample sharding: a (config=1, sample=s) mesh; the deep
        # per-pair budget is the axis that scales here.
        mesh = _mesh_for(cfg)
    with trace(cfg.trace_dir or None):
        rows = _label_batch(
            _master_key(cfg.seed), positions, pose_idx, var_idx, poses,
            std_devs, cfg.robot_wh, adaptive, torch.device(cfg.device),
            progress=_progress_logger(cfg, len(positions)),
            checkpoint_path=(data_dir / "ztest_checkpoint.npz"
                             if cfg.checkpoint_every else None),
            checkpoint_every=cfg.checkpoint_every, mesh=mesh,
        )
    out = rows[:, 2].copy() if cfg.cps_only else rows  # ztest.cu:391-396
    if cfg.shuffle:
        out = out[native.std_shuffle_perm(len(out), 0)]
    save_npy(data_file_out, out)
    _log(cfg, "Finished computation")
    return out
