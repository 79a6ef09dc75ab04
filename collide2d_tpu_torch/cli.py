"""Command-line interface of the port (console script ``collide2d-torch``):

    collide2d-torch generate ...   # generate_dataset.cu
    collide2d-torch relabel  ...   # compute_collision_probability.cu
    collide2d-torch ztest    ...   # ztest.cu
    collide2d-torch compare  ...   # label-agreement report
    collide2d-torch polylabel ...  # adaptive labels of convex k-gon configurations
    collide2d-torch movelabel ...  # adaptive labels of trajectories (moving robots)
    collide2d-torch bench     ...  # throughput benchmarks (utils/benchmarks.py)
    collide2d-torch balance   ...  # balance datasets across cp bins (balance_datasets.py)
    collide2d-torch show      ...  # contour plot of one (var, pose) slice (show_data.ipynb)
    collide2d-torch train     ...  # fit the learned collision model on a generated dataset
    collide2d-torch predict   ...  # its cps for one batch file (ztest --cps_only schema)

Flag names and defaults are the JAX package's (``collide2d_tpu/cli.py``,
after the reference's generate_dataset.cu:66-169 and ztest.cu:49-101),
plus ``--device`` (default ``cuda``). ``--impl`` takes ``auto`` (= the
fused kernel, ``cuda``), ``cuda`` or ``threefry`` (the per-draw reference
path). ``--data_parallel`` spreads the configuration axis over every
device of ``--device``'s kind (every visible card; one CPU device is no
mesh) and ``--sample_parallel S`` each configuration's samples over S of
them; labels are bitwise a single-device run's (`parallel`). A
``--sample_parallel`` larger than the device count exits with an error.
``--trace_dir`` writes a ``torch.profiler`` trace of generate, relabel,
ztest, polylabel or movelabel, with the program's spans
(`utils.profiling.span`). A negative ``--checkpoint_every`` is an error
(the JAX package reads it as "every group").
"""

from __future__ import annotations

import argparse
import sys

from collide2d_tpu_torch.data.pipeline import (
    GenerateConfig,
    RelabelConfig,
    ZTestConfig,
    _mesh_for,
    generate_dataset,
    relabel_dataset,
    ztest,
)
from collide2d_tpu_torch.utils.profiling import span, trace

_IMPL_HELP = ("MC sampler: auto = cuda, the fused kernel (on a CPU device "
              "its plain torch version); threefry = the per-draw reference "
              "path with the JAX package's jnp streams")


def _bool_flag(value: str) -> bool:
    if value.lower() in ("1", "true", "yes", "on"):
        return True
    if value.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {value!r}")


def _checkpoint_every(value: str) -> int:
    n = int(value)
    if n < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {n}")
    return n


def _add_common(p: argparse.ArgumentParser, checkpoint_help: str) -> None:
    """Flags shared by generate, relabel and ztest."""
    p.add_argument("--schedule", default="reference",
                   choices=["reference", "tuned", "opt"],
                   help="convergence-checkpoint schedule: 'reference' (the "
                        "mode's reference cadence), 'tuned' (one extra "
                        "rule-of-three checkpoint) or 'opt' (generate and "
                        "relabel: checkpoints placed from a probe of the "
                        "workload's cp distribution); all keep the same CI "
                        "guarantees")
    p.add_argument("--prune_sigma", type=float, default=0.0,
                   help="noise-aware pruning: configurations that cannot "
                        "touch within this many std-devs get cp=0 without "
                        "sampling (0 = off, the reference; at 6 the label "
                        "error is ~1e-8, far below every accuracy bin)")
    p.add_argument("--ladder", default="eighth",
                   choices=["half", "quarter", "eighth", "sixteenth"],
                   help="repack bucket ladder granularity")
    p.add_argument("--impl", default="auto",
                   choices=["auto", "cuda", "threefry"], help=_IMPL_HELP)
    p.add_argument("--device", default="cuda",
                   help="torch device the tables and labeling run on")
    p.add_argument("--checkpoint_every", type=_checkpoint_every, default=0,
                   help=checkpoint_help)
    p.add_argument("--trace_dir", default="",
                   help="write a torch.profiler trace (Chrome JSON) of the "
                        "labeling into this directory")
    p.add_argument("--verbose", type=_bool_flag, default=True,
                   help="per-sync progress lines + batch progress")


def _require_devices(name: str, args: argparse.Namespace) -> None:
    """Exit, as the JAX CLI does, when ``--sample_parallel`` asks for more
    devices than ``--device``'s kind has."""
    from collide2d_tpu_torch.parallel.sharding import local_devices

    s = getattr(args, "sample_parallel", 0)
    if s and s > 1:
        n = len(local_devices(args.device))
        if n < s:
            raise SystemExit(f"{name}: sample_parallel={s} needs that many "
                             f"devices, have {n}")


_BATCH_CHECKPOINT_HELP = "rounds between mid-batch checkpoints (0 = off)"


def _schedule_arg(args: argparse.Namespace):
    return None if args.schedule in (None, "reference") else args.schedule


def _add_generate(sub) -> None:
    d = GenerateConfig()
    p = sub.add_parser("generate", help="create a labeled collision dataset")
    p.add_argument("--data_dir", default=d.data_dir, help="where to store the data")
    p.add_argument("--num_batches", "-n", type=int, default=d.num_batches,
                   help="number of batches")
    p.add_argument("--batch_size", "-b", type=int, default=d.batch_size,
                   help="number of samples per batch")
    p.add_argument("--start_batch_count", "-s", type=int, default=d.start_batch_count,
                   help="start value for batches")
    p.add_argument("--num_poses", type=int, default=d.num_poses, help="number of poses")
    p.add_argument("--num_variances", type=int, default=d.num_variances,
                   help="number of variances")
    p.add_argument("--shape_variance", action="store_true",
                   help="whether or not to have shape variance")
    p.add_argument("--max_samples", type=int, default=d.max_samples,
                   help="maximum number of samples for z-test")
    p.add_argument("--accuracy_bins", type=float, nargs="+",
                   default=list(d.accuracy_bins),
                   help="accuracy bins e.g. 0.0 0.01 0.1 1.0")
    p.add_argument("--bin_accuracy", type=float, nargs="+",
                   default=list(d.bin_accuracy),
                   help="accuracy for each bin e.g. 0.0001 0.001 0.01")
    p.add_argument("--min_variance", type=float, nargs=5, default=list(d.min_variance),
                   help="min variance for each dimension")
    p.add_argument("--max_variance", type=float, nargs=5, default=list(d.max_variance),
                   help="max variance for each dimension")
    p.add_argument("--min_pose", type=float, nargs=3, default=list(d.min_pose),
                   help="min pose for each dimension")
    p.add_argument("--max_pose", type=float, nargs=3, default=list(d.max_pose),
                   help="max pose for each dimension")
    p.add_argument("--robot_width", "-w", type=float, default=d.robot_width)
    p.add_argument("--robot_height", type=float, default=d.robot_height)
    p.add_argument("--spread", type=float, default=d.spread, help="spread of poses")
    p.add_argument("--pose_dir", default=d.pose_dir, help="directory of poses")
    p.add_argument("--variance_dir", default=d.variance_dir,
                   help="directory of variances")
    p.add_argument("--seed", type=int, default=None,
                   help="device PRNG seed (default: time-based, like the reference)")
    p.add_argument("--refcompat_tables", action="store_true",
                   help="bit-identical libstdc++ pose/variance table sampling")
    p.add_argument("--no_shuffle", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="skip existing batch files and resume mid-batch from "
                        "data_dir/checkpoint_{batch}.npz (one per in-flight "
                        "pipelined batch; requires a fixed --seed)")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the configuration axis over every device of "
                        "--device's kind (labels unchanged)")
    p.add_argument("--overlap_batches", type=int, default=d.overlap_batches,
                   help="cross-batch pipelining depth: batch i+1's rounds "
                        "interleave with batch i's convergence tail; "
                        "outputs are bitwise-identical across all depths")
    _add_common(p, _BATCH_CHECKPOINT_HELP)
    p.set_defaults(func=_run_generate)


def generate_config(args: argparse.Namespace) -> GenerateConfig:
    """The `GenerateConfig` of parsed ``generate`` arguments."""
    return GenerateConfig(
        data_dir=args.data_dir,
        pose_dir=args.pose_dir,
        variance_dir=args.variance_dir,
        num_batches=args.num_batches,
        batch_size=args.batch_size,
        start_batch_count=args.start_batch_count,
        num_poses=args.num_poses,
        num_variances=args.num_variances,
        max_samples=args.max_samples,
        min_variance=tuple(args.min_variance),
        max_variance=tuple(args.max_variance),
        min_pose=tuple(args.min_pose),
        max_pose=tuple(args.max_pose),
        accuracy_bins=tuple(args.accuracy_bins),
        bin_accuracy=tuple(args.bin_accuracy),
        robot_width=args.robot_width,
        robot_height=args.robot_height,
        spread=args.spread,
        shape_variance=args.shape_variance,
        seed=args.seed,
        refcompat_tables=args.refcompat_tables,
        shuffle=not args.no_shuffle,
        overlap_batches=args.overlap_batches,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        schedule=_schedule_arg(args),
        prune_sigma=args.prune_sigma,
        verbose=args.verbose,
        impl=args.impl,
        ladder=args.ladder,
        data_parallel=args.data_parallel,
        trace_dir=args.trace_dir,
        device=args.device,
    )


def _run_generate(args: argparse.Namespace) -> int:
    generate_dataset(generate_config(args))
    return 0


def _add_relabel(sub) -> None:
    d = RelabelConfig()
    p = sub.add_parser(
        "relabel",
        help="recompute collision probabilities for an existing dataset",
    )
    p.add_argument("--data_in", default=d.data_in, help="where to read the data")
    p.add_argument("--data_out", default=d.data_out, help="where to write the data")
    p.add_argument("--max_samples", type=int, default=d.max_samples)
    p.add_argument("--robot_width", "-w", type=float, default=d.robot_width)
    p.add_argument("--robot_height", type=float, default=d.robot_height)
    p.add_argument("--shuffle", type=_bool_flag, default=d.shuffle,
                   help="whether or not to shuffle data")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the configuration axis over every device of "
                        "--device's kind (labels unchanged)")
    p.add_argument("--sample_parallel", type=int, default=d.sample_parallel,
                   help="shard each configuration's samples over this many "
                        "devices (labels unchanged; ignored with "
                        "--data_parallel)")
    p.add_argument("--resume", action="store_true",
                   help="skip already-written output batches and resume "
                        "mid-batch from per-batch checkpoint files "
                        "(requires a fixed --seed; the first run's "
                        "output-numbering window is pinned so a rerun "
                        "never appends a second copy)")
    p.add_argument("--overlap_batches", type=int, default=d.overlap_batches,
                   help="cross-batch pipelining depth (see generate "
                        "--overlap_batches); outputs do not depend on it")
    _add_common(p, _BATCH_CHECKPOINT_HELP)
    p.set_defaults(func=_run_relabel)


def relabel_config(args: argparse.Namespace) -> RelabelConfig:
    """The `RelabelConfig` of parsed ``relabel`` arguments."""
    return RelabelConfig(
        data_in=args.data_in,
        data_out=args.data_out,
        max_samples=args.max_samples,
        robot_width=args.robot_width,
        robot_height=args.robot_height,
        shuffle=args.shuffle,
        seed=args.seed,
        verbose=args.verbose,
        impl=args.impl,
        schedule=_schedule_arg(args),
        prune_sigma=args.prune_sigma,
        ladder=args.ladder,
        overlap_batches=args.overlap_batches,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        data_parallel=args.data_parallel,
        sample_parallel=args.sample_parallel,
        trace_dir=args.trace_dir,
        device=args.device,
    )


def _run_relabel(args: argparse.Namespace) -> int:
    if not args.data_parallel:
        _require_devices("relabel", args)
    relabel_dataset(relabel_config(args))
    return 0


def _add_ztest(sub) -> None:
    d = ZTestConfig()
    p = sub.add_parser("ztest", help="high-precision relabel of one file")
    p.add_argument("--data_dir", default=d.data_dir, help="where to read the data")
    p.add_argument("--data_file_in", default=d.data_file_in)
    p.add_argument("--data_file_out", default=d.data_file_out)
    p.add_argument("--max_samples", type=int, default=d.max_samples)
    p.add_argument("--robot_width", "-w", type=float, default=d.robot_width)
    p.add_argument("--robot_height", type=float, default=d.robot_height)
    p.add_argument("--shuffle", type=_bool_flag, default=d.shuffle,
                   help="shuffle the written artifact")
    p.add_argument("--cps_only", type=_bool_flag, default=d.cps_only,
                   help="whether or not to only compute collision probabilities")
    p.add_argument("--meta_dir", default=d.meta_dir,
                   help="path to meta folder containing accuracy_bins.npy and "
                        "bin_accuracy.npy")
    p.add_argument("--n_batch", type=int, default=d.n_batch,
                   help="samples per round (fixed schedule)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--sample_parallel", type=int, default=d.sample_parallel,
                   help="shard each configuration's samples over this many "
                        "devices (must divide --n_batch; labels unchanged)")
    _add_common(p, "rounds between mid-run checkpoints to "
                   "data_dir/ztest_checkpoint.npz (0 = off; a rerun with the "
                   "same --seed auto-resumes from it)")
    p.set_defaults(func=_run_ztest)


def _run_ztest(args: argparse.Namespace) -> int:
    _require_devices("ztest", args)
    ztest(ZTestConfig(
        data_dir=args.data_dir,
        data_file_in=args.data_file_in,
        data_file_out=args.data_file_out,
        max_samples=args.max_samples,
        robot_width=args.robot_width,
        robot_height=args.robot_height,
        shuffle=args.shuffle,
        cps_only=args.cps_only,
        meta_dir=args.meta_dir,
        n_batch=args.n_batch,
        seed=args.seed,
        verbose=args.verbose,
        impl=args.impl,
        schedule=_schedule_arg(args),
        prune_sigma=args.prune_sigma,
        ladder=args.ladder,
        checkpoint_every=args.checkpoint_every,
        sample_parallel=args.sample_parallel,
        trace_dir=args.trace_dir,
        device=args.device,
    ))
    return 0


def _add_compare(sub) -> None:
    p = sub.add_parser(
        "compare",
        help="label-agreement report between two labelings of the same rows",
    )
    p.add_argument("file_a", help=".npy: (N,5) dataset rows or (N,) cps")
    p.add_argument("file_b", help=".npy: same configurations, same order")
    p.add_argument("--n_samples_a", type=float, default=4_000_000)
    p.add_argument("--n_samples_b", type=float, default=4_000_000)
    p.add_argument("--tolerance", type=float, default=0.005)
    p.set_defaults(func=_run_compare)


def _run_compare(args: argparse.Namespace) -> int:
    import numpy as np

    from collide2d_tpu_torch.data.validate import compare_labels

    report = compare_labels(
        np.load(args.file_a), np.load(args.file_b),
        n_samples_a=args.n_samples_a, n_samples_b=args.n_samples_b,
        tolerance=args.tolerance,
    )
    print(report)
    return 0 if report.frac_within_tolerance >= 0.95 else 1


def _add_label_flags(p: argparse.ArgumentParser, impl_help: str = _IMPL_HELP) -> None:
    """Flags shared by the adaptive-labeling commands (polylabel,
    movelabel)."""
    p.add_argument("--max_samples", type=int, default=4_000_000,
                   help="per-configuration sample cap")
    p.add_argument("--accuracy_bins", type=float, nargs="+",
                   default=[0.0, 0.01, 0.1, 1.0])
    p.add_argument("--bin_accuracy", type=float, nargs="+",
                   default=[1e-4, 1e-3, 1e-2])
    p.add_argument("--impl", default="auto",
                   choices=["auto", "cuda", "threefry"], help=impl_help)
    p.add_argument("--schedule", default="reference",
                   choices=["reference", "tuned"],
                   help="convergence-checkpoint schedule: 'reference' or "
                        "'tuned' (one extra rule-of-three checkpoint); both "
                        "keep the same CI guarantees")
    p.add_argument("--prune_sigma", type=float, default=0.0,
                   help="noise-aware pruning (with a trajectory's motion "
                        "reach): configurations that cannot touch within this "
                        "many std-devs get cp=0 without sampling (0 = off)")
    p.add_argument("--ladder", default="eighth",
                   choices=["half", "quarter", "eighth", "sixteenth"],
                   help="repack bucket ladder granularity")
    p.add_argument("--seed", type=int, default=None,
                   help="PRNG seed (default: time-based)")
    p.add_argument("--device", default="cuda",
                   help="torch device the labeling runs on")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the configuration axis over every device of "
                        "--device's kind (labels unchanged)")
    p.add_argument("--sample_parallel", type=int, default=0,
                   help="shard each configuration's samples over this many "
                        "devices (labels unchanged); ignored with "
                        "--data_parallel")
    p.add_argument("--checkpoint_every", type=_checkpoint_every, default=0,
                   help="rounds between mid-run checkpoints to "
                        "<data_out>.checkpoint.npz (0 = off; a rerun with "
                        "the same --seed auto-resumes from it)")
    p.add_argument("--trace_dir", default="",
                   help="write a torch.profiler trace (Chrome JSON) of the "
                        "labeling into this directory")
    p.add_argument("--verbose", type=_bool_flag, default=False)


def _label(name: str, args: argparse.Namespace, configs, robot, **cfg_extra):
    """Run the adaptive driver for a labeling command and write
    ``args.data_out``: cp, n_samples, converged (traced into
    ``args.trace_dir`` when it is set)."""
    import time

    import numpy as np

    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.driver import adaptive_collision_probabilities
    from collide2d_tpu_torch.mc.estimator import AdaptiveConfig

    cfg = AdaptiveConfig(
        accuracy_bins=tuple(args.accuracy_bins),
        bin_accuracy=tuple(args.bin_accuracy),
        max_samples=args.max_samples,
        impl=args.impl,
        prune_sigma=args.prune_sigma,
        schedule=_schedule_arg(args),
        ladder=args.ladder,
        **cfg_extra,
    )
    _require_devices(name, args)
    mesh = _mesh_for(args)
    seed = args.seed if args.seed is not None else int(time.time())
    progress = None
    if args.verbose:
        def progress(num_left, n_samples, round):
            print(f"[{name}] round {round}: left={num_left} "
                  f"n_samples={n_samples}", flush=True)
    with trace(args.trace_dir or None):
        cp, n_used, done = adaptive_collision_probabilities(
            prng.PRNGKey(seed), configs, robot, cfg, progress=progress,
            checkpoint_path=(args.data_out + ".checkpoint.npz"
                             if args.checkpoint_every else None),
            checkpoint_every=args.checkpoint_every, mesh=mesh)
        with span("pipeline/save_output"):
            np.savez(args.data_out, cp=cp, n_samples=n_used, converged=done)
    return done


def _add_polylabel(sub) -> None:
    p = sub.add_parser(
        "polylabel",
        help="adaptively label convex k-gon configurations",
    )
    p.add_argument("--data_in", required=True,
                   help=".npz with obstacle_verts (C,K,2), position (C,2), "
                        "pose_theta (C,), std_dev (C,3), robot_verts (K2,2) "
                        "[optional mask (C,K) bool for padded K-gons]")
    p.add_argument("--data_out", required=True,
                   help="output .npz: cp (C,), n_samples (C,), converged (C,)")
    _add_label_flags(p)
    p.set_defaults(func=_run_polylabel)


def _run_polylabel(args: argparse.Namespace) -> int:
    import numpy as np

    from collide2d_tpu_torch.mc.estimator import PolygonConfigs

    fields = ("obstacle_verts", "position", "pose_theta", "std_dev", "robot_verts")
    with span("pipeline/load_input"), np.load(args.data_in) as data:
        for field in fields:
            if field not in data:
                raise SystemExit(f"polylabel: {args.data_in} missing '{field}'")
        arrays = {f: data[f] for f in (*fields, "mask") if f in data}
    with span("pipeline/upload"):
        cfgs = PolygonConfigs.from_padded(
            arrays["position"], arrays["pose_theta"], arrays["obstacle_verts"],
            arrays["std_dev"], mask=arrays.get("mask"), device=args.device,
        )
    done = _label("polylabel", args, cfgs,
                  np.asarray(arrays["robot_verts"], np.float32))
    print(f"labeled {cfgs.num} configurations -> {args.data_out} "
          f"(converged {float(done.mean()):.1%})")
    return 0


def _add_movelabel(sub) -> None:
    p = sub.add_parser(
        "movelabel",
        help="adaptively label TRAJECTORY configurations: P(a moving robot "
             "hits the noisy obstacle over t in [0, t_max])",
    )
    p.add_argument("--data_in", required=True,
                   help=".npz with position (C,2), pose_theta (C,), obstacle_wh "
                        "(C,2), std_dev (C,5), velocity (C,2) [optional omega "
                        "(C,), t_max (C,), robot_wh (2,)]; k-gon trajectories: "
                        "obstacle_verts (C,K,2) and robot_verts (K2,2) instead "
                        "of obstacle_wh/robot_wh, with std_dev (C,3) pose noise")
    p.add_argument("--data_out", required=True,
                   help="output .npz: cp (C,), n_samples (C,), converged (C,)")
    p.add_argument("--robot_width", "-w", type=float, default=4.07,
                   help="robot width when data_in has no robot_wh "
                        "(generate_dataset.cu:60)")
    p.add_argument("--robot_height", type=float, default=1.74)
    p.add_argument("--ca_iters", type=int, default=48,
                   help="conservative-advancement budget per ROTATING sample "
                        "(translation-only samples take the exact window)")
    p.add_argument("--ca_tol", type=float, default=1e-4,
                   help="contact certification tolerance of the advancement")
    _add_label_flags(p, _IMPL_HELP + "; trajectory batches: 'auto' runs the "
                        "fused kernels on translation-only batches and the "
                        "threefry screened cascade on rotating ones (mc.driver)")
    p.set_defaults(func=_run_movelabel)


def movelabel_inputs(path: str, args: argparse.Namespace, device):
    """The trajectory batch and robot of a ``movelabel`` input ``.npz``:
    (`MovingConfigs`, robot (2,)) or (`MovingPolygonConfigs`, robot
    vertices (K2, 2))."""
    import numpy as np

    from collide2d_tpu_torch.mc.moving import moving_configs, moving_polygon_configs

    with span("pipeline/load_input"), np.load(path) as npz:
        poly = "obstacle_verts" in npz
        for field in ("position", "pose_theta",
                      "obstacle_verts" if poly else "obstacle_wh", "std_dev",
                      "velocity"):
            if field not in npz:
                raise SystemExit(f"movelabel: {path} missing '{field}'")
        if poly and "robot_verts" not in npz:
            raise SystemExit("movelabel: polygon input (obstacle_verts present) "
                             "requires 'robot_verts' (K2, 2)")
        data = {f: npz[f] for f in npz.files}
    motion = dict(omega=data.get("omega", 0.0), t_max=data.get("t_max", 1.0),
                  device=device)
    with span("pipeline/upload"):
        if poly:
            cfgs = moving_polygon_configs(data["position"], data["pose_theta"],
                                          data["obstacle_verts"], data["std_dev"],
                                          data["velocity"], **motion)
            return cfgs, np.asarray(data["robot_verts"], np.float32)
        cfgs = moving_configs(data["position"], data["pose_theta"],
                              data["obstacle_wh"], data["std_dev"],
                              data["velocity"], **motion)
    robot = (np.asarray(data["robot_wh"], np.float32) if "robot_wh" in data
             else np.asarray([args.robot_width, args.robot_height], np.float32))
    return cfgs, robot


def _run_movelabel(args: argparse.Namespace) -> int:
    cfgs, robot = movelabel_inputs(args.data_in, args, args.device)
    try:
        done = _label("movelabel", args, cfgs, robot, ca_iters=args.ca_iters,
                      ca_tol=args.ca_tol)
    except ValueError as e:  # e.g. --impl cuda on rotating k-gon rows
        raise SystemExit(f"movelabel: {e}") from e
    print(f"labeled {cfgs.num} trajectories -> {args.data_out} "
          f"(converged {float(done.mean()):.1%})")
    return 0


def _add_bench(sub) -> None:
    p = sub.add_parser("bench", help="throughput benchmarks on the local device")
    p.add_argument("--pairs", type=int, default=1 << 20)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="cuda: the kernel legs at their on-card sizes; cpu: "
                        "the torch legs at CPU sizes")
    p.set_defaults(func=_run_bench)


def _run_bench(args: argparse.Namespace) -> int:
    from collide2d_tpu_torch.utils.benchmarks import run_all

    for line in run_all(pairs=args.pairs, iters=args.iters, device=args.device):
        print(line, flush=True)
    return 0


def _add_balance(sub) -> None:
    p = sub.add_parser("balance", help="balance datasets across cp bins / plot histogram")
    p.add_argument("data_dirs", nargs="+", help="one or two dataset directories")
    p.add_argument("--bins", type=float, nargs="+",
                   default=[0.0, 0.001, 0.01, 0.1, 1.0])
    p.add_argument("--out", default=None, help="save balanced dataset(s) to .npy")
    p.add_argument("--hist", default="hist.svg", help="histogram output path")
    p.set_defaults(func=_run_balance)


def _run_balance(args: argparse.Namespace) -> int:
    import numpy as np

    from collide2d_tpu_torch.data import balance as bal

    datasets = [bal.load_data(d) for d in args.data_dirs]
    bal.plot_histogram(datasets[0], np.asarray(args.bins), args.hist)
    print(f"histogram -> {args.hist}")
    if len(datasets) == 2:
        bins0 = bal.compute_bin_idx(datasets[0][:, 2], args.bins)
        bins1 = bal.compute_bin_idx(datasets[1][:, 2], args.bins)
        b0, b1 = bal.balance(datasets[0], datasets[1], bins0, bins1)
        print(f"balanced sizes: {b0.shape} {b1.shape}")
        if args.out:
            np.save(args.out + "_0.npy", b0)
            np.save(args.out + "_1.npy", b1)
            print(f"saved {args.out}_0.npy {args.out}_1.npy")
    elif args.out:
        bins0 = bal.compute_bin_idx(datasets[0][:, 2], args.bins)
        np.save(args.out, bal.balance_single(datasets[0], bins0))
        print(f"saved {args.out}")
    return 0


def _add_show(sub) -> None:
    p = sub.add_parser("show", help="contour-plot cp(x,y) for one (var,pose) slice")
    p.add_argument("data_file", help="a labeled batch .npy file")
    p.add_argument("--var_idx", type=float, default=0)
    p.add_argument("--pose_idx", type=float, default=0)
    p.add_argument("--out", default="contour.png")
    p.set_defaults(func=_run_show)


def _run_show(args: argparse.Namespace) -> int:
    import numpy as np

    from collide2d_tpu_torch.data import visualize as viz

    data = np.load(args.data_file)
    x, y, z = viz.get_data_for_specific_var_and_pos(data, args.var_idx, args.pose_idx)
    if len(z) < 4:
        print(
            f"only {len(z)} rows for (var_idx={args.var_idx}, "
            f"pose_idx={args.pose_idx}); need >= 4 for interpolation. "
            "Generate with small --num_poses/--num_variances to densify slices.",
            file=sys.stderr,
        )
        return 1
    viz.plot_contour(x, y, z, args.out)
    print(f"contour -> {args.out}")
    return 0


def _add_train(sub) -> None:
    p = sub.add_parser(
        "train",
        help="fit the learned collision-probability MLP on a generated "
             "dataset (the dataset's stated downstream purpose, "
             "generate_dataset.cu:30-36; the reference stops at the data)",
    )
    p.add_argument("--data_dir", default="./data/",
                   help="dataset directory (batch files + poses/variances)")
    p.add_argument("--out", default="model.npz", help="model artifact path")
    p.add_argument("--hidden", type=int, nargs="+", default=[256, 256, 256])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8192)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--val_fraction", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16",
                   help="product input dtype (outputs and sums are always "
                        "f32); bfloat16 runs on the card's tensor cores")
    p.add_argument("--data_parallel", action="store_true",
                   help="split each minibatch over every device of "
                        "--device's kind (gradients summed on the first)")
    p.add_argument("--accuracy_bins", type=float, nargs="+",
                   default=[0.0, 0.01, 0.1, 1.0],
                   help="bins for the per-bin validation MAE report")
    p.add_argument("--balance_bins", type=float, nargs="+", default=None,
                   help="cp bin edges: balance the training rows across "
                        "these bins first (data/balance truncation — the "
                        "reference's balance_datasets.py step), countering "
                        "the annulus sampler's ~61%% zero-cp mass")
    p.add_argument("--robot_width", type=float, default=4.07,
                   help="robot used for the physics feature columns "
                        "(signed distance at the mean pose) — must match "
                        "the robot the dataset was labeled with")
    p.add_argument("--robot_height", type=float, default=1.74)
    p.add_argument("--device", default="cuda",
                   help="torch device the features and the training run on")
    p.add_argument("--verbose", type=_bool_flag, default=True)
    p.set_defaults(func=_run_train)


def _run_train(args: argparse.Namespace) -> int:
    from collide2d_tpu_torch.models.learned import (
        TrainConfig,
        load_training_data,
        save_model,
        train_model,
    )

    robot_wh = (args.robot_width, args.robot_height)
    features, labels = load_training_data(
        args.data_dir, balance_bins=args.balance_bins, robot_wh=robot_wh,
        device=args.device)
    balanced = " (balanced)" if args.balance_bins else ""
    print(f"training on {features.shape[0]} rows from {args.data_dir}"
          f"{balanced}")
    cfg = TrainConfig(
        hidden=tuple(args.hidden),
        epochs=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        val_fraction=args.val_fraction,
        seed=args.seed,
        compute_dtype=args.compute_dtype,
        data_parallel=args.data_parallel,
        verbose=args.verbose,
    )
    result = train_model(features, labels, cfg,
                         accuracy_bins=tuple(args.accuracy_bins),
                         robot_wh=robot_wh, device=args.device)
    save_model(args.out, result, cfg)
    bins = ", ".join(
        f"[{lo:g},{hi:g}): {mae:.4f}"
        for (lo, hi), mae in zip(
            zip(args.accuracy_bins[:-1], args.accuracy_bins[1:]),
            result.val_mae_per_bin,
        )
    )
    print(f"val bce {result.val_bce:.5f}  val mae {result.val_mae:.4f}")
    if bins:
        print(f"val mae per cp bin: {bins}")
    print(f"model -> {args.out}")
    return 0


def _add_predict(sub) -> None:
    p = sub.add_parser(
        "predict",
        help="predict cps for one batch file with a trained model; output "
             "is the bare cps vector (ztest --cps_only schema), directly "
             "comparable to MC labels via `collide2d-torch compare`",
    )
    p.add_argument("--model", required=True, help="model artifact (.npz)")
    p.add_argument("--data_in", required=True,
                   help=".npy batch: (N,5) dataset rows or (N,4) relabel "
                        "rows")
    p.add_argument("--data_dir", default="./data/",
                   help="directory holding poses.npy / variances.npy")
    p.add_argument("--out", default="predicted_cps.npy")
    p.add_argument("--device", default="cuda",
                   help="torch device the features and the model run on")
    p.set_defaults(func=_run_predict)


def _run_predict(args: argparse.Namespace) -> int:
    from collide2d_tpu_torch.models.learned import predict_file
    from collide2d_tpu_torch.utils.io_npy import save_npy

    cps = predict_file(args.model, args.data_in, args.data_dir, device=args.device)
    save_npy(args.out, cps)
    print(f"predicted {cps.shape[0]} cps -> {args.out}")
    return 0


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """Parse a command line."""
    parser = argparse.ArgumentParser(
        prog="collide2d-torch",
        description="2D convex collision engine on PyTorch/CUDA "
                    "(dataset generation / relabeling / validation / "
                    "k-gon and trajectory labeling / benchmarks / "
                    "balancing and plots / the learned model)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    _add_generate(sub)
    _add_relabel(sub)
    _add_ztest(sub)
    _add_compare(sub)
    _add_polylabel(sub)
    _add_movelabel(sub)
    _add_bench(sub)
    _add_balance(sub)
    _add_show(sub)
    _add_train(sub)
    _add_predict(sub)
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    with span("pipeline/cli_parse"):
        args = parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
