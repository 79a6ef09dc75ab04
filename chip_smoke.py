"""Quickest proof that the PyTorch/CUDA port runs its main path on one GPU.

Run with no arguments from the repository root on a machine with an
NVIDIA H100 (sm_90a) and nvcc:

    python3 chip_smoke.py

Phases (each prints its result and seconds on its own line; any failure
raises, and the script then exits non-zero without printing a result):

1. the card's name and power limit (nvidia-smi); build the kernels from
   this checkout, one nvcc per source, started together: the fused Monte
   Carlo kernel (collide2d_tpu_torch/csrc/mc_kernel.cu) and the SAT
   kernels (collide2d_tpu_torch/csrc/sat_kernel.cu);
2. the kernel against its plain PyTorch version on the card, same Philox
   stream, C = 100,000 annulus configurations x n = 4096 samples, shape
   noise off and on, and the adaptive tail's 256 rows x 100,000 samples:
   sum |dcount| <= 1e-5 * C * n; samples/s of both, timed with CUDA
   events after a warm-up;
3. the main path: ``collide2d-torch generate --device cuda -n 2
   -b 100000 --seed 7`` at the default 64^4-row tables, 4e6 cap and
   reference bins, in process; two (100000, 5) float32 files with finite
   cp in [0, 1], kernel launches > 0, zero-probability share in
   [0.5, 0.7]; configs/s and mean samples per configuration;
4. the acceptance bar: ``ztest --cps_only true`` with another seed on the
   first 16,384 rows of batch 0, then ``compare``: mean |d| <= 1e-3 and a
   share within +-0.005 of at least 0.93;
5. stream invariance: ``generate -n 2 -b 16384`` with
   ``--overlap_batches 1`` and ``3`` at one seed give bitwise-equal files;
6. the SAT kernels at N = 2^23 pairs (the JAX bench's size), inputs drawn
   on the card by a seeded torch.Generator as in `example_configs`: the
   main path ``CollisionProbabilityModel.collide`` (vertex f32 and bf16,
   obb) and the count entry points launch every kernel; then each kernel
   against its plain version on the same packed tensors: 0 labels differ,
   counts exact, collision share in (0, 1); kernel ms (CUDA events, 20
   launches after a warm-up), plain ms (1 run), pairs/s and GB/s;
7. ``relabel --device cuda`` with another seed on phase 3's two batches:
   order and shapes kept, mean |d| <= 1e-3 and a share within +-0.005 of
   at least 0.93 against phase 3's labels; configs/s;
8. ``generate -n 1 -b 100000 --seed 7`` with ``--prune_sigma 6`` against
   the same call without it: rows `possible_collision_mask` keeps are
   bitwise equal, pruned rows have cp = 0; then ``--schedule opt``: files
   as in phase 3; checkpoints, mean samples per configuration, configs/s.

The second-to-last lines are the card (name, power limit) and one JSON
object describing each kernel of the path; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
C_CHECK, N_CHECK = 100_000, 4096
TAIL_ROWS, TAIL_SAMPLES = 256, 100_000
MISMATCH_BOUND = 1e-5
SAT_PAIRS = 1 << 23
# Bytes each kernel moves per pair (in + out): 8 f32 coordinates of each
# rectangle (bf16: half) or 6 f32 rows of each box, plus a 4-byte label.
SAT_BYTES = {"sat_label": 68, "sat_label_bf16": 36, "sat_count": 64,
             "sat_count_bf16": 32, "obb_label": 52, "obb_count": 48}


def _line(phase: str, seconds: float, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body} seconds={seconds:.3f}", flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _quiet(fn, *args):
    """Run ``fn(*args)`` with its progress lines captured (returned)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def _events_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from collide2d_tpu_torch.utils import cuda_build

    t = time.monotonic()
    names = ("mc_kernel", "sat_kernel")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(cuda_build.build, names))
    for name in names:
        cuda_build.load(name)
    _line("1 build", time.monotonic() - t, kernels=",".join(f"{n}.cu" for n in names),
          libraries=",".join(lib.name for lib in libs))


def phase_kernel_vs_plain() -> dict:
    from collide2d_tpu_torch.data.pipeline import GenerateConfig, _sample_tables
    from collide2d_tpu_torch.mc import prng
    from collide2d_tpu_torch.mc.estimator import Configs
    from collide2d_tpu_torch.mc.noise import sample_configuration_batch
    from collide2d_tpu_torch.ops import mc_cuda

    dev = torch.device("cuda")
    result = {}
    # (name, rows, samples, shape noise): the reference default and shape
    # noise at full batch width, then the adaptive tail's shape (min_active
    # rows, later_batch samples a round).
    cases = (("default", C_CHECK, N_CHECK, False),
             ("shape_noise", C_CHECK, N_CHECK, True),
             ("tail", TAIL_ROWS, TAIL_SAMPLES, False))
    for key, c, n, shape_noise in cases:
        t = time.monotonic()
        poses, variances = _sample_tables(GenerateConfig(
            num_poses=65_536, num_variances=65_536, shape_variance=shape_noise))
        cfg = GenerateConfig()
        pos, _, _, pose, sd = sample_configuration_batch(
            prng.PRNGKey(11), torch.as_tensor(poses, device=dev),
            torch.as_tensor(np.sqrt(variances), device=dev),
            num_configs=c, r_offset=cfg.r_offset, spread=cfg.spread)
        configs = Configs(pos, pose[:, 2], pose[:, :2], sd)
        params = mc_cuda.pack_mc_params(configs, cfg.robot_wh)
        uids = torch.arange(c, dtype=torch.int32, device=dev)
        seed = mc_cuda.round_seed(prng.PRNGKey(12), 3)
        got = mc_cuda.mc_counts(params, uids, seed, n, shape_noise=shape_noise)
        want = mc_cuda.mc_counts_plain(params, uids, seed, n,
                                       shape_noise=shape_noise, max_elems=1 << 24)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        total = int(diff.sum())
        if total > MISMATCH_BOUND * c * n:
            raise RuntimeError(
                f"kernel disagrees with its plain version: sum|dcount|={total} "
                f"> {MISMATCH_BOUND} * C * n ({key})")
        if not (0 < int(got.sum()) < c * n):
            raise RuntimeError("degenerate counts: all hits or none")
        kernel_ms = _events_ms(lambda: mc_cuda.mc_counts(
            params, uids, seed, n, shape_noise=shape_noise), reps=20)
        plain_ms = _events_ms(lambda: mc_cuda.mc_counts_plain(
            params, uids, seed, n, shape_noise=shape_noise,
            max_elems=1 << 24), reps=1)
        result[key] = dict(sum_abs_diff=total, max_abs_err=int(diff.max()),
                           rows_differ=int((diff > 0).sum()),
                           kernel_ms=kernel_ms, plain_ms=plain_ms)
        _line("2 kernel-vs-plain", time.monotonic() - t, case=key,
              shape_noise=shape_noise, C=c, n=n, sum_abs_dcount=total,
              rows_differ=result[key]["rows_differ"],
              kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.2f}",
              kernel_samples_per_s=f"{c * n / kernel_ms * 1e3:.4e}",
              plain_samples_per_s=f"{c * n / plain_ms * 1e3:.4e}")
    return result


def _generate(argv):
    from collide2d_tpu_torch import cli
    from collide2d_tpu_torch.data.pipeline import generate_dataset

    return generate_dataset(cli.generate_config(cli.parse_args(["generate", *argv])))


def _check_batch(path: Path, rows_expected: int = 100_000) -> np.ndarray:
    """A written batch: (rows, 5) float32, finite, cp in [0, 1]."""
    rows = np.load(path)
    if rows.shape != (rows_expected, 5) or rows.dtype != np.float32:
        raise RuntimeError(f"{path.name}: shape {rows.shape} dtype {rows.dtype}")
    cp = rows[:, 2]
    if not (np.isfinite(rows).all() and (cp >= 0).all() and (cp <= 1).all()):
        raise RuntimeError(f"{path.name}: cp not finite in [0, 1]")
    return rows


def phase_main_path(work: Path) -> int:
    from collide2d_tpu_torch.ops import mc_cuda

    t = time.monotonic()
    data = work / "main"
    mc_cuda.reset_launches()
    stats, _ = _quiet(_generate, ["--device", "cuda", "-n", "2", "-b", "100000",
                                  "--seed", "7", "--data_dir", str(data)])
    torch.cuda.synchronize()
    launches = mc_cuda.LAUNCHES
    if launches <= 0:
        raise RuntimeError("the main path never launched the kernel")
    zero = []
    for i in range(2):
        rows = _check_batch(data / f"{i}.npy")
        zero.append(float((rows[:, 2] == 0).mean()))
    zero_share = float(np.mean(zero))
    if not 0.5 <= zero_share <= 0.7:
        raise RuntimeError(f"zero-probability share {zero_share:.4f} not in [0.5, 0.7]")
    _line("3 generate", time.monotonic() - t, batches=2, batch_size=100_000,
          tables="64^4", setup_s=f"{stats.setup_seconds:.2f}",
          label_s=f"{stats.label_seconds:.3f}",
          configs_per_s=f"{stats.rows / stats.label_seconds:.1f}",
          mean_samples_per_config=f"{stats.samples_used / stats.rows:.1f}",
          slot_efficiency=f"{stats.samples_used / stats.slots_dispatched:.4f}",
          zero_share=f"{zero_share:.4f}", kernel_launches=launches)
    return launches


def phase_acceptance(work: Path) -> None:
    from collide2d_tpu_torch import cli
    from collide2d_tpu_torch.data.validate import compare_labels

    t = time.monotonic()
    data = work / "main"
    rows = np.load(data / "0.npy")[:16_384]
    head, inp, out = (work / f"ztest_{x}.npy" for x in ("head", "in", "cps"))
    np.save(head, rows)
    np.save(inp, rows[:, [0, 1, 3, 4]].astype(np.float32))
    rc, _ = _quiet(cli.main, [
        "ztest", "--device", "cuda", "--data_dir", str(data),
        "--data_file_in", str(inp), "--data_file_out", str(out),
        "--cps_only", "true", "--seed", "8"])
    if rc != 0:
        raise RuntimeError(f"ztest exited {rc}")
    report = compare_labels(rows, np.load(out))
    if report.mean_abs_diff > 1e-3 or report.frac_within_tolerance < 0.93:
        raise RuntimeError(f"acceptance bar missed: {report}")
    rc, _ = _quiet(cli.main, ["compare", str(head), str(out)])
    _line("4 ztest+compare", time.monotonic() - t, rows=16_384,
          mean_abs_d=f"{report.mean_abs_diff:.3e}",
          share_within_tol=f"{report.frac_within_tolerance:.4f}",
          tol=report.tolerance, compare_exit=rc)


def phase_invariance(work: Path) -> None:
    t = time.monotonic()
    dirs = []
    for overlap in (1, 3):
        d = work / f"overlap{overlap}"
        _quiet(_generate, ["--device", "cuda", "-n", "2", "-b", "16384",
                           "--num_poses", "4096", "--num_variances", "4096",
                           "--seed", "3", "--overlap_batches", str(overlap),
                           "--data_dir", str(d)])
        dirs.append(d)
    for i in range(2):
        if (dirs[0] / f"{i}.npy").read_bytes() != (dirs[1] / f"{i}.npy").read_bytes():
            raise RuntimeError(f"batch {i} differs between --overlap_batches 1 and 3")
    _line("5 invariance", time.monotonic() - t, batches=2, batch_size=16_384,
          bitwise_equal=True)


def phase_sat() -> dict:
    """Phase 6: returns per-kernel launches, errors and times."""
    from collide2d_tpu_torch.models.collision_model import CollisionProbabilityModel
    from collide2d_tpu_torch.ops import sat_cuda
    from collide2d_tpu_torch.ops.geometry import rects_from_params

    t = time.monotonic()
    dev = torch.device("cuda")
    n = SAT_PAIRS
    g = torch.Generator(device=dev).manual_seed(6)
    pos = torch.rand((n, 2), generator=g, device=dev) * 12.0 - 6.0
    theta = torch.rand((n,), generator=g, device=dev) * (2.0 * math.pi)
    wh = torch.rand((n, 2), generator=g, device=dev) * 4.9 + 0.1
    model = CollisionProbabilityModel()
    ext = model._robot_ext(pos)
    zeros, zeros_t = torch.zeros_like(pos), torch.zeros_like(theta)
    packs = {
        "f32": (sat_cuda.pack_rects(rects_from_params(pos, ext, theta)),
                sat_cuda.pack_rects(rects_from_params(zeros, wh, zeros_t))),
        "obb": (sat_cuda.pack_obbs(pos, ext, theta), sat_cuda.pack_obbs(zeros, wh, zeros_t)),
    }
    packs["bf16"] = tuple(p.to(torch.bfloat16) for p in packs["f32"])

    # The main path: the model's labels, and the count kernels' entry points
    # (the throughput legs call them on packed pairs).
    sat_cuda.reset_launches()
    labels = {
        "f32": model.collide(pos, theta, wh),
        "bf16": model.collide(pos, theta, wh, precision="bf16"),
        "obb": model.collide(pos, theta, wh, method="obb"),
    }
    counts = {"f32": sat_cuda.sat_count_cuda_t(*packs["f32"]),
              "bf16": sat_cuda.sat_count_cuda_t(*packs["bf16"]),
              "obb": sat_cuda.obb_count_cuda_t(*packs["obb"])}
    torch.cuda.synchronize()
    launches = dict(sat_cuda.LAUNCHES)
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a SAT kernel was never launched: {launches}")

    result = {name: {"launches": launches[name], "max_abs_err": 0.0}
              for name in launches}
    for key in ("f32", "bf16", "obb"):
        a, b = packs[key]
        label_fn, count_fn, plain_fn, label_name, count_name = (
            (sat_cuda.obb_collide_cuda_t, sat_cuda.obb_count_cuda_t,
             sat_cuda.obb_collide_plain, "obb_label", "obb_count") if key == "obb"
            else (sat_cuda.sat_rects_cuda_t, sat_cuda.sat_count_cuda_t,
                  sat_cuda.sat_collide_plain, "sat_label", "sat_count"))
        got = label_fn(a, b)
        want = plain_fn(a, b).reshape(-1).to(torch.float32)
        differ = int((got != want).sum())
        share = float(want.mean())
        if differ or not torch.equal(labels[key], got.to(torch.int32)):
            raise RuntimeError(f"{label_name} ({key}): {differ} labels differ "
                               "from the plain version")
        if not 0.0 < share < 1.0:
            raise RuntimeError(f"degenerate collision share {share} ({key})")
        plain_count = int(want.sum())
        count_err = abs(int(counts[key]) - plain_count)
        if count_err:
            raise RuntimeError(f"{count_name} ({key}): {int(counts[key])} != "
                               f"plain sum {plain_count}")
        for name, fn, plain, exact in (
                (label_name, lambda: label_fn(a, b), lambda: plain_fn(a, b),
                 float((got - want).abs().max())),
                (count_name, lambda: count_fn(a, b),
                 lambda: plain_fn(a, b).sum(), float(count_err))):
            kernel_ms = _events_ms(fn, reps=20)
            plain_ms = _events_ms(plain, reps=1)
            tag = name + ("_bf16" if key == "bf16" else "")
            gbps = SAT_BYTES[tag] * n / (kernel_ms * 1e-3) / 1e9
            _line("6 sat", time.monotonic() - t, kernel=tag, pairs=n,
                  labels_differ=differ, count=int(counts[key]),
                  collision_share=f"{share:.4f}",
                  kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.3f}",
                  kernel_pairs_per_s=f"{n / kernel_ms * 1e3:.4e}",
                  plain_pairs_per_s=f"{n / plain_ms * 1e3:.4e}",
                  bytes_per_pair=SAT_BYTES[tag], kernel_gb_per_s=f"{gbps:.1f}")
            entry = result[name]
            entry["max_abs_err"] = max(entry["max_abs_err"], exact)
            if key != "bf16":  # the f32 (and obb) timings are the reported ones
                entry.update(ms=kernel_ms, plain_ms=plain_ms)
    return result


def _relabel(argv):
    from collide2d_tpu_torch import cli
    from collide2d_tpu_torch.data.pipeline import relabel_dataset

    return relabel_dataset(cli.relabel_config(cli.parse_args(["relabel", *argv])))


def phase_relabel(work: Path) -> None:
    from collide2d_tpu_torch.data.validate import compare_labels

    t = time.monotonic()
    main, inp, out = work / "main", work / "relabel_in", work / "relabel_out"
    inp.mkdir()
    (out / "meta").mkdir(parents=True)
    for name in ("poses.npy", "variances.npy", "meta/accuracy_bins.npy",
                 "meta/bin_accuracy.npy"):
        os.symlink(main / name, out / name)
    for i in range(2):
        rows = np.load(main / f"{i}.npy")
        np.save(inp / f"{i}.npy", rows[:, [0, 1, 3, 4]].astype(np.float32))
    stats, _ = _quiet(_relabel, [
        "--device", "cuda", "--data_in", str(inp), "--data_out", str(out),
        "--seed", "8", "--shuffle", "false"])
    reports = []
    for i in range(2):
        new = _check_batch(out / f"{i}.npy")
        old = np.load(main / f"{i}.npy")
        if not np.array_equal(new[:, [0, 1, 3, 4]], old[:, [0, 1, 3, 4]]):
            raise RuntimeError(f"relabel batch {i}: rows not in input order")
        reports.append(compare_labels(old, new))
    mean_d = float(np.mean([r.mean_abs_diff for r in reports]))
    share = float(np.mean([r.frac_within_tolerance for r in reports]))
    if mean_d > 1e-3 or share < 0.93:
        raise RuntimeError(f"relabel misses the acceptance bar: {reports}")
    _line("7 relabel", time.monotonic() - t, batches=2, batch_size=100_000,
          label_s=f"{stats.label_seconds:.3f}",
          configs_per_s=f"{stats.rows / stats.label_seconds:.1f}",
          mean_samples_per_config=f"{stats.samples_used / stats.rows:.1f}",
          mean_abs_d=f"{mean_d:.3e}", share_within_tol=f"{share:.4f}")


def phase_prune_opt(work: Path) -> None:
    from collide2d_tpu_torch.mc.estimator import Configs
    from collide2d_tpu_torch.ops.broad_phase import possible_collision_mask

    t = time.monotonic()
    main = work / "main"
    tables = ["--pose_dir", str(main / "poses.npy"),
              "--variance_dir", str(main / "variances.npy")]
    base = ["--device", "cuda", "-n", "1", "-b", "100000", "--seed", "7", *tables]
    runs = {}
    for name, extra in (("full", []), ("pruned", ["--prune_sigma", "6"])):
        stats, _ = _quiet(_generate, [*base, *extra, "--data_dir", str(work / name)])
        runs[name] = (stats, _check_batch(work / name / "0.npy"))
    full, pruned = runs["full"][1], runs["pruned"][1]
    if not np.array_equal(full[:, [0, 1, 3, 4]], pruned[:, [0, 1, 3, 4]]):
        raise RuntimeError("pruned and unpruned runs sampled different rows")
    poses = np.load(main / "poses.npy")[full[:, 4].astype(np.int64)]
    sds = np.sqrt(np.load(main / "variances.npy")[full[:, 3].astype(np.int64)])
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device="cuda")  # noqa: E731
    configs = Configs(f32(full[:, :2]), f32(poses[:, 2]), f32(poses[:, :2]), f32(sds))
    keep = possible_collision_mask(configs, (4.07, 1.74), 6.0).cpu().numpy()
    if not np.array_equal(pruned[keep], full[keep]):
        raise RuntimeError(f"{int((pruned[keep] != full[keep]).any(1).sum())} kept "
                           "rows differ from the unpruned run")
    if (pruned[~keep, 2] != 0).any():
        raise RuntimeError("a pruned row has cp != 0")
    rate = {k: s.rows / s.label_seconds for k, (s, _) in runs.items()}
    _line("8 prune", time.monotonic() - t, rows=100_000,
          pruned_share=f"{1.0 - keep.mean():.4f}", kept_rows_bitwise_equal=True,
          configs_per_s_unpruned=f"{rate['full']:.1f}",
          configs_per_s_pruned=f"{rate['pruned']:.1f}",
          mean_samples_unpruned=f"{runs['full'][0].samples_used / len(full):.1f}",
          mean_samples_pruned=f"{runs['pruned'][0].samples_used / len(full):.1f}")

    t = time.monotonic()
    stats, log = _quiet(_generate, [*base, "--schedule", "opt",
                                    "--data_dir", str(work / "opt")])
    rows = _check_batch(work / "opt" / "0.npy")
    zero_share = float((rows[:, 2] == 0).mean())
    if not 0.5 <= zero_share <= 0.7:
        raise RuntimeError(f"opt: zero-probability share {zero_share:.4f} not in [0.5, 0.7]")
    found = re.search(r"opt schedule: (\d+) checkpoints", log)
    if found is None:
        raise RuntimeError("opt: the schedule was not resolved")
    _line("8 opt", time.monotonic() - t, rows=100_000, checkpoints=found.group(1),
          label_s=f"{stats.label_seconds:.3f}",
          configs_per_s=f"{stats.rows / stats.label_seconds:.1f}",
          mean_samples_per_config=f"{stats.samples_used / stats.rows:.1f}",
          zero_share=f"{zero_share:.4f}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    t0 = time.monotonic()
    card = _card()
    print(f"[1 card] {card}", flush=True)
    if not (HERE / "collide2d_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke: run it from a checkout of the repository")
    sys.path.insert(0, str(HERE))
    import collide2d_tpu_torch

    if Path(collide2d_tpu_torch.__file__).resolve().parent != HERE / "collide2d_tpu_torch":
        raise SystemExit("chip_smoke: imported collide2d_tpu_torch from outside this checkout")

    phase_build()
    check = phase_kernel_vs_plain()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        launches = phase_main_path(work)
        phase_acceptance(work)
        phase_invariance(work)
        sat = phase_sat()
        phase_relabel(work)
        phase_prune_opt(work)
    default = check["default"]
    kernels = {"kernels": [{
        "name": "mc_counts",
        "route": "cuda",
        "source": "collide2d_tpu_torch/csrc/mc_kernel.cu",
        "replaces": "collide2d_tpu/ops/mc_pallas.py:207",
        "launches": launches,
        "max_abs_err": max(check[k]["max_abs_err"] for k in check),
        "ms": default["kernel_ms"],
        "plain_ms": default["plain_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "collide2d_tpu_torch/csrc/sat_kernel.cu",
        "replaces": f"collide2d_tpu/ops/sat_pallas.py:{line}",
        **sat[name],
    } for name, line in (("sat_label", 96), ("sat_count", 100),
                         ("obb_label", 268), ("obb_count", 303))]}
    print(f"[done] seconds={time.monotonic() - t0:.1f}", flush=True)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
